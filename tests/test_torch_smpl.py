"""PyTorch port vs JAX package: SMPL assets, LBS and the SMPL heads.

Full SMPL width (V=6890), batch 2, on the CPU. Positions are held to
1e-5 m (fp32 sums over 207 pose features and 6890 regressor taps, in
another order); projected joints to 1e-3 px on ~1e3 px magnitudes.
"""

import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops.rotation import axis_angle_to_rotmat
from poco_tpu.smpl import assets as jassets
from poco_tpu.smpl.lbs import batch_rigid_transform as jax_batch_rigid_transform
from poco_tpu.smpl.lbs import smpl_forward as jax_smpl_forward
from poco_tpu.smpl import model as jmodel
from poco_tpu_torch.smpl import assets as tassets
from poco_tpu_torch.smpl import lbs as tlbs
from poco_tpu_torch.smpl import model as tmodel

METERS = 1e-5
V = 6890
B = 2


@pytest.fixture(scope="module")
def models():
    return (
        jassets.synthetic_smpl_model(num_verts=V, seed=3),
        tassets.synthetic_smpl_model(num_verts=V, seed=3, device="cpu"),
    )


def _pose(batch, seed, scale=0.4):
    rng = np.random.RandomState(seed)
    betas = rng.randn(batch, 10).astype(np.float32)
    aa = (scale * rng.randn(batch * 24, 3)).astype(np.float32)
    rot = np.array(axis_angle_to_rotmat(jnp.asarray(aa))).reshape(batch, 24, 3, 3)
    return betas, rot


def _close(port, ref, atol=METERS):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _same_params(jp, tp):
    for name in tlbs._TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    assert tp.parents == jp.parents
    assert tp.vertex_joint_ids == jp.vertex_joint_ids


@pytest.mark.parametrize("num_verts,seed", [(432, 0), (V, 3)])
def test_synthetic_model_same_arrays(num_verts, seed):
    _same_params(
        jassets.synthetic_smpl_model(num_verts=num_verts, seed=seed),
        tassets.synthetic_smpl_model(num_verts=num_verts, seed=seed, device="cpu"),
    )


def test_smpl_params_to_keeps_static_fields(models):
    _, tp = models
    moved = tp.to("cpu")
    assert moved.parents == tp.parents and moved.v_template.device.type == "cpu"


def test_smpl_params_index_tensors_follow_the_tuples(models):
    """The index tensors equal their tuples (and the 49-joint map), int64 on
    the params' device; `.to` (a dtype too) and a shard remake them from the
    tuples, `vertex_joint_index` global with a shard."""
    from poco_tpu_torch.constants import JOINT_MAP_49

    _, tp = models

    def assert_indexes(params):
        assert params.parent_index.tolist() == list(params.parents[1:])
        assert params.vertex_joint_index.tolist() == list(params.vertex_joint_ids)
        assert params.joint_map_49.tolist() == JOINT_MAP_49.tolist()
        for index in (params.parent_index, params.vertex_joint_index, params.joint_map_49):
            assert index.dtype == torch.int64 and index.device == params.v_template.device

    assert_indexes(tp)
    moved = tp.to(torch.float64)
    assert moved.v_template.dtype == torch.float64
    assert_indexes(moved)
    sharded = tlbs.dataclasses.replace(tp, v_template=tp.v_template[:8], shard=tlbs.VertexShard(
        0, 8, (8, V - 8), None, tp.lbs_weights))
    assert_indexes(sharded)
    assert len(sharded.vertex_joint_index) == len(tp.vertex_joint_ids)


def test_batch_rigid_transform(models):
    jp, tp = models
    _, rot = _pose(B, 1)
    joints = np.random.RandomState(2).randn(B, 24, 3).astype(np.float32)
    pj, rel = tlbs.batch_rigid_transform(torch.from_numpy(rot), torch.from_numpy(joints),
                                         tp.parents, tp.parent_index)
    pj_ref, rel_ref = jax_batch_rigid_transform(jnp.asarray(rot), jnp.asarray(joints), jp.parents)
    _close(pj, pj_ref)
    _close(rel, rel_ref)


def test_smpl_forward_fullwidth(models):
    jp, tp = models
    betas, rot = _pose(B, 4)
    port = tlbs.smpl_forward(tp, torch.from_numpy(betas), torch.from_numpy(rot))
    ref = jax_smpl_forward(jp, jnp.asarray(betas), jnp.asarray(rot), use_pallas=False)
    assert port.vertices.shape == (B, V, 3) and port.joints.shape == (B, 54, 3)
    _close(port.vertices, ref.vertices)
    _close(port.joints, ref.joints)
    _close(port.joints_lbs, ref.joints_lbs)


def test_smplcam_head_fullwidth(models):
    jp, tp = models
    betas, rot = _pose(B, 5)
    rng = np.random.RandomState(6)
    cam = np.stack([rng.uniform(0.7, 1.1, B), rng.randn(B) * 0.1, rng.randn(B) * 0.1],
                   axis=1).astype(np.float32)
    args = dict(
        focal_length=np.full(B, 1468.6, np.float32),
        bbox_scale=rng.uniform(0.8, 3.0, B).astype(np.float32),
        bbox_center=rng.uniform(200, 700, (B, 2)).astype(np.float32),
        img_w=np.full(B, 1280.0, np.float32),
        img_h=np.full(B, 720.0, np.float32),
    )
    port = tmodel.smplcam_head(
        tp, torch.from_numpy(rot), torch.from_numpy(betas), torch.from_numpy(cam),
        **{k: torch.from_numpy(v) for k, v in args.items()},
    )
    ref = jmodel.smplcam_head(
        jp, jnp.asarray(rot), jnp.asarray(betas), jnp.asarray(cam),
        **{k: jnp.asarray(v) for k, v in args.items()},
    )
    _close(port.vertices, ref.vertices)
    _close(port.joints3d, ref.joints3d)
    _close(port.joints2d, ref.joints2d, atol=1e-3)
    _close(port.fullimg_cam_t, ref.fullimg_cam_t, atol=1e-4)
    _close(port.cam_t, ref.cam_t, atol=1e-3)


def test_smplcam_head_detaches_camera(models):
    _, tp = models
    betas, rot = _pose(1, 7)
    cam = torch.tensor([[0.9, 0.0, 0.0]], requires_grad=True)
    out = tmodel.smplcam_head(
        tp, torch.from_numpy(rot), torch.from_numpy(betas), cam,
        torch.tensor([1000.0]), torch.tensor([1.0]), torch.tensor([[300.0, 200.0]]),
        torch.tensor([640.0]), torch.tensor([480.0]),
    )
    assert not out.fullimg_cam_t.requires_grad and out.cam_t.requires_grad


def test_smpl_head_weak_perspective(models):
    jp, tp = models
    betas, rot = _pose(B, 8)
    cam = np.asarray([[1.0, 0.0, 0.0], [0.8, 0.1, -0.1]], np.float32)
    port = tmodel.smpl_head(tp, torch.from_numpy(rot), torch.from_numpy(betas),
                            torch.from_numpy(cam), normalize_joints2d=True)
    ref = jmodel.smpl_head(jp, jnp.asarray(rot), jnp.asarray(betas), jnp.asarray(cam),
                           normalize_joints2d=True)
    _close(port.joints3d, ref.joints3d)
    _close(port.joints2d, ref.joints2d, atol=1e-4)


@pytest.fixture
def smpl_pkl(tmp_path, monkeypatch):
    """A standard-layout SMPL pkl whose arrays are chumpy objects."""
    from scipy.sparse import csc_matrix

    chumpy = types.ModuleType("chumpy")
    ch = types.ModuleType("chumpy.ch")

    class Ch(np.ndarray):
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", chumpy)
    monkeypatch.setitem(sys.modules, "chumpy.ch", ch)

    rng = np.random.RandomState(9)
    n = 40
    kintree = np.stack([np.r_[4294967295, jassets.SMPL_PARENTS[1:].astype(np.int64)], np.arange(24)])
    d = {
        "v_template": rng.randn(n, 3).view(Ch),
        "shapedirs": rng.randn(n, 3, 300).view(Ch),
        "posedirs": rng.randn(n, 3, 207),
        "J_regressor": csc_matrix(rng.rand(24, n)),
        "weights": rng.rand(n, 24).view(Ch),
        "kintree_table": kintree,
        "f": rng.randint(0, n, (60, 3)).astype(np.uint32),
        "bs_style": "lbs",
    }
    path = tmp_path / "SMPL_NEUTRAL.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f, protocol=2)
    np.save(tmp_path / "J_regressor_extra.npy", rng.rand(9, n).astype(np.float32))
    monkeypatch.delitem(sys.modules, "chumpy.ch")  # loaders must not need it
    return path


def test_load_smpl_pkl_with_chumpy_stub(smpl_pkl):
    raw = tassets.load_smpl_pkl(str(smpl_pkl))
    assert raw["v_template"].shape == (40, 3)
    assert raw["bs_style"] == "lbs"
    tp = tassets.load_smpl_model(str(smpl_pkl), str(smpl_pkl.parent / "J_regressor_extra.npy"),
                                 device="cpu")
    jp = jassets.load_smpl_model(str(smpl_pkl), str(smpl_pkl.parent / "J_regressor_extra.npy"))
    _same_params(jp, tp)
    assert tp.shapedirs.shape == (40, 3, 10) and tp.posedirs.shape == (207, 120)


def test_resolve_smpl_params(smpl_pkl, tmp_path_factory):
    tp = tassets.resolve_smpl_params(str(smpl_pkl.parent), "male", device="cpu")
    assert tp.v_template.shape == (40, 3)  # the neutral model, never synthetic
    empty = tmp_path_factory.mktemp("empty")
    fallback = tassets.resolve_smpl_params(str(empty), device="cpu")
    assert fallback.v_template.shape == (432, 3)
