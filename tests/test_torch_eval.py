"""PyTorch port vs JAX package: evaluation.

Each module of the evaluation path on the same seeded numpy inputs on both
sides: the metrics (Procrustes on similarity transforms, a reflected
input and coplanar ones), the rest of the rotation and camera ops, the
uncertainty post-processing and its statistics, the eval step on the
narrow POCO-CLIFF twin (`test_torch_model.narrow_models`) with three
synthetic SMPLs, and `run_eval` end to end on a small image dataset.
Tolerances are stated beside each check; the per-sample metrics are held
to 1e-4 m, the 0.1 mm budget of `tests/test_fullwidth_parity.py:57`.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.eval.metrics as jax_metrics
import poco_tpu.eval.uncertainty as jax_uncertainty
import poco_tpu.ops.camera as jax_camera
import poco_tpu.ops.rotation as jax_rotation
from poco_tpu.data.dataset import PocoDataset as JaxPocoDataset
from poco_tpu.eval.runner import make_gendered_eval_step as jax_make_eval_step
from poco_tpu.eval.runner import pw3d_split_report as jax_split_report
from poco_tpu.eval.runner import run_eval as jax_run_eval
from poco_tpu.eval.uncert_stats import UncertStatsTracker as JaxTracker
from poco_tpu.parallel.mesh import make_mesh
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl

import poco_tpu_torch.eval.metrics as metrics
import poco_tpu_torch.eval.uncertainty as uncertainty
import poco_tpu_torch.ops.camera as camera
import poco_tpu_torch.ops.rotation as rotation
from poco_tpu_torch.constants import PW3D_OCCLUDED_SEQUENCES, PW3D_TEST_SEQUENCES
from poco_tpu_torch.data.dataset import PocoDataset
from poco_tpu_torch.eval.checks import equivariant_case, procrustes_f64
from poco_tpu_torch.eval.runner import (
    EVAL_STAGES,
    make_gendered_eval_step,
    pw3d_split_report,
    run_eval,
)
from poco_tpu_torch.eval.uncert_stats import UncertStatsTracker
from poco_tpu_torch.ops.skinning import skinning_reference
from poco_tpu_torch.smpl import lbs as lbs_module
from poco_tpu_torch.smpl.assets import synthetic_smpl_model

from .test_torch_model import jax_variables, narrow_models

METERS_TOL = 1e-4       # per-sample mpjpe / pa_mpjpe / v2v (0.1 mm)
VAR_POSE_TOL = 2e-3     # the head-output budget
POSE_DIST_TOL = 1e-5    # per-joint rotmat MSE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module: under the fast tier's
    six workers on a shared host the default team (a thread a core)
    spends the many small ops of the SMPL chain waiting in its barriers,
    over ten times slower than one thread. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rotmats(rng, shape, scale=1.0):
    aa = (scale * rng.randn(*shape, 3)).astype(np.float32)
    return np.asarray(jax_rotation.axis_angle_to_rotmat(jnp.asarray(aa)))


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def _procrustes_case(case: str):
    """Joints of one Procrustes case; `checks.procrustes_f64` is the
    float64 per-sample reference."""
    rng = np.random.RandomState(["similarity", "noisy", "reflected", "coplanar_pred",
                                 "coplanar_gt"].index(case))
    gt = rng.randn(6, 14, 3).astype(np.float32)
    rot = _rotmats(rng, (6,))
    scale = rng.uniform(0.5, 2.0, (6, 1, 1)).astype(np.float32)
    trans = rng.randn(6, 1, 3).astype(np.float32)
    pred = (scale * np.einsum("bij,bnj->bni", rot, gt) + trans).astype(np.float32)
    if case == "noisy":
        pred = pred + 0.1 * rng.randn(*pred.shape).astype(np.float32)
    elif case == "reflected":  # a mirror image: the guard must not reflect
        pred = pred * np.asarray([-1.0, 1.0, 1.0], np.float32)
    elif case == "coplanar_pred":
        pred[..., 2] = 0.3
    elif case == "coplanar_gt":
        gt[..., 1] = -0.2
        pred = pred + 0.05 * rng.randn(*pred.shape).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize(
    "case", ["similarity", "noisy", "reflected", "coplanar_pred", "coplanar_gt"]
)
def test_procrustes_matches_jax_and_float64(case):
    """Aligned joints within 1e-5 of JAX's (fp32 SVDs of different
    libraries) and of the float64 per-sample reference; a similarity
    transform aligns to 0 (1e-5); torch.sign(0) = 0 as jnp.sign."""
    pred, gt = _procrustes_case(case)
    port = metrics.procrustes_align(_t(pred), _t(gt)).numpy()
    ref = np.asarray(jax_metrics.procrustes_align(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port, procrustes_f64(pred, gt), atol=1e-5, rtol=0)
    pa = metrics.pa_mpjpe(_t(pred), _t(gt)).numpy()
    np.testing.assert_allclose(
        pa, np.asarray(jax_metrics.pa_mpjpe(jnp.asarray(pred), jnp.asarray(gt))),
        atol=1e-6, rtol=0,
    )
    if case == "similarity":
        np.testing.assert_allclose(pa, 0.0, atol=1e-5)
    assert float(torch.sign(torch.tensor(0.0))) == float(jnp.sign(0.0)) == 0.0


def test_mpjpe_vertex_error_joints_and_correlation_match_jax():
    rng = np.random.RandomState(5)
    pred, gt = rng.randn(2, 4, 14, 3).astype(np.float32)
    verts = rng.randn(2, 4, 300, 3).astype(np.float32)
    reg = rng.rand(17, 300).astype(np.float32)
    reg /= reg.sum(1, keepdims=True)
    u, e = rng.rand(2, 200).astype(np.float32)
    e = e + 2 * u
    pairs = [
        (metrics.mpjpe(_t(pred), _t(gt)), jax_metrics.mpjpe(jnp.asarray(pred), jnp.asarray(gt))),
        (metrics.vertex_error(_t(verts[0]), _t(verts[1])),
         jax_metrics.vertex_error(jnp.asarray(verts[0]), jnp.asarray(verts[1]))),
        (metrics.joints_from_vertices(_t(reg), _t(verts[0])),
         jax_metrics.joints_from_vertices(jnp.asarray(reg), jnp.asarray(verts[0]))),
        (metrics.uncert_error_correlation(_t(u), _t(e)),
         jax_metrics.uncert_error_correlation(jnp.asarray(u), jnp.asarray(e))),
    ]
    for port, ref in pairs:  # fp32 sums in another order
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-6)
    assert metrics.joints_from_vertices(_t(reg), _t(verts[0])).shape == (4, 14, 3)


# --------------------------------------------------------------------------
# rotation and camera ops
# --------------------------------------------------------------------------

_BRANCH_AXES = {"w": None, "x": 0, "y": 1, "z": 2}


@pytest.mark.parametrize("branch", sorted(_BRANCH_AXES))
def test_rotmat_to_quat_every_branch_matches_jax(branch):
    """Rotations near the identity take the w branch; near pi about x, y
    or z, the x, y or z branch (each holds its largest trace). Same
    quaternion as JAX (atol 1e-6), and back to the same rotation."""
    rng = np.random.RandomState(3)
    aa = 0.3 * rng.randn(8, 3)
    axis = _BRANCH_AXES[branch]
    if axis is not None:
        aa = 0.1 * rng.randn(8, 3)
        aa[:, axis] = np.pi - 0.2 * rng.rand(8)
    aa = aa.astype(np.float32)
    rot = np.asarray(jax_rotation.axis_angle_to_rotmat(jnp.asarray(aa)))
    m = rot
    traces = np.stack([
        1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2], 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
        1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2], 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2],
    ], -1)
    assert (traces.argmax(-1) == "wxyz".index(branch)).all()
    port = rotation.rotmat_to_quat(_t(rot)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_rotation.rotmat_to_quat(jnp.asarray(rot))),
                               atol=1e-6, rtol=0)
    assert (port[:, 0] >= 0).all()
    np.testing.assert_allclose(rotation.quat_to_rotmat(_t(port)).numpy(), rot, atol=2e-6)
    np.testing.assert_allclose(
        rotation.rotmat_to_axis_angle(_t(rot)).numpy(),
        np.asarray(jax_rotation.rotmat_to_axis_angle(jnp.asarray(rot))), atol=2e-5, rtol=0,
    )


def test_quat_to_axis_angle_small_angle_branch_matches_jax():
    """Angles below 1e-6 take the Taylor branch on both sides."""
    rng = np.random.RandomState(4)
    aa = np.concatenate([
        rng.randn(4, 3) * 1e-8, np.zeros((1, 3)), rng.randn(4, 3) * 0.5,
    ]).astype(np.float32)
    quat = np.asarray(jax_rotation.axis_angle_to_quat(jnp.asarray(aa)))
    port = rotation.quat_to_axis_angle(_t(quat)).numpy()
    np.testing.assert_allclose(
        port, np.asarray(jax_rotation.quat_to_axis_angle(jnp.asarray(quat))), atol=1e-7, rtol=1e-6
    )
    np.testing.assert_allclose(port, aa, atol=1e-6, rtol=1e-5)


def test_rot6d_flip_and_average_match_jax():
    """rotmat_to_rot6d inverts rot6d_to_rotmat; flip_pose_rotmat equals
    JAX's exactly and is an involution; average_rotmats(R, R) == R, and
    the average of two poses matches JAX's within 1e-5 (two SVDs)."""
    rng = np.random.RandomState(6)
    ra, rb = _rotmats(rng, (2, 3, 24))
    six = rotation.rotmat_to_rot6d(_t(ra))
    np.testing.assert_array_equal(six.numpy(), np.asarray(jax_rotation.rotmat_to_rot6d(jnp.asarray(ra))))
    np.testing.assert_allclose(rotation.rot6d_to_rotmat(six).numpy().reshape(ra.shape), ra, atol=1e-6)
    flipped = rotation.flip_pose_rotmat(_t(ra))
    np.testing.assert_array_equal(
        flipped.numpy(), np.asarray(jax_rotation.flip_pose_rotmat(jnp.asarray(ra)))
    )
    np.testing.assert_array_equal(rotation.flip_pose_rotmat(flipped).numpy(), ra)
    np.testing.assert_allclose(rotation.average_rotmats(_t(ra), _t(ra)).numpy(), ra, atol=2e-6)
    avg = rotation.average_rotmats(_t(ra), _t(rb)).numpy()
    np.testing.assert_allclose(
        avg, np.asarray(jax_rotation.average_rotmats(jnp.asarray(ra), jnp.asarray(rb))), atol=1e-5
    )
    np.testing.assert_allclose(np.linalg.det(avg), 1.0, atol=1e-5)


def test_build_intrinsics_matches_jax():
    rng = np.random.RandomState(7)
    f, w, h = rng.uniform(300, 1500, (3, 5)).astype(np.float32)
    port = camera.build_intrinsics(_t(f), _t(w), _t(h))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jax_camera.build_intrinsics(*map(jnp.asarray, (f, w, h))))
    )


@pytest.mark.parametrize("use_all_joints", [False, True])
def test_estimate_translation_matches_jax(use_all_joints):
    """The same translation as JAX's solve (rtol 1e-5, fp32 normal
    equations), and the true one from exact, fully confident 2D joints."""
    rng = np.random.RandomState(8)
    j3d = (0.4 * rng.randn(4, 49, 3)).astype(np.float32)
    t_true = np.stack([rng.uniform(-0.3, 0.3, 4), rng.uniform(-0.3, 0.3, 4),
                       rng.uniform(20, 40, 4)], -1).astype(np.float32)
    p = j3d + t_true[:, None]
    uv = 5000.0 * p[..., :2] / p[..., 2:] + 112.0
    kp = np.concatenate([uv, rng.uniform(0.5, 1.0, (4, 49, 1))], -1).astype(np.float32)
    port = camera.estimate_translation_from_49(_t(j3d), _t(kp), use_all_joints=use_all_joints)
    ref = jax_camera.estimate_translation_from_49(
        jnp.asarray(j3d), jnp.asarray(kp), use_all_joints=use_all_joints
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), t_true, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# uncertainty post-processing and statistics (numpy: equal to JAX's)
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "loss_ver", ["norm_flow_res_gaus", "gauss_logsigma", "delta", "genG", "mse_genG",
                 "gauss_genG"]
)
@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)])
def test_prepare_uncert_matches_jax(loss_ver, trailing):
    """Every loss_ver on (B, P), (B, P, 3) and (B, P, 3, 3) heads, with
    P the 24 joints times the parameters a joint carries."""
    width = {"delta": 48, "genG": 48, "mse_genG": 48, "gauss_genG": 72}.get(loss_ver, 24)
    var = np.random.RandomState(9).uniform(0.1, 2.0, (5, width) + trailing).astype(np.float32)
    for kwargs in ({}, {"kinematic": True}, {"return_conf": True}):
        port = uncertainty.prepare_uncert(var, loss_ver=loss_ver, **kwargs)
        ref = jax_uncertainty.prepare_uncert(var, loss_ver=loss_ver, **kwargs)
        assert port.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("backbone", ["hrnet_w48_cls-cliff", "hrnet_w32-pare"])
def test_kinematic_and_global_uncert_match_jax(backbone):
    var = np.random.RandomState(10).uniform(0.0, 1.0, (6, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        uncertainty.kinematic_uncert(var), jax_uncertainty.kinematic_uncert(var)
    )
    np.testing.assert_array_equal(
        uncertainty.global_uncert(var, backbone), jax_uncertainty.global_uncert(var, backbone)
    )


def test_uncert_stats_tracker_matches_jax(tmp_path):
    rng = np.random.RandomState(11)
    port, ref = UncertStatsTracker(exclude_uncert_idx=(3,)), JaxTracker(exclude_uncert_idx=(3,))
    for _ in range(3):
        var = rng.uniform(0.0, 1.0, (4, 24, 3, 3)).astype(np.float32)
        err = rng.uniform(0.0, 0.2, (4, 24)).astype(np.float32)
        port.update(var, err, keep_histogram=True)
        ref.update(var, err, keep_histogram=True)
    assert port.summary() == ref.summary()
    assert port.histogram(bins=10) == ref.histogram(bins=10)
    path = port.dump(str(tmp_path), "val")
    assert path.endswith("uncert_stats_val.json")
    port.reset()
    assert port.histogram() is None


# --------------------------------------------------------------------------
# the eval step on the narrow POCO-CLIFF twin
# --------------------------------------------------------------------------

SMPL_SEEDS = (0, 1, 2)   # neutral, male, female


@pytest.fixture(scope="module")
def twin():
    """The narrow POCO-CLIFF pair, three synthetic SMPLs (V=6890) each
    side, and a random (17, V) regressor."""
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, "cliff")
        pair["smpls"] = [synthetic_smpl_model(6890, seed=s, device="cpu") for s in SMPL_SEEDS]
        pair["jax_smpls"] = [jax_synthetic_smpl(6890, seed=s) for s in SMPL_SEEDS]
        reg = np.random.RandomState(12).rand(17, 6890).astype(np.float32) ** 4
        pair["regressor"] = reg / reg.sum(1, keepdims=True)
        pair["variables"] = jax_variables(pair["model"])
        yield pair


def _eval_batch(seed: int, n: int = 3) -> dict:
    """The eval step's batch: normalized crops, CLIFF conditioning, GT
    pose and betas, every gender."""
    rng = np.random.RandomState(seed)
    orig = np.tile(np.asarray([[480.0, 640.0]], np.float32), (n, 1))
    center = rng.uniform(150, 450, (n, 2)).astype(np.float32)
    scale = rng.uniform(0.8, 1.6, n).astype(np.float32)
    focal = np.sqrt((orig**2).sum(1)).astype(np.float32)
    return {
        "img": rng.randn(n, 224, 224, 3).astype(np.float32),
        "bbox_info": np.stack([(center[:, 0] - 320) / focal * 2.8,
                               (center[:, 1] - 240) / focal * 2.8,
                               (scale * 200 - 0.24 * focal) / (0.06 * focal)], 1).astype(np.float32),
        "focal_length": focal, "scale": scale, "center": center, "orig_shape": orig,
        "pose": rng.uniform(-0.3, 0.3, (n, 72)).astype(np.float32),
        "betas": rng.uniform(-0.5, 0.5, (n, 10)).astype(np.float32),
        "gender": np.asarray([-1, 0, 1] * n, np.int32)[:n],
    }


def _assert_metrics_close(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    tols = {"mpjpe": METERS_TOL, "pa_mpjpe": METERS_TOL, "v2v": METERS_TOL,
            "var_pose": VAR_POSE_TOL, "pose_dist": POSE_DIST_TOL}
    for key, value in port.items():
        np.testing.assert_allclose(_np(value), np.asarray(ref[key]), atol=tols[key], rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("regressor", [False, True])
@pytest.mark.parametrize("flip_test", [False, True])
def test_eval_step_matches_jax(twin, flip_test, regressor):
    """Per-sample mpjpe, pa_mpjpe and v2v within 1e-4 m, var_pose within
    2e-3, pose_dist within 1e-5; gendered GT meshes from three different
    SMPLs, with the H36M branch on a random (17, V) regressor."""
    batch = _eval_batch(13 + 2 * flip_test + regressor)
    reg = twin["regressor"] if regressor else None
    step = make_gendered_eval_step(
        twin["model"], None if reg is None else _t(reg), flip_test=flip_test
    )
    port = step({k: _t(v) for k, v in batch.items()}, *twin["smpls"])
    jstep = jax_make_eval_step(
        twin["jax_model"], None if reg is None else jnp.asarray(reg), flip_test=flip_test
    )
    ref = jstep(twin["variables"], {k: jnp.asarray(v) for k, v in batch.items()},
                *twin["jax_smpls"])
    assert port["var_pose"].shape == port["pose_dist"].shape == (3, 24)
    _assert_metrics_close(port, ref)


@pytest.mark.parametrize("flip_test,regressor,passes", [
    (False, False, 5), (True, False, 7), (False, True, 4), (True, True, 6),
])
def test_eval_step_smpl_passes(twin, monkeypatch, flip_test, regressor, passes):
    """SMPL forwards a batch (each one skinning launch on the card): the
    model's, three GT meshes, the skeleton fallback; flip-TTA adds the
    mirrored forward and the averaged pose's."""
    calls = []

    def counting(*args):
        calls.append(1)
        return skinning_reference(*args)

    monkeypatch.setattr(lbs_module, "skinning", counting)
    reg = _t(twin["regressor"]) if regressor else None
    step = make_gendered_eval_step(twin["model"], reg, flip_test=flip_test)
    step({k: _t(v) for k, v in _eval_batch(20, n=2).items()}, *twin["smpls"])
    assert len(calls) == passes


def test_eval_step_refuses_a_model_in_train_mode(twin):
    twin["model"].train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            make_gendered_eval_step(twin["model"])
    finally:
        twin["model"].eval()


def test_flip_tta_recovers_equivariant_prediction():
    """For a flip-equivariant model (`checks.EquivariantStub`, the
    port's twin of the stub in tests/test_eval.py) flip-TTA changes
    nothing and equals the ground truth: the mirrored image depicts
    flip(R), the step un-flips it to R, and average(R, R) = R (mpjpe and
    v2v 0, atol 1e-4)."""
    smpl = synthetic_smpl_model(num_verts=96, device="cpu")
    stub, batch = equivariant_case("cpu", batch=4)
    m = make_gendered_eval_step(stub, flip_test=True)(batch, smpl, smpl, smpl)
    np.testing.assert_allclose(m["mpjpe"].numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(m["v2v"].numpy(), 0.0, atol=1e-4)


@pytest.mark.parametrize("flip_test", [False, True])
def test_eval_step_profiler_ranges(flip_test):
    """A profile of the eval step holds its `EVAL_STAGES` ranges, once
    each and in order (flip-TTA's only with flip_test), each with the ops
    it ran beneath it: the ranges a profile's per-stage split reads."""
    from torch.profiler import ProfilerActivity, profile

    smpl = synthetic_smpl_model(num_verts=96, device="cpu")
    stub, batch = equivariant_case("cpu", batch=2)
    step = make_gendered_eval_step(stub, flip_test=flip_test)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, smpl, smpl, smpl)
    ranges = sorted((e.time_range.start, e.name, len(e.cpu_children))
                    for e in prof.events() if e.name in EVAL_STAGES)
    expect = [s for s in EVAL_STAGES if flip_test or s != "eval_step/flip_tta"]
    assert [name for _, name, _ in ranges] == expect
    assert all(children > 0 for _, _, children in ranges)


# --------------------------------------------------------------------------
# run_eval end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_dataset(tmp_path_factory):
    """Eight JPEGs over a 3DPW test sequence, an occluded one and another
    (as the fixture of tests/test_eval.py), every gender."""
    root = tmp_path_factory.mktemp("eval_ds")
    rng = np.random.RandomState(0)
    seqs = [PW3D_TEST_SEQUENCES[0]] * 3 + [PW3D_OCCLUDED_SEQUENCES[0]] * 3 + ["other_00"] * 2
    names = []
    for i, seq in enumerate(seqs):
        (root / seq).mkdir(exist_ok=True)
        name = f"{seq}/img_{i}.jpg"
        # images of their own brightness, contrast and pattern, so that
        # the predicted sigma varies across samples and the correlations
        # of summary() are well conditioned
        yy, xx = np.mgrid[0:96, 0:128] / 32.0
        freq = rng.uniform(0.5, 3.0, 3)
        pattern = np.sin(freq[0] * xx + freq[1] * yy)[..., None] * np.cos(freq[2] * yy)[..., None]
        img = rng.uniform(30, 220) + rng.uniform(10, 90) * pattern + 8 * rng.randn(96, 128, 3)
        cv2.imwrite(str(root / name), np.clip(img, 0, 255).astype(np.uint8))
        names.append(name)
    n = len(names)
    np.savez(
        root / "ann.npz", imgname=np.array(names),
        center=np.tile([64.0, 48.0], (n, 1)) + rng.uniform(-8, 8, (n, 2)),
        scale=np.full(n, 0.4), pose=rng.uniform(-0.2, 0.2, (n, 72)),
        shape=rng.uniform(-0.5, 0.5, (n, 10)), gender=np.array(["m", "f", "n", "m"] * 2),
        has_smpl=np.ones(n),
    )
    return str(root / "ann.npz"), str(root)


@pytest.mark.parametrize("flip_test", [False, True])
def test_run_eval_matches_jax(twin, image_dataset, monkeypatch, flip_test):
    """Names, per-sample arrays (mm: 0.1 mm; var_pose-derived sigma 2e-3;
    pose_dist 1e-5), summary() and the split report (rtol 1e-4 or atol
    1e-6) and per_joint_stats() (to their rounding) against JAX's
    `run_eval`, batches of 3 with a short last one, both over the same
    crops: the JAX package's dataset on its cv2 path. The port's dataset
    gives the port's `run_eval` exactly what the JAX package's native
    loader gives it (the same decode and warp): every per-sample array and
    summary() equal. (Over the port's crops against JAX's native ones, the
    same crops too, uncert_mpjpe_corr of this fixture, about -0.03, sits
    at its bar's noise floor: sigma's 1-2 ulps of fp32 difference move it
    by ~4e-6 against a bar of 4.2e-6.)"""
    npz, root = image_dataset
    loss_ver = twin["model"].cfg.loss_ver
    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "1")
    own = run_eval(
        twin["model"], PocoDataset(npz, img_dir=root, is_train=False), *twin["smpls"],
        batch_size=3, loss_ver=loss_ver, flip_test=flip_test,
    )
    native = run_eval(
        twin["model"], JaxPocoDataset(npz, img_dir=root, is_train=False), *twin["smpls"],
        batch_size=3, loss_ver=loss_ver, flip_test=flip_test,
    )
    assert own.imgnames == native.imgnames
    for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm", "uncert", "pose_dist"):
        np.testing.assert_array_equal(getattr(own, key), getattr(native, key), err_msg=key)
    assert own.summary() == native.summary()

    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "0")
    port = run_eval(
        twin["model"], JaxPocoDataset(npz, img_dir=root, is_train=False), *twin["smpls"],
        batch_size=3, loss_ver=loss_ver, flip_test=flip_test,
    )
    ref = jax_run_eval(
        twin["jax_model"], twin["variables"], JaxPocoDataset(npz, img_dir=root, is_train=False),
        *twin["jax_smpls"], batch_size=3, mesh=make_mesh(), loss_ver=loss_ver,
        flip_test=flip_test,
    )
    assert port.imgnames == ref.imgnames and len(port.imgnames) == 8
    for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm"):
        np.testing.assert_allclose(getattr(port, key), getattr(ref, key), atol=0.1, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(port.uncert, ref.uncert, atol=VAR_POSE_TOL, rtol=0)
    np.testing.assert_allclose(port.pose_dist, ref.pose_dist, atol=POSE_DIST_TOL, rtol=0)

    s_port, s_ref = port.summary(), ref.summary()
    assert set(s_port) == set(s_ref)
    for key in s_ref:
        np.testing.assert_allclose(s_port[key], s_ref[key], rtol=1e-4, atol=1e-6, err_msg=key)
    rep_port = pw3d_split_report(port.imgnames, port.mpjpe_mm, port.pa_mpjpe_mm, port.v2v_mm)
    rep_ref = jax_split_report(ref.imgnames, ref.mpjpe_mm, ref.pa_mpjpe_mm, ref.v2v_mm)
    assert set(rep_port) == set(rep_ref) == {"all", "test_seq", "occluded_seq"}
    for split in rep_ref:
        for key in rep_ref[split]:
            np.testing.assert_allclose(rep_port[split][key], rep_ref[split][key],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{split} {key}")
    # the port's report on JAX's own arrays is JAX's report exactly
    assert pw3d_split_report(ref.imgnames, ref.mpjpe_mm, ref.pa_mpjpe_mm, ref.v2v_mm) == rep_ref
    pj_port, pj_ref = port.per_joint_stats(), ref.per_joint_stats()
    assert pj_port["joint_names"] == pj_ref["joint_names"]
    np.testing.assert_allclose(pj_port["sigma_mean"], pj_ref["sigma_mean"], atol=VAR_POSE_TOL)
    np.testing.assert_allclose(pj_port["pose_dist_mean"], pj_ref["pose_dist_mean"], atol=2e-6)
    np.testing.assert_allclose(pj_port["sigma_cov"], pj_ref["sigma_cov"], atol=2e-3)
    np.testing.assert_allclose(pj_port["pose_dist_cov"], pj_ref["pose_dist_cov"], atol=2e-3)


def test_eval_result_reports_match_jax_on_the_same_arrays():
    """summary() and per_joint_stats() of the port's EvalResult on JAX's
    kind of arrays (float32) equal JAX's: the correlations in float32
    (rtol 1e-5), everything else exactly."""
    from poco_tpu.eval.runner import EvalResult as JaxEvalResult

    from poco_tpu_torch.eval.runner import EvalResult

    rng = np.random.RandomState(14)
    n = 40
    fields = dict(
        imgnames=[f"s/{i}.jpg" for i in range(n)],
        mpjpe_mm=rng.uniform(40, 90, n).astype(np.float32),
        pa_mpjpe_mm=rng.uniform(20, 60, n).astype(np.float32),
        v2v_mm=rng.uniform(50, 110, n).astype(np.float32),
        uncert=rng.uniform(0.1, 0.9, (n, 24)).astype(np.float32),
        pose_dist=rng.uniform(0.0, 0.1, (n, 24)).astype(np.float32),
    )
    port, ref = EvalResult(**fields), JaxEvalResult(**fields)
    s_port, s_ref = port.summary(), ref.summary()
    assert set(s_port) == set(s_ref)
    for key in s_ref:
        rtol = 1e-5 if key.endswith("_corr") else 0
        np.testing.assert_allclose(s_port[key], s_ref[key], rtol=rtol, err_msg=key)
    assert port.per_joint_stats() == ref.per_joint_stats()
    bare = dataclasses.replace(port, uncert=None, pose_dist=None)
    assert bare.per_joint_stats() is None and "uncert_mpjpe_corr" not in bare.summary()


# --------------------------------------------------------------------------
# the evaluation CLI's --cfg_id
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_id", [0, 1])
def test_cli_cfg_id_selects_the_experiment_of_jax_eval_py(tmp_path, monkeypatch, cfg_id):
    """`python -m poco_tpu_torch.cli.eval --cfg <grid yaml> --cfg_id N`
    takes experiment N of a two-experiment grid-search config: the same
    hparams that the JAX `eval.py:81-89` takes through
    `poco_tpu.config.run_grid_search_experiments(..., log=False)`, and
    nothing is written under LOG_DIR. The CLI is stopped where it builds
    the model from the hparams."""
    import time

    import yaml
    from poco_tpu.config import run_grid_search_experiments as jax_grid_search

    import poco_tpu_torch.config as port_config
    from poco_tpu_torch.cli import eval as cli_eval

    logs = tmp_path / "logs"
    cfg_file = tmp_path / "sweep.yaml"
    cfg_file.write_text(yaml.safe_dump(
        {"EXP_NAME": "sweep_test", "LOG_DIR": str(logs), "OPTIMIZER": {"LR": [1e-4, 1e-5]}}
    ))

    class Selected(Exception):
        pass

    seen = []

    def stop_at_the_model(hparams):
        seen.append(hparams)
        raise Selected

    monkeypatch.setattr(port_config, "model_config_from_hparams", stop_at_the_model)
    # both sides name the (unwritten) logdir by the time of day
    monkeypatch.setattr(time, "strftime", lambda *args: "17-10-2026_00-00-00")
    with pytest.raises(Selected):
        cli_eval.main(["--cfg", str(cfg_file), "--cfg_id", str(cfg_id), "--device", "cpu"])
    expect = jax_grid_search(str(cfg_file), cfg_id=cfg_id, log=False)
    assert len(seen) == 1
    assert seen[0].OPTIMIZER.LR == [1e-4, 1e-5][cfg_id]
    assert seen[0].to_dict() == expect.to_dict()
    assert not logs.exists()
