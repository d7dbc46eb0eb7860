"""PyTorch port vs JAX package: the soft rasterizer
(`poco_tpu_torch/ops/soft_raster.py`), the part-segmentation and
silhouette losses (`losses/segmentation.py`), their terms in `poco_loss`
and the train step with both losses on.

The same seeded numpy inputs go through both packages on the CPU:
  * `soft_silhouette`, `soft_part_probs`, `render_losses` at out_res 56 on
    B=2 meshes of the synthetic SMPL (V=432, the tests' size, and the
    full V=6890): values within atol 1e-5, the part labels (argmax) equal
    on at least 99.9% of the pixels, and the gradients with respect to the
    vertices (`jax.grad` against autograd) within 1e-4 relative L2;
    chunking the rows changes nothing (atol 1e-7);
  * `part_segmentation_loss`, `neg_iou_loss` and `poco_loss` with both
    terms: rtol 1e-5;
  * the GT targets of the step (`render_targets`): silhouette within 1e-5,
    the labels equal on at least 99.9% of the pixels;
  * one train step of the narrow POCO-PARE twin (configs/poco_pare.yaml
    with TRAINING.USE_SMPL_RENDER_LOSS and USE_SMPL_SEGM_LOSS on) against
    JAX's, at the bars of `test_torch_train.check_train_step_against_jax`
    (loss terms rtol 1e-5, each gradient leaf 1e-3 relative in L2 form,
    or within 2x the port's own fp32 distance from float64 (FP32_FLOOR),
    with the ReLU branches of the port's float64 forward and the port's GT
    part labels on both sides), in tests/test_torch_train_render.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.losses.losses as jax_losses
from poco_tpu.losses import segmentation as jax_segmentation
from poco_tpu.ops import soft_raster as jax_raster
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.train.step import prepare_gt as jax_prepare_gt

import poco_tpu_torch.losses.losses as losses
from poco_tpu_torch.losses import segmentation
from poco_tpu_torch.ops import soft_raster
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.train.step import render_targets

from .test_torch_train import _train_batch

VALUE_ATOL = 1e-5      # silhouettes, probabilities, losses
GRAD_RTOL = 1e-4       # gradients w.r.t. the vertices, relative L2
LABEL_SHARE = 0.999    # share of pixels whose argmax part label agrees
LOSS_RTOL = 1e-5
CHUNK_ATOL = 1e-7      # chunked rows against one chunk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(num_verts: int, seed: int = 0):
    """Two meshes of the synthetic SMPL's size (its template, scaled,
    jittered and shifted), two crop cameras and the skinning weights."""
    rng = np.random.RandomState(seed)
    template = np.asarray(jax_synthetic_smpl(num_verts=num_verts).v_template)
    verts = np.stack([template * 0.6 + 0.02 * rng.randn(*template.shape),
                      template * 0.5 + 0.02 * rng.randn(*template.shape) + [0.1, -0.05, 0.0]])
    cams = np.asarray([[0.9, 0.0, 0.0], [1.1, 0.05, -0.1]], np.float32)
    weights = np.asarray(jax_synthetic_smpl(num_verts=num_verts).lbs_weights)
    return verts.astype(np.float32), cams, weights


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("num_verts", [432, 6890])
def test_soft_raster_values_match_jax(num_verts):
    verts, cams, weights = _meshes(num_verts)
    gt = verts[::-1].copy()
    np.testing.assert_allclose(
        soft_raster.project_weak_perspective(_t(verts), _t(cams), 56).numpy(),
        np.asarray(jax_raster.project_weak_perspective(verts, cams, 56)), atol=0)
    sil = soft_raster.soft_silhouette(_t(verts), _t(cams)).numpy()
    want = np.asarray(jax_raster.soft_silhouette(verts, cams))
    assert sil.shape == (2, 56, 56) and want.max() > 0.9
    np.testing.assert_allclose(sil, want, atol=VALUE_ATOL)
    probs = soft_raster.soft_part_probs(_t(verts), _t(cams), _t(weights)).numpy()
    want = np.asarray(jax_raster.soft_part_probs(verts, cams, weights))
    assert probs.shape == (2, 56, 56, 25)
    np.testing.assert_allclose(probs, want, atol=VALUE_ATOL)
    assert (probs.argmax(-1) == want.argmax(-1)).mean() >= LABEL_SHARE
    np.testing.assert_allclose(
        float(soft_raster.render_losses(_t(verts), _t(gt), _t(cams))),
        float(jax_raster.render_losses(verts, gt, cams)), atol=VALUE_ATOL)


@pytest.mark.parametrize("fn", ["silhouette", "part_probs", "render_losses"])
def test_soft_raster_vertex_gradients_match_jax(fn):
    verts, cams, weights = _meshes(432, seed=1)
    gt = verts[::-1].copy()
    w = np.random.RandomState(2).rand(2, 56, 56, 25).astype(np.float32)

    def scalar(raster, v, to):
        if fn == "silhouette":
            return (raster.soft_silhouette(v, to(cams)) * to(w[..., 0])).sum()
        if fn == "part_probs":
            return (raster.soft_part_probs(v, to(cams), to(weights)) * to(w)).sum()
        return raster.render_losses(v, to(gt), to(cams))

    want = np.asarray(jax.grad(lambda v: scalar(jax_raster, v, jnp.asarray))(jnp.asarray(verts)))
    v = _t(verts).requires_grad_()
    scalar(soft_raster, v, _t).backward()
    got = v.grad.numpy()
    assert np.abs(want).max() > 0
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)


def test_chunked_rows_equal_one_chunk(monkeypatch):
    """Rows in chunks (checkpointed where a gradient is wanted) give what
    one chunk gives, values and gradients."""
    verts, cams, weights = _meshes(432, seed=3)
    verts = np.concatenate([verts, verts[:1] * 0.9])

    def run():
        v = _t(verts).requires_grad_()
        sil = soft_raster.soft_silhouette(v, _t(cams[[0, 1, 0]]))
        probs = soft_raster.soft_part_probs(v, _t(cams[[0, 1, 0]]), _t(weights))
        (sil.sum() + probs[..., 3].sum()).backward()
        return sil.detach().numpy(), probs.detach().numpy(), v.grad.numpy()

    whole = run()
    monkeypatch.setattr(soft_raster, "ROW_ELEMENTS", 56 * 56 * 432)   # one row a chunk
    for got, want in zip(run(), whole):
        np.testing.assert_allclose(got, want, atol=CHUNK_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_part_segmentation_loss_matches_jax(masked):
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(3, 25, 56, 56)).astype(np.float32)
    labels = rng.randint(0, 25, (3, 56, 56)).astype(np.int64)
    valid = np.asarray([1.0, 0.0, 1.0], np.float32) if masked else None
    got = segmentation.part_segmentation_loss(
        _t(logits), _t(labels), None if valid is None else _t(valid))
    want = jax_segmentation.part_segmentation_loss(
        logits, labels, None if valid is None else jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    a, b = rng.rand(2, 3, 56, 56).astype(np.float32)
    np.testing.assert_allclose(float(segmentation.neg_iou_loss(_t(a), _t(b))),
                               float(jax_segmentation.neg_iou_loss(a, b)), rtol=LOSS_RTOL)


def test_poco_loss_with_render_and_segm_terms_matches_jax():
    """Both optional terms in `poco_loss`, each by value, and the total."""
    from .test_torch_train import _loss_inputs

    pred, gt = _loss_inputs(5)
    rng = np.random.RandomState(6)
    b = len(pred["pred_cam"])
    pred["pred_segm_mask"] = (2 * rng.randn(b, 25, 56, 56)).astype(np.float32)
    pred["pred_smpl_render"] = rng.rand(b, 56, 56).astype(np.float32)
    gt["gt_segm_mask"] = rng.randint(0, 25, (b, 56, 56)).astype(np.int64)
    gt["gt_smpl_render"] = rng.rand(b, 56, 56).astype(np.float32)
    kw = dict(use_smpl_segm_loss=True, use_smpl_render_loss=True,
              smpl_segm_loss_weight=0.7, smpl_render_loss_weight=1.3)
    _, got = losses.poco_loss(
        {k: _t(v) for k, v in pred.items()}, {k: _t(v) for k, v in gt.items()},
        losses.LossConfig(**kw))
    _, want = jax_losses.poco_loss(
        {k: jnp.asarray(v) for k, v in pred.items()}, {k: jnp.asarray(v) for k, v in gt.items()},
        jax_losses.LossConfig(**kw))
    assert {"loss/loss_smpl_segm", "loss/loss_smpl_render"} <= set(got)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL,
                                   err_msg=key)


def test_render_targets_match_jax_step_targets():
    """The GT silhouette and part labels of the step (JAX step.py:99-121),
    rendered from the JAX package's GT mesh on both sides (the meshes
    themselves are held in `test_torch_train.py`)."""
    batch = _train_batch(8)
    smpl, jax_smpl = synthetic_smpl_model(num_verts=6890, device="cpu"), jax_synthetic_smpl(6890)
    cfg = losses.LossConfig(use_smpl_render_loss=True, use_smpl_segm_loss=True)
    jgt = jax_prepare_gt({k: jnp.asarray(v) for k, v in batch.items()}, jax_smpl)
    got = render_targets({k: _t(v) for k, v in batch.items()},
                         {"vertices": _t(np.array(jgt["vertices"]))}, smpl, cfg)
    cam = jnp.tile(jnp.asarray([[0.9, 0.0, 0.0]]), (2, 1))
    np.testing.assert_allclose(got["gt_smpl_render"].numpy(),
                               np.asarray(jax_raster.soft_silhouette(jgt["vertices"], cam)),
                               atol=VALUE_ATOL)
    labels = np.asarray(jnp.argmax(
        jax_raster.soft_part_probs(jgt["vertices"], cam, jax_smpl.lbs_weights), axis=-1))
    assert (got["gt_segm_mask"].numpy() == labels).mean() >= LABEL_SHARE
    np.testing.assert_array_equal(got["gt_cam_render"].numpy(), np.asarray(cam))
    assert render_targets({}, {}, smpl, losses.LossConfig()) == {}
