"""PyTorch port vs JAX package: GT part labels
(`poco_tpu_torch/viz/part_labels.py`) and the training image grids
(`viz/train_viz.py`).

  * `runtime/raster.label_triangles` on one face against `cv2.fillPoly`
    (LINE_8, shift 0) on seeded integer triangles, inside the map and
    across its border (clipped edges), on maps of 56, 64 and 17 px: pixel
    for pixel;
  * `render_part_labels` / `generate_part_labels` against the JAX
    functions (cv2.fillPoly) on posed meshes of the synthetic SMPL at
    V=432 and V=6890, inside the map and across its border: pixel for
    pixel;
  * `render_training_grid` against the JAX function on the same meshes,
    crops and cameras, at the renderer's bar of tests/test_torch_demo.py
    (at most 0.1% of the pixels more than 2 grey levels off).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.viz import part_labels as jax_part_labels
from poco_tpu.viz import train_viz as jax_train_viz

from poco_tpu_torch.runtime import raster
from poco_tpu_torch.viz import part_labels, train_viz

RENDER_LEVELS, RENDER_SHARE = 2, 1e-3   # tests/test_torch_demo.py's renderer bar


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size,span", [(56, 0), (56, 40), (64, 150), (17, 10)])
def test_fill_triangle_matches_cv2_fillpoly(size, span):
    """span 0: triangles inside the map; otherwise corners up to `span` px
    around points up to span / 2 px outside it."""
    rng = np.random.RandomState(size + span)
    for _ in range(600):
        if span == 0:
            pts = rng.randint(0, size, (3, 2)).astype(np.int32)
        else:
            pts = np.round(rng.uniform(-span / 2, size + span / 2, 2)
                           + rng.uniform(-span, span, (3, 2))).astype(np.int32)
        want = np.zeros((size, size), np.uint8)
        cv2.fillPoly(want, [pts], 9)
        got = raster.label_triangles(np.zeros((size, size), np.uint8), pts[None], np.array([9]))
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def _posed_meshes(num_verts: int, n: int = 3, seed: int = 0):
    """Meshes of the synthetic SMPL's template, scaled, turned and shifted,
    with crop cameras that keep them inside the map."""
    rng = np.random.RandomState(seed)
    smpl = jax_synthetic_smpl(num_verts=num_verts)
    template = np.asarray(smpl.v_template)
    verts = []
    for _ in range(n):
        a = rng.uniform(-0.6, 0.6)
        rot = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        verts.append(0.5 * template @ rot.T + rng.uniform(-0.1, 0.1, 3))
    cams = np.stack([rng.uniform(0.7, 1.0, n), rng.uniform(-0.1, 0.1, n),
                     rng.uniform(-0.1, 0.1, n)], 1)
    return (np.asarray(verts, np.float32), cams.astype(np.float32),
            np.asarray(smpl.faces), np.asarray(smpl.lbs_weights))


@pytest.mark.parametrize("num_verts", [432, 6890])
def test_part_labels_match_jax(num_verts):
    verts, cams, faces, weights = _posed_meshes(num_verts)
    got = part_labels.generate_part_labels(verts, faces, cams, weights)
    want = jax_part_labels.generate_part_labels(verts, faces, cams, weights)
    assert got.shape == want.shape == (3, 56, 56) and got.dtype == np.uint8
    assert (want > 0).mean() > 0.05 and len(np.unique(want)) > 5
    np.testing.assert_array_equal(got, want)
    four = np.concatenate([cams[0, :1], cams[0]])   # the (4,) [sx, sy, tx, ty] form
    np.testing.assert_array_equal(
        part_labels.render_part_labels(verts[0], faces, four, weights, out_res=64),
        jax_part_labels.render_part_labels(verts[0], faces, four, weights, out_res=64))
    for cam in ([1.6, 0.3, 0.1], [1.0, 0.6, 0.1], [2.0, -0.2, 0.1]):   # across the border
        want = jax_part_labels.render_part_labels(verts[0], faces, cam, weights)
        assert (want[[0, -1]] > 0).any() or (want[:, [0, -1]] > 0).any()
        np.testing.assert_array_equal(
            part_labels.render_part_labels(verts[0], faces, cam, weights), want)


def test_training_grid_matches_jax(tmp_path):
    verts, cams, faces, weights = _posed_meshes(432, n=4, seed=1)
    rng = np.random.RandomState(2)
    images = rng.randn(4, 224, 224, 3).astype(np.float32)
    gt = verts[::-1].copy()
    var = rng.uniform(0.05, 0.9, (4, 24)).astype(np.float32)
    for kwargs in ({"gt_verts": gt}, {"gt_verts": gt, "gt_cam": cams[::-1].copy(),
                                      "var_pose": var, "lbs_weights": weights,
                                      "sideview": True, "max_rows": 3}):
        got = train_viz.render_training_grid(images, verts, cams, faces, **kwargs)
        want = jax_train_viz.render_training_grid(
            images, verts, cams, faces, **{k: (jnp.asarray(v) if k == "gt_verts" else v)
                                            for k, v in kwargs.items()})
        assert got.shape == want.shape and got.dtype == np.uint8
        assert (np.abs(got.astype(int) - want).max(axis=2) > RENDER_LEVELS).mean() <= RENDER_SHARE
    np.testing.assert_array_equal(train_viz.denormalize_images(images),
                                  jax_train_viz.denormalize_images(images))
    path = train_viz.save_training_grid(got, str(tmp_path), "train_e0_s0")
    assert path == str(tmp_path / "images" / "train_e0_s0.png")
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], got)
