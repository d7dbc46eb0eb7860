"""PyTorch port vs JAX package: rotation, camera and preprocessing ops.

The same seeded numpy inputs go through `poco_tpu.ops.*` and
`poco_tpu_torch.ops.*` on the CPU. Geometry is held to atol 1e-5 (fp32
rounding of O(1) values); crops to 1e-3 on the 0-255 scale (bilinear
weights computed in fp32 on both sides, in the same order).

`TestNonFiniteIndices` feeds NaN and infinite values to every place where
the port computes a device index from data: the index must stay in range
(on the card an index out of range is a device-side assert, which leaves
the process's CUDA context unusable), and the output must be NaN where
the JAX package's is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.losses import segmentation as jseg
from poco_tpu.models import layers as jlayers
from poco_tpu.ops import camera as jcam
from poco_tpu.ops import preprocess as jpre
from poco_tpu.ops import rotation as jrot
from poco_tpu.ops import soft_raster as jraster
from poco_tpu_torch.losses import segmentation as tseg
from poco_tpu_torch.models import layers as tlayers
from poco_tpu_torch.ops import camera as tcam
from poco_tpu_torch.ops import preprocess as tpre
from poco_tpu_torch.ops import rotation as trot
from poco_tpu_torch.ops import soft_raster as traster

ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0
    )


class TestRotation:
    @pytest.mark.parametrize("scale", [1e-8, 0.3, 2.5])
    def test_axis_angle_to_rotmat(self, scale):
        aa = (scale * np.random.RandomState(0).randn(5, 24, 3)).astype(np.float32)
        _close(trot.axis_angle_to_rotmat(torch.from_numpy(aa)),
               jrot.axis_angle_to_rotmat(jnp.asarray(aa)))

    def test_quat_to_rotmat_unnormalized(self):
        q = (3.0 * np.random.RandomState(1).randn(7, 4)).astype(np.float32)
        _close(trot.quat_to_rotmat(torch.from_numpy(q)),
               jrot.quat_to_rotmat(jnp.asarray(q)))

    def test_rot6d_to_rotmat(self):
        x = np.random.RandomState(2).randn(4, 144).astype(np.float32)
        out = trot.rot6d_to_rotmat(torch.from_numpy(x))
        assert out.shape == (96, 3, 3)
        _close(out, jrot.rot6d_to_rotmat(jnp.asarray(x)))

    def test_rot6d_degenerate_uses_eps_clamp(self):
        x = np.zeros((2, 6), np.float32)
        out = trot.rot6d_to_rotmat(torch.from_numpy(x))
        assert torch.isfinite(out).all()
        _close(out, jrot.rot6d_to_rotmat(jnp.asarray(x)))


class TestCamera:
    def test_weak_perspective_to_perspective(self):
        cam = np.random.RandomState(3).uniform(0.5, 1.5, (6, 3)).astype(np.float32)
        _close(tcam.weak_perspective_to_perspective(torch.from_numpy(cam)),
               jcam.weak_perspective_to_perspective(jnp.asarray(cam)), atol=1e-3)

    @pytest.mark.parametrize("scalar_focal", [True, False])
    def test_perspective_projection(self, scalar_focal):
        rng = np.random.RandomState(4)
        pts = rng.randn(3, 49, 3).astype(np.float32)
        trans = (rng.randn(3, 3) + [0, 0, 10]).astype(np.float32)
        center = rng.uniform(100, 500, (3, 2)).astype(np.float32)
        rot = np.array(jrot.axis_angle_to_rotmat(jnp.asarray(
            0.3 * rng.randn(3, 3).astype(np.float32))))
        focal = 1000.0 if scalar_focal else rng.uniform(800, 1200, 3).astype(np.float32)
        port = tcam.perspective_projection(
            torch.from_numpy(pts), torch.from_numpy(trans),
            focal if scalar_focal else torch.from_numpy(focal),
            torch.from_numpy(center), torch.from_numpy(rot),
        )
        ref = jcam.perspective_projection(
            jnp.asarray(pts), jnp.asarray(trans), focal if scalar_focal
            else jnp.asarray(focal), jnp.asarray(center), jnp.asarray(rot),
        )
        _close(port, ref, atol=1e-3)  # pixels: ~1e3 magnitudes in fp32

    def test_crop_cam_to_full_img_cam(self):
        rng = np.random.RandomState(5)
        b = 6
        args = [
            rng.uniform(0.5, 1.5, (b, 3)).astype(np.float32),
            rng.uniform(100, 600, b).astype(np.float32),
            rng.uniform(100, 900, (b, 2)).astype(np.float32),
            np.full(b, 1280.0, np.float32),
            np.full(b, 720.0, np.float32),
            np.full(b, 1468.6, np.float32),
        ]
        _close(tcam.crop_cam_to_full_img_cam(*map(torch.from_numpy, args)),
               jcam.crop_cam_to_full_img_cam(*map(jnp.asarray, args)), atol=1e-4)


class TestPreprocess:
    def _boxes(self, n, h, w, seed):
        rng = np.random.RandomState(seed)
        centers = np.stack([rng.uniform(-20, w + 20, n), rng.uniform(-20, h + 20, n)],
                           axis=1).astype(np.float32)
        scales = rng.uniform(0.2, 1.5, n).astype(np.float32)
        return centers, scales

    def test_crop_transform_params_rotated(self):
        centers, scales = self._boxes(5, 100, 120, 6)
        rot = np.random.RandomState(7).uniform(-30, 30, 5).astype(np.float32)
        a_t, t_t = tpre.crop_transform_params(
            torch.from_numpy(centers), torch.from_numpy(scales * 200),
            torch.from_numpy(rot))
        a_j, t_j = jpre.crop_transform_params(
            jnp.asarray(centers), jnp.asarray(scales * 200), jnp.asarray(rot))
        _close(a_t, a_j)
        _close(t_t, t_j, atol=1e-3)

    def test_bilinear_sample_zero_outside(self):
        img = np.random.RandomState(8).rand(9, 11, 3).astype(np.float32)
        rng = np.random.RandomState(9)
        xs = rng.uniform(-3, 14, (40,)).astype(np.float32)
        ys = rng.uniform(-3, 12, (40,)).astype(np.float32)
        _close(tpre.bilinear_sample_image(torch.from_numpy(img), torch.from_numpy(xs),
                                          torch.from_numpy(ys)),
               jpre.bilinear_sample_image(jnp.asarray(img), jnp.asarray(xs),
                                          jnp.asarray(ys)))

    def test_crop_and_resize_uint8(self):
        img = np.random.RandomState(10).randint(0, 256, (90, 130, 3)).astype(np.uint8)
        centers, scales = self._boxes(4, 90, 130, 11)
        port = tpre.crop_and_resize(torch.from_numpy(img), torch.from_numpy(centers),
                                    torch.from_numpy(scales * 200), out_res=32)
        ref = jpre.crop_and_resize(jnp.asarray(img), jnp.asarray(centers),
                                   jnp.asarray(scales * 200), out_res=32)
        assert port.shape == (4, 32, 32, 3)
        _close(port, ref, atol=1e-3)

    @pytest.mark.parametrize("padded", [False, True])
    def test_preprocess_crops(self, padded):
        img = np.random.RandomState(12).randint(0, 256, (70, 96, 3)).astype(np.uint8)
        centers, scales = self._boxes(3, 70, 96, 13)
        true_hw = np.asarray([60.0, 90.0], np.float32) if padded else None
        port = tpre.preprocess_crops(
            torch.from_numpy(img), torch.from_numpy(centers), torch.from_numpy(scales),
            out_res=40, true_hw=None if true_hw is None else torch.from_numpy(true_hw))
        ref = jpre.preprocess_crops(
            jnp.asarray(img), jnp.asarray(centers), jnp.asarray(scales),
            out_res=40, true_hw=None if true_hw is None else jnp.asarray(true_hw))
        assert set(port) == set(ref)
        # normalized crops: 1e-3 on the 0-255 scale, divided by 255 * min(std)
        _close(port["img"], ref["img"], atol=1e-3 / (255 * 0.224))
        for key in ("bbox_info", "scale", "center", "orig_shape"):
            _close(port[key], ref[key])
        _close(port["focal_length"], ref["focal_length"], atol=1e-3)


def _same_nans(port, ref):
    np.testing.assert_array_equal(np.isnan(port.detach().numpy()), np.isnan(np.asarray(ref)))


class TestNonFiniteIndices:
    # (centre, box edge) of a crop beside a finite one
    BAD_BOXES = {
        "nan_center": ((np.nan, np.nan), 80.0),
        "nan_size": ((50.0, 40.0), np.nan),
        "inf_size": ((50.0, 40.0), np.inf),
        "center_1e30": ((1e30, 40.0), 80.0),
    }

    @pytest.mark.parametrize("bad", sorted(BAD_BOXES))
    def test_crop_and_resize(self, bad):
        """`ops/preprocess.py`'s tap: a NaN coordinate used to cast to
        -2^63 and index out of range. The non-finite box's crop is NaN
        where JAX's is (all of it; the far box's crop is zeros), the
        finite crop as in `test_crop_and_resize_uint8`."""
        img = np.random.RandomState(10).randint(0, 256, (90, 130, 3)).astype(np.uint8)
        center, size = self.BAD_BOXES[bad]
        centers = np.asarray([[60.0, 45.0], center], np.float32)
        sizes = np.asarray([80.0, size], np.float32)
        port = tpre.crop_and_resize(torch.from_numpy(img), torch.from_numpy(centers),
                                    torch.from_numpy(sizes), out_res=32)
        ref = jpre.crop_and_resize(jnp.asarray(img), jnp.asarray(centers),
                                   jnp.asarray(sizes), out_res=32)
        _same_nans(port, ref)
        assert np.isnan(np.asarray(ref[1])).all() == (bad != "center_1e30")
        _close(port, ref, atol=1e-3)

    def test_preprocess_crops(self):
        """The request's batch with a NaN centre and an infinite scale
        among finite boxes: every key NaN (and infinite) where JAX's is."""
        img = np.random.RandomState(12).randint(0, 256, (70, 96, 3)).astype(np.uint8)
        centers = np.asarray([[40, 30], [np.nan, np.nan], [50, 20], [60, 40]], np.float32)
        scales = np.asarray([0.3, 0.4, np.inf, 0.5], np.float32)
        port = tpre.preprocess_crops(torch.from_numpy(img), torch.from_numpy(centers),
                                     torch.from_numpy(scales), out_res=40)
        ref = jpre.preprocess_crops(jnp.asarray(img), jnp.asarray(centers),
                                    jnp.asarray(scales), out_res=40)
        for key in ref:
            _same_nans(port[key], ref[key])
        _close(port["img"], ref["img"], atol=1e-3 / (255 * 0.224))
        for key in ("bbox_info", "scale", "center", "orig_shape"):
            _close(port[key], ref[key])

    def test_rotmat_to_quat(self):
        """`ops/rotation.py:113-115`: `argmax` over the 4 candidates picks
        an index in [0, 4) whatever the traces hold (a NaN's own), so
        `take_along_dim` stays in range; NaN where JAX's is."""
        rot = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
        rot[1], rot[2, 0, 1], rot[3, 1, 1], rot[4, 2, 2] = np.nan, np.nan, np.inf, -np.inf
        port = trot.rotmat_to_quat(torch.from_numpy(rot))
        ref = jrot.rotmat_to_quat(jnp.asarray(rot))
        _same_nans(port, ref)
        _close(port, ref)

    def test_get_heatmap_preds(self):
        """`models/layers.py:152`: the argmax only becomes coordinates
        (`idx % w`, `idx // w`), never an index; with NaN and infinite
        heatmaps the keypoints and confidences are JAX's."""
        hm = np.random.RandomState(0).randn(2, 3, 5, 6).astype(np.float32)
        hm[0, 1], hm[1, 2, 2, 3], hm[1, 0, 1, 1] = np.nan, np.nan, np.inf
        kp, conf = tlayers.get_heatmap_preds(torch.from_numpy(hm))
        jkp, jconf = jlayers.get_heatmap_preds(jnp.asarray(hm))
        _same_nans(conf, jconf)
        _close(kp, jkp)
        _close(conf, jconf)

    # finite points far and just outside the 5 x 6 map of the test below,
    # on each axis and both sides: x at +-(1 + 2/(6-1)) is one tap past the
    # edge, y at +-(1 + 2/(5-1)); 1.05 still takes part of the edge tap
    FAR_POINTS = [(s * v, 0.3) for s in (1, -1) for v in (1e30, 1e6, 1.4, 1.05)] + \
        [(-0.2, s * v) for s in (1, -1) for v in (1e30, 1e6, 1.5, 1.05)]

    def test_grid_sample_bilinear(self):
        """`models/layers.py:grid_sample_bilinear` (PARE's keypoint
        features): `F.grid_sample` bounds-checks every tap, so a NaN,
        infinite or far coordinate reads nothing out of range; NaN where
        JAX's is, zero where the point lies outside. The finite points
        past the edge (`FAR_POINTS`, clamped before the call) equal JAX's:
        zeros, and the edge tap's share at 1.05."""
        feats = np.random.RandomState(1).randn(2, 4, 5, 6).astype(np.float32)
        uv = np.random.RandomState(2).uniform(-1, 1, (2, 5 + len(self.FAR_POINTS), 2))
        uv = uv.astype(np.float32)
        uv[0, 1], uv[0, 2, 0], uv[1, 3], uv[1, 4, 1] = np.nan, np.inf, 1e30, -np.inf
        uv[:, 5:] = self.FAR_POINTS
        port = tlayers.grid_sample_bilinear(torch.from_numpy(feats), torch.from_numpy(uv))
        ref = jlayers.grid_sample_bilinear(jnp.asarray(feats), jnp.asarray(uv))
        _same_nans(port, ref)
        _close(port, ref)
        far = [i for i, (x, y) in enumerate(self.FAR_POINTS) if max(abs(x), abs(y)) > 1.1]
        assert np.abs(np.asarray(ref)[:, :, [5 + i for i in far]]).max() < 1e-6
        assert np.abs(np.asarray(ref)[:, :, 5:]).max() > 0.01

    def test_part_labels_and_segmentation_loss(self):
        """`losses/segmentation.py:31` gathers at the GT part labels, which
        `train/step.py:93` takes as the argmax of `soft_part_probs` over its
        25 channels: in [0, 25) even for a mesh of NaN vertices, so the
        gather stays in range; the labels and the loss are JAX's."""
        rng = np.random.RandomState(3)
        verts = (0.3 * rng.randn(3, 40, 3)).astype(np.float32)
        verts[1] = np.nan
        verts[2, 5] = np.inf
        cam = np.tile(np.asarray([[0.9, 0.0, 0.0]], np.float32), (3, 1))
        parts = np.eye(24, dtype=np.float32)[rng.randint(0, 24, 40)]
        labels = traster.soft_part_probs(torch.from_numpy(verts), torch.from_numpy(cam),
                                         torch.from_numpy(parts), out_res=16).argmax(-1)
        jlabels = jnp.argmax(jraster.soft_part_probs(jnp.asarray(verts), jnp.asarray(cam),
                                                     jnp.asarray(parts), out_res=16), axis=-1)
        assert 0 <= int(labels.min()) and int(labels.max()) < 25
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
        logits = (3 * rng.randn(3, 25, 16, 16)).astype(np.float32)
        logits[1, :, 2, 3] = np.nan
        for valid in (None, np.asarray([1.0, 0.0, 1.0], np.float32)):
            port = tseg.part_segmentation_loss(torch.from_numpy(logits), labels,
                                               None if valid is None else torch.from_numpy(valid))
            ref = jseg.part_segmentation_loss(jnp.asarray(logits), jlabels,
                                              None if valid is None else jnp.asarray(valid))
            _same_nans(port, ref)
            _close(port, ref, atol=1e-4)
