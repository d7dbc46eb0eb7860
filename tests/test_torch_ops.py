"""PyTorch port vs JAX package: rotation, camera and preprocessing ops.

The same seeded numpy inputs go through `poco_tpu.ops.*` and
`poco_tpu_torch.ops.*` on the CPU. Geometry is held to atol 1e-5 (fp32
rounding of O(1) values); crops to 1e-3 on the 0-255 scale (bilinear
weights computed in fp32 on both sides, in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops import camera as jcam
from poco_tpu.ops import preprocess as jpre
from poco_tpu.ops import rotation as jrot
from poco_tpu_torch.ops import camera as tcam
from poco_tpu_torch.ops import preprocess as tpre
from poco_tpu_torch.ops import rotation as trot

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
