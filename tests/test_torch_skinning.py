"""The port's skinning: plain version vs the TPU kernel, wrapper contract.

`skinning_reference` (the plain torch version that the CUDA kernel is
held to on the card) is compared with the Pallas kernel in interpret
mode and with the JAX einsum path, at atol 1e-4 (fp32 sums of 24 terms
in another order), including a V that is no multiple of the TPU tile.

The CUDA kernel (`csrc/skinning.cu`) runs only on the card
(tests/test_torch_gpu.py), but its arithmetic is emulated here in numpy:
the 3xTF32 blend (W and the transforms split into a TF32 part and a TF32
residual, three products summed in fp32) and the register epilogue
((T0 x + T1 y) + (T2 z + T3) per output row), held to the same
references at the same atol; and one TF32 product is shown to miss it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops.pallas_lbs import skinning_pallas
from poco_tpu.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.skinning import skinning, skinning_reference, skinning_simt

ATOL = 1e-4


def _inputs(batch, num_verts, seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(num_verts, 24).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = (0.4 * rng.randn(batch * 24, 3)).astype(np.float32)
    tfms[:, :, :3, :3] = np.asarray(axis_angle_to_rotmat(jnp.asarray(aa))).reshape(
        batch, 24, 3, 3
    )
    tfms[:, :, :3, 3] = 0.1 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return w, tfms, vp


def _jax_einsum_skinning(w, tfms, vp):
    """The XLA path of poco_tpu.smpl.lbs.lbs (lbs.py:177-186)."""
    b, v = vp.shape[:2]
    vt = jnp.einsum("vj,bjk->bvk", w, tfms.reshape(b, 24, 16)).reshape(b, v, 4, 4)
    return jnp.einsum("bvxy,bvy->bvx", vt[:, :, :3, :3], vp) + vt[:, :, :3, 3]


@pytest.mark.parametrize("batch,num_verts", [(2, 100), (3, 77), (1, 1)])
def test_reference_matches_pallas_interpret(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=num_verts)
    port = skinning_reference(*map(torch.from_numpy, (w, tfms, vp)))
    ref = skinning_pallas(
        jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp),
        vertex_tile=32, interpret=True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (4, 1001)])
def test_reference_matches_jax_einsum(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=batch)
    port = skinning_reference(*map(torch.from_numpy, (w, tfms, vp)))
    ref = _jax_einsum_skinning(jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(2, 50, seed=1)]
    before = skinning.launches
    out = skinning(*args)
    assert skinning.launches == before
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=0)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error; here
    a meta tensor (not CUDA) must raise, not run the plain version."""
    w, tfms, vp = (torch.from_numpy(a) for a in _inputs(2, 50, seed=2))
    with pytest.raises(ValueError, match="one CUDA device"):
        skinning(w, tfms, vp.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_library_path_follows_source(monkeypatch, tmp_path):
    path = kernels.library_path("skinning")
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("libskinning-")
    src = tmp_path / "skinning.cu"
    src.write_text((kernels.CSRC_DIR / "skinning.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    assert kernels.library_path("skinning") != path


def test_wrapper_on_cpu_keeps_autograd():
    w, tfms, vp = (torch.from_numpy(a) for a in _inputs(2, 50, seed=4))
    vp.requires_grad_(True)
    skinning(w, tfms, vp).square().sum().backward()
    expect = torch.autograd.grad(
        skinning_reference(w, tfms, vp).square().sum(), vp
    )[0]
    torch.testing.assert_close(vp.grad, expect, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", [skinning, skinning_simt])
def test_wrapper_refuses_a_gradient_off_the_cpu(kernel):
    """The CUDA kernels have no backward: off the CPU, inputs that need a
    gradient raise (a meta tensor stands in for a CUDA one here) instead of
    giving an output that autograd cannot follow."""
    w, tfms, vp = (torch.from_numpy(a) for a in _inputs(2, 50, seed=5))
    vp = vp.to("meta").requires_grad_(True)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="no backward"):
        kernel(w, tfms, vp)
    assert kernel.launches == before


def test_simt_wrapper_on_cpu_takes_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(2, 50, seed=6)]
    before = skinning_simt.launches
    out = skinning_simt(*args)
    assert skinning_simt.launches == before
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=0)


# --------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated
# --------------------------------------------------------------------------

_TF32_MASK = np.uint32(0xFFFFE000)


def _tf32_round(x):
    """cvt.rna.tf32.f32 on finite float32: nearest of 10 mantissa bits,
    ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & _TF32_MASK).view(np.float32)


def _tf32_truncate(x):
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & _TF32_MASK).view(np.float32)


def _kernel_emulation(w, tfms, vp, products=3):
    """The kernel's blend and epilogue in float32. W is split with
    cvt.rna twice (big, then the residual); the transforms' rows 0-2 into
    a rounded big part and a truncated residual. `products=1` keeps only
    big x big, the one-TF32-product blend the kernel does not use."""
    batch, num_verts = vp.shape[:2]
    a = np.ascontiguousarray(tfms[:, :, :3, :]).reshape(batch, 24, 12)
    w_big, a_big = _tf32_round(w), _tf32_round(a)
    t = np.einsum("vj,bjk->bvk", w_big, a_big)
    if products == 3:
        w_small = _tf32_round(w - w_big)
        a_small = _tf32_truncate(a - a_big)
        t = (
            np.einsum("vj,bjk->bvk", w_small, a_big)
            + np.einsum("vj,bjk->bvk", w_big, a_small)
            + t
        )
    t = t.astype(np.float32).reshape(batch, num_verts, 3, 4)
    x, y, z = (vp[..., i][..., None] for i in range(3))
    return (t[..., 0] * x + t[..., 1] * y) + (t[..., 2] * z + t[..., 3])


def _float64_skinning(w, tfms, vp):
    b, v = vp.shape[:2]
    t = np.einsum(
        "vj,bjk->bvk", w.astype(np.float64), tfms.reshape(b, 24, 16).astype(np.float64)
    ).reshape(b, v, 4, 4)
    return np.einsum("bvxy,bvy->bvx", t[:, :, :3, :3], vp.astype(np.float64)) + t[:, :, :3, 3]


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (2, 1001)])
def test_kernel_arithmetic_matches_pallas_interpret(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=num_verts + 7)
    ref = skinning_pallas(
        jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp), interpret=True
    )
    np.testing.assert_allclose(
        _kernel_emulation(w, tfms, vp), np.asarray(ref), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (2, 1001)])
def test_kernel_arithmetic_matches_jax_einsum(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=num_verts + 8)
    ref = _jax_einsum_skinning(jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp))
    np.testing.assert_allclose(
        _kernel_emulation(w, tfms, vp), np.asarray(ref), atol=ATOL, rtol=0
    )


def test_one_tf32_product_misses_the_gate():
    """Why the kernel splits: at B=2, V=6890 one TF32 product lands
    several times ATOL from the float64 result, the split blend about 100
    times inside it."""
    w, tfms, vp = _inputs(2, 6890, seed=9)
    exact = _float64_skinning(w, tfms, vp)
    one = np.abs(_kernel_emulation(w, tfms, vp, products=1) - exact).max()
    three = np.abs(_kernel_emulation(w, tfms, vp) - exact).max()
    assert one > ATOL
    assert three < ATOL / 50


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = np.asarray([1.0 + 0.49 * ulp, 1.0 + 0.5 * ulp, -(1.0 + 0.5 * ulp), 1.0 + 0.51 * ulp],
                   dtype=np.float32)
    np.testing.assert_array_equal(
        _tf32_round(x), np.asarray([1.0, 1.0 + ulp, -(1.0 + ulp), 1.0 + ulp], np.float32)
    )
