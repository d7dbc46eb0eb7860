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

The backward's plain version (`skinning_backward_reference`, which the
backward kernels are held to on the card) is compared with torch autograd
and with jax.vjp of the JAX einsum path, and the SMPL forward's
gradients with respect to betas and rotations with jax.grad, at atol
1e-5. The backward kernel's arithmetic (`csrc/skinning_backward.cu`:
both products as 3xTF32, per-warp and per-tile partial sums, the
fixed-order cross-tile sum) is emulated in numpy and held to jax.vjp
within the card's bar, 1e-5 x max |ref| + 1e-7; one TF32 product is
shown to miss that bar on both gradients.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops.pallas_lbs import skinning_pallas
from poco_tpu.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.skinning import (
    _SkinningFunction,
    skinning,
    skinning_backward,
    skinning_backward_reference,
    skinning_backward_simt,
    skinning_reference,
    skinning_simt,
)

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
    """Off the CPU (a meta tensor stands in for a CUDA one here), an input
    that needs a gradient the kernels cannot give raises instead of
    giving an output that autograd cannot follow: for `skinning_simt`,
    which has no backward, any input; for `skinning`, the skinning
    weights (its backward gives the transforms and v_posed only)."""
    w, tfms, vp = (torch.from_numpy(a) for a in _inputs(2, 50, seed=5))
    w, tfms, vp = w.to("meta"), tfms.to("meta"), vp.to("meta")
    if kernel is skinning:
        w.requires_grad_(True)
    else:
        vp.requires_grad_(True)
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


# --------------------------------------------------------------------------
# the backward: plain version against autograd and jax.vjp; lbs gradients
# --------------------------------------------------------------------------

GRAD_ATOL = 1e-5


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (3, 1001)])
def test_backward_reference_matches_autograd_and_jax_vjp(batch, num_verts):
    """`skinning_backward_reference` (the plain version the backward kernel
    is held to on the card) against torch autograd through
    `skinning_reference` and against jax.vjp of the JAX einsum path, at
    atol 1e-5: fp32 sums over V in another order. The output gradient is
    0.1 x N(0, 1) a coordinate, so the transforms' gradient, a sum over
    the V vertices, is O(1) (its largest entry about 1.5 at V=6890)."""
    w, tfms, vp = _inputs(batch, num_verts, seed=num_verts + 21)
    g = 0.1 * np.random.RandomState(num_verts).randn(batch, num_verts, 3).astype(np.float32)
    grad_vp, grad_tfms = skinning_backward_reference(*map(torch.from_numpy, (w, tfms, vp, g)))
    assert bool((grad_tfms[:, :, 3] == 0).all())

    t_tfms, t_vp = torch.from_numpy(tfms).requires_grad_(), torch.from_numpy(vp).requires_grad_()
    auto_tfms, auto_vp = torch.autograd.grad(
        skinning_reference(torch.from_numpy(w), t_tfms, t_vp), (t_tfms, t_vp), torch.from_numpy(g)
    )
    np.testing.assert_allclose(grad_vp.numpy(), auto_vp.numpy(), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(grad_tfms.numpy(), auto_tfms.numpy(), atol=GRAD_ATOL, rtol=0)

    _, vjp = jax.vjp(
        lambda a, v: _jax_einsum_skinning(jnp.asarray(w), a, v), jnp.asarray(tfms), jnp.asarray(vp)
    )
    jax_tfms, jax_vp = vjp(jnp.asarray(g))
    np.testing.assert_allclose(grad_vp.numpy(), np.asarray(jax_vp), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(grad_tfms.numpy(), np.asarray(jax_tfms), atol=GRAD_ATOL, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_backward_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(2, 50, seed=12)]
    g = torch.randn(2, 50, 3)
    before = skinning_backward.launches
    out = skinning_backward(*args, g)
    assert skinning_backward.launches == before
    for a, b in zip(out, skinning_backward_reference(*args, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("through", ["plain", "function"])
def test_lbs_gradients_match_jax_grad(monkeypatch, through):
    """Gradients of a loss on the SMPL vertices and joints with respect to
    betas and the pose rotations, the port against jax.grad of the JAX
    package's einsum path, at V=6890 and atol 1e-5. `function` routes the
    port's skinning through the autograd Function that the card uses
    (forward and backward wrappers, here on their plain versions)."""
    from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
    from poco_tpu.smpl.lbs import smpl_forward as jax_smpl_forward
    from poco_tpu_torch.smpl import lbs as lbs_module
    from poco_tpu_torch.smpl.assets import synthetic_smpl_model
    from poco_tpu_torch.smpl.lbs import smpl_forward

    if through == "function":
        monkeypatch.setattr(lbs_module, "skinning", _SkinningFunction.apply)
    rng = np.random.RandomState(3)
    betas = rng.randn(2, 10).astype(np.float32)
    aa = (0.4 * rng.randn(2 * 24, 3)).astype(np.float32)
    rot = np.asarray(axis_angle_to_rotmat(jnp.asarray(aa))).reshape(2, 24, 3, 3)
    r_v = rng.randn(2, 6890, 3).astype(np.float32) / 6890
    r_j = rng.randn(2, 54, 3).astype(np.float32)

    jax_smpl = jax_synthetic_smpl(num_verts=6890)

    def jax_loss(b, r):
        out = jax_smpl_forward(jax_smpl, b, r)
        return (out.vertices * r_v).sum() + (out.joints * r_j).sum()

    jb, jr = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(betas), jnp.asarray(rot))

    smpl = synthetic_smpl_model(num_verts=6890, device="cpu")
    tb = torch.from_numpy(betas).requires_grad_()
    tr = torch.from_numpy(rot.copy()).requires_grad_()
    out = smpl_forward(smpl, tb, tr)
    loss = (out.vertices * torch.from_numpy(r_v)).sum() + (out.joints * torch.from_numpy(r_j)).sum()
    gb, gr = torch.autograd.grad(loss, (tb, tr))
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), atol=GRAD_ATOL, rtol=0)


# --------------------------------------------------------------------------
# the backward kernel's arithmetic, emulated
# --------------------------------------------------------------------------

BACKWARD_RTOL, BACKWARD_ATOL = 1e-5, 1e-7  # the card's bar (chip_smoke.py)
TILE, WARP_ROWS = 128, 16                    # vertices a block, a warp


def _split_rna(x):
    """big + small, both rounded with cvt.rna (W and E in the kernel)."""
    big = _tf32_round(x)
    return big, _tf32_round(x - big)


def _backward_emulation(w, tfms, vp, g, products=3):
    """`csrc/skinning_backward.cu` in float32: the blend T = W A' (W split
    with cvt.rna twice, the transforms' rows 0-2 into a rounded big part
    and a truncated residual), grad_v_posed[y] = (T0y g0 + T1y g1) + T2y g2;
    E[v] = g[v] (x) [v_posed[v], 1] split with cvt.rna twice, each warp's
    16 vertices reduced by E^T W as three products, the 8 warps' partials
    added in order, and the tiles' partials added as four interleaved
    running sums, then (s0 + s1) + (s2 + s3). `products=1` keeps only
    big x big in both products."""
    batch, num_verts = vp.shape[:2]
    a = np.ascontiguousarray(tfms[:, :, :3, :3])               # (B, 24, x, y)
    w_big, w_small = _split_rna(w)
    a_big = _tf32_round(a)
    t = np.einsum("vj,bjxy->bvxy", w_big, a_big)
    if products == 3:
        a_small = _tf32_truncate(a - a_big)
        t = (np.einsum("vj,bjxy->bvxy", w_small, a_big)
             + np.einsum("vj,bjxy->bvxy", w_big, a_small)) + t
    t = t.astype(np.float32)
    grad_vp = (t[:, :, 0] * g[..., 0:1] + t[:, :, 1] * g[..., 1:2]) + t[:, :, 2] * g[..., 2:3]

    tiles = -(-num_verts // TILE)
    pad = tiles * TILE - num_verts
    homog = np.concatenate([vp, np.ones_like(vp[..., :1])], axis=-1)
    e = (g[..., :, None] * homog[..., None, :]).reshape(batch, num_verts, 12)
    e = np.pad(e, ((0, 0), (0, pad), (0, 0))).reshape(batch, tiles, 8, WARP_ROWS, 12)
    wp = np.pad(w, ((0, pad), (0, 0))).reshape(tiles, 8, WARP_ROWS, 24)
    e_big, e_small = _split_rna(e)
    wp_big, wp_small = _split_rna(wp)
    prod = "btwue,twuj->btwje"
    warp_part = np.einsum(prod, e_big, wp_big)
    if products == 3:
        warp_part = (np.einsum(prod, e_small, wp_big)
                     + np.einsum(prod, e_big, wp_small)) + warp_part
    warp_part = warp_part.astype(np.float32)
    tile_part = warp_part[:, :, 0]
    for k in range(1, 8):
        tile_part = tile_part + warp_part[:, :, k]
    sums = [np.zeros_like(tile_part[:, 0]) for _ in range(4)]
    for c in range(tiles):
        sums[c % 4] = sums[c % 4] + tile_part[:, c]
    rows = ((sums[0] + sums[1]) + (sums[2] + sums[3])).reshape(batch, 24, 3, 4)
    grad_tfms = np.concatenate([rows, np.zeros_like(rows[:, :, :1])], axis=2)
    return grad_vp.astype(np.float32), grad_tfms.astype(np.float32)


def _backward_case(batch, num_verts, seed):
    w, tfms, vp = _inputs(batch, num_verts, seed=seed)
    g = (0.1 * np.random.RandomState(seed + 1).randn(batch, num_verts, 3)).astype(np.float32)
    return w, tfms, vp, g


def _within_bar(got, ref):
    """The largest error over the card's bar, 1e-5 x max |ref| + 1e-7."""
    return float(np.abs(got - ref).max()) / (BACKWARD_RTOL * float(np.abs(ref).max())
                                             + BACKWARD_ATOL)


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (2, 1001), (2, TILE + 1)])
def test_backward_kernel_arithmetic_matches_jax_vjp(batch, num_verts):
    """The emulated kernel against jax.vjp of the JAX einsum path
    (poco_tpu/smpl/lbs.py:177-186), both gradients within 1e-5 x max
    |ref| + 1e-7, with row 3 of grad_rel_tfms exactly 0: at the main
    path's V, a V that is no multiple of the tile, and one past a tile."""
    w, tfms, vp, g = _backward_case(batch, num_verts, seed=num_verts + 31)
    _, vjp = jax.vjp(
        lambda a, v: _jax_einsum_skinning(jnp.asarray(w), a, v), jnp.asarray(tfms), jnp.asarray(vp)
    )
    ref_tfms, ref_vp = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    got_vp, got_tfms = _backward_emulation(w, tfms, vp, g)
    assert _within_bar(got_vp, ref_vp) <= 1.0
    assert _within_bar(got_tfms, ref_tfms) <= 1.0
    assert not got_tfms[:, :, 3].any()


def _float64_backward(w, tfms, vp, g):
    grads = skinning_backward_reference(
        *(torch.from_numpy(x.astype(np.float64)) for x in (w, tfms, vp, g))
    )
    return [x.numpy() for x in grads]


@pytest.mark.parametrize("which", ["grad_v_posed", "grad_rel_tfms"])
def test_one_tf32_product_misses_the_backward_bar(which):
    """Why the backward kernel splits: at B=2, V=6890, one TF32 product
    misses the card's bar against float64 several times over on each
    gradient (about 18x and 39x here), while the 3xTF32 split lands inside it."""
    case = _backward_case(2, 6890, seed=41)
    exact = _float64_backward(*case)[("grad_v_posed", "grad_rel_tfms").index(which)]
    index = ("grad_v_posed", "grad_rel_tfms").index(which)
    one = _backward_emulation(*case, products=1)[index]
    three = _backward_emulation(*case)[index]
    assert _within_bar(one, exact) > 4.0
    assert _within_bar(three, exact) < 1.0


def test_backward_simt_wrapper_on_cpu_takes_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(2, 50, seed=13)]
    g = torch.randn(2, 50, 3)
    before = skinning_backward_simt.launches
    out = skinning_backward_simt(*args, g)
    assert skinning_backward_simt.launches == before
    for a, b in zip(out, skinning_backward_reference(*args, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_ablation_script_needs_a_card(monkeypatch, capsys):
    """`ablate_skinning_backward.py` builds nothing and exits 1 without a
    CUDA device."""
    import ablate_skinning_backward as ablate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["ablate_skinning_backward.py"])
    assert ablate.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
