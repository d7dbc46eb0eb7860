"""SMPL skinning: the CUDA kernels' wrappers and their plain torch versions.

`skinning` launches `csrc/skinning.cu` (the port of the TPU kernel
`poco_tpu/ops/pallas_lbs.py:skinning_pallas`, a 3xTF32 tensor-core blend)
on CUDA tensors, and runs `skinning_reference` only for tensors that lie
on the CPU. A CUDA tensor either runs the kernel or raises: there is no
fallback. Both kernels of the main paths are registered torch custom ops,
`poco_tpu_torch::skinning` and `poco_tpu_torch::skinning_backward`, each
with a CUDA implementation (the kernel, through ctypes), a CPU one (the
plain version) and a fake one (shapes only), so a `torch.export` program
keeps a call to the op, which launches the kernel where the program runs
on the card, instead of the plain einsums. The forward's autograd is the
backward op, which launches `csrc/skinning_backward.cu` (plain version
`skinning_backward_reference`): the gradients of v_posed and of the
transforms; the skinning weights are SMPL buffers and get none. Importing
this module registers the ops.
`skinning_simt` launches the first, fp32-FMA version of the forward kernel
(`csrc/skinning_simt.cu`) under the same contract but without a backward,
and `skinning_backward_simt` the first, fp32-FMA version of the backward
(`csrc/skinning_backward_simt.cu`); both are off the main path and kept
as the yardsticks the redesigns are timed against.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

NUM_JOINTS = 24


def skinning_reference(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """Plain skinning: blend the (B, V, 4, 4) transforms, then apply them.

    Args:
        lbs_weights: (V, J) skinning weights.
        rel_tfms: (B, J, 4, 4) relative joint transforms.
        v_posed: (B, V, 3) posed vertices.
    Returns:
        (B, V, 3) skinned vertices.
    """
    batch, num_joints = rel_tfms.shape[:2]
    num_verts = lbs_weights.shape[0]
    vert_tfms = torch.einsum(
        "vj,bjk->bvk", lbs_weights, rel_tfms.reshape(batch, num_joints, 16)
    ).reshape(batch, num_verts, 4, 4)
    return (
        torch.einsum("bvxy,bvy->bvx", vert_tfms[:, :, :3, :3], v_posed)
        + vert_tfms[:, :, :3, 3]
    )


def skinning_backward_reference(
    lbs_weights: torch.Tensor,
    rel_tfms: torch.Tensor,
    v_posed: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gradients of `skinning_reference` for the output gradient
    `grad_out` (B, V, 3): with T[b, v] = sum_j W[v, j] A[b, j],

        grad_v_posed[b, v] = T[b, v, :3, :3]^T grad_out[b, v]
        grad_rel_tfms[b, j, x, :] = sum_v W[v, j] grad_out[b, v, x] [v_posed[b, v], 1]

    for x < 3; row 3 of grad_rel_tfms is 0. Returns (grad_v_posed (B, V, 3),
    grad_rel_tfms (B, J, 4, 4)).
    """
    batch, num_joints = rel_tfms.shape[:2]
    num_verts = lbs_weights.shape[0]
    vert_tfms = torch.einsum(
        "vj,bjk->bvk", lbs_weights, rel_tfms[:, :, :3, :3].reshape(batch, num_joints, 9)
    ).reshape(batch, num_verts, 3, 3)
    grad_v_posed = torch.einsum("bvxy,bvx->bvy", vert_tfms, grad_out)
    homog = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    rows = torch.einsum("vj,bvx,bvy->bjxy", lbs_weights, grad_out, homog)
    grad_rel_tfms = torch.cat([rows, torch.zeros_like(rows[:, :, :1])], dim=2)
    return grad_v_posed, grad_rel_tfms


def _check_cuda(library: str, tensors, shapes: str) -> torch.device:
    """Raise unless `tensors` are float32, contiguous and on one CUDA
    device; returns that device."""
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"{library}: tensors must all lie on the CPU or on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{library}: float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{library}: inputs must be contiguous")
    num_verts, batch = tensors[0].shape[0], tensors[2].shape[0]
    expect = [(num_verts, NUM_JOINTS), (batch, NUM_JOINTS, 4, 4)]
    expect += [(batch, num_verts, 3)] * (len(tensors) - 2)
    if [tuple(t.shape) for t in tensors] != expect:
        raise ValueError(
            f"{library}: expected {shapes}, got {[tuple(t.shape) for t in tensors]}"
        )
    return device


def _call(library: str, symbol: str, device: torch.device, pointers, sizes) -> None:
    """Launch `symbol` of kernel library `library` on the current stream of
    `device`; raise if the launch fails."""
    fn = getattr(kernels.load(library), symbol)
    # the pointers, then batch, num_verts, num_joints, then the stream
    fn.argtypes = (
        [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*pointers, *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{library} kernel launch failed: CUDA error {rc}")


def _launch(library, symbol, lbs_weights, rel_tfms, v_posed):
    """Check the CUDA inputs, allocate the output and launch the forward
    kernel `symbol` of library `library`. Counts nothing: the wrappers do."""
    tensors = (lbs_weights, rel_tfms, v_posed)
    device = _check_cuda(library, tensors, "(V, 24), (B, 24, 4, 4), (B, V, 3)")
    batch, num_verts = v_posed.shape[:2]
    out = torch.empty((batch, num_verts, 3), dtype=torch.float32, device=device)
    _call(
        library, symbol, device,
        [t.data_ptr() for t in (*tensors, out)], (batch, num_verts, NUM_JOINTS),
    )
    return out


def _refuse_gradient(library: str, tensors, what: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{library}: the CUDA kernel has no backward for {what}, so its output "
            "would carry no gradient there; run it under torch.no_grad() or "
            "torch.inference_mode(), or detach the inputs"
        )


@torch.library.custom_op("poco_tpu_torch::skinning", mutates_args=(), device_types="cuda")
def _skinning_op(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """The CUDA implementation of the op: the kernel, counted."""
    out = _launch("skinning", "poco_skinning_f32", lbs_weights, rel_tfms, v_posed)
    skinning.launches += 1
    return out


@_skinning_op.register_kernel("cpu")
def _skinning_cpu(lbs_weights, rel_tfms, v_posed):
    return skinning_reference(lbs_weights, rel_tfms, v_posed)


@_skinning_op.register_fake
def _skinning_fake(lbs_weights, rel_tfms, v_posed):
    return v_posed.new_empty(v_posed.shape)


@torch.library.custom_op(
    "poco_tpu_torch::skinning_backward", mutates_args=(), device_types="cuda"
)
def _skinning_backward_op(
    lbs_weights: torch.Tensor,
    rel_tfms: torch.Tensor,
    v_posed: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of the op: the backward kernel, counted."""
    out = _backward("skinning_backward", "", lbs_weights, rel_tfms, v_posed, grad_out)
    skinning_backward.launches += 1
    return out


@_skinning_backward_op.register_kernel("cpu")
def _skinning_backward_cpu(lbs_weights, rel_tfms, v_posed, grad_out):
    return skinning_backward_reference(lbs_weights, rel_tfms, v_posed, grad_out)


@_skinning_backward_op.register_fake
def _skinning_backward_fake(lbs_weights, rel_tfms, v_posed, grad_out):
    return v_posed.new_empty(v_posed.shape), rel_tfms.new_empty(rel_tfms.shape)


def _skinning_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _skinning_grad(ctx, grad_out):
    """Autograd of the `skinning` op: the `skinning_backward` op gives the
    gradients of the transforms and v_posed; the skinning weights get none
    (the wrappers refuse weights that need one before the forward)."""
    lbs_weights, rel_tfms, v_posed = ctx.saved_tensors
    grad_v_posed, grad_rel_tfms = torch.ops.poco_tpu_torch.skinning_backward(
        lbs_weights, rel_tfms, v_posed, grad_out.contiguous()
    )
    return None, grad_rel_tfms, grad_v_posed


_skinning_op.register_autograd(_skinning_grad, setup_context=_skinning_setup_context)


def skinning(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """Fused skinning; same contract as `skinning_reference`.

    Calls the `poco_tpu_torch::skinning` op. CPU tensors take the plain
    version, forward and backward. CUDA tensors must be float32, contiguous
    and on one device, with J = 24; the kernel writes into a fresh output
    on the current stream and `skinning.launches` counts each launch (never
    a traced or fake call). When autograd is on, the result carries the
    backward op (`skinning_backward`) for the transforms and v_posed;
    weights that need a gradient raise, since the kernel gives them none.
    Tensors on any other device (meta included) raise here, before the op
    would reach its fake implementation.
    """
    tensors = (lbs_weights, rel_tfms, v_posed)
    _refuse_gradient("skinning", (lbs_weights,), "the skinning weights")
    if not all(t.device.type == "cpu" for t in tensors):
        _check_cuda("skinning", tensors, "(V, 24), (B, 24, 4, 4), (B, V, 3)")
    return torch.ops.poco_tpu_torch.skinning(*tensors)


def _backward(library, suffix, lbs_weights, rel_tfms, v_posed, grad_out):
    """Check the CUDA inputs, allocate the outputs and the scratch of
    per-tile partial sums (sized from the library's tile), and launch the
    backward kernel of `library`. Counts nothing: the wrappers do."""
    tensors = (lbs_weights, rel_tfms, v_posed, grad_out)
    device = _check_cuda(library, tensors, "(V, 24), (B, 24, 4, 4), (B, V, 3), (B, V, 3)")
    batch, num_verts = v_posed.shape[:2]
    grad_v_posed = torch.empty((batch, num_verts, 3), dtype=torch.float32, device=device)
    grad_rel_tfms = torch.empty(
        (batch, NUM_JOINTS, 4, 4), dtype=torch.float32, device=device
    )
    chunk = getattr(kernels.load(library), "poco_skinning_backward_chunk" + suffix)()
    chunks = -(-num_verts // chunk)
    partial = torch.empty(
        (batch, chunks, NUM_JOINTS * 12), dtype=torch.float32, device=device
    )
    _call(
        library, "poco_skinning_backward_f32" + suffix, device,
        [t.data_ptr() for t in (*tensors, grad_v_posed, grad_rel_tfms, partial)],
        (batch, num_verts, NUM_JOINTS),
    )
    return grad_v_posed, grad_rel_tfms


def skinning_backward(
    lbs_weights: torch.Tensor,
    rel_tfms: torch.Tensor,
    v_posed: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of skinning; same contract as
    `skinning_backward_reference`.

    Calls the `poco_tpu_torch::skinning_backward` op. CPU tensors take the
    plain version. CUDA tensors must be float32, contiguous and on one
    device; the kernel (3xTF32 tensor cores) writes fresh outputs (and a
    scratch of per-tile partial sums) on the current stream, and
    `skinning_backward.launches` counts each launch.
    """
    tensors = (lbs_weights, rel_tfms, v_posed, grad_out)
    if not all(t.device.type == "cpu" for t in tensors):
        _check_cuda("skinning_backward", tensors,
                    "(V, 24), (B, 24, 4, 4), (B, V, 3), (B, V, 3)")
    return torch.ops.poco_tpu_torch.skinning_backward(*tensors)


def skinning_backward_simt(
    lbs_weights: torch.Tensor,
    rel_tfms: torch.Tensor,
    v_posed: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32-FMA backward kernel, the yardstick of `skinning_backward`;
    same contract, counted in `skinning_backward_simt.launches`."""
    tensors = (lbs_weights, rel_tfms, v_posed, grad_out)
    if all(t.device.type == "cpu" for t in tensors):
        return skinning_backward_reference(*tensors)
    out = _backward("skinning_backward_simt", "_simt", *tensors)
    skinning_backward_simt.launches += 1
    return out


def skinning_simt(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """The fp32-FMA skinning kernel, the yardstick of `skinning`; same
    contract, counted in `skinning_simt.launches`, and no backward: on CUDA
    tensors that need a gradient while autograd is on it raises."""
    tensors = (lbs_weights, rel_tfms, v_posed)
    if all(t.device.type == "cpu" for t in tensors):
        return skinning_reference(*tensors)
    _refuse_gradient("skinning_simt", tensors, "any input")
    out = _launch("skinning_simt", "poco_skinning_f32_simt", *tensors)
    skinning_simt.launches += 1
    return out


skinning.launches = 0
skinning_backward.launches = 0
skinning_backward_simt.launches = 0
skinning_simt.launches = 0
