"""SMPL skinning: the CUDA kernels' wrappers and their plain torch version.

`skinning` launches `csrc/skinning.cu` (the port of the TPU kernel
`poco_tpu/ops/pallas_lbs.py:skinning_pallas`, a 3xTF32 tensor-core blend)
on CUDA tensors, and runs `skinning_reference` only for tensors that lie
on the CPU. A CUDA tensor either runs the kernel or raises: there is no
fallback. `skinning_simt` launches the first, fp32-FMA version of the
kernel (`csrc/skinning_simt.cu`) under the same contract; it is off the
main path and kept as the yardstick the redesign is timed against.
Neither kernel has a backward: on CUDA tensors that require a gradient
they raise rather than return a result that autograd cannot follow.
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


def _load(library: str, symbol: str):
    fn = getattr(kernels.load(library), symbol)
    # weights, tfms, v_posed, out, batch, num_verts, num_joints, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(library, symbol, lbs_weights, rel_tfms, v_posed):
    """Check the CUDA inputs, allocate the output and launch `symbol` of
    kernel library `library`. Counts nothing: the wrappers do."""
    tensors = (lbs_weights, rel_tfms, v_posed)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{library}: the CUDA kernel has no backward yet, so its output "
            "would carry no gradient; run it under torch.no_grad() or "
            "torch.inference_mode(), or detach the inputs"
        )
    device = v_posed.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"{library}: tensors must all lie on the CPU or on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{library}: float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{library}: inputs must be contiguous")
    num_verts = lbs_weights.shape[0]
    batch = v_posed.shape[0]
    if (
        lbs_weights.shape != (num_verts, NUM_JOINTS)
        or rel_tfms.shape != (batch, NUM_JOINTS, 4, 4)
        or v_posed.shape != (batch, num_verts, 3)
    ):
        raise ValueError(
            f"{library}: expected (V, 24), (B, 24, 4, 4), (B, V, 3), got "
            f"{tuple(lbs_weights.shape)}, {tuple(rel_tfms.shape)}, "
            f"{tuple(v_posed.shape)}"
        )
    out = torch.empty((batch, num_verts, 3), dtype=torch.float32, device=device)
    fn = _load(library, symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            lbs_weights.data_ptr(), rel_tfms.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), batch, num_verts, NUM_JOINTS, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{library} kernel launch failed: CUDA error {rc}")
    return out


def skinning(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """Fused skinning; same contract as `skinning_reference`.

    CPU tensors take the plain version. CUDA tensors must be float32,
    contiguous and on one device, with J = 24, and must not require a
    gradient while autograd is on; the kernel writes into a fresh output
    on the current stream and `skinning.launches` counts each launch.
    """
    if all(t.device.type == "cpu" for t in (lbs_weights, rel_tfms, v_posed)):
        return skinning_reference(lbs_weights, rel_tfms, v_posed)
    out = _launch("skinning", "poco_skinning_f32", lbs_weights, rel_tfms, v_posed)
    skinning.launches += 1
    return out


def skinning_simt(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """The fp32-FMA skinning kernel, the yardstick of `skinning`; same
    contract, counted in `skinning_simt.launches`."""
    if all(t.device.type == "cpu" for t in (lbs_weights, rel_tfms, v_posed)):
        return skinning_reference(lbs_weights, rel_tfms, v_posed)
    out = _launch(
        "skinning_simt", "poco_skinning_f32_simt", lbs_weights, rel_tfms, v_posed
    )
    skinning_simt.launches += 1
    return out


skinning.launches = 0
skinning_simt.launches = 0
