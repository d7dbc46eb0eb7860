"""SMPL skinning: the CUDA kernel's wrapper and its plain torch version.

`skinning` launches `csrc/skinning.cu` (the port of the TPU kernel
`poco_tpu/ops/pallas_lbs.py:skinning_pallas`) on CUDA tensors, and runs
`skinning_reference` only for tensors that lie on the CPU. A CUDA tensor
either runs the kernel or raises: there is no fallback.
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


def _kernel():
    fn = kernels.load("skinning").poco_skinning_f32
    # weights, tfms, v_posed, out, batch, num_verts, num_joints, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def skinning(
    lbs_weights: torch.Tensor, rel_tfms: torch.Tensor, v_posed: torch.Tensor
) -> torch.Tensor:
    """Fused skinning; same contract as `skinning_reference`.

    CPU tensors take the plain version. CUDA tensors must be float32,
    contiguous and on one device, with J = 24; the kernel writes into a
    fresh output on the current stream and `skinning.launches` counts
    each launch.
    """
    tensors = (lbs_weights, rel_tfms, v_posed)
    if all(t.device.type == "cpu" for t in tensors):
        return skinning_reference(lbs_weights, rel_tfms, v_posed)
    device = v_posed.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            "skinning: tensors must all lie on the CPU or on one CUDA device, "
            f"got {[str(t.device) for t in tensors]}"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            f"skinning: float32 only, got {[t.dtype for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("skinning: inputs must be contiguous")
    num_verts = lbs_weights.shape[0]
    batch = v_posed.shape[0]
    if (
        lbs_weights.shape != (num_verts, NUM_JOINTS)
        or rel_tfms.shape != (batch, NUM_JOINTS, 4, 4)
        or v_posed.shape != (batch, num_verts, 3)
    ):
        raise ValueError(
            "skinning: expected (V, 24), (B, 24, 4, 4), (B, V, 3), got "
            f"{tuple(lbs_weights.shape)}, {tuple(rel_tfms.shape)}, "
            f"{tuple(v_posed.shape)}"
        )
    out = torch.empty((batch, num_verts, 3), dtype=torch.float32, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            lbs_weights.data_ptr(), rel_tfms.data_ptr(), v_posed.data_ptr(),
            out.data_ptr(), batch, num_verts, NUM_JOINTS, stream,
        )
    if rc != 0:
        raise RuntimeError(f"skinning kernel launch failed: CUDA error {rc}")
    skinning.launches += 1
    return out


skinning.launches = 0
