"""The card's published peaks and the least time of the skinning kernels'
work (copied from the repository's `chip_smoke.py`: `Peaks`, `PEAKS`,
`skinning_bytes`, `skinning_bound`, `backward_bytes`, `backward_bound`).

The bounds count the work the kernels' inputs need, whatever implements
them: W, the transforms and v_posed read once, the output written once,
against the operations on the fastest engine that keeps fp32 accuracy,
the tensor cores with a 3xTF32 split plus the fp32 rest."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peaks of one card at its full power limit, dense rates."""

    bytes_per_s: float      # device memory
    fp32_flop_per_s: float  # fp32 outside the tensor cores
    tf32_flop_per_s: float  # TF32 on the tensor cores

    @property
    def fp32_accurate_flop_per_s(self) -> float:
        """The fastest fp32-accurate rate: TF32 over three (3xTF32)."""
        return self.tf32_flop_per_s / 3.0


# NVIDIA's data sheets, keyed by the name torch.cuda.get_device_name()
# gives (sparse tensor rates halved to dense)
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 494.7e12),  # H100 SXM
    "NVIDIA H100 PCIe": Peaks(2.0e12, 51e12, 378e12),
    "NVIDIA H100 NVL": Peaks(3.9e12, 60e12, 417.5e12),
    "NVIDIA H200": Peaks(4.8e12, 67e12, 494.5e12),  # H200 SXM
}


def card_peaks(name: str) -> Peaks:
    if name not in PEAKS:
        raise RuntimeError(f"no published peaks for {name!r} (known: {sorted(PEAKS)})")
    return PEAKS[name]


def skinning_bytes(batch: int, num_verts: int) -> int:
    """W, the transforms and v_posed read once, out written once."""
    return 4 * (num_verts * 24 + batch * 24 * 16 + 2 * batch * num_verts * 3)


def skinning_bound_s(batch: int, num_verts: int, peaks: Peaks) -> float:
    """Least time of the forward: bytes against 3xTF32 products of the
    24 x 12 blend plus the fp32 affine."""
    t_bytes = skinning_bytes(batch, num_verts) / peaks.bytes_per_s
    t_ops = (3 * 2 * 24 * 12 * batch * num_verts / peaks.tf32_flop_per_s
             + 18 * batch * num_verts / peaks.fp32_flop_per_s)
    return max(t_bytes, t_ops)


def backward_bytes(batch: int, num_verts: int) -> int:
    """W and the transforms read once, v_posed and the output gradient
    read once, grad_v_posed and grad_rel_tfms written once."""
    return 4 * (num_verts * 24 + 2 * batch * 24 * 16 + 3 * batch * num_verts * 3)


def backward_bound_s(batch: int, num_verts: int, peaks: Peaks) -> float:
    """Least time of the backward: its bytes against its two GEMM-shaped
    products (24 x 9 and 24 x 12) as 3xTF32 plus 9 + 9 + 12 fp32 FMAs a
    (vertex, sample)."""
    per_vertex = batch * num_verts
    t_bytes = backward_bytes(batch, num_verts) / peaks.bytes_per_s
    t_ops = (3 * 2 * 24 * (9 + 12) * per_vertex / peaks.tf32_flop_per_s
             + (2 * 9 + 12) * per_vertex / peaks.fp32_flop_per_s)
    return max(t_bytes, t_ops)
