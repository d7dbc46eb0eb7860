# Frozen copy of poco_tpu_torch/models/layers.py at commit 48ff100 (see __init__.py).
"""Layers shared by the PARE / POCO heads (torch, NCHW).

Port of `poco_tpu.models.layers` (reference pocolib/models/layers/
{locallyconnected2d,keypoint_attention,softargmax,interpolate}.py). They
are plain products, reductions and one gather, as in the JAX package,
where XLA fuses them; here they are einsums and stock torch ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import distributed


def dropout_keep_mask(x: torch.Tensor, keep: float) -> torch.Tensor:
    """The keep mask of `Dropout`: True with probability `keep`, drawn
    from torch's generator for `x`'s device. A module-level function so
    that a test can feed every dropout layer one mask (all-keep, for
    parity with the JAX package, whose random bits torch cannot repeat).

    x holds this process's data shard of the global batch (each shard as
    many rows): every process draws the mask of the whole global batch
    from its generator, which every process seeds alike, and keeps its own
    rows, so the processes drop what one process would drop, and the
    processes of a model group (the same rows) drop alike."""
    rows = x.shape[0]
    full = torch.rand((rows * distributed.data_count(), *x.shape[1:]), device=x.device)
    lo = distributed.data_index() * rows
    return full[lo:lo + rows] < keep


class Dropout(nn.Module):
    """Inverted dropout as flax computes it: in training, x / keep where
    the mask keeps, 0 elsewhere; the identity in eval mode."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(dropout_keep_mask(x, keep), x / keep, torch.zeros_like(x))


class PerPositionConv1x1(nn.Module):
    """Unshared-weight 1x1 conv over a fixed (H, W) grid: the reference
    `LocallyConnected2d` with kernel_size 1, used as per-joint MLPs over
    a [24, 1] grid (pare_head.py:411-419).

    Input (B, C, H, W) -> (B, O, H, W). The weight keeps the reference
    layout (1, O, C, H, W, 1), so a reference checkpoint loads as it is.
    """

    def __init__(self, in_channels: int, out_channels: int, grid: tuple[int, int],
                 bias: bool = False):
        super().__init__()
        h, w = grid
        bound = math.sqrt(6.0 / (in_channels + out_channels))
        self.weight = nn.Parameter(
            torch.empty(1, out_channels, in_channels, h, w, 1).uniform_(-bound, bound)
        )
        self.bias = nn.Parameter(torch.zeros(1, out_channels, h, w)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # as the JAX layer's einsum: the input promoted to the weight's
        # dtype, so fp32 weights compute in fp32 under a bf16 autocast
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        with torch.autocast(x.device.type, enabled=False):
            y = torch.einsum("bchw,ochw->bohw", x.to(dtype), self.weight[0, ..., 0].to(dtype))
            return y if self.bias is None else y + self.bias


def keypoint_attention(
    features: torch.Tensor, heatmaps: torch.Tensor, act: str = "softmax",
    use_scale: bool = False,
) -> torch.Tensor:
    """Per-joint soft pooling (reference keypoint_attention.py:34-56).

    Args:
        features: (B, C, H, W).
        heatmaps: (B, J, H, W) attention logits.
    Returns:
        (B, C, J) per-joint pooled features.
    """
    b, j, h, w = heatmaps.shape
    hm = heatmaps.reshape(b, j, h * w)
    if use_scale:
        hm = hm / math.sqrt(float(h * w))
    if act == "softmax":
        hm = torch.softmax(hm, dim=-1)
    elif act == "sigmoid":
        hm = torch.sigmoid(hm)
    return torch.einsum("bjn,bcn->bcj", hm, features.reshape(b, -1, h * w))


def softargmax2d(
    heatmaps: torch.Tensor, temperature: float = 1.0, normalize_keypoints: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable 2D argmax (reference softargmax.py:56-108).

    Args:
        heatmaps: (B, J, H, W).
    Returns:
        keypoints (B, J, 2), (x, y), in [-1, 1] when normalized, and the
        normalized heatmap (B, J, H, W).
    """
    b, j, h, w = heatmaps.shape
    norm = torch.softmax(heatmaps.reshape(b, j, h * w) * temperature, dim=-1)
    coords = torch.arange(h * w, device=heatmaps.device)
    xs = (coords % w).to(heatmaps.dtype)
    ys = (coords // w).to(heatmaps.dtype)
    kx = (norm * xs).sum(dim=-1)
    ky = (norm * ys).sum(dim=-1)
    if normalize_keypoints:
        kx = kx / (w - 1) * 2.0 - 1.0
        ky = ky / (h - 1) * 2.0 - 1.0
    return torch.stack([kx, ky], dim=-1), norm.reshape(b, j, h, w)


def softargmax1d(
    heatmaps: torch.Tensor, temperature: float = 1.0, normalize_keypoints: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable 1D argmax over the last axis (reference
    softargmax.py:25-54): (B, C, D) -> (B, C) positions, (B, C, D)."""
    d = heatmaps.shape[-1]
    norm = torch.softmax(heatmaps * temperature, dim=-1)
    kp = (norm * torch.arange(d, device=heatmaps.device, dtype=heatmaps.dtype)).sum(dim=-1)
    if normalize_keypoints:
        kp = kp / (d - 1) * 2.0 - 1.0
    return kp, norm


def get_heatmap_preds(
    heatmaps: torch.Tensor, normalize_keypoints: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard argmax keypoints (the first maximum) and the max value as
    confidence; a joint whose maximum is not positive sits at (0, 0)
    before normalization.

    Returns:
        keypoints (B, J, 2) and confidence (B, J, 1).
    """
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    maxval, idx = flat.amax(dim=-1), flat.argmax(dim=-1)
    mask = (maxval > 0).to(heatmaps.dtype)
    x = (idx % w).to(heatmaps.dtype) * mask
    y = (idx // w).to(heatmaps.dtype) * mask
    if normalize_keypoints:
        x = x / (w - 1) * 2.0 - 1.0
        y = y / (h - 1) * 2.0 - 1.0
    return torch.stack([x, y], dim=-1), maxval[..., None]


def grid_sample_bilinear(features: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear samples at normalized (x, y) in [-1, 1], align_corners=True,
    zero outside (reference interpolate.py:3-19).

    Args:
        features: (B, C, H, W).
        uv: (B, N, 2).
    Returns:
        (B, C, N).

    Finite coordinates are first clamped to a range that lies wholly
    outside the map (past 1 + 2/(size-1), where no tap reaches it): on the
    card `F.grid_sample` turns a point ~1e30 out into NaN instead of
    zero. `clamp` passes NaN on, and infinities are left as they are, so
    the NaN outputs stay JAX's.
    """
    h, w = features.shape[-2:]
    bound = uv.new_tensor([1 + 4 / max(w - 1, 1), 1 + 4 / max(h - 1, 1)])
    uv = torch.where(torch.isfinite(uv), uv.clamp(-bound, bound), uv)
    return F.grid_sample(
        features, uv.unsqueeze(2), mode="bilinear", padding_mode="zeros",
        align_corners=True,
    )[..., 0]
