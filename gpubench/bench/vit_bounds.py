"""The least time of a ViT block's MLP (`poco/vit_mlp`: LayerNorm, fc1,
GELU, fc2) at a call's shape: `tokens` rows of width `dim` through a
`hidden`-wide layer and back.

The work is its two products, 2 * tokens * dim * hidden FLOPs each,
against the card's fastest fp32-accurate rate (3xTF32, the peak `mfu.*`
takes), so no fp32-exact route reads over 100%. The bytes are what the
block needs whatever implements it: its input read once, its output
written once, and both layers' weights and biases read once; the
LayerNorm's 2 * dim parameters and the hidden activations, which a fused
kernel need never write, are left out."""

from __future__ import annotations

from bench.peaks import Peaks


def mlp_flops(tokens: int, dim: int, hidden: int) -> int:
    return 2 * 2 * tokens * dim * hidden


def mlp_bytes(tokens: int, dim: int, hidden: int) -> int:
    """fp32 input and output, fc1's and fc2's weights and biases."""
    return 4 * (2 * tokens * dim + 2 * dim * hidden + hidden + dim)


def mlp_bound_s(tokens: int, dim: int, hidden: int, peaks: Peaks) -> float:
    return max(mlp_flops(tokens, dim, hidden) / peaks.fp32_accurate_flop_per_s,
               mlp_bytes(tokens, dim, hidden) / peaks.bytes_per_s)
