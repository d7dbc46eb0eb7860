"""ViT trunk of HMR 2.0 (torch): ViTPose-H as 4DHumans builds it.

Goel et al., "Humans in 4D" (ICCV 2023), `hmr2/models/backbones/vit.py`
(`vit()`): a 256 x 192 crop, a 16-px patch embedding (padding 2) to a
16 x 12 grid of 192 tokens, an absolute position table whose class row is
added to every patch row, 32 pre-norm blocks of 1280 (16 heads of 80, a
5120-wide GELU MLP, LayerNorm eps 1e-6), a last LayerNorm, and the tokens
back as a (B, 1280, 16, 12) map. drop_path (0.55 in training) is left out:
the port runs the trunk in inference (on the card its linear layers'
kernel has no backward and refuses inputs that need a gradient; on the
CPU the trunk stays differentiable).

Attention is `torch.nn.functional.scaled_dot_product_attention` (its
scale 1/sqrt(80) is the published one). The four linear layers of a
block (qkv, proj, fc1, fc2) run through `ops/linear.py:linear_3xtf32`
with their `nn.Linear` modules' own weight and bias: on the card the
3xTF32 tensor-core kernel, with fc1's GELU and the block's two residual
adds (into proj and fc2) in its epilogue; on the CPU `F.linear` and the
same epilogue in plain torch. Each block's attention and MLP run in the
spans `poco/vit_attention` and `poco/vit_mlp`. Module names are the
published code's, so its state_dict keys are a ViTPose checkpoint's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.linear import linear_3xtf32
from ...utils import spans


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """residual + proj(attention(qkv(x)))."""
        b, n, c = x.shape
        qkv = linear_3xtf32(x, self.qkv.weight, self.qkv.bias)
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, c // self.num_heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        return linear_3xtf32(out, self.proj.weight, self.proj.bias, "residual", residual)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """residual + fc2(gelu(fc1(x)))."""
        hidden = linear_3xtf32(x, self.fc1.weight, self.fc1.bias, "gelu")
        return linear_3xtf32(hidden, self.fc2.weight, self.fc2.bias, "residual", residual)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with spans.span(spans.VIT_ATTENTION):
            x = self.attn(self.norm1(x), x)
        with spans.span(spans.VIT_MLP):
            x = self.mlp(self.norm2(x), x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ViT(nn.Module):
    """(B, 3, H, W) crops at `img_size` -> (B, embed_dim, H/16, W/16)."""

    def __init__(self, img_size: tuple[int, int] = (256, 192), patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: int = 4):
        super().__init__()
        self.img_size = img_size
        self.out_channels = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        grid = [(s + 4 - patch_size) // patch_size + 1 for s in img_size]
        self.pos_embed = nn.Parameter(torch.zeros(1, grid[0] * grid[1] + 1, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2).contiguous()   # (B, tokens, C) rows for the op
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for block in self.blocks:
            x = block(x)
        x = self.last_norm(x)
        return x.transpose(1, 2).reshape(b, c, hp, wp)


def vit_h() -> ViT:
    """ViTPose-H at HMR 2.0's input: 32 blocks of 1280, 16 heads, MLP 5120."""
    return ViT()
