"""The benchmark's plain reference of HMR 2.0's trunk: ViTPose-H.

Written from the published description, not copied from the port:
Goel et al., "Humans in 4D: Reconstructing and Tracking Humans with
Transformers" (ICCV 2023, arXiv:2305.20091), github.com/shubham-goel/
4D-Humans `hmr2/models/backbones/vit.py` (`vit()`, `ViT`, `Block`,
`Attention`, `Mlp`, `PatchEmbed`). Plain torch in fp32 (the benchmark
turns TF32 off); attention is written out as softmax(q k^T * scale) v.

    x = Conv2d(3, D, 16, stride 16, padding 2)(crop)      # 256 x 192 -> 16 x 12
    x = tokens(x) + pos_embed[:, 1:] + pos_embed[:, :1]    # (B, 192, D)
    32 times:  x = x + attn(LN1(x));  x = x + mlp(LN2(x))  # LN eps 1e-6
      attn: qkv = Linear(D, 3D) (with bias), 16 heads of D/16,
            softmax(q k^T / sqrt(D/16)) v, Linear(D, D)
      mlp:  Linear(D, 4D), GELU (erf), Linear(4D, D)
    x = LN(x) -> (B, D, 16, 12)

Departures from 4DHumans:

- drop_path (0.55) is left out: the model is in inference, where it is
  the identity;
- the initializers are the published ones (`_init_weights`: Linear
  weights truncated normal of std 0.02 and zero bias, LayerNorm 1 and 0;
  `pos_embed` truncated normal 0.02; the patch conv torch's default), and
  set only the scale of the benchmark's seeded weights (`bench/synth.py:
  seeded_weights`): the pretrained ViTPose weights are not fetched.
"""

from __future__ import annotations

import torch
from torch import nn


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q * self.scale) @ k.transpose(-2, -1), dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch_size, stride=patch_size, padding=2)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        hp, wp = x.shape[2], x.shape[3]
        return x.flatten(2).transpose(1, 2), hp, wp


class ViT(nn.Module):
    def __init__(self, img_size=(256, 192), patch_size: int = 16, embed_dim: int = 1280,
                 depth: int = 32, num_heads: int = 16, mlp_ratio: int = 4):
        super().__init__()
        self.img_size = tuple(img_size)
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        hp = (self.img_size[0] + 4 - patch_size) // patch_size + 1
        wp = (self.img_size[1] + 4 - patch_size) // patch_size + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, hp * wp + 1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio)
                                     for _ in range(depth)])
        self.last_norm = nn.LayerNorm(embed_dim, eps=1e-6)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.apply(_init_weights)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x, hp, wp = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for block in self.blocks:
            x = block(x)
        x = self.last_norm(x)
        return x.permute(0, 2, 1).reshape(b, -1, hp, wp)


def _init_weights(m: nn.Module) -> None:
    if isinstance(m, nn.Linear):
        nn.init.trunc_normal_(m.weight, std=0.02)
        nn.init.zeros_(m.bias)
    elif isinstance(m, nn.LayerNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)
