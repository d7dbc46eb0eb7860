"""HMR 2.0's SMPL head (torch): a transformer decoder whose one query
token cross-attends to the trunk's tokens.

Goel et al., "Humans in 4D" (ICCV 2023), `hmr2/models/heads/smpl_head.py`
(`SMPLTransformerDecoderHead`) and `hmr2/models/components/
pose_transformer.py` (`TransformerDecoder`, `TransformerCrossAttn`): a
zero token (1 wide) embedded to 1024 plus a learned position, 6 layers of
pre-norm self-attention, cross-attention to the trunk's tokens (8 heads of
64; the norm on the query side only) and a 1024-wide GELU feed-forward,
each with a residual; then `decpose` (24 x 6D), `decshape` (10) and
`deccam` (3) added once to the mean parameters (IEF_ITERS 1). The 6D
layout is HMR 2.0's own (`hmr2/utils/geometry.py:rot6d_to_rotmat`: two
rows, not SPIN's column pair). Module and buffer names are the published
code's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...smpl.mean_params import load_mean_params

# the identity rotation in HMR 2.0's 6D layout: rows a1 = (1, 0, 0), a2 = (0, 1, 0)
IDENTITY_6D = np.array([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], np.float32)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6D -> (N, 3, 3): the 6 values are the rows a1, a2;
    Gram-Schmidt gives the matrix's first two columns."""
    a = x.reshape(-1, 2, 3)
    b1 = F.normalize(a[:, 0], dim=-1)
    a2 = a[:, 1]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-1)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H * D) -> (B, H, N, D)."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H * D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out(_merge(F.scaled_dot_product_attention(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class TransformerCrossAttn(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 context_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim)),
        ]) for _ in range(depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 context_dim: int):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head, mlp_dim,
                                                context_dim)

    def forward(self, token: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context=context)


class Hmr2Head(nn.Module):
    """(B, C, H, W) trunk map -> pred_pose (B, 24, 3, 3), pred_shape (B, 10),
    pred_cam (B, 3), pred_pose_6d (B, 144), uncert_feat (B, dim): the
    decoder's output token."""

    def __init__(self, context_dim: int = 1280, dim: int = 1024, depth: int = 6,
                 heads: int = 8, dim_head: int = 64, mlp_dim: int = 1024,
                 num_joints: int = 24, mean_params_path: str | None = None):
        super().__init__()
        self.dim = dim
        self.num_joints = num_joints
        self.transformer = TransformerDecoder(dim, depth, heads, dim_head, mlp_dim, context_dim)
        self.decpose = nn.Linear(dim, 6 * num_joints)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        for dec in (self.decpose, self.decshape, self.deccam):   # INIT_DECODER_XAVIER
            nn.init.xavier_uniform_(dec.weight, gain=0.01)
        pose, shape, cam = load_mean_params(mean_params_path, num_joints,
                                            identity_6d=IDENTITY_6D)
        self.register_buffer("init_body_pose", torch.from_numpy(pose)[None])
        self.register_buffer("init_betas", torch.from_numpy(shape)[None])
        self.register_buffer("init_cam", torch.from_numpy(cam)[None])

    def forward(self, features: torch.Tensor) -> dict[str, torch.Tensor]:
        batch = features.shape[0]
        context = features.flatten(2).transpose(1, 2)
        token = features.new_zeros(batch, 1, 1)
        out = self.transformer(token, context=context)[:, 0]
        pose = self.decpose(out) + self.init_body_pose
        shape = self.decshape(out) + self.init_betas
        cam = self.deccam(out) + self.init_cam
        return {
            "uncert_feat": out,
            "pred_pose": rot6d_to_rotmat(pose).reshape(batch, self.num_joints, 3, 3),
            "pred_shape": shape,
            "pred_cam": cam,
            "pred_pose_6d": pose,
        }

    def get_output_channels(self) -> int:
        return self.dim
