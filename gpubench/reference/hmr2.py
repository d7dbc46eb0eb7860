"""The benchmark's plain reference of HMR 2.0: the ViT-H trunk (`vit.py`),
the transformer decoder SMPL head, the camera and SMPL.

Written from the published description, not copied from the port:
Goel et al., "Humans in 4D: Reconstructing and Tracking Humans with
Transformers" (ICCV 2023, arXiv:2305.20091), github.com/shubham-goel/
4D-Humans: `hmr2/models/hmr2.py` (`HMR2.forward_step`),
`hmr2/models/heads/smpl_head.py` (`SMPLTransformerDecoderHead`),
`hmr2/models/components/pose_transformer.py` (`TransformerDecoder`,
`TransformerCrossAttn`, `Attention`, `CrossAttention`, `FeedForward`,
`PreNorm`), `hmr2/utils/geometry.py` (`rot6d_to_rotmat`) and
`hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml`. Plain torch in
fp32 (the benchmark turns TF32 off); attention written out as
softmax(q k^T * scale) v; SMPL by this package's `lbs.py` (the einsum
skinning).

    x = crop[:, :, :, 32:-32]                   # 256 x 256 -> 256 x 192
    f = vit_h(x)                                # (B, 1280, 16, 12)
    t = Linear(1, 1024)(zeros(B, 1, 1)) + pos   # one query token
    6 times:  t = t + SA(LN(t));  t = t + CA(LN(t), f);  t = t + FF(LN(t))
      SA: to_qkv 1024 -> 3 x 512 (no bias), 8 heads of 64, to_out 512 -> 1024
      CA: to_q 1024 -> 512, to_kv 1280 -> 2 x 512 (no bias), to_out 512 -> 1024
      FF: Linear(1024, 1024), GELU, Linear(1024, 1024)     # LN eps 1e-5
    pose6d = decpose(t) + mean pose;  betas = decshape(t) + mean;  cam = deccam(t) + mean
    R = rot6d_to_rotmat(pose6d)                 # rows a1, a2 (HMR 2.0's layout)
    cam_t = [cam_1, cam_2, 2 * 5000 / (256 * cam_0 + 1e-9)]

Departures from 4DHumans:

- the traffic's boxes are square (scale * 200 a side), not ViTDet boxes
  widened to 4:3; the crop is this package's `preprocess.py` at
  `out_res` = 256 (ImageNet normalization, as HMR 2.0's);
- SMPL gives the port's 49-joint SPIN output (`smpl_model.smpl_49`), not
  HMR 2.0's 44 joints; the 2D joints are projected with focal length
  5000 about the crop centre and divided by 256 / 2 (the port's
  normalization, SPIN's), where HMR 2.0 divides by 256;
- the mean parameters are the identity pose in HMR 2.0's 6D layout
  ([1, 0, 0, 0, 1, 0] a joint), zero shape and the camera [0.9, 0, 0]
  (`smpl_mean_params.npz` is not shipped);
- the read-outs `decpose`, `decshape`, `deccam` start as
  INIT_DECODER_XAVIER starts them (xavier, gain 0.01), which sets their
  seeded weights' scale; the other initializers are torch's and the
  published `torch.randn` position, and set only the scale of the seeded
  weights (`bench/synth.py:seeded_weights`);
- drop_path and dropout are left out: the model is in inference.
"""

from __future__ import annotations

import torch
from torch import nn

from .lbs import SmplParams
from .smpl_model import smpl_49
from .vit import ViT

# hmr_vit_transformer.yaml's trunk (`vit()`) and SMPL_HEAD.TRANSFORMER_DECODER
VIT_H = {"img_size": (256, 192), "patch_size": 16, "embed_dim": 1280, "depth": 32,
         "num_heads": 16, "mlp_ratio": 4}
DECODER = {"dim": 1024, "depth": 6, "heads": 8, "dim_head": 64, "mlp_dim": 1024}
FOCAL_LENGTH = 5000.0
MEAN_POSE_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)   # the identity, rows a1 and a2
MEAN_CAM = (0.9, 0.0, 0.0)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """HMR 2.0's 6D -> (N, 3, 3): `x.reshape(-1, 2, 3).permute(0, 2, 1)`,
    then Gram-Schmidt on the two columns."""
    x = x.reshape(-1, 2, 3).permute(0, 2, 1)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = a1 / a1.norm(dim=1, keepdim=True).clamp_min(1e-12)
    u = a2 - (b1 * a2).sum(dim=1, keepdim=True) * b1
    b2 = u / u.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b3 = torch.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over `heads` heads of (B, N, heads * d)."""
    b, n, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).permute(0, 2, 1, 3)

    q, k, v = split(q), split(k), split(v)
    dots = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    out = torch.matmul(torch.softmax(dots, dim=-1), v)
    return out.permute(0, 2, 1, 3).reshape(b, n, inner)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(attend(q, k, v, self.heads))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, heads * dim_head * 2, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(attend(self.to_q(x), k, v, self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # indices as published: Linear, GELU, Dropout, Linear
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
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
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head)),
                PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
                PreNorm(dim, FeedForward(dim, mlp_dim)),
            ]) for _ in range(depth)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head, mlp_dim,
                                                context_dim)

    def forward(self, token: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.to_token_embedding(token)
        x = x + self.pos_embedding[:, :x.shape[1]]
        return self.transformer(x, context=context)


class Hmr2Head(nn.Module):
    """`SMPLTransformerDecoderHead` at `hmr_vit_transformer.yaml`'s
    settings: depth 6, heads 8, dim_head 64, mlp_dim 1024, the token 1024
    wide, context_dim 1280, a zero input token, IEF_ITERS 1."""

    def __init__(self, context_dim: int = 1280, dim: int = 1024, depth: int = 6,
                 heads: int = 8, dim_head: int = 64, mlp_dim: int = 1024):
        super().__init__()
        self.transformer = TransformerDecoder(dim, depth, heads, dim_head, mlp_dim, context_dim)
        self.decpose = nn.Linear(dim, 24 * 6)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        for layer in (self.decpose, self.decshape, self.deccam):
            nn.init.xavier_uniform_(layer.weight, gain=0.01)
        self.register_buffer("init_body_pose", torch.tensor(MEAN_POSE_6D * 24)[None])
        self.register_buffer("init_betas", torch.zeros(1, 10))
        self.register_buffer("init_cam", torch.tensor(MEAN_CAM)[None])

    def forward(self, features: torch.Tensor):
        b = features.shape[0]
        context = features.flatten(2).permute(0, 2, 1)     # 'b c h w -> b (h w) c'
        token = torch.zeros(b, 1, 1, device=features.device)
        out = self.transformer(token, context=context)[:, 0]
        pose = self.decpose(out) + self.init_body_pose.expand(b, -1)
        betas = self.decshape(out) + self.init_betas.expand(b, -1)
        cam = self.deccam(out) + self.init_cam.expand(b, -1)
        return rot6d_to_rotmat(pose).view(b, 24, 3, 3), betas, cam


class HMR2(nn.Module):
    """HMR 2.0 on the benchmark's batch (`preprocess.py` at `cfg.img_res`):
    the outputs under the port's names. `trunk` and `decoder` are the
    widths (`ViT`'s and `Hmr2Head`'s arguments), the published ones by
    default."""

    def __init__(self, cfg, trunk: dict = VIT_H, decoder: dict = DECODER):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(**trunk)
        self.head = Hmr2Head(context_dim=self.backbone.embed_dim, **decoder)

    def forward(self, batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict:
        img = batch["img"].permute(0, 3, 1, 2)
        cut = (img.shape[-1] - self.backbone.img_size[1]) // 2
        rotmat, betas, cam = self.head(self.backbone(img[:, :, :, cut:img.shape[-1] - cut]))
        vertices, joints3d = smpl_49(smpl, betas, rotmat)
        res = self.cfg.img_res
        cam_t = torch.stack([cam[:, 1], cam[:, 2],
                             2 * FOCAL_LENGTH / (res * cam[:, 0] + 1e-9)], dim=-1)
        points = joints3d + cam_t[:, None]
        joints2d = FOCAL_LENGTH * points[..., :2] / points[..., 2:] / (res / 2.0)
        return {"pred_pose": rotmat, "pred_shape": betas, "pred_cam": cam,
                "smpl_vertices": vertices, "smpl_joints3d": joints3d,
                "smpl_joints2d": joints2d, "pred_cam_t": cam_t}
