# Frozen copy of poco_tpu_torch/models/attention.py at commit 48ff100 (see __init__.py).
"""PARE's optional attention modules (torch, NCHW): co-attention and the
dot-product non-local block.

Port of `poco_tpu.models.attention` (reference pocolib/models/layers/
coattention.py:24-126 and non_local/dot_product.py:6-115). They are off
in every shipped config and part of the PARE head's option surface.
Submodule names are the JAX package's, so `state_dict_from_jax` carries
them by name.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BN_MOMENTUM, BatchNorm1d, batch_norm, conv


def _positions(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) -> (B, N, C)."""
    return x.flatten(2).transpose(1, 2)


class CoAttention(nn.Module):
    """Gated cross-branch co-attention between two (B, C, H, W) maps.

    `final_conv`: "simple" (one 1x1 conv with bias over the concat), or
    "single_k" / "double_k" (one or two [k x k conv, BN, ReLU]).
    """

    def __init__(self, n_channel: int, final_conv: str = "simple"):
        super().__init__()
        c = n_channel
        self.linear_e = nn.Linear(c, c, bias=False)
        self.gate = conv(c, 1, 1, padding=0)
        for tag in ("1", "2"):
            if final_conv == "simple":
                layer = conv(2 * c, c, 1, padding=0, bias=True)
            else:
                k = int(final_conv[-1])
                reps = 2 if final_conv.startswith("double") else 1
                layers = []
                for r in range(reps):
                    layers += [conv(2 * c if r == 0 else c, c, k), batch_norm(c), nn.ReLU()]
                layer = nn.Sequential(*layers)
            setattr(self, f"final_conv_{tag}", layer)

    def forward(
        self, input_1: torch.Tensor, input_2: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        shape = input_1.shape
        exemplar, query = _positions(input_1), _positions(input_2)   # (B, N, C)
        attn = torch.einsum("bnc,bmc->bnm", self.linear_e(exemplar), query)
        a1 = torch.softmax(attn, dim=1)                 # over exemplar positions
        b1 = torch.softmax(attn.transpose(1, 2), dim=1)
        query_att = torch.einsum("bnc,bnm->bmc", exemplar, a1)
        exemplar_att = torch.einsum("bmc,bmn->bnc", query, b1)
        input1_att = exemplar_att.transpose(1, 2).reshape(shape)
        input2_att = query_att.transpose(1, 2).reshape(shape)
        input1_att = input1_att * torch.sigmoid(self.gate(input1_att))
        input2_att = input2_att * torch.sigmoid(self.gate(input2_att))
        return (
            self.final_conv_1(torch.cat([input1_att, input_1], dim=1)),
            self.final_conv_2(torch.cat([input2_att, input_2], dim=1)),
        )


class NonLocalBlock(nn.Module):
    """Dot-product non-local block over (B, C, *spatial).

    The residual projection `w` and the scale of its BN `w_bn` start at
    zero, so the block starts as the identity (dot_product.py:41-47).
    """

    def __init__(self, in_channels: int, inter_channels: int | None = None,
                 use_bn: bool = True):
        super().__init__()
        inter = inter_channels or max(in_channels // 2, 1)
        self.g = nn.Linear(in_channels, inter)
        self.theta = nn.Linear(in_channels, inter)
        self.phi = nn.Linear(in_channels, inter)
        self.w = nn.Linear(inter, in_channels)
        nn.init.zeros_(self.w.weight)
        nn.init.zeros_(self.w.bias)
        self.w_bn = None
        if use_bn:
            self.w_bn = BatchNorm1d(in_channels, eps=1e-5, momentum=BN_MOMENTUM)
            nn.init.zeros_(self.w_bn.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = _positions(x)                              # (B, N, C)
        f = torch.einsum(
            "bnc,bmc->bnm", self.theta(flat), self.phi(flat)
        ) / flat.shape[1]
        w = self.w(torch.einsum("bnm,bmc->bnc", f, self.g(flat)))
        if self.w_bn is not None:
            w = self.w_bn(w.transpose(1, 2)).transpose(1, 2)
        return (w + flat).transpose(1, 2).reshape(x.shape)
