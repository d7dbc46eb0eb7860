"""Tiny CNN backbones for tests and CPU smoke runs (torch, NCHW).

Port of `poco_tpu.models.backbones.tiny`: four strided 3x3 conv + BN +
ReLU blocks, `conv1..4` / `bn1..4`. The "cls" variant pools to (B, 4w);
the "pose" variant stops after its third (stride-1) block, at a
(B, w, 56, 56) map for a 224 px crop. They run the same head, SMPL,
uncertainty and flow machinery as the real backbones at a fraction of
the cost (`configs/tiny_smoke.yaml`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, conv


class TinyBackbone(nn.Module):
    def __init__(self, variant: str = "cls", width: int = 32):
        super().__init__()
        if variant not in ("cls", "pose"):
            raise ValueError(f"tiny backbone variant {variant!r}: cls or pose")
        self.variant = variant
        w = width
        self.conv1, self.bn1 = conv(3, w, 3, 2), batch_norm(w)
        self.conv2, self.bn2 = conv(w, w, 3, 2), batch_norm(w)
        if variant == "pose":
            self.conv3, self.bn3 = conv(w, w, 3, 1), batch_norm(w)
            self.out_channels = w
        else:
            self.conv3, self.bn3 = conv(w, 2 * w, 3, 2), batch_norm(2 * w)
            self.conv4, self.bn4 = conv(2 * w, 4 * w, 3, 2), batch_norm(4 * w)
            self.out_channels = 4 * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = F.relu(self.bn3(self.conv3(y)))
        if self.variant == "pose":
            return y
        y = F.relu(self.bn4(self.conv4(y)))
        return y.mean(dim=(2, 3))


def tiny_cls() -> TinyBackbone:
    return TinyBackbone(variant="cls", width=32)


def tiny_pose() -> TinyBackbone:
    return TinyBackbone(variant="pose", width=32)
