"""ResNet backbones (torch, NCHW), torchvision's topology and names.

Port of `poco_tpu.models.backbones.resnet`: the trunk without the
classifier, returning the last feature map, (B, 2048, 7, 7) for resnet50
at 224 px (reference pocolib/models/backbone/resnet.py: the pre-pool
features that hmr_head / pare_head read). The stem's -inf pad and 3x3/2
max-pool is `MaxPool2d(3, 2, padding=1)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BasicBlock, Bottleneck, ResLayer, batch_norm


class ResNet(nn.Module):
    """Torchvision-style ResNet trunk: (B, 3, H, W) -> (B, C, H/32, W/32)."""

    def __init__(self, block, layers, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        inplanes = 64
        for i, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            setattr(self, f"layer{i + 1}", ResLayer(
                block, inplanes, planes, layers[i], stride,
                groups=groups, base_width=base_width,
            ))
            inplanes = planes * block.expansion
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
        return y


def resnet18() -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2))


def resnet34() -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3))


def resnet50() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3))


def resnet152() -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3))


def resnext50_32x4d() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), groups=32, base_width=4)


def resnext101_32x8d() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), groups=32, base_width=8)


def wide_resnet50_2() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), base_width=128)


def wide_resnet101_2() -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), base_width=128)
