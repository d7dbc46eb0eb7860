"""Shared backbone building blocks (torch, NCHW).

Port of `poco_tpu.models.backbones.common` without its TPU layout
rewrites (lane-padded convs and BN, the space-to-depth stem): those
compute the same math on the same logical parameter shapes, which these
plain modules hold. Attribute names follow the reference torch modules
(pocolib/models/backbone/{hrnet,hrnet_cls,resnet}.py, torchvision), so a
reference state_dict loads as it is. Symmetric `k // 2` padding, BN eps
1e-5 and momentum 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1


def conv(
    in_ch: int,
    out_ch: int,
    kernel: int,
    stride: int = 1,
    padding: int | None = None,
    bias: bool = False,
) -> nn.Conv2d:
    if padding is None:
        padding = kernel // 2
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = batch_norm(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (expansion 4). `groups` and
    `base_width` follow torchvision, so the same block makes the ResNeXt
    and wide-ResNet trunks."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1, padding=0)
        self.bn1 = batch_norm(width)
        self.conv2 = nn.Conv2d(
            width, width, 3, stride, 1, groups=groups, bias=False
        )
        self.bn2 = batch_norm(width)
        self.conv3 = conv(width, planes * 4, 1, padding=0)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


def ResLayer(
    block, inplanes: int, planes: int, num_blocks: int, stride: int = 1,
    groups: int = 1, base_width: int = 64,
):
    """Sequence of residual blocks, torch `_make_layer` equivalent: the
    first block gets a 1x1 conv + BN `downsample` where the shape changes.
    `groups` / `base_width` go to Bottleneck blocks only."""
    out = planes * block.expansion
    downsample = None
    if stride != 1 or inplanes != out:
        downsample = nn.Sequential(
            conv(inplanes, out, 1, stride, padding=0), batch_norm(out)
        )
    extra = {"groups": groups, "base_width": base_width} if block is Bottleneck else {}
    layers = [block(inplanes, planes, stride, downsample, **extra)]
    layers += [block(out, planes, **extra) for _ in range(1, num_blocks)]
    return nn.Sequential(*layers)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact integer-factor nearest upsampling (NCHW)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True (NCHW): output pixel i
    samples input coordinate i * (in - 1) / (out - 1)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
