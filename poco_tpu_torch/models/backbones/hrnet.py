"""HRNet classification backbone (torch, NCHW): the CLIFF HRNet-W48-cls.

Port of `poco_tpu.models.backbones.hrnet.HRNet(variant="cls")`: stem ->
Bottleneck layer1 -> 3 multi-resolution stages with fusion -> the
classification head (incremental Bottlenecks, strided downsampling, 1x1
conv to 2048, global average pool) giving a (B, 2048) vector
(reference pocolib/models/backbone/hrnet_cls.py:250-486). Attribute
names are the reference's (`transition1`, `stage2`, `incre_modules`,
`downsamp_modules`, `final_layer`, ...).

Stage schedule: stage2 = 1 module x 2 branches, stage3 = 4 x 3,
stage4 = 3 x 4, all 4-block BASIC branches with SUM fusion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BasicBlock, Bottleneck, ResLayer, batch_norm, conv, upsample_nearest

STAGE_MODULES = {2: 1, 3: 4, 4: 3}  # modules per stage
STAGE_BLOCKS = 4                    # BASIC blocks per branch
HEAD_CHANNELS = (32, 64, 128, 256)  # cls-head Bottleneck widths
NUM_FEATURES = 2048


class HRModule(nn.Module):
    """One multi-resolution module: parallel branches + full fusion.

    fuse_layers[i][j] brings branch j to branch i's resolution: a 1x1
    conv + BN then nearest upsampling for j > i, (i - j) strided 3x3
    convs for j < i (ReLU between them), None for j == i.
    """

    def __init__(self, channels: list[int]):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            ResLayer(BasicBlock, c, c, STAGE_BLOCKS) for c in channels
        )
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        conv(channels[j], channels[i], 1, padding=0),
                        batch_norm(channels[i]),
                    ))
                elif j == i:
                    row.append(None)
                else:
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = channels[i] if last else channels[j]
                        layers = [conv(channels[j], out, 3, 2), batch_norm(out)]
                        if not last:
                            layers.append(nn.ReLU())
                        steps.append(nn.Sequential(*layers))
                    row.append(nn.Sequential(*steps))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    z = ys[j]
                elif j > i:
                    z = upsample_nearest(layer(ys[j]), 2 ** (j - i))
                else:
                    z = layer(ys[j])
                acc = z if acc is None else acc + z
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet-cls: (B, 3, H, W) -> (B, 2048) pooled feature.

    Args:
        width: base branch width (48 for HRNet-W48); tests build it narrow.
    """

    def __init__(self, width: int = 48):
        super().__init__()
        self.conv1 = conv(3, 64, 3, 2)
        self.bn1 = batch_norm(64)
        self.conv2 = conv(64, 64, 3, 2)
        self.bn2 = batch_norm(64)
        self.layer1 = ResLayer(Bottleneck, 64, 64, 4)

        prev = [64 * Bottleneck.expansion]
        for stage in (2, 3, 4):
            chans = [width * 2**i for i in range(stage)]
            transition = []
            for i, c in enumerate(chans):
                if i < len(prev):
                    transition.append(
                        None if prev[i] == c else nn.Sequential(
                            conv(prev[i], c, 3), batch_norm(c), nn.ReLU()
                        )
                    )
                else:
                    steps = []
                    for k in range(i + 1 - len(prev)):
                        out = c if k == i - len(prev) else prev[-1]
                        steps.append(nn.Sequential(
                            conv(prev[-1], out, 3, 2), batch_norm(out), nn.ReLU()
                        ))
                    transition.append(nn.Sequential(*steps))
            setattr(self, f"transition{stage - 1}", nn.ModuleList(transition))
            setattr(self, f"stage{stage}", nn.Sequential(
                *[HRModule(chans) for _ in range(STAGE_MODULES[stage])]
            ))
            prev = chans

        self.incre_modules = nn.ModuleList(
            ResLayer(Bottleneck, c_in, c_head, 1)
            for c_in, c_head in zip(prev, HEAD_CHANNELS)
        )
        self.downsamp_modules = nn.ModuleList(
            nn.Sequential(
                conv(HEAD_CHANNELS[i] * 4, HEAD_CHANNELS[i + 1] * 4, 3, 2, bias=True),
                batch_norm(HEAD_CHANNELS[i + 1] * 4),
                nn.ReLU(),
            )
            for i in range(3)
        )
        self.final_layer = nn.Sequential(
            conv(HEAD_CHANNELS[3] * 4, NUM_FEATURES, 1, padding=0, bias=True),
            batch_norm(NUM_FEATURES),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        xs = [self.layer1(y)]
        for stage in (2, 3, 4):
            transition = getattr(self, f"transition{stage - 1}")
            xs = [
                xs[i] if t is None else t(xs[-1])
                for i, t in enumerate(transition)
            ]
            xs = getattr(self, f"stage{stage}")(xs)

        y = self.incre_modules[0](xs[0])
        for i in range(3):
            y = self.incre_modules[i + 1](xs[i + 1]) + self.downsamp_modules[i](y)
        y = self.final_layer(y)
        return y.mean(dim=(2, 3))


def hrnet_w48_cls() -> HRNet:
    """CLIFF backbone: (B, 3, 224, 224) -> (B, 2048)."""
    return HRNet(width=48)
