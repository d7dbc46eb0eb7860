"""HRNet backbones (torch, NCHW): classification (W48-cls) and pose (W32).

Port of `poco_tpu.models.backbones.hrnet.HRNet`. One trunk (stem ->
Bottleneck layer1 -> 3 multi-resolution stages with fusion) feeds one of
two ends:

  * `variant="cls"`, the CLIFF backbone: the classification head
    (incremental Bottlenecks, strided downsampling, 1x1 conv to 2048,
    global average pool) gives a (B, 2048) vector (reference
    pocolib/models/backbone/hrnet_cls.py:250-486);
  * `variant="pose"`, the PARE backbone: the four branches merged on the
    1/4-resolution grid (bilinear x2 + conv + BN + ReLU chains, or plain
    interpolation) and concatenated, (B, 15w, H/4, W/4): (B, 480, 56, 56)
    for HRNet-W32 at 224 px (reference pocolib/models/backbone/hrnet.py:
    437-527). The reference pose net's heatmap `final_layer` is not built:
    nothing reads it.

Attribute names are the reference's (`transition1`, `stage2`,
`incre_modules`, `downsamp_modules`, `final_layer`, `upsample_stage_2`,
...). Stage schedule: stage2 = 1 module x 2 branches, stage3 = 4 x 3,
stage4 = 3 x 4, all 4-block BASIC branches with SUM fusion.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    BasicBlock,
    Bottleneck,
    ResLayer,
    batch_norm,
    conv,
    resize_bilinear_align_corners,
    upsample_nearest,
)

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
    """HRNet: (B, 3, H, W) -> (B, 2048) pooled feature ("cls") or the
    (B, 15 * width, H/4, W/4) merged map ("pose").

    Args:
        width: base branch width (48 for W48-cls, 32 for W32); tests build
            it narrow.
        variant: "cls" or "pose".
        use_conv: pose only; upsample with bilinear + conv chains (the
            `hrnet_w32` default) instead of plain interpolation.
        downsample: pose only; merge on the lowest resolution instead.
    """

    def __init__(
        self,
        width: int = 48,
        variant: str = "cls",
        use_conv: bool = True,
        downsample: bool = False,
    ):
        super().__init__()
        if variant not in ("cls", "pose"):
            raise ValueError(f"HRNet variant {variant!r}: 'cls' or 'pose'")
        self.variant = variant
        self.use_conv = use_conv
        self.downsample = downsample
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

        if variant == "cls":
            self._build_cls_head(prev)
            self.out_channels = NUM_FEATURES
        else:
            self._build_pose_merge(prev)
            self.out_channels = sum(prev)

    def _build_cls_head(self, chans: list[int]) -> None:
        self.incre_modules = nn.ModuleList(
            ResLayer(Bottleneck, c_in, c_head, 1)
            for c_in, c_head in zip(chans, HEAD_CHANNELS)
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

    def _build_pose_merge(self, chans: list[int]) -> None:
        """`upsample_stage_{b+1}` repeats [Upsample x2, conv, BN, ReLU] b
        times (conv at index 4k+1, BN at 4k+2); `downsample_stage_{b+1}`
        repeats [strided conv, BN, ReLU] 3-b times."""
        if not self.use_conv:
            return
        if self.downsample:
            for b in range(3):
                layers = []
                for _ in range(3 - b):
                    layers += [conv(chans[b], chans[b], 3, 2), batch_norm(chans[b]), nn.ReLU()]
                setattr(self, f"downsample_stage_{b + 1}", nn.Sequential(*layers))
            return
        for b in range(1, 4):
            layers = []
            for _ in range(b):
                layers += [
                    nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                    conv(chans[b], chans[b], 3),
                    batch_norm(chans[b]),
                    nn.ReLU(),
                ]
            setattr(self, f"upsample_stage_{b + 1}", nn.Sequential(*layers))

    def trunk(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Stem, layer1 and the three stages: the four branch maps."""
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
        return xs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.trunk(x)
        if self.variant == "cls":
            return self._cls_head(xs)
        return self._pose_merge(xs)

    def _cls_head(self, xs: list[torch.Tensor]) -> torch.Tensor:
        y = self.incre_modules[0](xs[0])
        for i in range(3):
            y = self.incre_modules[i + 1](xs[i + 1]) + self.downsamp_modules[i](y)
        y = self.final_layer(y)
        return y.mean(dim=(2, 3))

    def _pose_merge(self, xs: list[torch.Tensor]) -> torch.Tensor:
        if self.downsample:
            tgt_h, tgt_w = xs[3].shape[2:]
            outs = [
                getattr(self, f"downsample_stage_{b + 1}")(xs[b]) if self.use_conv
                else resize_bilinear_align_corners(xs[b], tgt_h, tgt_w)
                for b in range(3)
            ]
            return torch.cat(outs + [xs[3]], dim=1)
        tgt_h, tgt_w = xs[0].shape[2:]
        outs = [xs[0]] + [
            getattr(self, f"upsample_stage_{b + 1}")(xs[b]) if self.use_conv
            else resize_bilinear_align_corners(xs[b], tgt_h, tgt_w)
            for b in range(1, 4)
        ]
        return torch.cat(outs, dim=1)


def hrnet_w48_cls() -> HRNet:
    """CLIFF backbone: (B, 3, 224, 224) -> (B, 2048)."""
    return HRNet(width=48)


def hrnet_w32() -> HRNet:
    """PARE backbone: (B, 3, 224, 224) -> (B, 480, 56, 56)."""
    return HRNet(width=32, variant="pose", use_conv=True)


def hrnet_w48() -> HRNet:
    """Pose HRNet-W48, interpolation merge: (B, 720, H/4, W/4)."""
    return HRNet(width=48, variant="pose", use_conv=False)


def hrnet_w64() -> HRNet:
    """Pose HRNet-W64, interpolation merge: (B, 960, H/4, W/4)."""
    return HRNet(width=64, variant="pose", use_conv=False)
