# Frozen copy of poco_tpu_torch/models/backbones/common.py at commit 48ff100 (see __init__.py).
"""Shared backbone building blocks (torch, NCHW).

Port of `poco_tpu.models.backbones.common` without its TPU layout
rewrites (lane-padded convs and BN, the space-to-depth stem): those
compute the same math on the same logical parameter shapes, which these
plain modules hold. Attribute names follow the reference torch modules
(pocolib/models/backbone/{hrnet,hrnet_cls,resnet}.py, torchvision), so a
reference state_dict loads as it is. Symmetric `k // 2` padding, BN eps
1e-5 and momentum 0.1; in training, BN's running variance takes the
biased batch variance, as flax's BatchNorm does (`FlaxVarianceBN`, applied
by `flax_variance_update` around a model's forward).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from . import distributed

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


class FlaxVarianceBN:
    """Mixin for torch's batch norms whose running variance moves toward
    the biased batch variance (sum of squares over n), as flax's
    `nn.BatchNorm` updates `batch_stats.var`, instead of torch's unbiased
    one (over n - 1). The normalization itself is the same in both.

    torch's own update runs in the layer; `flax_variance_update` corrects
    it for all of a model's layers at once around the model's forward. The
    layer only records the n it normalized over while that is active.

    In training with more than one data shard the statistics are the
    global batch's, as flax takes them over a batch sharded across chips
    (`_global_forward`, over the data group); n is then the global count.
    """

    batch_counts: list[int] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and distributed.data_count() > 1:
            return self._global_forward(x)
        if self.batch_counts is not None:
            self.batch_counts.append(x.numel() // x.shape[1])
        return super().forward(x)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Batch norm over the rows of every data shard (each holds as many).

        Two passes, each a sum over processes that carries a gradient
        (`distributed.all_reduce_sum`: two collectives a forward, two in
        the backward): the per-channel mean, then the mean square of x
        less it, so the biased variance is as precise as one process's.
        In fp32; the running statistics move as torch's layer moves them,
        with the global n."""
        self._check_input_dim(x)
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        view = (1, c) + (1,) * (x.ndim - 2)
        xf = x.float()
        n = x.numel() // c * distributed.data_count()
        mean = distributed.all_reduce_sum(xf.sum(dims)) / n
        xc = xf - mean.view(view)
        var = distributed.all_reduce_sum((xc * xc).sum(dims)) / n
        y = xc * torch.rsqrt(var + self.eps).view(view)
        if self.affine:
            y = y * self.weight.view(view) + self.bias.view(view)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                f = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                     else self.momentum)
                self.running_mean.mul_(1.0 - f).add_(mean.to(self.running_mean.dtype), alpha=f)
                self.running_var.mul_(1.0 - f).add_(
                    (var * (n / max(n - 1, 1))).to(self.running_var.dtype), alpha=f)
            if self.batch_counts is not None:
                self.batch_counts.append(n)
        return y.to(x.dtype)


@contextlib.contextmanager
def flax_variance_update(model: nn.Module):
    """Around a forward of `model`: the running variances of its
    `FlaxVarianceBN` layers in training take flax's update instead of
    torch's. With keep = 1 - momentum, torch stores new = keep * old +
    momentum * var * n / (n - 1), and new - (new - keep * old) / n = keep *
    old + momentum * var. The correction is four multi-tensor kernels over
    all the layers (a copy of each (C,) running variance before, three
    in-place passes after), not a pass over the activations. A layer with a
    momentum of 1 (no moving average: the statistics replaced by one
    batch's, as `utils.weights.calibrate_batchnorm` sets a random model's)
    or None keeps torch's value, and so does a layer the forward skips."""
    layers = [m for m in model.modules() if isinstance(m, FlaxVarianceBN) and m.training
              and m.track_running_stats and m.momentum not in (None, 1.0)]
    if not layers:
        yield
        return
    # through .data: autograd saved running_var with the batch-norm call
    # (its backward does not read it) and would refuse a version bump
    running = [m.running_var.data for m in layers]
    kept = torch._foreach_mul(running, [1.0 - m.momentum for m in layers])
    for m in layers:
        m.batch_counts = []
    try:
        yield
    finally:
        counts = [m.batch_counts for m in layers]
        for m in layers:
            m.batch_counts = None
    ran = [i for i, c in enumerate(counts) if c]
    if any(len(counts[i]) > 1 for i in ran):
        raise RuntimeError("flax_variance_update: a batch norm ran twice in one forward")
    if not ran:
        return
    new = [running[i] for i in ran]
    diff = torch._foreach_sub(new, [kept[i] for i in ran])
    torch._foreach_div_(diff, [float(counts[i][0]) for i in ran])
    torch._foreach_sub_(new, diff)


class BatchNorm2d(FlaxVarianceBN, nn.BatchNorm2d):
    pass


class BatchNorm1d(FlaxVarianceBN, nn.BatchNorm1d):
    pass


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=BN_MOMENTUM)


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
