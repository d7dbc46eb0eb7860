"""Keypoint utilities (port of `poco_tpu.utils.kp_utils`); so far only the
`AverageMeter` that the uncertainty statistics use."""

from __future__ import annotations


class AverageMeter:
    """Running avg/min/max tracker (reference eval_utils.py:183-201)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = -float("inf")

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.min = min(self.min, val)
        self.max = max(self.max, val)
