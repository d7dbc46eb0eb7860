"""Checks of the training path, shared by `chip_smoke.py` and the tests.

Two fp32 runs of one train-mode forward (card and CPU, or the port and
the JAX package) differ by rounding, and in a deep net at a small batch
that rounding grows to about 1e-4 of an activation at the last layers.
Wherever it moves a ReLU's input across 0, the two backward passes differ
by the whole gradient that unit passes back, not by rounding: a handful
of flipped units in millions moves a backbone's gradient by percents in
relative L2, which says nothing of whether the two implementations agree.
`ReluMasks` takes that branch out of the comparison: it records which
units a reference forward (float64) passed, and makes later forwards take
the same branches, so the gradients then compared differ by rounding
alone. `flips` counts the units whose own input disagreed.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


class ReluMasks:
    """The pass mask (input > 0) of every `F.relu` call of a forward, in
    call order (`nn.ReLU` calls `F.relu` too)."""

    def __init__(self):
        self.masks: list[torch.Tensor] = []
        self._flips: list[torch.Tensor] = []

    @property
    def flips(self) -> int:
        """Units the last replayed forward saw on the other side of 0."""
        return int(sum(f.sum().item() for f in self._flips))

    @property
    def units(self) -> int:
        """Units of the recorded forward's ReLUs."""
        return sum(m.numel() for m in self.masks)

    @contextlib.contextmanager
    def record(self):
        """Run `F.relu` as it is and keep each call's mask (on the CPU)."""
        relu = F.relu
        self.masks = []

        def recording(x, inplace=False):
            self.masks.append((x.detach() > 0).cpu())
            return relu(x, inplace=inplace)

        F.relu = recording
        try:
            yield self
        finally:
            F.relu = relu

    @contextlib.contextmanager
    def replay(self):
        """`F.relu(x)` becomes x * mask, the recorded mask of the same
        call, and counts the units whose own sign disagrees (`flips`).
        Raises if the forward calls `F.relu` at another shape or
        more often than the recorded one did."""
        relu = F.relu
        calls = iter(self.masks)
        self._flips = []

        def replaying(x, inplace=False):
            mask = next(calls, None)
            if mask is None or mask.shape != x.shape:
                raise RuntimeError(f"ReluMasks.replay: no recorded mask for a relu of {tuple(x.shape)}")
            mask = mask.to(x.device)
            self._flips.append(((x.detach() > 0) != mask).sum())
            return x * mask.to(x.dtype)

        F.relu = replaying
        try:
            yield self
        finally:
            F.relu = relu
