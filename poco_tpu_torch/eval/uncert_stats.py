"""Per-joint uncertainty statistics tracking across training/validation.

Reference contract: pocolib/utils/poco_utils.py:97-294 (POCOUtils) —
per-joint uncertainty and per-joint pose-error distributions accumulated
with AverageMeters and logged as TensorBoard histograms/scalars every N
epochs. Here the tracker keeps the same per-joint min/mean/max meters and
writes JSON summaries (plus optional histogram arrays) into the logdir,
without the reference's exec/eval-built dynamic attributes (port of
`poco_tpu.eval.uncert_stats`).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from ..constants import SMPL_JOINT_NAMES
from ..utils.kp_utils import AverageMeter
from .uncertainty import prepare_uncert


class UncertStatsTracker:
    """Accumulates per-joint uncertainty (and optional error) stats.

    Args:
        loss_ver: for prepare_uncert collapsing.
        exclude_uncert_idx: joints excluded from the uncertainty head.
    """

    def __init__(
        self,
        loss_ver: str = "norm_flow_res_gaus",
        exclude_uncert_idx: tuple[int, ...] = (),
    ):
        self.loss_ver = loss_ver
        self.joint_names = [
            n for j, n in enumerate(SMPL_JOINT_NAMES)
            if j not in exclude_uncert_idx
        ]
        self.reset()

    def reset(self) -> None:
        self.meters = {n: AverageMeter() for n in self.joint_names}
        self.error_meters = {n: AverageMeter() for n in self.joint_names}
        self._samples: list[np.ndarray] = []

    def update(
        self,
        var_pose: np.ndarray,
        pose_error: np.ndarray | None = None,
        keep_histogram: bool = False,
    ) -> None:
        """Accumulate a batch.

        Args:
            var_pose: raw head output (B, P[, 3, 3]).
            pose_error: optional (B, P) per-joint pose errors.
        """
        var = prepare_uncert(var_pose, loss_ver=self.loss_ver)
        if keep_histogram:
            self._samples.append(var)
        for j, name in enumerate(self.joint_names):
            if j >= var.shape[1]:
                break
            self.meters[name].update(float(var[:, j].mean()), n=var.shape[0])
            if pose_error is not None:
                self.error_meters[name].update(
                    float(pose_error[:, j].mean()), n=var.shape[0]
                )

    def summary(self) -> dict:
        out = {
            "uncert_mean": {n: m.avg for n, m in self.meters.items()},
            "uncert_min": {n: m.min for n, m in self.meters.items()},
            "uncert_max": {n: m.max for n, m in self.meters.items()},
        }
        if any(m.count for m in self.error_meters.values()):
            out["pose_error_mean"] = {
                n: m.avg for n, m in self.error_meters.items()
            }
        return out

    def histogram(self, bins: int = 20) -> dict | None:
        """Pooled per-joint histograms (TB-histogram equivalent)."""
        if not self._samples:
            return None
        var = np.concatenate(self._samples)
        edges = np.linspace(0.0, 1.0, bins + 1)
        return {
            name: np.histogram(var[:, j], bins=edges)[0].tolist()
            for j, name in enumerate(self.joint_names)
            if j < var.shape[1]
        }

    def dump(self, logdir: str, tag: str) -> str:
        payload = self.summary()
        hist = self.histogram()
        if hist:
            payload["histograms"] = hist
        path = osp.join(logdir, f"uncert_stats_{tag}.json")
        os.makedirs(logdir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path
