"""POCO uncertainty head: per-joint variance from pose-head features (torch).

Port of `poco_tpu.models.heads.poco_uncert.PocoUncertHead` (reference
pocolib/models/head/poco_head.py:14-154), in its three input modes:

  * "feat"          MLP over the pose head's `uncert_feat`;
  * "feat-pose"     the flattened predicted pose (24 * 9) concatenated
                    to the features before the MLP (POCO-PARE);
  * "feat-pose-net" separate sigmoid encoders for the pose and for the
                    features, concatenated (features first), then one
                    projection (POCO-CLIFF).

The MLP is `uncert_fc1..n`, each followed by dropout (when enabled) and
the output activation. Rows where `gt_pose_cond_mask` is set feed the
ground-truth pose instead of the prediction (the reference's
GT_POSE_COND calibration).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import Dropout

UNCERT_INP_TYPES = ("feat", "feat-pose", "feat-pose-net")


def num_uncert_outputs(loss_ver: str, sigma_dim: int, num_uncert_parts: int) -> int:
    """Output width per loss version (reference poco_head.py:84-94)."""
    if loss_ver in ("genG", "delta", "mse_genG"):
        return num_uncert_parts * 2 * sigma_dim
    if loss_ver == "gauss_genG":
        return num_uncert_parts * 3 * sigma_dim
    return num_uncert_parts * sigma_dim


class PocoUncertHead(nn.Module):
    def __init__(
        self,
        num_input_channels: int,
        num_neurons: Sequence[int] = (216,),
        sigma_dim: int = 1,
        activation_type: str = "sigmoid",
        use_dropout: bool = True,
        uncert_inp_type: str = "feat-pose-net",
        exclude_uncert_idx: Sequence[int] = (),
        loss_ver: str = "norm_flow_res_gaus",
        num_joints: int = 24,
    ):
        super().__init__()
        if uncert_inp_type not in UNCERT_INP_TYPES:
            raise ValueError(
                f"uncert_inp_type {uncert_inp_type!r}: one of {UNCERT_INP_TYPES}"
            )
        self.uncert_inp_type = uncert_inp_type
        self.activation_type = activation_type
        self.sigma_dim = sigma_dim if "norm_flow" in loss_ver else 1
        self.out_width = num_uncert_outputs(
            loss_ver, self.sigma_dim, num_joints - len(exclude_uncert_idx)
        )
        pose_width = num_joints * 9
        if uncert_inp_type == "feat-pose-net":
            width = num_neurons[0]
            self.uncert_fc_poseNet = nn.Linear(pose_width, width)
            self.uncert_fc_featNet = nn.Linear(num_input_channels, width)
            widths = [2 * width, self.out_width]
        else:
            num_in = num_input_channels + (pose_width if uncert_inp_type == "feat-pose" else 0)
            widths = [num_in, *num_neurons, self.out_width]
        for i in range(len(widths) - 1):
            setattr(self, f"uncert_fc{i + 1}", nn.Linear(widths[i], widths[i + 1]))
        self.num_fc = len(widths) - 1
        self.dropout = Dropout(0.5)
        self.use_dropout = use_dropout

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation_type == "sigmoid":
            return torch.sigmoid(x)
        if self.activation_type == "softplus":
            return nn.functional.softplus(x)
        return x

    def forward(
        self,
        uncert_feat: torch.Tensor,
        pred_pose: torch.Tensor,
        gt_pose_rotmat: torch.Tensor | None = None,
        gt_pose_cond_mask: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        """Args:
            uncert_feat: (B, C) pose-head features.
            pred_pose: (B, 24, 3, 3) predicted rotations.
            gt_pose_rotmat: optional (B, 24, 3, 3) GT rotations.
            gt_pose_cond_mask: optional (B,) bool; True rows use the GT.
        Returns:
            {"var_pose": (B, P*sigma_dim), or (B, P, 3, 3) if sigma_dim==9}.
        """
        batch = uncert_feat.shape[0]
        x = uncert_feat
        if "pose" in self.uncert_inp_type:
            pose_inp = pred_pose.reshape(batch, -1)
            if gt_pose_rotmat is not None and gt_pose_cond_mask is not None:
                pose_inp = torch.where(
                    gt_pose_cond_mask[:, None], gt_pose_rotmat.reshape(batch, -1),
                    pose_inp,
                )
            if self.uncert_inp_type == "feat-pose-net":
                pose_feats = torch.sigmoid(self.dropout(self.uncert_fc_poseNet(pose_inp)))
                x = torch.sigmoid(self.dropout(self.uncert_fc_featNet(x)))
                x = torch.cat([x, pose_feats], dim=1)
            else:
                x = torch.cat([x, pose_inp], dim=1)
        for i in range(1, self.num_fc + 1):
            x = getattr(self, f"uncert_fc{i}")(x)
            if self.use_dropout:
                x = self.dropout(x)
            x = self._act(x)
        var_pose = x[:, : self.out_width]
        if self.sigma_dim == 9:
            var_pose = var_pose.reshape(batch, -1, 3, 3)
        return {"var_pose": var_pose}
