"""POCO uncertainty head, `feat-pose-net` mode (torch).

Port of `poco_tpu.models.heads.poco_uncert.PocoUncertHead` for the CLIFF
configuration (reference pocolib/models/head/poco_head.py:14-154):
separate sigmoid encoders for the flattened predicted pose and for the
head features, concatenated (features first), then `uncert_fc1` with the
output activation gives the per-joint `var_pose`. Rows where
`gt_pose_cond_mask` is set feed the ground-truth pose instead of the
prediction (the reference's GT_POSE_COND calibration).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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
        if uncert_inp_type != "feat-pose-net":
            raise NotImplementedError(
                f"uncert_inp_type {uncert_inp_type!r}: only 'feat-pose-net' "
                "(the POCO-CLIFF configuration) is ported"
            )
        self.activation_type = activation_type
        self.sigma_dim = sigma_dim if "norm_flow" in loss_ver else 1
        self.out_width = num_uncert_outputs(
            loss_ver, self.sigma_dim, num_joints - len(exclude_uncert_idx)
        )
        width = num_neurons[0]
        self.uncert_fc_poseNet = nn.Linear(num_joints * 9, width)
        self.uncert_fc_featNet = nn.Linear(num_input_channels, width)
        self.uncert_fc1 = nn.Linear(2 * width, self.out_width)
        self.dropout = nn.Dropout(0.5)
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
        pose_inp = pred_pose.reshape(batch, -1)
        if gt_pose_rotmat is not None and gt_pose_cond_mask is not None:
            pose_inp = torch.where(
                gt_pose_cond_mask[:, None], gt_pose_rotmat.reshape(batch, -1),
                pose_inp,
            )
        pose_feats = torch.sigmoid(self.dropout(self.uncert_fc_poseNet(pose_inp)))
        x = torch.sigmoid(self.dropout(self.uncert_fc_featNet(uncert_feat)))
        x = self.uncert_fc1(torch.cat([x, pose_feats], dim=1))
        if self.use_dropout:
            x = self.dropout(x)
        var_pose = self._act(x)[:, : self.out_width]
        if self.sigma_dim == 9:
            var_pose = var_pose.reshape(batch, -1, 3, 3)
        return {"var_pose": var_pose}
