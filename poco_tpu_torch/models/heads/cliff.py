"""CLIFF bbox-conditioned iterative SMPL regressor head (torch).

Port of `poco_tpu.models.heads.cliff.CliffHead` (reference
pocolib/models/head/cliff_head.py:10-133): pooled backbone features
concatenated with the 3-d bbox descriptor, three iterations of
fc1(1024) -> fc2(1024) -> residual decoders for pose (24x6), shape (10)
and camera (3), starting from the SMPL mean parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.rotation import rot6d_to_rotmat
from ...smpl.mean_params import load_mean_params
from ..layers import Dropout


class CliffHead(nn.Module):
    def __init__(
        self,
        num_input_features: int = 2048,
        num_joints: int = 24,
        n_iter: int = 3,
        mean_params_path: str | None = None,
    ):
        super().__init__()
        self.num_input_features = num_input_features
        self.num_joints = num_joints
        self.n_iter = n_iter
        npose = num_joints * 6
        self.fc1 = nn.Linear(num_input_features + 3 + npose + 10 + 3, 1024)
        self.drop1 = Dropout(0.5)
        self.fc2 = nn.Linear(1024, 1024)
        self.drop2 = Dropout(0.5)
        self.decpose = nn.Linear(1024, npose)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        for dec in (self.decpose, self.decshape, self.deccam):
            nn.init.xavier_uniform_(dec.weight, gain=0.01)

        pose, shape, cam = load_mean_params(mean_params_path, num_joints)
        self.register_buffer("init_pose", torch.from_numpy(pose)[None])
        self.register_buffer("init_shape", torch.from_numpy(shape)[None])
        self.register_buffer("init_cam", torch.from_numpy(cam)[None])

    def forward(
        self, features: torch.Tensor, bbox_info: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """Args:
            features: (B, C) pooled features (or (B, C, H, W), pooled here).
            bbox_info: (B, 3) CLIFF bbox descriptor.
        Returns dict with pred_pose (B,24,3,3), pred_shape (B,10),
        pred_cam (B,3), pred_pose_6d (B,144), uncert_feat (B,C),
        body_feat2 (B,1024).
        """
        if features.ndim > 2:
            features = features.mean(dim=(2, 3))
        batch = features.shape[0]
        pred_pose = self.init_pose.expand(batch, -1)
        pred_shape = self.init_shape.expand(batch, -1)
        pred_cam = self.init_cam.expand(batch, -1)

        xc = None
        for _ in range(self.n_iter):
            xc = torch.cat(
                [features, bbox_info, pred_pose, pred_shape, pred_cam], dim=1
            )
            xc = self.drop1(self.fc1(xc))
            xc = self.drop2(self.fc2(xc))
            pred_pose = self.decpose(xc) + pred_pose
            pred_shape = self.decshape(xc) + pred_shape
            pred_cam = self.deccam(xc) + pred_cam

        pred_rotmat = rot6d_to_rotmat(pred_pose).reshape(
            batch, self.num_joints, 3, 3
        )
        return {
            "pred_pose": pred_rotmat,
            "pred_cam": pred_cam,
            "pred_shape": pred_shape,
            "pred_pose_6d": pred_pose,
            "uncert_feat": features,
            "body_feat2": xc,
        }

    def get_output_channels(self) -> int:
        return self.num_input_features
