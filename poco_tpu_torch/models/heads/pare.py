"""PARE part-attention SMPL regressor head (torch, NCHW).

Port of `poco_tpu.models.heads.pare.PareHead` (reference pocolib/models/
head/pare_head.py:35-969), with every option the JAX head takes:

  * dual conv branches over the backbone map, 2x [3x3 conv, BN, ReLU]
    each: the 2D keypoint branch and the 3D SMPL branch;
  * part attention from the keypoint branch: `part_segm` (J+1 logits,
    background dropped), `hm`, `hm_soft`, `part_segm_pool` or `attention`;
  * per-joint soft pooling of both branches (keypoint attention), or
    bilinear samples at the predicted keypoints when it is off;
  * per-joint pose MLPs (`PerPositionConv1x1` over a [24, 1] grid) and
    cam / shape MLPs over the flattened per-joint SMPL features, or the
    HMR-style iterative decoder, or iterative per-joint regression;
  * `same_branch_v1` in-head uncertainty and the `diff_branch` feature
    export read by the POCO uncertainty head;
  * co-attention, branch / final non-local blocks, branch iteration,
    soft attention and coordinate position encodings.

The JAX head's `lane_pad` is a TPU layout rewrite of the same math and
has no counterpart here. Submodule names are the reference's where the
converter maps them (`keypoint_deconv_layers.{3k}`, `pose_mlp`, ...;
poco_tpu/utils/checkpoint_convert.py:233-255) and the JAX package's for
the rest. A module exists exactly where the JAX head creates parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.rotation import rot6d_to_rotmat
from ...smpl.mean_params import load_mean_params
from ..attention import CoAttention, NonLocalBlock
from ..backbones.common import batch_norm, conv
from ..layers import (
    Dropout,
    PerPositionConv1x1,
    get_heatmap_preds,
    grid_sample_bilinear,
    keypoint_attention,
    softargmax2d,
)


def coord_maps(size: int, device=None) -> torch.Tensor:
    """(1, 2, size, size) normalized x and y coordinate channels
    (reference get_coord_maps, geometry.py:581-610)."""
    r = torch.arange(size, dtype=torch.float32, device=device) / (size - 1) * 2.0 - 1.0
    xx = r[None, :].expand(size, size)
    yy = r[:, None].expand(size, size)
    return torch.stack([xx, yy])[None]


def _deconv_branch(in_ch: int, filters) -> nn.Sequential:
    layers = []
    for f in filters:
        layers += [conv(in_ch, f, 3), batch_norm(f), nn.ReLU()]
        in_ch = f
    return nn.Sequential(*layers)


class PareHead(nn.Module):
    def __init__(
        self,
        num_input_features: int = 480,
        num_joints: int = 24,
        uncert_layer: str = "diff_branch",
        uncert_act: str = "sigmoid",
        softmax_temp: float = 1.0,
        num_deconv_layers: int = 2,
        num_deconv_filters: tuple[int, ...] = (128, 128),
        num_camera_params: int = 3,
        num_features_smpl: int = 64,
        final_conv_kernel: int = 1,
        use_heatmaps: str = "part_segm",
        use_keypoint_attention: bool = True,
        keypoint_attention_act: str = "softmax",
        use_scale_keypoint_attention: bool = False,
        use_hmr_regression: bool = False,
        iterative_regression: bool = False,
        iter_residual: bool = False,
        num_iterations: int = 3,
        pose_input_type: str = "feats.self_pose.shape.cam",
        shape_input_type: str = "feats.shape.cam",
        use_mean_camshape: bool = False,
        use_mean_pose: bool = False,
        use_coattention: bool = False,
        num_coattention_iter: int = 1,
        coattention_conv: str = "simple",
        use_branch_nonlocal: bool = False,
        use_final_nonlocal: bool = False,
        num_branch_iteration: int = 0,
        use_soft_attention: bool = False,
        use_position_encodings: bool = False,
        use_keypoint_features_for_smpl: bool = False,
        mean_params_path: str | None = None,
    ):
        super().__init__()
        nj = num_joints
        filters = [num_deconv_filters[i] for i in range(num_deconv_layers)]
        self.num_joints = nj
        self.uncert_layer = uncert_layer
        self.uncert_act = uncert_act
        self.softmax_temp = softmax_temp
        self.use_heatmaps = use_heatmaps
        self.keypoint_attention_act = keypoint_attention_act
        self.use_scale_keypoint_attention = use_scale_keypoint_attention
        self.num_iterations = num_iterations
        self.iter_residual = iter_residual
        self.pose_input_type = pose_input_type.split(".")
        self.shape_input_type = shape_input_type.split(".")
        self.use_mean_camshape = use_mean_camshape
        self.use_mean_pose = use_mean_pose
        self.num_coattention_iter = num_coattention_iter
        self.num_branch_iteration = num_branch_iteration
        self.use_position_encodings = use_position_encodings
        self.num_deconv_filters = tuple(num_deconv_filters)
        # The reference's override chain (pare_head.py:112-132): part_segm
        # and attention force keypoint attention on, soft attention forces
        # HMR regression and keypoint features for SMPL, co-attention
        # forces the latter off.
        self.use_kp_attention = (
            use_heatmaps in ("part_segm", "attention") or use_keypoint_attention
        )
        self.use_hmr = use_hmr_regression or use_soft_attention
        self.use_kp_feats_for_smpl = use_soft_attention or (
            not use_coattention and use_keypoint_features_for_smpl
        )
        self.iterative = iterative_regression and not self.use_hmr
        c_branch = num_deconv_filters[-1]

        pose, shape, cam = load_mean_params(mean_params_path, nj)
        self.register_buffer("init_pose", torch.from_numpy(pose)[None])
        self.register_buffer("init_shape", torch.from_numpy(shape)[None])
        self.register_buffer("init_cam", torch.from_numpy(cam)[None])

        c_in = num_input_features + (2 if use_position_encodings else 0)
        self.keypoint_deconv_layers = _deconv_branch(c_in, filters)
        if not self.use_kp_feats_for_smpl:
            self.smpl_deconv_layers = _deconv_branch(c_in, filters)
        kp_out = nj + 1 if use_heatmaps in ("part_segm", "part_segm_pool") else nj
        self._final_layer("keypoint_final_layer", c_branch, kp_out,
                          use_soft_attention, final_conv_kernel)
        self._final_layer("smpl_final_layer", c_branch, num_features_smpl,
                          use_soft_attention, final_conv_kernel)

        if use_coattention:
            self.coattention = CoAttention(c_branch, coattention_conv)
        if use_branch_nonlocal:
            self.branch_2d_nonlocal = NonLocalBlock(c_branch)
            if not self.use_kp_feats_for_smpl:
                self.branch_3d_nonlocal = NonLocalBlock(c_branch)
        if use_final_nonlocal and not self.use_hmr:
            self.final_pose_nonlocal = NonLocalBlock(c_branch)
            self.final_shape_nonlocal = NonLocalBlock(num_features_smpl)
        if num_branch_iteration > 0:
            self.branch_iter_3d_nonlocal = NonLocalBlock(c_branch)

        smpl_flat = num_features_smpl * nj
        if self.use_hmr:
            self.fc1 = nn.Linear(smpl_flat + nj * 6 + 10 + num_camera_params, 1024)
            self.fc2 = nn.Linear(1024, 1024)
            self.decpose = nn.Linear(1024, nj * 6)
            self.decshape = nn.Linear(1024, 10)
            self.deccam = nn.Linear(1024, num_camera_params)
            for dec in (self.decpose, self.decshape, self.deccam):
                nn.init.xavier_uniform_(dec.weight, gain=0.01)
            self.drop1 = Dropout(0.5)
            self.drop2 = Dropout(0.5)
            return
        pose_in, shape_in = c_branch, smpl_flat
        if self.iterative:
            widths = {"self_pose": 6, "all_pose": 6 * nj, "shape": 10,
                      "cam": num_camera_params}
            pose_in += sum(widths[k] for k in self.pose_input_type if k in widths)
            shape_in += sum(
                widths[k] for k in self.shape_input_type
                if k in ("all_pose", "shape", "cam")
            )
        self.pose_mlp = PerPositionConv1x1(pose_in, 6, (nj, 1))
        self.cam_mlp = nn.Linear(shape_in, num_camera_params)
        self.shape_mlp = nn.Linear(shape_in, 10)
        # the JAX head creates it only where a final_preds call reads it
        if uncert_layer == "same_branch_v1" and (
            not self.iterative or use_coattention or num_branch_iteration > 0
        ):
            self.uncert_mlp = PerPositionConv1x1(c_branch, 1, (nj, 1))

    def _final_layer(self, name, c_in, c_out, soft_attention, kernel) -> None:
        """1x1 (or `kernel`) conv with bias, or with soft attention a
        3x3 conv (256) -> BN -> ReLU -> 1x1 conv (pare_head.py:195-227):
        modules `{name}_pre`, `{name}_prebn` and `{name}`."""
        if soft_attention:
            setattr(self, f"{name}_pre", conv(c_in, 256, 3))
            setattr(self, f"{name}_prebn", batch_norm(256))
            setattr(self, name, conv(256, c_out, 1, padding=0, bias=True))
        else:
            pad = 1 if kernel == 3 else 0
            setattr(self, name, conv(c_in, c_out, kernel, padding=pad, bias=True))

    def _apply_final(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, f"{name}_pre"):
            x = F.relu(getattr(self, f"{name}_prebn")(getattr(self, f"{name}_pre")(x)))
        return getattr(self, name)(x)

    def _part_attention(self, part_feats, output):
        """Heatmaps / segmentation -> attention map (pare_head.py:781-826)."""
        hm = self._apply_final("keypoint_final_layer", part_feats)
        mode = self.use_heatmaps
        if mode == "hm":
            kp, confidence = get_heatmap_preds(hm)
            output.update(pred_kp2d=kp, pred_kp2d_conf=confidence, pred_heatmaps_2d=hm)
        elif mode in ("part_segm", "part_segm_pool"):
            output["pred_segm_mask"] = hm
            hm = hm[:, 1:]
            if mode == "part_segm_pool":
                output["pred_kp2d"] = softargmax2d(hm, self.softmax_temp)[0]
        elif mode == "attention":
            output["pred_attention"] = hm
        else:  # "hm_soft", and the JAX head's fallback for any other mode
            output.update(pred_kp2d=softargmax2d(hm, self.softmax_temp)[0],
                          pred_heatmaps_2d=hm)
        return hm

    def _local_feats(self, smpl_feats, attention, output):
        """Per-joint pooling of both branches (pare_head.py:754-763):
        (B, C, J) pose features and (B, num_features_smpl, J)."""
        csf = self._apply_final("smpl_final_layer", smpl_feats)
        if not self.use_kp_attention:
            kp = output["pred_kp2d"]
            return grid_sample_bilinear(smpl_feats, kp), grid_sample_bilinear(csf, kp)
        return tuple(
            keypoint_attention(
                f, attention, act=self.keypoint_attention_act,
                use_scale=self.use_scale_keypoint_attention,
            )
            for f in (smpl_feats, csf)
        )

    def _final_preds(self, plf, csp, p0, s0, c0):
        """Pose (B, J, 6), shape, cam and in-head uncertainty (or None)."""
        batch, nj = plf.shape[0], self.num_joints
        if self.use_hmr:
            xf = csp.reshape(batch, -1)
            pose = p0.reshape(p0.shape[0], -1).expand(batch, -1)
            shape = s0.expand(batch, -1)
            cam = c0.expand(batch, -1)
            for _ in range(3):
                xc = torch.cat([xf, pose, shape, cam], dim=1)
                xc = self.drop2(self.fc2(self.drop1(self.fc1(xc))))
                pose = self.decpose(xc) + pose
                shape = self.decshape(xc) + shape
                cam = self.deccam(xc) + cam
            return pose.reshape(batch, nj, 6), shape, cam, None
        shape_feats = csp
        if hasattr(self, "final_pose_nonlocal"):
            plf = self.final_pose_nonlocal(plf)
            shape_feats = self.final_shape_nonlocal(csp)
        pose_grid = plf[..., None]                       # (B, C, J, 1)
        shape_flat = shape_feats.reshape(batch, -1)
        pose = self.pose_mlp(pose_grid)
        cam = self.cam_mlp(shape_flat)
        shape = self.shape_mlp(shape_flat)
        uncert = None
        if hasattr(self, "uncert_mlp"):
            u = self.uncert_mlp(pose_grid)
            if self.uncert_act == "sigmoid":
                u = torch.sigmoid(u)
            elif self.uncert_act == "relu":
                u = F.relu(u)
            elif self.uncert_act == "softplus":
                u = F.softplus(u)
            uncert = u[:, 0, :, 0]
        if self.use_mean_camshape:
            cam = cam + c0
            shape = shape + s0
        if self.use_mean_pose:
            pose = pose + p0.reshape(1, 6, nj, 1)
        return pose[..., 0].transpose(1, 2), shape, cam, uncert

    def _iterative_final_preds(self, plf, csp):
        """Per-joint iterative regression (pare_head.py:865-895)."""
        batch, nj = plf.shape[0], self.num_joints
        shape_flat = csp.reshape(batch, -1)
        pred_pose = self.init_pose.reshape(1, 6, nj, 1).expand(batch, -1, -1, -1)
        pred_shape = self.init_shape.expand(batch, -1)
        pred_cam = self.init_cam.expand(batch, -1)
        for _ in range(self.num_iterations):
            inp = [plf[..., None]]
            if "self_pose" in self.pose_input_type:
                inp.append(pred_pose)
            if "all_pose" in self.pose_input_type:
                inp.append(pred_pose.reshape(batch, 6 * nj, 1, 1).expand(-1, -1, nj, 1))
            if "shape" in self.pose_input_type:
                inp.append(pred_shape[:, :, None, None].expand(-1, -1, nj, 1))
            if "cam" in self.pose_input_type:
                inp.append(pred_cam[:, :, None, None].expand(-1, -1, nj, 1))
            pose_inp = torch.cat(inp, dim=1)
            sh_inp = [shape_flat]
            if "all_pose" in self.shape_input_type:
                sh_inp.append(pred_pose.reshape(batch, -1))
            if "shape" in self.shape_input_type:
                sh_inp.append(pred_shape)
            if "cam" in self.shape_input_type:
                sh_inp.append(pred_cam)
            shape_inp = torch.cat(sh_inp, dim=1)
            if self.iter_residual:
                pred_pose = self.pose_mlp(pose_inp) + pred_pose
                pred_cam = self.cam_mlp(shape_inp) + pred_cam
                pred_shape = self.shape_mlp(shape_inp) + pred_shape
            else:
                pred_pose = self.pose_mlp(pose_inp)
                pred_cam = self.cam_mlp(shape_inp)
                pred_shape = self.shape_mlp(shape_inp) + self.init_shape
        return pred_pose[..., 0].transpose(1, 2), pred_shape, pred_cam

    def forward(self, features: torch.Tensor) -> dict[str, torch.Tensor]:
        """Args:
            features: (B, C, H, W) backbone map, (B, 480, 56, 56) from
                HRNet-W32 at 224 px.
        Returns dict with pred_pose (B, 24, 3, 3), pred_pose_6d (B, 144),
        pred_cam, pred_shape, the attention-mode outputs (pred_segm_mask
        (B, 25, H, W) for part_segm, ...), uncert_feat for the diff_branch
        layers and var_pose for same_branch_v1.
        """
        batch = features.shape[0]
        output: dict[str, torch.Tensor] = {}
        if self.use_position_encodings:
            pos = coord_maps(features.shape[2], features.device)
            features = torch.cat([features, pos.expand(batch, -1, -1, -1)], dim=1)

        part_feats = self.keypoint_deconv_layers(features)
        if hasattr(self, "branch_2d_nonlocal"):
            part_feats = self.branch_2d_nonlocal(part_feats)
        if self.use_kp_feats_for_smpl:
            smpl_feats = part_feats
        else:
            smpl_feats = self.smpl_deconv_layers(features)
            if hasattr(self, "branch_3d_nonlocal"):
                smpl_feats = self.branch_3d_nonlocal(smpl_feats)

        attention = self._part_attention(part_feats, output)
        plf, csp = self._local_feats(smpl_feats, attention, output)
        if self.iterative:
            pred_pose, pred_shape, pred_cam = self._iterative_final_preds(plf, csp)
            pred_uncert = None
        else:
            pred_pose, pred_shape, pred_cam, pred_uncert = self._final_preds(
                plf, csp, self.init_pose, self.init_shape, self.init_cam
            )

        # co-attention rounds, then branch iterations, each followed by a
        # fresh attention, pooling and decoding from the last predictions
        rounds = self.num_coattention_iter if hasattr(self, "coattention") else 0
        for step in range(rounds + self.num_branch_iteration):
            if step < rounds:
                smpl_feats, part_feats = self.coattention(smpl_feats, part_feats)
            else:
                smpl_feats = self.branch_iter_3d_nonlocal(smpl_feats)
                part_feats = smpl_feats
            attention = self._part_attention(part_feats, output)
            plf, csp = self._local_feats(smpl_feats, attention, output)
            pred_pose, pred_shape, pred_cam, pred_uncert = self._final_preds(
                plf, csp, pred_pose, pred_shape, pred_cam
            )

        output.update(
            pred_pose=rot6d_to_rotmat(pred_pose).reshape(batch, self.num_joints, 3, 3),
            pred_pose_6d=pred_pose.reshape(batch, -1),
            pred_cam=pred_cam,
            pred_shape=pred_shape,
        )
        if pred_uncert is not None:
            output["var_pose"] = pred_uncert
        if self.uncert_layer == "diff_branch":
            output["uncert_feat"] = plf.reshape(batch, -1)
        elif self.uncert_layer == "diff_branch_lc2d":
            output["uncert_feat"] = plf[..., None]
        return output

    def get_output_channels(self) -> int:
        if "lc2d" in self.uncert_layer:
            return self.num_deconv_filters[-1]
        return self.num_joints * self.num_deconv_filters[-1]
