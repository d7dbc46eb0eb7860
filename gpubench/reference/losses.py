# Frozen copy of poco_tpu_torch/losses/losses.py at commit 48ff100 (see __init__.py).
"""POCO / HMR training losses in torch (port of `poco_tpu.losses.losses`).

Reference contract: pocolib/losses/losses.py:164-509. As in the JAX
package, every component is a masked mean over static shapes: the
reference's boolean indexing (`x[has_smpl == 1]`) is not used, so a batch
with no selected row gives 0 and not NaN, and the loss has the same
terms whatever the batch holds.

With more than one process every mean is over the global batch, as the
JAX package takes it over a batch sharded across chips: each process's
loss is its share (its rows' sum over the global denominator), the
shares sum to the one-process loss, and the train step sums the
gradients over processes (`parallel.distributed`).

GT dict keys (tensors on the model's device):
    pose          (B, 72) axis-angle SMPL pose
    betas         (B, 10)
    pose_3d       (B, 24, 4) GT 3D joints + confidence
    vertices      (B, V, 3) GT mesh
    has_smpl      (B,) float {0,1}
    has_pose_3d   (B,) float {0,1}
    keypoints     (B, 49, 3) crop-frame keypoints, [-1,1] normalized + conf
    keypoints_fullimg (B, 49, 3) full-image pixel keypoints + conf
    orig_shape    (B, 2) original (h, w)
    scale         (B,) bbox height / 200
    gt_pose_cond_mask (B,) bool: rows fed the GT pose in the uncert head
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .rotation import axis_angle_to_rotmat
from . import distributed

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and options (the JAX package's `LossConfig`)."""

    shape_loss_weight: float = 0.0
    keypoint3d_loss_weight: float = 5.0
    keypoint2d_loss_weight: float = 2.5
    keypoint2d_noncrop: bool = False
    pose_loss_weight: float = 1.0
    beta_loss_weight: float = 0.001
    openpose_train_weight: float = 0.0
    gt_train_weight: float = 1.0
    pose_uncert_weight: float = 1.0
    beta_uncert_weight: float = 1.0
    nf_loss_weight: float = 0.01
    loss_weight: float = 60.0
    loss_ver: str = "norm_flow_res_gaus"
    uncert_type: str = "pose"
    exclude_uncert_idx: tuple[int, ...] = ()
    use_smpl_segm_loss: bool = False
    smpl_segm_loss_weight: float = 1.0
    use_smpl_render_loss: bool = False
    smpl_render_loss_weight: float = 1.0
    # With a 2-D sigma (SIGMA_DIM=1, every shipped config) the reference
    # trains the pose term as plain MSE: its `len(pose_var.shape) == 2`
    # branch swallows the loss_ver chain (losses.py:477-496). That is the
    # default here too; sigma1_nll=True applies the Gaussian NLL with a
    # broadcast sigma instead (the JAX package's documented divergence).
    sigma1_nll: bool = False

    @property
    def effective_pose_weight(self) -> float:
        # the reference scales the pose weight by the uncertainty weight
        # for every uncertainty-aware loss version (losses.py:218-219)
        if "pose" in self.uncert_type and self.loss_ver != "norm_flow":
            return self.pose_loss_weight * self.pose_uncert_weight
        return self.pose_loss_weight


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of x over the global batch: with more than one data shard,
    this process's share of it (its rows' sum over the global count; every
    shard holds as many rows), so that the shards' shares sum to the mean."""
    world = distributed.data_count()
    if world == 1:
        return x.mean()
    return x.sum() / (x.numel() * world)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the rows where mask (B,) is 1; 0 if none is. With
    more than one data shard the rows are the global batch's: this
    process's share (its rows' sum over the global count of masked
    entries)."""
    mask = mask.to(x.dtype)
    weighted = x * mask.reshape((-1,) + (1,) * (x.ndim - 1))
    per_row = x[0].numel()
    count = distributed.all_reduce_sum_(mask.sum()) * per_row
    return weighted.sum() / torch.clamp(count, min=1.0)


def projected_keypoint_loss(
    pred_kp2d: torch.Tensor,
    gt_kp2d: torch.Tensor,
    openpose_weight: float,
    gt_weight: float,
) -> torch.Tensor:
    """Confidence-weighted squared reprojection error, unreduced
    (reference losses.py:361-376)."""
    conf = gt_kp2d[..., -1:]
    conf = torch.cat([conf[:, :25] * openpose_weight, conf[:, 25:] * gt_weight], dim=1)
    return conf * (pred_kp2d - gt_kp2d[..., :-1]) ** 2


def keypoint_3d_loss(
    pred_joints49: torch.Tensor, gt_joints24: torch.Tensor, has_pose_3d: torch.Tensor
) -> torch.Tensor:
    """Pelvis-centered, confidence-weighted MSE over the 24 GT joints
    (reference losses.py:392-419)."""
    pred = pred_joints49[:, 25:, :]
    gt = gt_joints24[..., :-1]
    conf = gt_joints24[..., -1:]
    gt = gt - ((gt[:, 2, :] + gt[:, 3, :]) / 2.0)[:, None, :]
    pred = pred - ((pred[:, 2, :] + pred[:, 3, :]) / 2.0)[:, None, :]
    return masked_mean(conf * (pred - gt) ** 2, has_pose_3d)


def shape_loss(
    pred_vertices: torch.Tensor, gt_vertices: torch.Tensor, has_smpl: torch.Tensor
) -> torch.Tensor:
    """Per-vertex L1 (reference losses.py:422-434)."""
    return masked_mean((pred_vertices - gt_vertices).abs(), has_smpl)


def smpl_losses_uncertainty(
    pred_rotmat: torch.Tensor,
    pred_betas: torch.Tensor,
    gt_pose_aa: torch.Tensor,
    gt_betas: torch.Tensor,
    has_smpl: torch.Tensor,
    gt_pose_cond_mask: torch.Tensor | None,
    var_pose: torch.Tensor | None,
    cfg: LossConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose and shape parameter losses with the uncertainty weighting
    (reference losses.py:437-509). GT-pose-conditioned rows leave the
    sigma-weighted pose loss; they add a plain MSE and the mean sigma
    instead (losses.py:503-507)."""
    batch = pred_rotmat.shape[0]
    gt_rotmat = axis_angle_to_rotmat(gt_pose_aa.reshape(-1, 3)).reshape(batch, 24, 3, 3)

    if gt_pose_cond_mask is None:
        gt_pose_cond_mask = torch.zeros(batch, dtype=torch.bool, device=pred_rotmat.device)
    gt_pose_cond_mask = gt_pose_cond_mask.bool()
    with_smpl = has_smpl > 0
    no_uncert = gt_pose_cond_mask & with_smpl
    uncert = ~gt_pose_cond_mask & with_smpl

    sq_err = (pred_rotmat - gt_rotmat) ** 2

    if var_pose is not None and "pose" in cfg.uncert_type:
        sigma = var_pose
        sigma_was_2d = sigma.ndim == 2
        if sigma_was_2d:
            sigma = sigma[:, :, None, None].expand(*sigma.shape[:2], 3, 3)
        if sigma_was_2d and not cfg.sigma1_nll:
            # the reference's fallthrough: a 2-D sigma trains plain MSE
            loss_pose = masked_mean(sq_err, uncert)
        elif cfg.loss_ver == "norm_flow_res":
            if sigma.shape[1] < 24:
                # EXCLUDE_UNCERT_IDX leaves P < 24 parts; the reference
                # crashes on the shapes here (losses.py:480-484); the JAX
                # package falls back to plain MSE, as for norm_flow_res_gaus
                loss_pose = masked_mean(sq_err, uncert)
            else:
                amp = 1.0 / math.sqrt(2.0 * math.pi)
                log_q = torch.log(sigma / amp) + (pred_rotmat - gt_rotmat).abs() / (
                    math.sqrt(2.0) * sigma + 1e-9
                )
                loss_pose = masked_mean(log_q, uncert)
        elif cfg.loss_ver == "norm_flow_res_gaus":
            if sigma.shape[1] < 24:
                # excluded parts -> plain MSE (losses.py:487-488)
                loss_pose = masked_mean(sq_err, uncert)
            else:
                nll = sq_err / (sigma + _EPS) + torch.log(sigma + _EPS)
                loss_pose = 0.5 * masked_mean(nll, uncert)
        else:
            # an unknown loss_ver with 'pose' uncertainty: the reference
            # fills a zero pose loss (losses.py:494-496)
            loss_pose = torch.zeros((), dtype=pred_rotmat.dtype, device=pred_rotmat.device)
    else:
        loss_pose = masked_mean(sq_err, uncert)

    loss_betas = masked_mean((pred_betas - gt_betas) ** 2, has_smpl)

    if var_pose is not None:
        loss_pose_no_uncert = masked_mean(sq_err, no_uncert)
        loss_gt_var = masked_mean(var_pose, no_uncert)
        any_cond = (distributed.all_reduce_sum_(no_uncert.sum()) > 0).to(loss_pose.dtype)
        loss_pose = loss_pose + any_cond * (loss_pose_no_uncert + loss_gt_var)

    return loss_pose, loss_betas


def poco_loss(
    pred: dict[str, Any], gt: dict[str, torch.Tensor], cfg: LossConfig = LossConfig()
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total POCO training loss and its terms (reference POCOLoss.forward,
    losses.py:227-358). The part-segmentation and render terms enter where
    their flag is set and both their inputs are given, as in the JAX
    package."""
    has_smpl = gt["has_smpl"].float()
    has_pose_3d = gt["has_pose_3d"].float()
    var_pose = pred.get("var_pose")

    pred_kp2d = pred["smpl_joints2d"]
    if cfg.keypoint2d_noncrop:
        # orig_shape stores (h, w); pixel coordinates normalize by (w, h)
        img_size = gt["orig_shape"].flip(-1)[:, None, :]
        pred_norm = 2.0 * (pred_kp2d / img_size) - 1.0
        gt_kp = gt["keypoints_fullimg"]
        gt_norm = torch.cat([2.0 * (gt_kp[..., :2] / img_size) - 1.0, gt_kp[..., 2:]], dim=-1)
        kp_loss = projected_keypoint_loss(
            pred_norm, gt_norm, cfg.openpose_train_weight, cfg.gt_train_weight
        )
        scale_w = img_size[:, 0, :] / (gt["scale"] * 200.0)[:, None]
        loss_keypoints = batch_mean(kp_loss * scale_w[:, None, :])
    else:
        loss_keypoints = batch_mean(projected_keypoint_loss(
            pred_kp2d, gt["keypoints"], cfg.openpose_train_weight, cfg.gt_train_weight
        ))

    loss_regr_pose, loss_regr_betas = smpl_losses_uncertainty(
        pred["pred_pose"], pred["pred_shape"], gt["pose"], gt["betas"],
        has_smpl, gt.get("gt_pose_cond_mask"), var_pose, cfg,
    )
    loss_keypoints_3d = keypoint_3d_loss(pred["smpl_joints3d"], gt["pose_3d"], has_pose_3d)
    loss_shape = shape_loss(pred["smpl_vertices"], gt["vertices"], has_smpl)
    loss_cam = batch_mean(torch.exp(-pred["pred_cam"][:, 0] * 10.0) ** 2) * 0.016

    loss_dict = {
        "loss/loss_keypoints": loss_keypoints * cfg.keypoint2d_loss_weight,
        "loss/loss_keypoints_3d": loss_keypoints_3d * cfg.keypoint3d_loss_weight,
        "loss/loss_regr_pose": loss_regr_pose * cfg.effective_pose_weight,
        "loss/loss_regr_betas": loss_regr_betas
        * cfg.beta_loss_weight
        * cfg.beta_uncert_weight,
        "loss/loss_shape": loss_shape * cfg.shape_loss_weight,
        "loss/loss_cam": loss_cam,
    }

    # the optional part-segmentation cross-entropy (reference
    # losses.py:334-340) and differentiable-render MSE (losses.py:328-332)
    if cfg.use_smpl_segm_loss and "pred_segm_mask" in pred and "gt_segm_mask" in gt:
        raise NotImplementedError("the reference has no part-segmentation loss (off in "
                                  "every configuration of the benchmark)")
        loss_dict["loss/loss_smpl_segm"] = part_segmentation_loss(  # noqa: F821
            pred["pred_segm_mask"], gt["gt_segm_mask"], has_smpl
        ) * cfg.smpl_segm_loss_weight
    if cfg.use_smpl_render_loss and "pred_smpl_render" in pred and "gt_smpl_render" in gt:
        loss_dict["loss/loss_smpl_render"] = batch_mean(
            (pred["pred_smpl_render"] - gt["gt_smpl_render"]) ** 2
        ) * cfg.smpl_render_loss_weight

    # the flow's calibration term (reference losses.py:342-347)
    log_phi = pred.get("log_phi")
    if log_phi is not None and var_pose is not None:
        nf_term = torch.log(var_pose + _EPS) - log_phi
        loss_dict["loss/loss_nf"] = masked_mean(nf_term, has_smpl) * cfg.nf_loss_weight

    total = sum(loss_dict.values()) * cfg.loss_weight
    loss_dict["loss/total_loss"] = total
    return total, loss_dict


def hmr_loss_config(**overrides) -> LossConfig:
    """Loss config of the plain HMR baseline (reference HMRLoss,
    losses.py:15-162): no uncertainty weighting, no flow term."""
    defaults = dict(loss_ver="mse", uncert_type="", nf_loss_weight=0.0)
    defaults.update(overrides)
    return LossConfig(**defaults)
