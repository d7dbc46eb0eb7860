"""Train and eval steps (port of `poco_tpu.train.step`).

Replaces the reference's LitModule.training_step / validation_step
(pocolib/core/trainer.py:210-362):

  * `prepare_gt` builds the supervision on the device: the GT mesh and
    joints from a SMPL forward on the GT pose and shape (no gradient), and
    the crop keypoints and 3D joints a batch lacks;
  * `render_targets` renders the GT mesh's soft silhouette and part
    labels when the render or part-segmentation loss is on
    (`ops/soft_raster.py`);
  * `make_train_step` runs the model in train mode, `poco_loss`, the
    backward and the optimizer step, each in a `record_function` range of
    TRAIN_STAGES, so a profile splits the step's device time by stage.

On a CUDA device a step launches the skinning kernel twice (the GT mesh
and the prediction) and its backward kernel once. With more than one
process, the step sums the gradients over processes before the optimizer
(inside the backward's range), so every process applies the same update,
and returns the loss terms of the global batch.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..constants import FOCAL_LENGTH, IMG_RES, J24_TO_J14
from ..losses.losses import LossConfig, poco_loss
from ..models.poco import compute_precision
from ..ops.camera import perspective_projection
from ..ops.rotation import axis_angle_to_rotmat
from ..ops.soft_raster import soft_part_probs, soft_silhouette
from ..parallel import distributed
from ..smpl.lbs import SmplParams
from ..smpl.model import smpl_49

# the train step's profiler ranges, in the order they run
TRAIN_STAGES = ("train_step/gt", "train_step/forward", "train_step/backward",
                "train_step/optimizer")


@torch.no_grad()
def prepare_gt(batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict[str, torch.Tensor]:
    """Supervision targets on the batch's device (trainer.py:220-247): the
    GT rotations, the GT mesh and 49 joints from the neutral SMPL, and,
    where the batch has none, 3D joints (the GT joints, confidence 1) and
    crop keypoints (the GT joints projected by a canonical camera at depth
    2f/res with the principal point at the crop center, in [-1, 1])."""
    gt_pose, gt_betas = batch["pose"], batch["betas"]
    batch_size = gt_pose.shape[0]
    gt_rotmat = axis_angle_to_rotmat(gt_pose.reshape(-1, 3)).reshape(batch_size, 24, 3, 3)
    gt_vertices, gt_joints49 = smpl_49(smpl, gt_betas, gt_rotmat)

    gt = dict(batch)
    gt.update(gt_pose_rotmat=gt_rotmat, vertices=gt_vertices, model_joints=gt_joints49)
    device = gt_pose.device
    if "pose_3d" not in batch:
        conf = torch.ones((batch_size, 24, 1), device=device)
        gt["pose_3d"] = torch.cat([gt_joints49[:, 25:], conf], dim=-1)
    if "keypoints" not in batch:
        cam_t = torch.tensor(
            [[0.0, 0.0, 2.0 * FOCAL_LENGTH / IMG_RES]], device=device
        ).expand(batch_size, 3)
        center = torch.full((batch_size, 2), IMG_RES / 2.0, device=device)
        proj = perspective_projection(gt_joints49, cam_t, FOCAL_LENGTH, camera_center=center)
        gt["keypoints"] = torch.cat(
            [2.0 * proj / IMG_RES - 1.0, torch.ones((batch_size, 49, 1), device=device)], dim=-1
        )
    return gt


@torch.no_grad()
def render_targets(batch: dict[str, torch.Tensor], gt: dict[str, torch.Tensor],
                   smpl: SmplParams, loss_cfg: LossConfig) -> dict[str, torch.Tensor]:
    """The render and part-segmentation targets (the JAX package's
    step.py:99-121, in place of the reference's neural_renderer,
    trainer.py:251-275): the GT mesh's soft silhouette under the batch's
    `gt_cam` (default [0.9, 0, 0]) with that camera as `gt_cam_render`,
    and the argmax of its soft part probabilities, the skinning weights
    as the part assignment. Empty when neither loss is on."""
    if not (loss_cfg.use_smpl_render_loss or loss_cfg.use_smpl_segm_loss):
        return {}
    verts = gt["vertices"]
    gt_cam = batch.get("gt_cam")
    if gt_cam is None:
        gt_cam = torch.tensor([[0.9, 0.0, 0.0]], device=verts.device).expand(len(verts), 3)
    out = {}
    if loss_cfg.use_smpl_render_loss:
        out["gt_smpl_render"] = soft_silhouette(verts, gt_cam)
        out["gt_cam_render"] = gt_cam
    if loss_cfg.use_smpl_segm_loss:
        out["gt_segm_mask"] = soft_part_probs(verts, gt_cam, smpl.all_lbs_weights).argmax(-1)
    return out


def add_pred_render(out: dict, gt: dict) -> dict:
    """The render loss's prediction, in place: the predicted mesh's soft
    silhouette under the GT render camera, when the render loss is on
    (the JAX package's step.py:136-140)."""
    if "gt_cam_render" in gt:
        out["pred_smpl_render"] = soft_silhouette(out["smpl_vertices"], gt["gt_cam_render"])
    return out


def _fp32(out: dict) -> dict:
    """Floating outputs of an autocast region as fp32, for the loss."""
    return {
        k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
        for k, v in out.items()
    }


def make_train_step(model, optimizer, loss_cfg: LossConfig = LossConfig(),
                    autocast_dtype: torch.dtype | None = None):
    """The training step: step(batch, smpl) -> metrics.

    The batch holds the model's inputs (`models/poco.py`) and the GT keys
    of `losses.py`; `gt_pose_cond_mask` is optional. The model runs in
    train mode (under a `autocast_dtype` autocast if given; SMPL and the
    loss stay fp32), then the loss's backward and `optimizer.step()`
    (a `ModuleAdam`). Returns the loss terms (0-d tensors on the device),
    `grad_norm` (the global norm before clipping) and two auxiliaries the
    trainer pops: `_var_pose` and `_viz` (4 rows of the meshes and camera).
    With TRAINING.USE_SMPL_RENDER_LOSS or USE_SMPL_SEGM_LOSS, the GT
    stage also renders the GT mesh's soft silhouette and part labels
    (`render_targets`), and the forward stage the prediction's silhouette.
    """
    def step(batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict:
        with record_function(TRAIN_STAGES[0]):
            gt = prepare_gt(batch, smpl)
            gt.update(render_targets(batch, gt, smpl, loss_cfg))
        with record_function(TRAIN_STAGES[1]):
            model.train()
            model_batch = dict(batch, gt_pose_rotmat=gt["gt_pose_rotmat"])
            with compute_precision(batch["img"].device.type, autocast_dtype):
                out = model(model_batch, smpl)
            out = add_pred_render(_fp32(out), gt)
            loss, loss_dict = poco_loss(out, gt, loss_cfg)
        with record_function(TRAIN_STAGES[2]):
            optimizer.zero_grad()
            loss.backward()
            # each data shard's loss is its share of the global one: the
            # sum of the gradients over the data group is the one-process
            # gradient (a model group's, equal but for the card's last
            # bits, are averaged)
            distributed.all_reduce_gradients(optimizer.params)
        with record_function(TRAIN_STAGES[3]):
            grad_norm = optimizer.step()
        metrics = global_loss_terms({k: v.detach() for k, v in loss_dict.items()})
        metrics["grad_norm"] = grad_norm
        if out.get("var_pose") is not None:
            metrics["_var_pose"] = out["var_pose"].detach()
        metrics["_viz"] = {
            "pred_verts": out["smpl_vertices"][:4].detach(),
            "pred_cam": out["pred_cam"][:4].detach(),
            "gt_verts": gt["vertices"][:4],
        }
        return metrics

    return step


def global_loss_terms(terms: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The loss terms of the global batch, the same on every process: the
    sum of the data shards' shares, in one collective."""
    if distributed.data_count() == 1:
        return terms
    total = distributed.all_reduce_sum_(torch.stack(list(terms.values())))
    return dict(zip(terms, total.unbind()))


def make_eval_step(model, j_regressor_h36m: torch.Tensor | None = None):
    """The validation step of the JAX package (step.py:166-211):
    step(batch, smpl) -> per-sample mpjpe, pa_mpjpe, v2v (m) and, with an
    uncertainty head, `uncert` (the mean sigma). The batch carries
    `gt_vertices` and, without a regressor, `gt_joints3d` (B, 24, 3)."""
    from ..eval.metrics import joints_from_vertices, mpjpe, pa_mpjpe, vertex_error

    @torch.no_grad()
    def step(batch: dict[str, torch.Tensor], smpl: SmplParams) -> dict[str, torch.Tensor]:
        model.eval()
        out = model(batch, smpl)
        pred_verts, gt_verts = out["smpl_vertices"], batch["gt_vertices"]
        if j_regressor_h36m is not None:
            pred_j14 = joints_from_vertices(j_regressor_h36m, pred_verts)
            gt_j14 = joints_from_vertices(j_regressor_h36m, gt_verts)
        else:
            sel = torch.as_tensor(J24_TO_J14, device=pred_verts.device)
            pred_j = out["smpl_joints3d"][:, 25:][:, sel]
            gt_j = batch["gt_joints3d"][:, sel]
            # hip-midpoint pelvis, as keypoint_3d_loss centres
            pred_j14 = pred_j - (pred_j[:, 2:3] + pred_j[:, 3:4]) / 2.0
            gt_j14 = gt_j - (gt_j[:, 2:3] + gt_j[:, 3:4]) / 2.0
        metrics = {
            "mpjpe": mpjpe(pred_j14, gt_j14),
            "pa_mpjpe": pa_mpjpe(pred_j14, gt_j14),
            # raw vertices, no alignment (the reference protocol)
            "v2v": vertex_error(pred_verts, gt_verts),
        }
        if out.get("var_pose") is not None:
            metrics["uncert"] = out["var_pose"].mean(dim=-1)
        return metrics

    return step


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32 (the JAX
    package's `optax_global_norm`): the norms of a model's ~1000 gradient
    tensors in a few multi-tensor kernels, not one kernel a tensor."""
    return torch.nn.utils.get_total_norm([t.float() for t in tensors], 2.0)


def best_model_metric(pa_mpjpe_mm: float, mpjpe_mm: float) -> float:
    """Composite selection criterion (reference trainer.py:407-408)."""
    return 0.5 * (1.5 * pa_mpjpe_mm + mpjpe_mm)
