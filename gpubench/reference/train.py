# prepare_gt: frozen copy of poco_tpu_torch/train/step.py:prepare_gt at
# commit 48ff100. The step and Adam below are written plainly from
# train/step.py:make_train_step and train/state.py:ModuleAdam (see
# __init__.py): one process, fp32, no autocast, no render targets.
"""The training step of the reference: GT, forward, loss, backward, Adam."""

from __future__ import annotations

import numpy as np
import torch

from .constants import FOCAL_LENGTH, IMG_RES, SMPL_PARENTS, SMPL_VERTEX_JOINT_IDS
from .camera import perspective_projection
from .lbs import SmplParams
from .losses import LossConfig, poco_loss
from .rotation import axis_angle_to_rotmat
from .smpl_model import smpl_49


def smpl_from_arrays(arrays: dict[str, torch.Tensor], kintree_table=None) -> SmplParams:
    """SMPL from the arrays of a model file (`v_template`, `shapedirs`
    (V, 3, 10), `posedirs` (V, 3, 207), `J_regressor`, `weights`, `f`) and
    the (9, V) extra regressor `J_regressor_extra`, on their device."""
    num_verts = arrays["v_template"].shape[0]
    parents = np.array(SMPL_PARENTS if kintree_table is None else np.asarray(kintree_table)[0])
    parents[0] = -1
    ids = SMPL_VERTEX_JOINT_IDS
    ids = ids if num_verts > ids.max() else ids % num_verts
    return SmplParams(
        v_template=arrays["v_template"].float(),
        shapedirs=arrays["shapedirs"][..., :10].float(),
        posedirs=arrays["posedirs"].reshape(num_verts * 3, -1).T.contiguous().float(),
        j_regressor=arrays["J_regressor"].float(),
        lbs_weights=arrays["weights"].float(),
        j_regressor_extra=arrays["J_regressor_extra"].float(),
        faces=arrays["f"].int(),
        parents=tuple(int(x) for x in parents),
        vertex_joint_ids=tuple(int(x) for x in ids),
    )


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


class Adam:
    """torch.optim.Adam's update (no weight decay, no clipping, one
    learning rate for every module), written out: m and v the moving
    means of g and g^2, the step lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.steps = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        self.steps += 1
        c1, c2 = 1.0 - b1 ** self.steps, 1.0 - b2 ** self.steps
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_step(model, adam: Adam, batch: dict, smpl: SmplParams, loss_cfg: LossConfig):
    """One step: GT mesh, train-mode forward (with the flow's GT pose),
    loss, backward, Adam. Returns the loss terms (0-d tensors)."""
    gt = prepare_gt(batch, smpl)
    model.train()
    out = model(dict(batch, gt_pose_rotmat=gt["gt_pose_rotmat"]), smpl)
    loss, terms = poco_loss(out, gt, loss_cfg)
    model.zero_grad(set_to_none=True)
    loss.backward()
    adam.step()
    return terms
