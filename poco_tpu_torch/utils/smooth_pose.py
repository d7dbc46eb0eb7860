"""Temporal pose smoothing: One-Euro over rotation matrices, then SMPL
again (port of `poco_tpu.utils.smooth_pose`; reference
pocolib/utils/smooth_pose.py:25-71).

The filter runs on the host over the whole (T, 24, 3, 3) track; the
smoothed track goes through SMPL once, batched over all frames, on the
SMPL weights' device (one `skinning` launch on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..smpl.lbs import SmplParams
from ..smpl.model import smpl_49
from .one_euro import one_euro_track


@torch.inference_mode()
def smooth_pose(
    pred_pose: np.ndarray,
    pred_betas: np.ndarray,
    smpl: SmplParams,
    min_cutoff: float = 0.004,
    beta: float = 0.7,
):
    """Filter a pose track and regenerate vertices and joints.

    Args:
        pred_pose: (T, 24, 3, 3) rotation matrices.
        pred_betas: (T, 10).
    Returns:
        (verts (T, V, 3), pose_hat (T, 24, 3, 3), joints3d (T, 49, 3)),
        numpy float32.
    """
    pose_hat = one_euro_track(
        np.asarray(pred_pose), min_cutoff=min_cutoff, beta=beta
    )
    device = smpl.v_template.device
    verts, joints3d = smpl_49(
        smpl,
        torch.as_tensor(np.asarray(pred_betas, np.float32), device=device),
        torch.as_tensor(np.asarray(pose_hat, np.float32), device=device),
    )
    return verts.cpu().numpy(), pose_hat, joints3d.cpu().numpy()
