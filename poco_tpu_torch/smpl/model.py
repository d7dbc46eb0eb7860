"""SMPL layer and camera-projection heads (port of `poco_tpu.smpl.model`).

The reference wraps smplx and reorders to a 49-joint convention
(pocolib/models/head/smpl_head.py:12-83), with a CLIFF full-image camera
variant (pocolib/models/head/smplcam_head.py:26-96).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import FOCAL_LENGTH, IMG_RES
from ..ops.camera import (
    crop_cam_to_full_img_cam,
    perspective_projection,
    weak_perspective_to_perspective,
)
from ..utils import spans
from .lbs import SmplParams, smpl_forward


class SmplHeadOutput(NamedTuple):
    vertices: torch.Tensor        # (B, V, 3)
    joints3d: torch.Tensor        # (B, 49, 3)
    joints2d: torch.Tensor        # (B, 49, 2)
    cam_t: torch.Tensor           # (B, 3) crop-frame camera translation
    fullimg_cam_t: torch.Tensor | None  # (B, 3) CLIFF full-image translation


def smpl_49(
    params: SmplParams, betas: torch.Tensor, pose_rotmats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """SMPL forward -> (vertices (B, V, 3), joints49 (B, 49, 3))."""
    out = smpl_forward(params, betas, pose_rotmats)
    with spans.span(spans.SYNC_JOINT_MAP, wait=True):
        joint_map = params.joint_map_49
    return out.vertices, out.joints[:, joint_map]


def smpl_head(
    params: SmplParams,
    rotmat: torch.Tensor,
    shape: torch.Tensor,
    cam: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    img_res: int = IMG_RES,
    normalize_joints2d: bool = False,
) -> SmplHeadOutput:
    """Weak-perspective SMPL head: the 49 joints projected by a centered
    camera in crop coordinates."""
    verts, joints3d = smpl_49(params, shape, rotmat)
    cam_t = weak_perspective_to_perspective(cam, focal_length, img_res)
    joints2d = perspective_projection(joints3d, cam_t, focal_length)
    if normalize_joints2d:
        joints2d = joints2d / (img_res / 2.0)
    return SmplHeadOutput(verts, joints3d, joints2d, cam_t, None)


def smplcam_head(
    params: SmplParams,
    rotmat: torch.Tensor,
    shape: torch.Tensor,
    cam: torch.Tensor,
    focal_length: torch.Tensor,
    bbox_scale: torch.Tensor,
    bbox_center: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    img_res: int = IMG_RES,
) -> SmplHeadOutput:
    """CLIFF full-image-camera SMPL head.

    The crop camera is lifted to a full-image perspective translation and
    the 49 joints are projected in original-image pixels. The camera is
    detached first, as the reference does (smplcam_head.py:72).

    Args:
        focal_length: (B,) full-image focal lengths.
        bbox_scale: (B,) bbox height / 200.
        bbox_center: (B, 2) bbox center in original-image pixels.
        img_w, img_h: (B,) original image sizes.
    """
    verts, joints3d = smpl_49(params, shape, rotmat)
    fullimg_cam_t = crop_cam_to_full_img_cam(
        crop_cam=cam.detach(),
        bbox_height=bbox_scale * 200.0,
        bbox_center=bbox_center,
        img_w=img_w,
        img_h=img_h,
        focal_length=focal_length,
        crop_res=img_res,
    )
    crop_cam_t = weak_perspective_to_perspective(cam, FOCAL_LENGTH, img_res)
    camera_center = torch.stack([img_w / 2.0, img_h / 2.0], dim=-1)
    joints2d = perspective_projection(
        joints3d, fullimg_cam_t, focal_length, camera_center
    )
    return SmplHeadOutput(verts, joints3d, joints2d, crop_cam_t, fullimg_cam_t)
