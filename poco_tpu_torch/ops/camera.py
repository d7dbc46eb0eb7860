"""Camera models: weak-perspective -> perspective, pinhole projection and
the CLIFF crop-to-full-image camera (torch port of `poco_tpu.ops.camera`).
"""

from __future__ import annotations

import torch

from ..constants import FOCAL_LENGTH, IMG_RES


def weak_perspective_to_perspective(
    cam: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    img_res: int = IMG_RES,
) -> torch.Tensor:
    """[s, tx, ty] weak-perspective camera -> 3D translation [tx, ty, tz]."""
    s, tx, ty = cam[..., 0], cam[..., 1], cam[..., 2]
    tz = 2.0 * focal_length / (img_res * s + 1e-9)
    return torch.stack([tx, ty, tz], dim=-1)


def perspective_projection(
    points: torch.Tensor,
    translation: torch.Tensor,
    focal_length,
    camera_center: torch.Tensor | None = None,
    rotation: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pinhole projection of (B, N, 3) points -> (B, N, 2) pixels.

    Args:
        translation: (B, 3) camera translation.
        focal_length: scalar or (B,) focal length in pixels.
        camera_center: (B, 2) principal point; zeros if None.
        rotation: optional (B, 3, 3) camera rotation.
    """
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    proj = points[..., :2] / points[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=points.dtype, device=points.device)
    if f.ndim == 0:
        f = f.expand(points.shape[0])
    proj = proj * f[:, None, None]
    if camera_center is not None:
        proj = proj + camera_center[:, None, :]
    return proj


def crop_cam_to_full_img_cam(
    crop_cam: torch.Tensor,
    bbox_height: torch.Tensor,
    bbox_center: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    focal_length: torch.Tensor,
    crop_res: int = IMG_RES,
) -> torch.Tensor:
    """Weak-perspective crop camera -> (B, 3) full-image translation
    (the CLIFF conversion, reference smplcam_head.py:123-139)."""
    s, tx, ty = crop_cam[..., 0], crop_cam[..., 1], crop_cam[..., 2]
    r = bbox_height / crop_res
    tz = 2.0 * focal_length / (r * crop_res * s)
    cx = 2.0 * (bbox_center[..., 0] - img_w / 2.0) / (s * bbox_height)
    cy = 2.0 * (bbox_center[..., 1] - img_h / 2.0) / (s * bbox_height)
    return torch.stack([tx + cx, ty + cy, tz], dim=-1)
