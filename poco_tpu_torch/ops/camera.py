"""Camera models: weak-perspective -> perspective, pinhole projection, the
CLIFF crop-to-full-image camera, intrinsics and the batched least-squares
camera translation (torch port of `poco_tpu.ops.camera`).
"""

from __future__ import annotations

import torch

from ..constants import FOCAL_LENGTH, IMG_RES
from ..utils import spans


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
    with spans.span(spans.SYNC_FOCAL, wait=True):
        # a number stays a 0-d host tensor, which a card's kernel takes as
        # an argument (copied to the card, it would wait for the queue)
        f = torch.as_tensor(focal_length, dtype=points.dtype)
        if f.ndim:
            f = f.to(points.device)[:, None, None]
    proj = proj * f
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


def build_intrinsics(
    focal_length: torch.Tensor, img_w: torch.Tensor, img_h: torch.Tensor
) -> torch.Tensor:
    """(B, 3, 3) pinhole intrinsics with the principal point at the image
    center (reference smplcam_head.py:65-69)."""
    k = torch.zeros(
        (focal_length.shape[0], 3, 3), dtype=torch.float32, device=focal_length.device
    )
    k[:, 0, 0] = focal_length
    k[:, 1, 1] = focal_length
    k[:, 0, 2] = img_w / 2.0
    k[:, 1, 2] = img_h / 2.0
    k[:, 2, 2] = 1.0
    return k


def estimate_translation(
    joints3d: torch.Tensor,
    joints2d: torch.Tensor,
    conf: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    img_size: float = float(IMG_RES),
) -> torch.Tensor:
    """Batched weighted least-squares camera translation.

    The t = (tx, ty, tz) that minimizes the confidence-weighted
    reprojection residual of `joints3d + t` against `joints2d` under a
    centered pinhole camera, as one 3x3 fp32 solve a sample of the normal
    equations (the reference's per-sample numpy solver,
    pocolib/utils/geometry.py:511-551).

    Args:
        joints3d: (B, J, 3); joints2d: (B, J, 2) pixels; conf: (B, J).
    Returns:
        (B, 3) translations.
    """
    f = focal_length
    c = img_size / 2.0
    x, y, z = joints3d[..., 0], joints3d[..., 1], joints3d[..., 2]
    u, v = joints2d[..., 0], joints2d[..., 1]
    # rows per joint: [f, 0, c-u] . t = (u-c) z - f x
    #                 [0, f, c-v] . t = (v-c) z - f y
    a_u = torch.stack([torch.full_like(u, f), torch.zeros_like(u), c - u], dim=-1)
    a_v = torch.stack([torch.zeros_like(v), torch.full_like(v, f), c - v], dim=-1)
    rows = torch.cat([a_u, a_v], dim=1)                            # (B, 2J, 3)
    rhs = torch.cat([(u - c) * z - f * x, (v - c) * z - f * y], dim=1)
    wts = torch.cat([conf, conf], dim=1)                           # (B, 2J)
    ata = torch.einsum("bki,bk,bkj->bij", rows, wts, rows)
    atb = torch.einsum("bki,bk,bk->bi", rows, wts, rhs)
    ata = ata + 1e-6 * torch.eye(3, dtype=ata.dtype, device=ata.device)
    return torch.linalg.solve(ata, atb[..., None])[..., 0]


def estimate_translation_from_49(
    joints3d_49: torch.Tensor,
    keypoints_49: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    img_size: float = float(IMG_RES),
    use_all_joints: bool = False,
) -> torch.Tensor:
    """Translation fit over the 24 GT joints (25:49) of the 49-joint
    convention, confidences in the keypoints' last channel (reference
    geometry.py:554-578); every joint with `use_all_joints`."""
    if not use_all_joints:
        joints3d_49, keypoints_49 = joints3d_49[:, 25:], keypoints_49[:, 25:]
    return estimate_translation(
        joints3d_49, keypoints_49[..., :2], keypoints_49[..., 2], focal_length, img_size
    )
