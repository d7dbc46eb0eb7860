"""Host-side (numpy) data transforms for training-time augmentation.

These mirror the reference's per-item numpy transforms
(pocolib/utils/image_utils.py, pocolib/dataset/base_dataset.py:172-262),
so npz annotation files and converted checkpoints behave identically
(port of `poco_tpu.data.transforms`). The demo/inference path uses the
on-device equivalents in `ops.preprocess` instead.

No OpenCV: the three-point affine and Rodrigues' formula are solved in
float64 numpy as cv2 solves them, and crops are warped by the port's
image loader (`runtime/loader.py`, the C++ bilinear warp of the whole-batch
path), so a per-item crop equals its row of `PocoDataset.get_batch`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    IMG_NORM_MEAN,
    IMG_NORM_STD,
    IMG_RES,
    J24_FLIP_PERM,
    J49_FLIP_PERM,
    SMPL_POSE_FLIP_PERM,
)
from ..runtime import loader


@dataclasses.dataclass
class AugmentParams:
    flip: bool = False
    pixel_noise: np.ndarray = None  # (3,) per-channel multipliers
    rot: float = 0.0                # degrees
    scale: float = 1.0

    def __post_init__(self):
        if self.pixel_noise is None:
            self.pixel_noise = np.ones(3, np.float32)


def sample_augment_params(
    rng: np.random.RandomState,
    flip_prob: float = 0.5,
    noise_factor: float = 0.4,
    rot_factor: float = 30.0,
    scale_factor: float = 0.25,
    use_flip: bool = True,
) -> AugmentParams:
    """Training augmentation sampling (reference base_dataset.py:172-199)."""
    flip = use_flip and rng.uniform() <= flip_prob
    pn = rng.uniform(1 - noise_factor, 1 + noise_factor, 3).astype(np.float32)
    rot = float(
        min(2 * rot_factor, max(-2 * rot_factor, rng.randn() * rot_factor))
    )
    sc = float(
        min(1 + scale_factor, max(1 - scale_factor, rng.randn() * scale_factor + 1))
    )
    if rng.uniform() <= 0.6:
        rot = 0.0
    return AugmentParams(flip=flip, pixel_noise=pn, rot=rot, scale=sc)


def _affine_matrix(
    center, bbox_size, out_res, rot_deg=0.0, inv=False
) -> np.ndarray:
    """cv2-convention affine crop transform (vibe_image_utils.py:58-91)."""
    rot_rad = np.pi * rot_deg / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)

    def rot2d(pt):
        return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs])

    src = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + rot2d(np.array([0, bbox_size * 0.5]))
    src[2] = center + rot2d(np.array([bbox_size * 0.5, 0]))
    dst = np.array(
        [
            [out_res * 0.5, out_res * 0.5],
            [out_res * 0.5, out_res],
            [out_res, out_res * 0.5],
        ],
        np.float32,
    )
    if inv:
        return affine_from_points(dst, src)
    return affine_from_points(src, dst)


def affine_from_points(src, dst) -> np.ndarray:
    """The (2, 3) float64 affine taking three points `src` to `dst`
    (`cv2.getAffineTransform`: the same 6x6 system, solved in float64)."""
    a = np.concatenate([np.asarray(src, np.float64), np.ones((3, 1))], axis=1)
    return np.linalg.solve(a, np.asarray(dst, np.float64)).T


def affine_output_to_source(
    center,
    bbox_size: float,
    out_res: int = IMG_RES,
    rot_deg: float = 0.0,
    flip: bool = False,
) -> np.ndarray:
    """(2, 3) matrix mapping output crop pixel (j, i) -> source (x, y).

    Exactly the mapping cv2.warpAffine applies for crop_image followed by
    the `out[:, ::-1]` horizontal flip of process_image, so that a
    whole-batch warp can reproduce the per-item crop.
    """
    m = _affine_matrix(
        np.asarray(center, np.float32), bbox_size, out_res, rot_deg,
        inv=True,
    ).astype(np.float64)
    if flip:
        # output j -> out_res-1-j before the inverse crop transform
        f = np.array(
            [[-1.0, 0.0, out_res - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        m3 = np.vstack([m, [0.0, 0.0, 1.0]]) @ f
        m = m3[:2]
    return m.astype(np.float32)


def crop_image(
    img: np.ndarray,
    center,
    scale: float,
    out_res: int = IMG_RES,
    rot_deg: float = 0.0,
) -> np.ndarray:
    """Affine warp crop (reference crop_cv2, image_utils.py:189-206):
    bilinear, zero outside the image, float32 out. `img` holds 8-bit
    pixels (uint8, or floats with whole values in [0, 255])."""
    m = affine_output_to_source(center, scale * 200.0, out_res, rot_deg)
    return loader.affine_warp(img, m, out_res=out_res)


def transform_point(pt, center, scale, out_res=IMG_RES, rot_deg=0.0):
    """Map an original-image point into crop pixel coords."""
    trans = _affine_matrix(
        np.asarray(center, np.float32), scale * 200.0, out_res, rot_deg
    )
    p = np.array([pt[0], pt[1], 1.0])
    return trans @ p


def process_image(
    img: np.ndarray,
    center,
    scale: float,
    aug: AugmentParams,
    out_res: int = IMG_RES,
) -> np.ndarray:
    """Crop + flip + channel noise; returns float32 HWC in [0, 255].

    Reference: rgb_processing (base_dataset.py:201-221), but HWC (the
    model's batch is NHWC) with normalization left to the device
    (ops.preprocess.normalize_image). One warp through the loader with
    the flip in the matrix and the noise as the gain: the arithmetic of a
    row of `PocoDataset.get_batch`.
    """
    m = affine_output_to_source(center, scale * 200.0, out_res, aug.rot, aug.flip)
    return loader.affine_warp(img, m, aug.pixel_noise, out_res)


def process_keypoints_2d(
    kp: np.ndarray,
    center,
    scale: float,
    aug: AugmentParams,
    out_res: int = IMG_RES,
) -> np.ndarray:
    """GT 2D keypoints -> augmented, [-1,1]-normalized crop coords.

    Reference: j2d_processing (base_dataset.py:223-235).
    """
    kp = kp.copy().astype(np.float32)
    trans = _affine_matrix(
        np.asarray(center, np.float32), aug.scale * scale * 200.0, out_res,
        aug.rot,
    )
    pts = np.concatenate([kp[:, :2] + 1.0, np.ones((kp.shape[0], 1))], axis=1)
    kp[:, :2] = (trans @ pts.T).T
    kp[:, :2] = 2.0 * kp[:, :2] / out_res - 1.0
    if aug.flip:
        kp = flip_keypoints(kp)
    return kp.astype(np.float32)


def process_keypoints_3d(S: np.ndarray, aug: AugmentParams) -> np.ndarray:
    """GT 3D joints (24, 4) -> rotated/flipped (base_dataset.py:237-250)."""
    S = S.copy().astype(np.float32)
    if aug.rot != 0.0:
        rot_rad = -aug.rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.eye(3, dtype=np.float32)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        S[:, :-1] = S[:, :-1] @ rot_mat.T
    if aug.flip:
        S = flip_keypoints(S)
    return S


def process_pose(pose: np.ndarray, aug: AugmentParams) -> np.ndarray:
    """SMPL theta (72,) -> rotated global orient + flipped
    (base_dataset.py:252-262)."""
    pose = pose.copy().astype(np.float32)
    pose[:3] = rotate_axis_angle(pose[:3], aug.rot)
    if aug.flip:
        pose = flip_pose(pose)
    return pose


def rotate_axis_angle(aa: np.ndarray, rot_deg: float) -> np.ndarray:
    """In-plane rotation of a global axis-angle (image_utils.py:236-247)."""
    if rot_deg == 0.0:
        return aa.astype(np.float32)
    rad = np.deg2rad(-rot_deg)
    rz = np.array(
        [
            [np.cos(rad), -np.sin(rad), 0.0],
            [np.sin(rad), np.cos(rad), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    r = rodrigues_to_matrix(aa.astype(np.float64))
    return rodrigues_to_vector(rz @ r).astype(np.float32)


def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle (3,) -> rotation matrix, float64 (`cv2.Rodrigues`)."""
    rvec = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    r = rvec / theta
    c, s = np.cos(theta), np.sin(theta)
    skew = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * skew


def rodrigues_to_vector(rmat: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (3,), float64, as `cv2.Rodrigues`
    computes it: the nearest rotation (SVD) first, the angle from the
    trace, the axis from the skew part or, near pi, from the diagonal."""
    u, _, vt = np.linalg.svd(np.asarray(rmat, np.float64))
    rm = u @ vt
    r = np.array([rm[2, 1] - rm[1, 2], rm[0, 2] - rm[2, 0], rm[1, 0] - rm[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((np.trace(rm) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    r = np.array([
        np.sqrt(max((rm[0, 0] + 1.0) * 0.5, 0.0)),
        np.sqrt(max((rm[1, 1] + 1.0) * 0.5, 0.0)) * (-1.0 if rm[0, 1] < 0 else 1.0),
        np.sqrt(max((rm[2, 2] + 1.0) * 0.5, 0.0)) * (-1.0 if rm[0, 2] < 0 else 1.0),
    ])
    if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (rm[1, 2] > 0) != (r[1] * r[2] > 0):
        r[2] = -r[2]
    return r * (theta / np.linalg.norm(r))


def flip_keypoints(kp: np.ndarray) -> np.ndarray:
    """Left/right keypoint flip (image_utils.py:258-266)."""
    perm = J24_FLIP_PERM if len(kp) == 24 else J49_FLIP_PERM
    kp = kp[perm]
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """SMPL pose parameter flip (image_utils.py:269-278)."""
    pose = pose[SMPL_POSE_FLIP_PERM]
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


def normalize_image_np(img_hwc_255: np.ndarray) -> np.ndarray:
    """Host-side ImageNet normalization (matches device path)."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    return (img_hwc_255.astype(np.float32) / 255.0 - mean) / std


def convert_crop_coords_to_orig_img(
    bbox: np.ndarray, keypoints: np.ndarray, crop_size: int = IMG_RES
) -> np.ndarray:
    """Normalized crop keypoints -> original-image pixels (CLIFF).

    Reference: image_utils.py:120-132. bbox rows are (cx, cy, h).
    """
    kp = keypoints.copy()
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    kp[..., :2] = 0.5 * crop_size * (kp[..., :2] + 1.0)
    kp[..., :2] = kp[..., :2] * (h[..., None, None] / crop_size)
    kp[..., 0] = (cx - h / 2)[..., None] + kp[..., 0]
    kp[..., 1] = (cy - h / 2)[..., None] + kp[..., 1]
    return kp
