# Frozen copy of poco_tpu_torch/ops/rotation.py at commit 48ff100 (see __init__.py).
"""Rotation representation conversions (torch, float32, any batch shape).

Conventions match `poco_tpu.ops.rotation` and the reference framework
(pocolib/utils/geometry.py:207-261), so converted head weights decode the
same rotations.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) with real part first -> rotation (..., 3, 3)."""
    norm = torch.linalg.norm(quat, dim=-1, keepdim=True)
    q = quat / norm.clamp_min(_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return rot.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion (..., 4), smooth at the identity
    through the 2nd-order Taylor expansion of sin(x/2)/x."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle.abs() < 1e-6
    safe_angle = torch.where(small, torch.ones_like(angle), angle)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angle * angle) / 48.0, torch.sin(half) / safe_angle
    )
    return torch.cat([torch.cos(half), aa * sin_half_over_angle], dim=-1)


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula via the quaternion route: (..., 3) -> (..., 3, 3)."""
    return quat_to_rotmat(axis_angle_to_quat(aa))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> rotation matrix (Zhou et al. 2019).

    The 6 values are a (3, 2) column pair in the order
    [a1_0, a2_0, a1_1, a2_1, a1_2, a2_2]; Gram-Schmidt gives the first two
    columns of the matrix.

    Args:
        x: any shape whose size is a multiple of 6.
    Returns:
        (N, 3, 3) rotation matrices, N = x.numel() // 6.
    """
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(_EPS)
    a2_proj = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2_proj / torch.linalg.norm(a2_proj, dim=-1, keepdim=True).clamp_min(
        _EPS
    )
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def quat_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> axis-angle (..., 3), with the same Taylor
    branch as `axis_angle_to_quat` near the identity."""
    norm = torch.linalg.norm(quat[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norm, quat[..., :1])
    angle = 2.0 * half
    small = angle.abs() < 1e-6
    safe_angle = torch.where(small, torch.ones_like(angle), angle)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angle * angle) / 48.0, torch.sin(half) / safe_angle
    )
    return quat[..., 1:] / sin_half_over_angle


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) with w >= 0.

    Branchless Shepperd selection: of the four candidate decompositions,
    the one whose 4 q_i^2 trace is largest (reference
    pocolib/utils/geometry.py:101-127).
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    t_w = 1.0 + m00 + m11 + m22
    t_x = 1.0 + m00 - m11 - m22
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22
    cands = torch.stack(
        [
            torch.stack([t_w, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, t_x, m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, t_y, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, t_z], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    traces = torch.stack([t_w, t_x, t_y, t_z], dim=-1)
    best = traces.argmax(dim=-1, keepdim=True)
    q = torch.take_along_dim(cands, best[..., None], dim=-2)[..., 0, :]
    t_best = torch.take_along_dim(traces, best, dim=-1)
    q = q * (0.5 / torch.sqrt(t_best.clamp_min(_EPS)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_axis_angle(rotmat_to_quat(rot))


def rotmat_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> 6D (..., 6): the first two columns,
    row-major, so that rot6d_to_rotmat(rotmat_to_rot6d(R)) == R."""
    return rot[..., :, :2].reshape(rot.shape[:-2] + (6,))


def flip_pose_rotmat(rot: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of an SMPL pose (B, 24, 3, 3): the left/right joint
    permutation, then conjugation by S = diag(1, -1, -1) (a rotation by pi
    about x, so the result stays in SO(3)); the rotmat form of the
    reference's axis-angle flip (constants.py:104-114). An involution."""
    from .constants import SMPL_JOINTS_FLIP_PERM

    s = torch.tensor([1.0, -1.0, -1.0], dtype=rot.dtype, device=rot.device)
    perm = torch.as_tensor(SMPL_JOINTS_FLIP_PERM, device=rot.device)
    # S R S flips the signs of the entries where exactly one index is 0
    return rot[:, perm] * s[:, None] * s[None, :]


def average_rotmats(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Chordal mean of two rotation batches (..., 3, 3): the arithmetic
    mean projected back to SO(3) by a batched SVD with the determinant's
    sign fix. average_rotmats(R, R) == R."""
    u, _, vh = torch.linalg.svd(0.5 * (ra + rb))
    det = torch.linalg.det(u @ vh)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    return (u * d[..., None, :]) @ vh
