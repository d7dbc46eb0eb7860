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
