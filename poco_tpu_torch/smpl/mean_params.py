"""Mean SMPL parameters that initialize the iterative regression heads.

The reference loads SPIN's `smpl_mean_params.npz` (cliff_head.py:43-49).
Without the asset, the identity pose in 6D form and a canonical
weak-perspective camera keep the 3-iteration decoders well conditioned.
"""

from __future__ import annotations

import os

import numpy as np

# Identity rotation in the column-pair 6D layout read by rot6d_to_rotmat:
# [a1_0, a2_0, a1_1, a2_1, a1_2, a2_2] = [1, 0, 0, 1, 0, 0].
_IDENTITY_6D = np.array([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], np.float32)


def load_mean_params(path: str | None = None, num_joints: int = 24):
    """Returns (init_pose (J*6,), init_shape (10,), init_cam (3,))."""
    path = path or os.environ.get("POCO_TPU_SMPL_MEAN_PARAMS", "")
    if path and os.path.exists(path):
        d = np.load(path)
        pose = np.asarray(d["pose"][: num_joints * 6], np.float32)
        shape = np.asarray(d["shape"], np.float32).reshape(-1)[:10]
        cam = np.asarray(d["cam"], np.float32).reshape(-1)[:3]
        return pose, shape, cam
    pose = np.tile(_IDENTITY_6D, num_joints)
    shape = np.zeros(10, np.float32)
    cam = np.array([0.9, 0.0, 0.0], np.float32)
    return pose, shape, cam
