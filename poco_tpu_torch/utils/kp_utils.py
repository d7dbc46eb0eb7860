"""Keypoint format registries and conversion (port of
`poco_tpu.utils.kp_utils`): the joint-name tables per annotation format,
`convert_kps`, `get_perm_idxs`, the SMPL skeleton, and the
`AverageMeter` of the uncertainty statistics."""

from __future__ import annotations

import numpy as np

from ..constants import JOINT_NAMES, SMPL_PARENTS

# ---------------------------------------------------------------------------
# Joint-name registries (lowercase short names shared across formats)
# ---------------------------------------------------------------------------

SPIN_JOINT_NAMES = JOINT_NAMES[:25] + [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop", "hip", "thorax",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)",
    "nose", "leye", "reye", "lear", "rear",
]

H36M_JOINT_NAMES = [
    "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
    "Spine (H36M)", "neck", "Head (H36M)", "headtop",
    "lshoulder", "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
]

COCO_JOINT_NAMES = [
    "nose", "leye", "reye", "lear", "rear",
    "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist", "rwrist",
    "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
]

MPII_JOINT_NAMES = [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "hip", "thorax", "neck", "headtop",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
]

COMMON_JOINT_NAMES = [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle",
    "rwrist", "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist",
    "neck", "headtop",
]

PW3D_JOINT_NAMES = [
    "nose", "thorax", "rshoulder", "relbow", "rwrist",
    "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
]

MPII3D_TEST_JOINT_NAMES = [
    "headtop", "neck",
    "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
    "rhip", "rknee", "rankle", "lhip", "lknee", "lankle",
    "hip", "Spine (H36M)", "Head (H36M)",
]

MPII3D_JOINT_NAMES = [
    "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
    "Head (H36M)", "headtop", "left_clavicle",
    "lshoulder", "lelbow", "lwrist", "left_hand",
    "right_clavicle", "rshoulder", "relbow", "rwrist", "right_hand",
    "lhip", "lknee", "lankle", "left_foot", "left_toe",
    "rhip", "rknee", "rankle", "right_foot", "right_toe",
]

POSETRACK_JOINT_NAMES = [
    "nose", "neck", "headtop", "lear", "rear",
    "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist", "rwrist",
    "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
]

PENNACTION_JOINT_NAMES = [
    "headtop", "lshoulder", "rshoulder", "lelbow", "relbow",
    "lwrist", "rwrist", "lhip", "rhip", "lknee", "rknee",
    "lankle", "rankle",
]

JOINT_NAME_REGISTRY: dict[str, list[str]] = {
    "spin": SPIN_JOINT_NAMES,
    "h36m": H36M_JOINT_NAMES,
    "coco": COCO_JOINT_NAMES,
    "mpii": MPII_JOINT_NAMES,
    "common": COMMON_JOINT_NAMES,
    "3dpw": PW3D_JOINT_NAMES,
    # the reference's CamelCase names (get_smpl_joint_names,
    # kp_utils.py:795-821) — NOT the snake_case display names: these
    # deliberately match no other registry, so convert_kps to/from
    # 'smpl' returns zero rows exactly as the reference does
    "smpl": [
        "Hips", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee",
        "Spine2", "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot",
        "Neck", "L_Collar", "R_Collar", "Head", "L_Shoulder",
        "R_Shoulder", "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist",
        "L_Hand", "R_Hand",
    ],
    "mpii3d_test": MPII3D_TEST_JOINT_NAMES,
    "mpii3d": MPII3D_JOINT_NAMES,
    "posetrack": POSETRACK_JOINT_NAMES,
    "pennaction": PENNACTION_JOINT_NAMES,
}


def get_joint_names(fmt: str) -> list[str]:
    return JOINT_NAME_REGISTRY[fmt]


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Remap (N, J_src, 3) keypoints between formats by joint name.

    Missing joints become zero rows (reference kp_utils.py:14-25).
    """
    src_names = get_joint_names(src)
    dst_names = get_joint_names(dst)
    out = np.zeros((joints.shape[0], len(dst_names), 3), joints.dtype)
    for idx, name in enumerate(dst_names):
        if name in src_names:
            out[:, idx] = joints[:, src_names.index(name)]
    return out


def get_perm_idxs(src: str, dst: str) -> list[int]:
    """Indices into src selecting dst's joints (reference kp_utils.py:27-31)."""
    src_names = get_joint_names(src)
    return [
        src_names.index(n) for n in get_joint_names(dst) if n in src_names
    ]


def get_smpl_skeleton() -> np.ndarray:
    """(23, 2) parent->child edges of the SMPL tree (kp_utils.py:881-908),
    derived from the parent table."""
    return np.array(
        [[int(SMPL_PARENTS[j]), j] for j in range(1, 24)], np.int64
    )



class AverageMeter:
    """Running avg/min/max tracker (reference eval_utils.py:183-201)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = -float("inf")

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.min = min(self.min, val)
        self.max = max(self.max, val)
