# Frozen copy of poco_tpu_torch/constants.py at commit 48ff100 (see __init__.py).
"""Joint conventions, image normalization, and dataset split registries.

The 49-joint convention (25 OpenPose + 24 "ground-truth" joints) and the
SMPL-joint mapping follow the reference framework's contract
(reference: pocolib/core/constants.py:15-114) so that converted checkpoints,
npz annotation files, and evaluation protocols remain interchangeable.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Image preprocessing contract (reference: pocolib/core/constants.py:1-5)
# ---------------------------------------------------------------------------
IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)
FOCAL_LENGTH = 5000.0
IMG_RES = 224

# ---------------------------------------------------------------------------
# 49-joint superset: 25 OpenPose joints followed by 24 GT joints
# (reference: pocolib/core/constants.py:15-67)
# ---------------------------------------------------------------------------
OPENPOSE_JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip",
    "OP RHip", "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar",
    "OP LBigToe", "OP LSmallToe", "OP LHeel",
    "OP RBigToe", "OP RSmallToe", "OP RHeel",
]

GT_JOINT_NAMES = [
    "Right Ankle", "Right Knee", "Right Hip",
    "Left Hip", "Left Knee", "Left Ankle",
    "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist",
    "Neck (LSP)", "Top of Head (LSP)",
    "Pelvis (MPII)", "Thorax (MPII)",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)",
    "Nose", "Left Eye", "Right Eye", "Left Ear", "Right Ear",
]

JOINT_NAMES = OPENPOSE_JOINT_NAMES + GT_JOINT_NAMES
NUM_JOINTS_49 = len(JOINT_NAMES)
JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Index of each of the 49 joints inside the 54-joint SMPL output
# (24 LBS joints + 21 vertex-selected keypoints + 9 extra regressed joints);
# reference: pocolib/core/constants.py:73-91.
SMPL_JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17,
    "OP RElbow": 19, "OP RWrist": 21, "OP LShoulder": 16,
    "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0,
    "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30,
    "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34,
    "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45,
    "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

# Gather indices: joints54[..., JOINT_MAP_49, :] -> the 49-joint convention.
JOINT_MAP_49 = np.asarray([SMPL_JOINT_MAP[n] for n in JOINT_NAMES], dtype=np.int32)

# ---------------------------------------------------------------------------
# Joint selectors (reference: pocolib/core/constants.py:95-101)
# ---------------------------------------------------------------------------
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
J24_TO_J14 = J24_TO_J17[:14]
SMPL_J24_TO_COMMON_J14 = [8, 5, 2, 1, 4, 7, 21, 19, 17, 16, 18, 20, 12, 15]

# ---------------------------------------------------------------------------
# Left/right flip permutations (reference: pocolib/core/constants.py:104-114)
# ---------------------------------------------------------------------------
SMPL_JOINTS_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16,
    19, 18, 21, 20, 23, 22,
]
SMPL_POSE_FLIP_PERM = [
    3 * j + k for j in SMPL_JOINTS_FLIP_PERM for k in range(3)
]
J24_FLIP_PERM = [
    5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17,
    18, 19, 21, 20, 23, 22,
]
_OP25_FLIP_PERM = [
    0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17,
    22, 23, 24, 19, 20, 21,
]
J49_FLIP_PERM = _OP25_FLIP_PERM + [25 + i for i in J24_FLIP_PERM]

# ---------------------------------------------------------------------------
# SMPL kinematic tree (standard SMPL parent table; joint 0 = pelvis root)
# ---------------------------------------------------------------------------
SMPL_PARENTS = np.asarray(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21],
    dtype=np.int32,
)
SMPL_NUM_JOINTS = 24
SMPL_NUM_BETAS = 10
SMPL_NUM_VERTS = 6890

# SMPL joint names, in kinematic order (for logging / uncertainty reports).
SMPL_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hand", "right_hand",
]

# Vertex indices supplying the 21 "vertex-selected" keypoints appended after
# the 24 LBS joints (order: 5 face, 6 feet, 10 hand tips), matching the
# standard SMPL vertex-keypoint convention the reference inherits via smplx.
SMPL_VERTEX_JOINT_IDS = np.asarray(
    [
        332,   # nose
        6260,  # right eye
        2800,  # left eye
        4071,  # right ear
        583,   # left ear
        3216,  # left big toe
        3226,  # left small toe
        3387,  # left heel
        6617,  # right big toe
        6624,  # right small toe
        6787,  # right heel
        2746, 2319, 2445, 2556, 2673,   # left hand tips (thumb..pinky)
        6191, 5782, 5905, 6016, 6133,   # right hand tips (thumb..pinky)
    ],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# 3DPW split registries (reference: pocolib/core/constants.py:116-161)
# ---------------------------------------------------------------------------
PW3D_OCCLUDED_SEQUENCES = [
    "courtyard_backpack", "courtyard_basketball",
    "courtyard_bodyScannerMotions", "courtyard_box", "courtyard_golf",
    "courtyard_jacket", "courtyard_laceShoe", "downtown_stairs",
    "flat_guitar", "flat_packBags", "outdoors_climbing",
    "outdoors_crosscountry", "outdoors_fencing", "outdoors_freestyle",
    "outdoors_golf", "outdoors_parcours", "outdoors_slalom",
]

PW3D_TEST_SEQUENCES = [
    "flat_packBags_00", "downtown_weeklyMarket_00", "outdoors_fencing_01",
    "downtown_walkBridge_01", "downtown_enterShop_00",
    "downtown_rampAndStairs_00", "downtown_bar_00", "downtown_runForBus_01",
    "downtown_cafe_00", "flat_guitar_01", "downtown_runForBus_00",
    "downtown_sitOnStairs_00", "downtown_bus_00", "downtown_arguing_00",
    "downtown_crossStreets_00", "downtown_walkUphill_00",
    "downtown_walking_00", "downtown_car_00", "downtown_warmWelcome_00",
    "downtown_upstairs_00", "downtown_stairs_00",
    "downtown_windowShopping_00", "office_phoneCall_00",
    "downtown_downstairs_00",
]
