"""Frozen copy of humor_torch/body_model/constants.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

SMPL skeleton constants (a copy of humor_tpu/body_model/constants.py:
the port imports nothing from the JAX package).

Behavioral parity with the reference repo's humor/body_model/utils.py:5-19 and
the reference repo's humor/datasets/amass_utils.py:22-27 — these are public,
model-defined constants (joint ordering of the SMPL body, kinematic tree,
chosen mocap-marker vertices), not code.
"""

from __future__ import annotations


# 22 SMPL body joints (root + 21), canonical ordering.
SMPL_JOINT_NAMES = [
    "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
    "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
    "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
    "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
    "rightHand",
]
SMPL_JOINTS = {name: i for i, name in enumerate(SMPL_JOINT_NAMES)}
NUM_SMPL_JOINTS = len(SMPL_JOINT_NAMES)  # 22
NUM_BODY_JOINTS = NUM_SMPL_JOINTS - 1    # 21 (no root)

# parent[i] is the kinematic parent of joint i (-1 for root).
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 12, 12, 13, 14,
                16, 17, 18, 19]

# Joints whose binary ground-contact state the model predicts
# (reference amass_utils.py:22-23).
CONTACT_ORDERING = [
    "hips", "leftLeg", "rightLeg", "leftFoot", "rightFoot", "leftToeBase",
    "rightToeBase", "leftHand", "rightHand",
]
CONTACT_INDS = [SMPL_JOINTS[n] for n in CONTACT_ORDERING]
NUM_CONTACTS = len(CONTACT_ORDERING)  # 9

# 43 virtual mocap-marker vertex ids on the SMPL mesh used as "keypoints"
# (reference body_model/utils.py:17-19).
KEYPT_VERTS = [
    4404, 920, 3076, 3169, 823, 4310, 1010, 1085, 4495, 4569, 6615, 3217,
    3313, 6713, 6785, 3383, 6607, 3207, 1241, 1508, 4797, 4122, 1618, 1569,
    5135, 5040, 5691, 5636, 5404, 2230, 2173, 2108, 134, 3645, 6543, 3123,
    3024, 4194, 1306, 182, 3694, 4294, 744,
]
NUM_KEYPT_VERTS = len(KEYPT_VERTS)  # 43

BETA_SIZE = 16

# Default asset locations (same layout as the reference repo so users can
# reuse their downloaded body models).
SMPLH_PATH = "./body_models/smplh"
SMPL_PATH = "./body_models/smpl"
SMPLX_PATH = "./body_models/smplx"
VPOSER_PATH = "./body_models/vposer_v1_0"


# OpenPose BODY_25 constants used by the fitting losses
# (reference fitting/fitting_utils.py:678-682).
OP_NUM_JOINTS = 25
OP_IGNORE_JOINTS = [1, 9, 12]  # midhip and spine/neck interpolations
OP_EDGE_LIST = [
    [1, 8], [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [8, 9], [9, 10],
    [10, 11], [8, 12], [12, 13], [13, 14], [1, 0], [0, 15], [15, 17], [0, 16],
    [16, 18], [14, 19], [19, 20], [14, 21], [11, 22], [22, 23], [11, 24],
]
# indices to swap under a left/right image flip
OP_FLIP_MAP = [
    (2, 5), (3, 6), (4, 7), (9, 12), (10, 13), (11, 14), (15, 16), (17, 18),
    (22, 19), (23, 20), (24, 21),
]
