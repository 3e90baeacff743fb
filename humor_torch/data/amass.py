"""AMASS preprocessing: raw mocap arrays -> a training-ready sequence
(port of the parts of humor_tpu/data/amass.py that training needs).

Trim to the middle 80%, a chunked SMPL forward (joints and the keypoint
vertices), the floor height and contacts from velocity and height
thresholds with a 1-d gap clustering of the static toe heights, the
terrain-sequence discard, central-difference velocities, the 30 Hz
downsample and the per-frame heading rotations. Host numpy except the
SMPL forward, which runs on the body model's device. Reading and writing
the npz files (process_file, cleanup_amass) is not ported yet (ROADMAP
A7).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.body_model import smpl as smpl_lib
from humor_torch.ops import transforms

OUT_FPS = 30
SPLIT_FRAME_LIMIT = 2000
DISCARD_SHORTER_THAN = 1.0  # seconds

FLOOR_VEL_THRESH = 0.005
FLOOR_HEIGHT_OFFSET = 0.01
CONTACT_VEL_THRESH = 0.005
CONTACT_TOE_HEIGHT_THRESH = 0.04
CONTACT_ANKLE_HEIGHT_THRESH = 0.08
TERRAIN_HEIGHT_THRESH = 0.04
ROOT_HEIGHT_THRESH = 0.04
CLUSTER_SIZE_THRESH = 0.25

# the HuMoR paper's split by mocap dataset
TRAIN_DATASETS = ["CMU", "MPI_Limits", "TotalCapture", "Eyes_Japan_Dataset",
                  "KIT", "BioMotionLab_NTroje", "BMLmovi", "EKUT", "ACCAD"]
TEST_DATASETS = ["Transitions_mocap", "HumanEva"]
VAL_DATASETS = ["MPI_HDM05", "SFU", "MPI_mosh"]
ALL_DATASETS = TRAIN_DATASETS + TEST_DATASETS + VAL_DATASETS


def cluster_1d(values: np.ndarray, eps: float = 0.005,
               min_samples: int = 3) -> np.ndarray:
    """DBSCAN(eps, min_samples) labels for 1-d data: sort, split where
    consecutive values are more than eps apart, clusters smaller than
    min_samples are noise (-1)."""
    n = values.shape[0]
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    order = np.argsort(values)
    sv = values[order]
    breaks = np.nonzero(np.diff(sv) > eps)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [n]])
    next_label = 0
    for s, e in zip(starts, ends):
        if e - s >= min_samples:
            labels[order[s:e]] = next_label
            next_label += 1
    return labels


def _joint_vel(joints: np.ndarray, idx: int) -> np.ndarray:
    """Per-frame displacement magnitude of one joint, last value repeated."""
    seq = joints[:, idx]
    vel = np.linalg.norm(seq[1:] - seq[:-1], axis=1)
    return np.append(vel, vel[-1])


def _contact(joints: np.ndarray, name: str, floor_height: float,
             vel_thresh: float, height_thresh: float) -> np.ndarray:
    j = C.SMPL_JOINTS[name]
    heights = joints[:, j, 2] - floor_height
    return np.logical_and(_joint_vel(joints, j) < vel_thresh,
                          heights < height_thresh)


def determine_floor_height_and_contacts(
        joints: np.ndarray, fps: float, discard_terrain: bool = True
) -> Tuple[float, np.ndarray, bool]:
    """joints (N, 22, 3), z up -> (floor_height, contacts (N, 22),
    discard): the floor is the median of the lowest cluster of static toe
    heights."""
    N = joints.shape[0]
    lt, rt = C.SMPL_JOINTS["leftToeBase"], C.SMPL_JOINTS["rightToeBase"]
    left_static = _joint_vel(joints, lt) < FLOOR_VEL_THRESH
    right_static = _joint_vel(joints, rt) < FLOOR_VEL_THRESH
    root_h = joints[:, C.SMPL_JOINTS["hips"], 2]
    static_h = np.concatenate([joints[left_static, lt, 2],
                               joints[right_static, rt, 2]])
    static_i = np.concatenate([np.arange(N)[left_static],
                               np.arange(N)[right_static]])

    discard = False
    if static_h.shape[0] > 0:
        labels = cluster_1d(static_h)
        heights, root_heights, sizes = [], [], []
        for lab in np.unique(labels):
            clust = static_h[labels == lab]
            inds = np.unique(static_i[labels == lab])
            heights.append(np.median(clust))
            root_heights.append(np.median(root_h[inds]))
            sizes.append(clust.shape[0])
        best = int(np.argmin(heights))
        floor_height = heights[best]
        min_root = root_heights[best]
        if discard_terrain:
            for rh, h, sz in zip(root_heights, heights, sizes):
                if (rh > min_root + ROOT_HEIGHT_THRESH
                        and h > floor_height + TERRAIN_HEIGHT_THRESH
                        and sz > int(CLUSTER_SIZE_THRESH * fps)):
                    discard = True
                    break
        offset_floor = floor_height - FLOOR_HEIGHT_OFFSET
    else:
        floor_height = offset_floor = 0.0

    contacts = np.zeros((N, C.NUM_SMPL_JOINTS), np.float64)
    for name, thresh in (
            ("leftFoot", CONTACT_ANKLE_HEIGHT_THRESH),
            ("rightFoot", CONTACT_ANKLE_HEIGHT_THRESH),
            ("leftToeBase", CONTACT_TOE_HEIGHT_THRESH),
            ("rightToeBase", CONTACT_TOE_HEIGHT_THRESH),
            ("leftHand", CONTACT_ANKLE_HEIGHT_THRESH),
            ("rightHand", CONTACT_ANKLE_HEIGHT_THRESH),
            ("leftLeg", CONTACT_ANKLE_HEIGHT_THRESH),
            ("rightLeg", CONTACT_ANKLE_HEIGHT_THRESH)):
        contacts[:, C.SMPL_JOINTS[name]] = _contact(
            joints, name, floor_height, CONTACT_VEL_THRESH, thresh)
    return offset_floor, contacts, discard


def estimate_velocity(seq: np.ndarray, h: float) -> np.ndarray:
    """Central difference over axis 0: (T, ...) -> (T-2, ...)."""
    return (seq[2:] - seq[:-2]) / (2.0 * h)


def estimate_angular_velocity(rot_seq: np.ndarray, h: float) -> np.ndarray:
    """(T, ..., 3, 3) rotations -> (T-2, ..., 3) angular velocities."""
    w_mat = np.matmul(estimate_velocity(rot_seq, h),
                      np.swapaxes(rot_seq[1:-1], -1, -2))
    w_x = (-w_mat[..., 1, 2] + w_mat[..., 2, 1]) / 2.0
    w_y = (w_mat[..., 0, 2] - w_mat[..., 2, 0]) / 2.0
    w_z = (-w_mat[..., 0, 1] + w_mat[..., 1, 0]) / 2.0
    return np.stack([w_x, w_y, w_z], axis=-1)


def _aa_to_rotmat(aa: np.ndarray) -> np.ndarray:
    return transforms.aa_to_rotmat(
        torch.as_tensor(np.asarray(aa, np.float32))).numpy()


def compute_align_mats(root_orient_aa: np.ndarray) -> np.ndarray:
    """Per-frame heading-canonicalizing rotations from aa root orients."""
    return transforms.compute_world2aligned_mat(
        torch.as_tensor(_aa_to_rotmat(root_orient_aa))).numpy()


def compute_joint_align_mats(joints: np.ndarray) -> np.ndarray:
    """Per-frame heading rotations from the hip joints."""
    return transforms.compute_world2aligned_joints_mat(
        torch.as_tensor(np.asarray(joints, np.float32))).numpy()


def smpl_sequence(model: smpl_lib.SmplModel, root_orient: np.ndarray,
                  pose_body: np.ndarray, betas: np.ndarray,
                  trans: np.ndarray, pose_hand: Optional[np.ndarray] = None,
                  chunk: int = SPLIT_FRAME_LIMIT
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SMPL over a (N, ...) sequence in chunks of `chunk` frames, on the
    model's device -> (joints (N, 22, 3), keypoint vertices (N, K, 3));
    only the keypoint vertices the body has are skinned."""
    dev = model.v_template.device
    N = trans.shape[0]
    keypt = np.asarray([i for i in C.KEYPT_VERTS if i < model.num_verts])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    joints_out, verts_out = [], []
    with torch.no_grad():
        for s in range(0, N, chunk):
            e = min(N, s + chunk)
            out = smpl_lib.forward(
                model, f32(root_orient[s:e]), f32(pose_body[s:e]),
                f32(np.repeat(betas[None], e - s, axis=0)), f32(trans[s:e]),
                pose_hand=None if pose_hand is None else f32(pose_hand[s:e]),
                vert_ids=keypt)
            joints_out.append(out.Jtr[:, :C.NUM_SMPL_JOINTS].cpu().numpy())
            verts_out.append(out.v.cpu().numpy())
    return np.concatenate(joints_out), np.concatenate(verts_out)


def process_sequence(model: smpl_lib.SmplModel, raw: Dict[str, np.ndarray],
                     num_betas: int = C.BETA_SIZE, out_fps: int = OUT_FPS,
                     discard_terrain: bool = True
                     ) -> Optional[Dict[str, np.ndarray]]:
    """Raw AMASS arrays {fps, gender, trans, root_orient, pose_body,
    [pose_hand], betas} -> the processed sequence dict, or None when the
    sequence is discarded (too short, or on terrain)."""
    fps = float(np.asarray(raw["fps"]))
    trans = np.asarray(raw["trans"], np.float64)
    root_orient = np.asarray(raw["root_orient"], np.float64)
    pose_body = np.asarray(raw["pose_body"], np.float64)
    pose_hand = (np.asarray(raw.get("pose_hand"), np.float64)
                 if raw.get("pose_hand") is not None else None)
    betas = np.asarray(raw["betas"], np.float64)[:num_betas]
    N = trans.shape[0]

    s, e = int(0.1 * N), int(0.9 * N)      # the middle 80%
    trans, root_orient, pose_body = trans[s:e], root_orient[s:e], pose_body[s:e]
    if pose_hand is not None:
        pose_hand = pose_hand[s:e]
    N = trans.shape[0]
    if N < DISCARD_SHORTER_THAN * fps:
        return None

    joints, verts = smpl_sequence(model, root_orient, pose_body, betas,
                                  trans, pose_hand)
    joints = joints.astype(np.float64)
    verts = verts.astype(np.float64)

    floor_height, contacts, discard = determine_floor_height_and_contacts(
        joints, fps, discard_terrain=discard_terrain)
    if discard:
        return None
    trans[:, 2] -= floor_height
    joints[:, :, 2] -= floor_height
    verts[:, :, 2] -= floor_height

    joints_w2a = compute_joint_align_mats(joints).astype(np.float64)
    h = 1.0 / fps
    joints_vel = estimate_velocity(joints, h)
    verts_vel = estimate_velocity(verts, h)
    trans_vel = estimate_velocity(trans, h)
    root_orient_vel = estimate_angular_velocity(
        _aa_to_rotmat(root_orient).astype(np.float64), h)
    pose_body_vel = estimate_angular_velocity(
        _aa_to_rotmat(pose_body.reshape(N, -1, 3)).astype(np.float64), h)
    joint_orient_vel = -estimate_angular_velocity(joints_w2a, h)[:, 2]

    # velocities exist on the middle N-2 frames
    N = N - 2
    contacts = contacts[1:-1]
    trans, root_orient, pose_body = trans[1:-1], root_orient[1:-1], pose_body[1:-1]
    joints, verts = joints[1:-1], verts[1:-1]

    if out_fps < fps:
        new_n = int(float(out_fps) / fps * N)
        ds = np.linspace(0, N - 1, num=new_n, dtype=int)
        fps = float(out_fps)
        contacts, trans, root_orient, pose_body = (
            contacts[ds], trans[ds], root_orient[ds], pose_body[ds])
        joints, verts = joints[ds], verts[ds]
        joints_vel, verts_vel, trans_vel = (
            joints_vel[ds], verts_vel[ds], trans_vel[ds])
        root_orient_vel, pose_body_vel = root_orient_vel[ds], pose_body_vel[ds]
        joint_orient_vel = joint_orient_vel[ds]

    return {
        "fps": fps,
        "gender": str(raw.get("gender", "neutral")),
        "floor_height": floor_height,
        "contacts": contacts,
        "trans": trans,
        "root_orient": root_orient,
        "pose_body": pose_body,
        "betas": np.asarray(raw["betas"], np.float64),
        "joints": joints,
        "mojo_verts": verts,
        "joints_vel": joints_vel,
        "mojo_verts_vel": verts_vel,
        "trans_vel": trans_vel,
        "root_orient_vel": root_orient_vel,
        "joint_orient_vel_seq": joint_orient_vel,
        "pose_body_vel": pose_body_vel,
        "world2aligned_rot": compute_align_mats(root_orient).astype(
            np.float64),
    }
