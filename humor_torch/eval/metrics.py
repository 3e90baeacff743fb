"""Quantitative fitting-evaluation metrics (port of
humor_tpu/eval/metrics.py, in torch and numpy).

Every metric is a function over whole sequences with inf-sentinel
visibility masks, computed in float32 torch on the tensors' device;
per-point arrays come back as numpy and are aggregated on the host.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.fitting.geometry import compute_plane_intersection


def _t(x) -> torch.Tensor:
    """A tensor as it is; anything else as a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


GRND_PEN_THRESH_LIST = [0.0, 0.03, 0.06, 0.09, 0.12, 0.15]
DATA_FPS = 30.0
DATA_H = 1.0 / DATA_FPS
IMW, IMH = 1920, 1080   # all i3DB/PROX data

# Benchmark-table skip lists: sequences
# where a BASELINE method fails catastrophically are excluded from the
# quantitative comparison for every method.
# MVAE does not converge on these AMASS sequences:
AMASS_EVAL_BLACKLIST = [
    "HumanEva_S1_Box_1_poses_548_frames_30_fps",
    "HumanEva_S1_Box_3_poses_330_frames_30_fps",
    "HumanEva_S1_Gestures_1_poses_594_frames_30_fps",
]
# PROX-D fails on these PROX sub-sequences:
RGBD_EVAL_BLACKLIST = (
    [f"MPH1Library_00145_01_{i:04d}" for i in range(20, 29)]
    + [f"N0Sofa_03403_01_{i:04d}" for i in range(0, 15)]
)
# VIBE fails on these:
RGB_EVAL_BLACKLIST = ["MPH1Library_00145_01_0031", "N0Sofa_03403_01_0013"]


def filter_blacklisted(seq_names, blacklist) -> List:
    """Drop blacklisted sequence names (exact or prefix match — windowed
    results append suffixes to the recording name)."""
    return [n for n in seq_names
            if not any(os.path.basename(str(n)).startswith(b)
                       for b in blacklist)]

_J = C.SMPL_JOINTS
EE_SUBSET = [_J["leftFoot"], _J["rightFoot"], _J["leftToeBase"],
             _J["rightToeBase"], _J["leftHand"], _J["rightHand"]]
LEGS_SUBSET = [_J["leftFoot"], _J["rightFoot"], _J["leftToeBase"],
               _J["rightToeBase"], _J["leftLeg"], _J["rightLeg"]]

# 12-joint comparison skeleton (iMapper eval)
IMAP2COMPARE = [0, 1, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15]
COMP_ROOT_IDX = 4
SMPL2COMPARE = [_J["rightFoot"], _J["rightLeg"], _J["leftLeg"],
                _J["leftFoot"], _J["hips"], _J["neck"], _J["rightHand"],
                _J["rightForeArm"], _J["rightArm"], _J["leftArm"],
                _J["leftForeArm"], _J["leftHand"]]


def positional_errors(pred, gt) -> torch.Tensor:
    """Per-point position error: (T, N, 3) -> (T, N)."""
    return torch.linalg.vector_norm(_t(pred) - _t(gt), dim=-1)


def subset_joint_err(pred, gt, subset: str = "ee") -> torch.Tensor:
    """(T, 22, 3) SMPL joints -> (T, |subset|) errors."""
    inds = EE_SUBSET if subset == "ee" else LEGS_SUBSET
    return torch.linalg.vector_norm(_t(pred)[:, inds] - _t(gt)[:, inds],
                                    dim=-1)


def visibility_split(pred, gt, obs) -> Tuple[np.ndarray, np.ndarray]:
    """Split per-point errors into (visible, occluded) 1-d arrays by the
    inf sentinel in obs (T, N, 3)."""
    err = _np(positional_errors(pred, gt))
    vis = ~np.isinf(_np(obs)[..., 0])
    return err[vis], err[~vis]


def joint_accel_mag(joints, h: float = DATA_H) -> torch.Tensor:
    """(T, J, 3) -> (T-2, J) acceleration magnitudes."""
    joints = _t(joints)
    accel = (joints[:-2] - 2.0 * joints[1:-1] + joints[2:]) / (h * h)
    return torch.linalg.vector_norm(accel, dim=-1)


def toe_floor_penetration(joints, floor_plane=None,
                          thresh_list=GRND_PEN_THRESH_LIST
                          ) -> Tuple[List[int], int, np.ndarray]:
    """(T, 22, 3) joints -> (pen counts per threshold, total toe-frames,
    penetration distances at threshold 0)."""
    joints = _t(joints)
    floor_plane = (torch.tensor([0.0, 0.0, 1.0, 0.0]) if floor_plane is None
                   else _t(floor_plane)).to(joints)
    toes = joints[:, [_J["leftToeBase"], _J["rightToeBase"]]]
    toes = toes.reshape(-1, 3)
    normal = floor_plane[:3] / torch.linalg.vector_norm(floor_plane[:3])
    plane = floor_plane.expand(toes.shape[0], 4)
    _, s = compute_plane_intersection(toes, (-normal).expand(toes.shape),
                                      plane)
    s = _np(s)
    counts = [int((s < -t).sum()) for t in thresh_list]
    pen_dist = -s[s < 0]
    return counts, int(s.shape[0]), pen_dist


def contact_accuracy(pred_contacts: np.ndarray, gt_contacts: np.ndarray
                     ) -> Tuple[int, int]:
    """Binary contact agreement over the 9 prior joints -> (correct,
    total). Accepts either full 22-joint arrays or the 9-contact-joint
    packing (the dataset's storage layout)."""
    def _nine(x):
        x = _np(x)
        if x.shape[-1] == len(C.CONTACT_INDS):
            return x
        return x[..., np.asarray(C.CONTACT_INDS)]

    p, g = _nine(pred_contacts), _nine(gt_contacts)
    return int(((p - g) == 0).sum()), int(p.size)


def align_to_root(joints, root_idx: int = 0) -> torch.Tensor:
    """Root-align a joint sequence (T, J, 3) by subtracting the root."""
    joints = _t(joints)
    return joints - joints[:, root_idx:root_idx + 1]


def quant_eval_3d(pred: Dict, gt: Dict, obs: Dict) -> Dict[str, np.ndarray]:
    """One sequence's 3D eval: per-point errors for joints3d/verts3d/
    mesh3d (+ee/legs, vis/occ splits), accel, ground penetration, contact accuracy. Returns raw per-point arrays for
    host-side aggregation."""
    out: Dict[str, np.ndarray] = {}
    for modality in ("joints3d", "verts3d", "mesh3d"):
        if modality not in pred or modality not in gt:
            continue
        out[f"{modality}_all"] = _np(
            positional_errors(pred[modality], gt[modality])).reshape(-1)
        if modality == "joints3d":
            out["joints3d_ee"] = _np(
                subset_joint_err(pred[modality], gt[modality], "ee")
            ).reshape(-1)
            out["joints3d_legs"] = _np(
                subset_joint_err(pred[modality], gt[modality], "legs")
            ).reshape(-1)
        if modality in obs:
            vis, occ = visibility_split(pred[modality], gt[modality],
                                        obs[modality])
            out[f"{modality}_vis"] = vis
            out[f"{modality}_occ"] = occ

    out["accel_mag"] = _np(
        joint_accel_mag(pred["joints3d"])).reshape(-1)

    counts, total, pen_dist = toe_floor_penetration(pred["joints3d"])
    out["ground_pen_dist"] = pen_dist
    for t, c in zip(GRND_PEN_THRESH_LIST, counts):
        key = f"ground_pen@{t:.2f}"
        out[key] = np.asarray([c])
        out[key + "_cnt"] = np.asarray([total])

    if "contacts" in pred and "contacts" in gt:
        correct, total_c = contact_accuracy(pred["contacts"],
                                            gt["contacts"])
        out["contact_acc"] = np.asarray([correct])
        out["contact_acc_cnt"] = np.asarray([total_c])
    return out


def aggregate(per_seq: List[Dict[str, np.ndarray]]
              ) -> Dict[str, Dict[str, float]]:
    """Aggregate per-sequence metric arrays into mean/std/median/max/min
    (one CSV row a metric). Ratio metrics
    (ground_pen@*, contact_acc) aggregate count/total."""
    keys = sorted({k for d in per_seq for k in d
                   if not k.endswith("_cnt")})
    out: Dict[str, Dict[str, float]] = {}
    for k in keys:
        if k.startswith("ground_pen@") or k == "contact_acc":
            num = sum(float(d[k][0]) for d in per_seq if k in d)
            den = sum(float(d[k + "_cnt"][0]) for d in per_seq if k in d)
            out[k] = {"frac": num / max(den, 1.0)}
            continue
        vals = np.concatenate([d[k] for d in per_seq if k in d and
                               d[k].size > 0]) if any(
            k in d and d[k].size for d in per_seq) else np.zeros(0)
        if vals.size == 0:
            out[k] = {"mean": 0.0, "std": 0.0, "median": 0.0,
                      "max": 0.0, "min": 0.0}
        else:
            out[k] = {"mean": float(vals.mean()),
                      "std": float(vals.std()),
                      "median": float(np.median(vals)),
                      "max": float(vals.max()),
                      "min": float(vals.min())}
    return out


def to_comparison_skeleton(joints, source: str = "smpl") -> torch.Tensor:
    """Map SMPL (22) or iMapper (16) joints onto the shared 12-joint
    comparison skeleton."""
    idx = SMPL2COMPARE if source == "smpl" else IMAP2COMPARE
    return _t(joints)[..., idx, :]


def occlusion_from_masks(gt_joints: np.ndarray,      # (T, J, 3) cam frame
                         masks: np.ndarray,          # (T, H, W) 0/1
                         cam_intrins,                # (fx, fy, cx, cy)
                         ) -> np.ndarray:
    """Per-GT-joint occlusion by projecting each joint into the frame's
    occluder mask (round the pinhole
    projection to pixel coordinates, clamp to the image, and read the
    mask — 1 means the joint lands on an occluding object). Returns
    (T, J) bool; non-finite GT joints come back False (they are dropped
    by the validity mask upstream)."""
    g = np.asarray(gt_joints, np.float64)
    T, J = g.shape[:2]
    H, W = np.asarray(masks).shape[-2:]
    fx, fy, cx, cy = [float(v) for v in cam_intrins]
    finite = np.isfinite(g).all(axis=-1)           # (T, J)
    safe = np.where(finite[..., None], g, 1.0)
    z = np.where(np.abs(safe[..., 2]) < 1e-9, 1e-9, safe[..., 2])
    u = np.clip(np.round(fx * safe[..., 0] / z + cx).astype(int), 0, W - 1)
    v = np.clip(np.round(fy * safe[..., 1] / z + cy).astype(int), 0, H - 1)
    m = np.asarray(masks).reshape(T, H, W)
    occ = m[np.arange(T)[:, None], v, u] == 1
    return occ & finite


def quant_eval_2d(pred_joints_smpl,                # (T, 22, 3) camera frame
                  gt_joints_imap=None,             # (T, 16, 3)
                  floor_plane=None,                # (4,)
                  occlusions=None,                 # (T, 16)
                  vis_masks: Optional[np.ndarray] = None,        # (T, H, W)
                  cam_intrins=None,                # (fx, fy, cx, cy)
                  ) -> Dict[str, np.ndarray]:
    """RGB fitting eval: iMapper comparison-skeleton MPJPE (global + root-aligned,
    all/ee/legs, vis/occ split) when GT is given; plausibility (accel +
    ground penetration vs the predicted floor) always.

    The vis/occ split uses dataset-provided per-joint `occlusions` flags
    when available, else determines occlusion by projecting GT joints
    into `vis_masks` with `cam_intrins` (the only signal on real i3DB
    data)."""
    out: Dict[str, np.ndarray] = {}

    if gt_joints_imap is not None:
        pred_c = to_comparison_skeleton(pred_joints_smpl, "smpl")
        gt_c = to_comparison_skeleton(gt_joints_imap, "imap")
        valid = ~np.isinf(_np(gt_c[..., 0]))  # (T, 12)
        err = _np(positional_errors(
            pred_c, torch.where(torch.isinf(gt_c), 0.0, gt_c)))
        out["joints3d_comp_all"] = err[valid]
        # root (pelvis, COMP_ROOT_IDX) aligned
        pred_a = pred_c - pred_c[:, COMP_ROOT_IDX: COMP_ROOT_IDX + 1]
        gt_safe = torch.where(torch.isinf(gt_c), 0.0, gt_c)
        gt_a = gt_safe - gt_safe[:, COMP_ROOT_IDX: COMP_ROOT_IDX + 1]
        err_a = _np(positional_errors(pred_a, gt_a))
        out["joints3d_comp_align"] = err_a[valid]
        occ = None
        if occlusions is not None:
            occ = _np(occlusions)[
                :, np.asarray(IMAP2COMPARE)].astype(bool)
        elif vis_masks is not None and cam_intrins is not None:
            occ = occlusion_from_masks(_np(gt_c), vis_masks,
                                       cam_intrins)
        if occ is not None:
            out["joints3d_comp_vis"] = err[valid & ~occ]
            out["joints3d_comp_occ"] = err[valid & occ]

    out["accel_mag"] = _np(
        joint_accel_mag(pred_joints_smpl)).reshape(-1)
    counts, total, pen_dist = toe_floor_penetration(
        pred_joints_smpl, floor_plane)
    out["ground_pen_dist"] = pen_dist
    for t, c in zip(GRND_PEN_THRESH_LIST, counts):
        key = f"ground_pen@{t:.2f}"
        out[key] = np.asarray([c])
        out[key + "_cnt"] = np.asarray([total])
    return out


def quant_eval_prox(pred_joints,                     # (T, 22, 3) cam frame
                    gt_joints,                       # (T, 22, 3) pseudo-GT
                    valid: np.ndarray,               # (T,) bool
                    floor_plane=None,
                    ) -> Dict[str, np.ndarray]:
    """PROX quantitative eval vs PROXD/MoSh pseudo-GT SMPL fits: joint
    position errors (all/ee/legs) restricted to frames with a valid
    pseudo-GT fit (the loader's dummy-filled frames are invalid), plus the plausibility metrics (accel + ground
    penetration) over the FULL predicted sequence."""
    valid = np.asarray(valid, bool)
    out = quant_eval_2d(pred_joints, floor_plane=floor_plane)
    if valid.any():
        sel = torch.as_tensor(valid)
        p, g = _t(pred_joints)[sel], _t(gt_joints)[sel]
        out["joints3d_all"] = _np(
            positional_errors(p, g)).reshape(-1)
        out["joints3d_ee"] = _np(
            subset_joint_err(p, g, "ee")).reshape(-1)
        out["joints3d_legs"] = _np(
            subset_joint_err(p, g, "legs")).reshape(-1)
        # root-aligned variant (local pose quality independent of the
        # global registration of the pseudo-GT)
        out["joints3d_align_all"] = _np(positional_errors(
            align_to_root(p), align_to_root(g))).reshape(-1)
    return out


def write_csv(path: str, table: Dict[str, Dict[str, float]]) -> None:
    """Write the aggregate table as CSV (metric, stat columns)."""
    import csv

    stats = sorted({s for v in table.values() for s in v})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric"] + stats)
        for k in sorted(table):
            w.writerow([k] + [table[k].get(s, "") for s in stats])
