"""iMapper (i3DB) observations (port of humor_tpu/data/imapper.py, host
code in numpy): OpenPose 2D keypoints + annotated 3D joints for RGB
fitting evaluation.

The GT joints are masked to inf where their confidence is zero and
placed from the ~7.5 Hz annotation onto the 30 Hz video with the i3DB
release's irregular early-frame pattern; the GT floor is a plane fitted
to the lower corners of the scene's annotated floor-contact boxes.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from humor_torch.body_model import constants as C
from humor_torch.data.rgb import read_keypoints, split_overlapping_windows


# scene-object parts whose lower corners rest on the floor, per i3DB
# scene
GROUND_CTC_PARTS = {
    "Scene05": ["00_couch_seat"],
    "Scene07": ["00_couch_seat", "01_couch_seat"],
    "Scene10": ["00_couch_seat", "01_couch_seat", "03_couch_seat"],
    "Scene11": ["00_couch_seat", "01_couch_seat", "01_couch_seat-1",
                "02_couch_seat"],
    "Scene13": ["04_couch_seat"]
    + [f"{p}_chair_leg{s}" for p in ("05", "07", "08", "09")
       for s in ("", "-1", "-2", "-3")],
    "Scene14": [f"{p}_chair_leg{s}" for p in ("01", "02", "03")
                for s in ("", "-1", "-3", "-4")]
    + [f"04_table_leg{s}" for s in ("", "-1", "-2", "-3")]
    + [f"00_couch_leg{s}" for s in ("", "-1", "-3", "-4")],
}

# unit-cube corner signs and triangle faces
_OBB_CORNERS = np.asarray(
    [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1),
     (1, 1, -1), (1, -1, -1), (1, -1, 1), (1, 1, 1)], np.float32)
_OBB_FACES = np.asarray(
    [(0, 3, 1), (3, 2, 1), (0, 1, 5), (1, 6, 5), (4, 5, 6), (4, 6, 7),
     (3, 4, 2), (4, 7, 2), (4, 3, 5), (3, 0, 5), (6, 2, 7), (6, 1, 2)],
    np.int32)


@dataclass
class Obb:
    """Oriented bounding box of an annotated i3DB scene object
    (a plain dataclass + pure functions).
    `axes` holds the box axes in COLUMNS; `scales` are full side
    lengths."""

    centroid: np.ndarray  # (3,)
    axes: np.ndarray      # (3, 3), axes in columns
    scales: np.ndarray    # (3,)

    @classmethod
    def from_json(cls, data: Dict) -> "Obb":
        return cls(centroid=np.asarray(data["centroid"],
                                       np.float32).reshape(3),
                   axes=np.asarray(data["axes"], np.float32).reshape(3, 3),
                   scales=np.asarray(data["scales"],
                                     np.float32).reshape(3))

    @classmethod
    def load(cls, path: str) -> "Obb":
        with open(path) as f:
            return cls.from_json(json.load(f))

    def corners_3d(self) -> np.ndarray:
        """All 8 corners, (8, 3)."""
        half = self.axes * (self.scales[None, :] / 2.0)  # columns scaled
        return self.centroid[None] + _OBB_CORNERS @ half.T

    def faces_3d(self) -> np.ndarray:
        """(12, 3) triangle vertex indices into corners_3d."""
        return _OBB_FACES.copy()

    def corners_3d_lower(self, up_axis=(0.0, -1.0, 0.0)) -> np.ndarray:
        """The 4 corners lowest along `up_axis` (camera frame: -y is up),
        ordered so consecutive corners share an edge."""
        c3d = self.corners_3d()
        idx = np.argsort(c3d @ np.asarray(up_axis, np.float32))
        quad = c3d[sorted(idx[:4])]
        for i in range(4):
            i1, i2 = (i + 1) % 4, (i + 2) % 4
            if (np.linalg.norm(quad[i1] - quad[i])
                    > np.linalg.norm(quad[i2] - quad[i])):
                quad[[i1, i2]] = quad[[i2, i1]]
        return quad


def fit_floor_plane_from_points(pts: np.ndarray) -> np.ndarray:
    """Least-squares plane y = a*x + c*z + d over floor-contact points ->
    (4,) [nx, ny, nz, offset] with the normal facing up (-y in camera
    coords), by numpy least squares."""
    A = np.stack([pts[:, 0], pts[:, 2], np.ones(len(pts))], axis=1)
    (a, c, d), *_ = np.linalg.lstsq(A.astype(np.float64), pts[:, 1],
                                    rcond=None)
    normal = np.asarray([-a, 1.0, -c])
    mag = np.linalg.norm(normal)
    normal, intercept = normal / mag, d / mag
    if normal[1] > 0.0:
        normal, intercept = -normal, -intercept
    return np.concatenate([normal, [intercept]]).astype(np.float32)


def fit_gt_floor_from_scene(scene_dir: str, scene_name: str,
                            obb_names: Optional[List[str]] = None
                            ) -> Optional[np.ndarray]:
    """GT floor plane from the scene's annotated object boxes: gather the
    floor-contact parts' lower corners and fit a plane. Returns None when the scene has no usable annotations."""
    parts = (obb_names if obb_names is not None
             else GROUND_CTC_PARTS.get(scene_name))
    if not parts:
        return None
    pts = []
    for name in parts:
        path = osp.join(scene_dir, "gt", name + ".json")
        if not osp.exists(path):
            continue
        pts.append(Obb.load(path).corners_3d_lower())
    if not pts:
        return None
    return fit_floor_plane_from_points(np.concatenate(pts, axis=0))


def parse_gt_skeleton(scene_info: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """i3DB GT json -> (joints3d (F, J, 3) with inf for unobserved,
    occlusion mask (F, J))."""
    joints3d = []
    for k, v in sorted(scene_info["3d"].items(), key=lambda kv: int(kv[0])):
        nj = len(v)
        dim = len(v[list(v.keys())[0]])
        pose = np.zeros((dim, nj), np.float32)
        for joint, pos in v.items():
            pose[:, int(joint)] = pos
        joints3d.append(pose.T)
    joints3d = np.stack(joints3d)
    F, J = joints3d.shape[:2]

    conf = np.zeros((F, J, 1), np.float32)
    for fid, v in enumerate(scene_info["confidence"]["values"]):
        for joint, jconf in v.items():
            conf[fid, int(joint)] = float(jconf)
    conf[conf == 0.0] = np.inf
    joints3d = joints3d * conf

    occ = np.zeros((F, J), np.int64)
    for k, v in scene_info.get("occluded", {}).items():
        occ[int(k) - 1] = v
    return joints3d, occ


def align_to_30hz(sub: np.ndarray, num_obs_frames: int) -> np.ndarray:
    """Place ~7.5 Hz GT annotations onto the 30 Hz observed timeline with
    the i3DB release's irregular early-frame pattern.
    Unannotated frames are inf."""
    out = np.full((num_obs_frames,) + sub.shape[1:], np.inf, np.float64)
    n = sub.shape[0]
    pattern = [0, 2, 3, 5]
    for dst, src in zip(pattern, range(min(4, n))):
        if dst < num_obs_frames:
            out[dst] = sub[src]
    idx = 5
    for src in range(4, n):
        idx += 3
        if idx >= num_obs_frames:
            break
        out[idx] = sub[src]
    return out


@dataclass
class IMapperConfig:
    seq_len: int = 60
    overlap_len: int = 10
    img_width: int = 1920
    img_height: int = 1080


class IMapperDataset:
    """One i3DB scene -> observation windows + aligned GT."""

    def __init__(self, scene_dir: str, cfg: IMapperConfig,
                 gt_json: Optional[str] = None,
                 cam_mat: Optional[np.ndarray] = None,
                 load_gt_floor: bool = True):
        self.cfg = cfg
        keyp_paths = sorted(glob.glob(
            osp.join(scene_dir, "keypoints", "*_keypoints.json")))
        self.joints2d = (np.stack([read_keypoints(p) for p in keyp_paths])
                         if keyp_paths
                         else np.zeros((0, C.OP_NUM_JOINTS, 3), np.float32))
        self.num_frames = self.joints2d.shape[0]
        self.intervals, self.overlap = split_overlapping_windows(
            max(self.num_frames, 1), cfg.seq_len, cfg.overlap_len)

        self.gt_joints3d = None
        self.gt_occlusions = None
        if gt_json and osp.exists(gt_json):
            with open(gt_json) as f:
                info = json.load(f)
            j3d, occ = parse_gt_skeleton(info)
            self.gt_joints3d = align_to_30hz(j3d, self.num_frames)
            self.gt_occlusions = align_to_30hz(occ.astype(np.float64),
                                               self.num_frames)
        self.cam_mat = cam_mat

        # GT floor from annotated scene-object boxes (no PlaneRCNN needed)
        self.floor_plane = None
        if load_gt_floor:
            scene_name = osp.basename(osp.normpath(scene_dir))
            self.floor_plane = fit_gt_floor_from_scene(scene_dir,
                                                       scene_name)

    def observation_batch(self) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, np.ndarray]]:
        T = min(self.cfg.seq_len, max(self.num_frames, 1))
        B = len(self.intervals)
        obs: Dict[str, np.ndarray] = {
            "joints2d": np.zeros((B, T, C.OP_NUM_JOINTS, 3), np.float32),
            "seq_interval": np.asarray(self.intervals, np.int32),
        }
        gt: Dict[str, np.ndarray] = {}
        if self.gt_joints3d is not None:
            nj = self.gt_joints3d.shape[1]
            gt["joints3d"] = np.full((B, T, nj, 3), np.inf, np.float32)
        for b, (s, e) in enumerate(self.intervals):
            obs["joints2d"][b, : e - s] = self.joints2d[s:e]
            if self.gt_joints3d is not None:
                gt["joints3d"][b, : e - s] = self.gt_joints3d[s:e]
        if self.cam_mat is not None:
            fx, fy = self.cam_mat[0, 0], self.cam_mat[1, 1]
            cx, cy = self.cam_mat[0, 2], self.cam_mat[1, 2]
            obs["cam_f"] = np.tile([fx, fy], (B, 1)).astype(np.float32)
            obs["cam_center"] = np.tile([cx, cy],
                                        (B, 1)).astype(np.float32)
        if self.floor_plane is not None:
            obs["floor_plane"] = np.tile(self.floor_plane, (B, 1))
        return obs, gt
