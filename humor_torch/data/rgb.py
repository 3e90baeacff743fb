"""RGB video observations (port of humor_tpu/data/rgb.py, host code in
numpy): a video's OpenPose 2D keypoints -> overlapping sub-sequence
windows, stacked into one (B, T, ...) observation batch that the fit
optimizes jointly, its overlap-consistency terms tying the windows
together (fitting/optimizer.py).

The window split spreads the remainder over the overlaps; the keypoint
reader is the one the PROX and iMapper loaders share. Person masks
(`mask_path`, one PNG a frame named after its keypoint file) are read
with PIL as 8-bit grayscale, as cv2.imread(path, 0) reads them.
"""

from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from humor_torch.body_model import constants as C

DEFAULT_GROUND = np.array([0.0, -1.0, 0.0, -0.5])
DEFAULT_FOCAL = (1060.531764702488, 1060.3856705041412)


def split_overlapping_windows(num_frames: int, seq_len: int,
                              overlap_len: int
                              ) -> Tuple[List[Tuple[int, int]], int]:
    """Split N frames into seq_len windows overlapping by >= overlap_len,
    distributing the remainder into the overlaps.
    Returns (intervals, effective_overlap)."""
    if num_frames <= seq_len:
        return [(0, num_frames)], 0
    # a valid split needs the window to advance: overlap < seq_len
    overlap_len = min(overlap_len, seq_len - 1)
    num_seqs = math.ceil((num_frames - overlap_len)
                         / (seq_len - overlap_len))
    r = seq_len * num_seqs - overlap_len * (num_seqs - 1) - num_frames
    extra_o = r // (num_seqs - 1)
    overlap_len = overlap_len + extra_o
    new_cov = seq_len * num_seqs - overlap_len * (num_seqs - 1)
    r = new_cov - num_frames

    intervals = []
    cur_s = 0
    cur_e = cur_s + seq_len
    for i in range(num_seqs):
        intervals.append((cur_s, cur_e))
        cur_overlap = overlap_len + (1 if i < r else 0)
        cur_s += seq_len - cur_overlap
        cur_e = cur_s + seq_len
    return intervals, overlap_len


def read_keypoints(path: str) -> np.ndarray:
    """OpenPose BODY_25 JSON -> (25, 3) [x, y, conf]; zeros when no person
    was detected."""
    with open(path) as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return np.zeros((C.OP_NUM_JOINTS, 3), np.float32)
    kp = np.asarray(people[0]["pose_keypoints_2d"],
                    np.float32).reshape(-1, 3)
    return kp[:C.OP_NUM_JOINTS]


def read_gray_png(path: str) -> np.ndarray:
    """An image as (H, W) uint8 grayscale (PIL's "L" conversion)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def flip_keypoints(kp: np.ndarray, img_width: float) -> np.ndarray:
    """Left/right flip of BODY_25 keypoints (C.OP_FLIP_MAP)."""
    out = kp.copy()
    out[..., 0] = img_width - 1 - out[..., 0]
    for a, b in C.OP_FLIP_MAP:
        out[..., [a, b], :] = out[..., [b, a], :]
    return out


def mask_occluded_joints(joints2d: np.ndarray, mask: np.ndarray
                         ) -> np.ndarray:
    """Zero the confidence of joints landing on non-zero (occluder) mask
    pixels. joints2d (J, 3); mask (H, W)."""
    imh, imw = mask.shape
    uv = np.round(joints2d[:, :2]).astype(int)
    uv[:, 0] = np.clip(uv[:, 0], 0, imw - 1)
    uv[:, 1] = np.clip(uv[:, 1], 0, imh - 1)
    occluded = mask[uv[:, 1], uv[:, 0]] != 0
    out = joints2d.copy()
    out[occluded] = 0.0
    return out


def load_planercnn_floor(res_path: str) -> np.ndarray:
    """Heuristic floor plane from PlaneRCNN results: the plane with the
    most mask pixels in the bottom rows whose normal is y-dominant;
    the default ground when none is. Returns (a, b, c, d)."""
    params_path = glob.glob(os.path.join(res_path,
                                         "*_plane_parameters_*.npy"))[0]
    masks_path = glob.glob(os.path.join(res_path,
                                        "*_plane_masks_*.npy"))[0]
    params = np.load(params_path)
    masks = np.load(masks_path)

    label_count = masks[:, -10:, :].sum(axis=(1, 2))
    while True:
        idx = int(np.argmax(label_count))
        if label_count[idx] <= 0:
            return DEFAULT_GROUND.copy()
        p = params[idx]
        plane = np.asarray([p[0], -p[2], p[1]], np.float64)
        off = np.linalg.norm(plane)
        normal = plane / max(off, 1e-12)
        if normal[1] > 0:
            normal, off = -normal, -off
        if abs(normal[1]) > abs(normal[0]) and abs(normal[1]) > abs(normal[2]):
            return np.concatenate([normal, [off]]).astype(np.float32)
        label_count[idx] = 0


@dataclass
class RGBVideoConfig:
    # seq_len <= 0 means no window splitting: the whole clip is one
    # window
    seq_len: int = 60
    overlap_len: int = 10
    img_width: int = 1920
    img_height: int = 1080


class RGBVideoDataset:
    """One RGB video -> a single (B, T, ...) observation batch of
    overlapping sub-sequence windows."""

    def __init__(self, joints2d_path: str, cfg: RGBVideoConfig,
                 cam_mat: Optional[np.ndarray] = None,
                 mask_path: Optional[str] = None,
                 floor_plane: Optional[np.ndarray] = None,
                 video_name: str = "rgb_video"):
        self.cfg = cfg
        self.video_name = video_name
        keyp_paths = sorted(glob.glob(
            os.path.join(joints2d_path, "*_keypoints.json")))
        if not keyp_paths:
            raise FileNotFoundError(
                f"no *_keypoints.json under {joints2d_path}")
        frames = np.stack([read_keypoints(p) for p in keyp_paths])

        if mask_path is not None:
            names = ["_".join(os.path.basename(p).split("_")[:-1])
                     for p in keyp_paths]
            for t, name in enumerate(names):
                mp = os.path.join(mask_path, name + ".png")
                if os.path.exists(mp):
                    frames[t] = mask_occluded_joints(frames[t],
                                                     read_gray_png(mp))

        self.num_frames = frames.shape[0]
        self.seq_len = (cfg.seq_len if cfg.seq_len > 0
                        else self.num_frames)
        self.intervals, self.overlap = split_overlapping_windows(
            self.num_frames, self.seq_len, cfg.overlap_len)
        self.joints2d = frames
        if cam_mat is None:
            cam_mat = np.asarray(
                [[DEFAULT_FOCAL[0], 0, cfg.img_width / 2.0],
                 [0, DEFAULT_FOCAL[1], cfg.img_height / 2.0],
                 [0, 0, 1]], np.float32)
        self.cam_mat = cam_mat
        self.floor_plane = (np.asarray(floor_plane, np.float32)
                            if floor_plane is not None
                            else DEFAULT_GROUND.astype(np.float32))

    def observation_batch(self) -> Dict[str, np.ndarray]:
        """All windows stacked: {'joints2d' (B, T, 25, 3), 'floor_plane'
        (B, 4), 'cam_f'/'cam_center' (B, 2), 'seq_interval' (B, 2)}.
        Short final windows are zero-confidence padded to T."""
        T = self.seq_len if self.num_frames > self.seq_len \
            else self.num_frames
        B = len(self.intervals)
        j2d = np.zeros((B, T, C.OP_NUM_JOINTS, 3), np.float32)
        for b, (s, e) in enumerate(self.intervals):
            j2d[b, : e - s] = self.joints2d[s:e]
        fx, fy = self.cam_mat[0, 0], self.cam_mat[1, 1]
        cx, cy = self.cam_mat[0, 2], self.cam_mat[1, 2]
        return {
            "joints2d": j2d,
            "floor_plane": np.tile(self.floor_plane, (B, 1)),
            "cam_f": np.tile([fx, fy], (B, 1)).astype(np.float32),
            "cam_center": np.tile([cx, cy], (B, 1)).astype(np.float32),
            "seq_interval": np.asarray(self.intervals, np.int32),
        }
