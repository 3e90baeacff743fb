"""PROX RGB-D observations (port of humor_tpu/data/prox.py, host code in
numpy): Kinect depth + OpenPose 2D -> masked, backprojected person point
clouds and keypoints for the fit.

The public PROX layout: recordings/<name>/{keypoints,Depth,BodyIndex}/,
calibration/{IR,Color}.json; 90 frames are trimmed at each end, the
images are mirrored (keypoints flipped), each frame's cloud holds at
most 4096 points (inf-padded). The camera model is OpenCV's (k1, k2, p1,
p2[, k3]): `undistort_points` is cv2.undistortPoints' fixed 5-iteration
inverse and `project_points` cv2.projectPoints' forward model, both in
float64 numpy; the 16-bit depth and 8-bit body-index PNGs are read with
PIL. Nothing here imports cv2.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from humor_torch.body_model import constants as C
from humor_torch.data.rgb import (flip_keypoints, read_gray_png,
                                  read_keypoints, split_overlapping_windows)

TRIM_EDGES = 90
MAX_POINTS = 4096
FEMALE_SUBJECTS = [162, 3452, 159, 3403]
UNDISTORT_ITERS = 5   # cv2.undistortPoints' default TermCriteria(COUNT, 5)


def gender_of_subject(subject_id: int) -> str:
    return "female" if subject_id in FEMALE_SUBJECTS else "male"


# PROX/PROXD pickle key -> our naming;
# 'betas' appears under two names across the releases
SMPL_NAME_MAP = {"transl": "trans", "beta": "betas", "betas": "betas",
                 "body_pose": "pose_body", "global_orient": "root_orient"}
SMPL_SIZES = {"trans": 3, "betas": 10, "pose_body": 63, "root_orient": 3}


def read_fitting_seq(fitting_paths: List[str], return_valid: bool = False):
    """Read a sequence of PROX/PROXD per-frame SMPL fit pickles into one
    stacked dict:
    missing files and fits containing non-finite values are dummy-filled
    with zeros and flagged invalid. Returns {trans (T, 3), betas (T, 10),
    pose_body (T, 63), root_orient (T, 3)} (+ valid bool list)."""
    import pickle

    fit = {k: [] for k in SMPL_SIZES}
    valid: List[bool] = []
    for fpath in fitting_paths:
        if not os.path.exists(fpath):
            print(f"No PROX results exist for {fpath}, filling with "
                  "dummy zeros!")
            for k, size in SMPL_SIZES.items():
                fit[k].append(np.zeros((size,), np.float32))
            valid.append(False)
            continue
        with open(fpath, "rb") as f:
            param = pickle.load(f, encoding="latin1")
        # gather the frame's components first, then append atomically:
        # a pickle missing one SMPL key (or carrying a non-finite value)
        # must not leave that component's list shorter than the others —
        # np.stack would raise or rows would misalign across frames
        frame: Dict[str, np.ndarray] = {}
        for key, name in SMPL_NAME_MAP.items():
            if key not in param or name in frame:
                continue
            frame[name] = np.asarray(param[key], np.float32).reshape(-1)
        cur_valid = (
            set(frame) == set(SMPL_SIZES)
            and all(v.shape == (SMPL_SIZES[k],) and np.isfinite(v).all()
                    for k, v in frame.items()))
        if not cur_valid:
            print(f"PROX results missing/nan for {fpath}, filling with "
                  "dummy zeros!")
        for name, size in SMPL_SIZES.items():
            fit[name].append(frame[name] if cur_valid
                             else np.zeros((size,), np.float32))
        valid.append(cur_valid)
    out = {k: np.stack(v).astype(np.float32) if v
           else np.zeros((0, SMPL_SIZES[k]), np.float32)
           for k, v in fit.items()}
    if return_valid:
        return out, valid
    return out


def _dist_coeffs(dist: np.ndarray) -> np.ndarray:
    """(k1, k2, p1, p2[, k3[, k4, k5, k6[, s1, s2, s3, s4]]]) -> 12
    coefficients, zero-padded."""
    k = np.zeros(12, np.float64)
    d = np.asarray(dist, np.float64).ravel()
    k[:d.size] = d
    return k


def undistort_points(uv: np.ndarray, camera_mtx: np.ndarray,
                     dist: np.ndarray, iters: int = UNDISTORT_ITERS
                     ) -> np.ndarray:
    """Pixels (N, 2) -> normalized image coordinates (N, 2): OpenCV's
    undistortPoints without R or P, a fixed-point iteration of the
    distortion model's inverse that stops after `iters` rounds (not at
    the exact inverse), a point falling back to its distorted
    coordinates where the radial factor turns negative."""
    k = _dist_coeffs(dist)
    K = np.asarray(camera_mtx, np.float64)
    uv = np.asarray(uv, np.float64).reshape(-1, 2)
    x0 = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (uv[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    live = np.ones(x.shape, bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) \
            / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        stop = live & (icdist < 0)
        x, y = np.where(stop, x0, x), np.where(stop, y0, y)
        live &= ~stop
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 \
            + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 \
            + k[11] * r2 * r2
        x = np.where(live, (x0 - dx) * icdist, x)
        y = np.where(live, (y0 - dy) * icdist, y)
    return np.stack([x, y], axis=-1)


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector (3,) -> matrix (3, 3), as cv2.Rodrigues."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    r = r / theta
    c, s = np.cos(theta), np.sin(theta)
    skew = np.asarray([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                       [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1 - c) * np.outer(r, r) + s * skew


def project_points(pts: np.ndarray, rot: np.ndarray, trans: np.ndarray,
                   camera_mtx: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """World points (N, 3) -> pixels (N, 2): cv2.projectPoints' forward
    model; `rot` is a rotation vector (3,) or matrix (3, 3)."""
    rot = np.asarray(rot, np.float64)
    R = rot.reshape(3, 3) if rot.size == 9 else rodrigues(rot)
    X = np.asarray(pts, np.float64).reshape(-1, 3) @ R.T \
        + np.asarray(trans, np.float64).reshape(1, 3)
    z = np.where(X[:, 2] != 0, 1.0 / np.where(X[:, 2] != 0, X[:, 2], 1.0),
                 1.0)
    x, y = X[:, 0] * z, X[:, 1] * z
    k = _dist_coeffs(dist)
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    cdist = 1 + k[0] * r2 + k[1] * r4 + k[4] * r6
    icdist2 = 1.0 / (1 + k[5] * r2 + k[6] * r4 + k[7] * r6)
    xd = x * cdist * icdist2 + k[2] * 2 * x * y + k[3] * (r2 + 2 * x * x) \
        + k[8] * r2 + k[9] * r4
    yd = y * cdist * icdist2 + k[2] * (r2 + 2 * y * y) + k[3] * 2 * x * y \
        + k[10] * r2 + k[11] * r4
    K = np.asarray(camera_mtx, np.float64)
    return np.stack([xd * K[0, 0] + K[0, 2], yd * K[1, 1] + K[1, 2]], -1)


def read_depth_png(path: str) -> np.ndarray:
    """A 16-bit depth PNG as (H, W) integers (PIL's "I;16" mode, or "I"
    for a 32-bit PNG), as cv2.imread(path, IMREAD_UNCHANGED) reads it."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


class Projection:
    """Kinect calibration: unproject depth to 3D, project to color frame
    (OpenCV's camera model, in numpy)."""

    def __init__(self, calib_dir: str):
        with open(osp.join(calib_dir, "IR.json")) as f:
            self.depth_cam = json.load(f)
        with open(osp.join(calib_dir, "Color.json")) as f:
            self.color_cam = json.load(f)

    def unproject_depth_image(self, depth: np.ndarray,
                              cam: Dict) -> np.ndarray:
        h, w = depth.shape
        us = np.arange(depth.size) % w
        vs = np.arange(depth.size) // w
        ds = depth.ravel()
        uv = np.stack([us, vs], axis=-1).astype(np.float64)
        xy = undistort_points(uv, np.asarray(cam["camera_mtx"]),
                              np.asarray(cam["k"]))
        xyz = np.concatenate([xy, ds[:, None]], axis=-1)
        xyz[:, :2] *= xyz[:, 2:3]
        view = np.asarray(cam["view_mtx"])
        xyz = (xyz - view[:, 3][None]) @ view[:, :3]
        return xyz.reshape(h, w, 3)

    def project_points(self, pts: np.ndarray, cam: Dict) -> np.ndarray:
        return project_points(
            pts.reshape(-1, 3), np.asarray(cam["R"], np.float64),
            np.asarray(cam["T"], np.float64),
            np.asarray(cam["camera_mtx"]), np.asarray(cam["k"]))

    def masked_point_cloud(self, depth: np.ndarray, mask: np.ndarray,
                           max_pts: int = MAX_POINTS,
                           seed: int = 0) -> np.ndarray:
        """Person point cloud in the color-camera frame: zero out masked
        (non-person) depth, unproject, subsample to max_pts with inf
        padding."""
        d = depth.copy()
        d[mask != 0] = 0.0
        pts = self.unproject_depth_image(d, self.depth_cam).reshape(-1, 3)
        pts = pts[d.ravel() > 1e-2]
        view = np.asarray(self.color_cam["view_mtx"])
        if pts.shape[0]:
            pts = pts @ view[:, :3].T + view[:, 3][None]
        return subsample_points(pts, max_pts, seed)


def subsample_points(pts: np.ndarray, max_pts: int,
                     seed: int = 0) -> np.ndarray:
    """Fixed-size point set: random subsample when over, inf-pad when
    under (fixed shapes; the fitting losses mask inf)."""
    rng = np.random.RandomState(seed)
    out = np.full((max_pts, 3), np.inf, np.float32)
    n = pts.shape[0]
    if n == 0:
        return out
    if n > max_pts:
        sel = rng.choice(n, max_pts, replace=False)
        out[:] = pts[sel]
    else:
        out[:n] = pts
    return out


def fit_floor_ransac(points: np.ndarray, n_iters: int = 200,
                     thresh: float = 0.05, seed: int = 0,
                     min_up: float = 0.7) -> np.ndarray:
    """RANSAC plane fit over scene points -> (a, b, c, d) with the normal
    flipped up in the camera frame (-y), replacing the reference's
    RANSACRegressor+DBSCAN pipeline (:360-427) with a direct plane
    RANSAC.

    `min_up` rejects candidate planes whose normal is not mostly
    vertical (|n_y| < min_up): the reference's RANSACRegressor fits
    y = f(x, z), which structurally cannot select a wall — this filter
    reproduces that floor bias (without it, a dominant wall would win
    the inlier vote). Among floor-ish candidates it then prefers the
    LOWEST plane (largest camera-frame y) when inlier counts are close,
    standing in for the reference's DBSCAN pick of the lowest height
    cluster (prox_dataset.py:399-427)."""
    rng = np.random.RandomState(seed)
    candidates = []  # (inliers, height_y, plane)
    n = points.shape[0]
    for _ in range(n_iters):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = points[idx]
        normal = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(normal)
        if norm < 1e-9:
            continue
        normal = normal / norm
        if abs(normal[1]) < min_up:
            continue  # wall/furniture side — the reference can't fit it
        d = float(normal @ p0)
        dist = np.abs(points @ normal - d)
        inliers = int((dist < thresh).sum())
        height = d / normal[1]  # plane height along +y (down = lower)
        candidates.append((inliers, height, np.concatenate([normal, [d]])))
    if not candidates:
        return np.asarray([0.0, -1.0, 0.0, 0.5], np.float32)
    max_inliers = max(c[0] for c in candidates)
    # among comparably-supported planes, take the LOWEST one (tabletops
    # and seats can out-vote the floor when furniture dominates a view)
    strong = [c for c in candidates if c[0] >= 0.9 * max_inliers]
    best = max(strong, key=lambda c: c[1])[2]
    # least-squares refit on the consensus set (RANSACRegressor's final
    # estimator step): y = a*x + c*z + d over the inliers
    from humor_torch.data.imapper import fit_floor_plane_from_points

    dist = np.abs(points @ best[:3] - best[3])
    inl = points[dist < thresh]
    if inl.shape[0] >= 3:
        return fit_floor_plane_from_points(inl)
    if best[1] > 0:  # normal must face up (camera -y)
        best = -best
    return best.astype(np.float32)


@dataclass
class ProxConfig:
    seq_len: int = 60
    overlap_len: int = 10
    max_points: int = MAX_POINTS
    use_depth: bool = True
    flip: bool = True          # PROX images are mirrored
    img_width: int = 1920
    img_height: int = 1080
    # load PROXD (qualitative) / MoSh (quantitative) per-frame SMPL fits
    # as pseudo-GT
    load_fitting: bool = False


class ProxDataset:
    """One PROX recording -> observation windows. Expects the public PROX
    layout: recordings/<name>/{keypoints,Depth,BodyIndex}/..., calibration/
    <cam>/ {IR,Color}.json."""

    def __init__(self, recording_dir: str, calib_dir: str,
                 cfg: ProxConfig, cam_mat: Optional[np.ndarray] = None,
                 fitting_root: Optional[str] = None):
        self.cfg = cfg
        self.recording_dir = recording_dir
        # default pseudo-GT location in the public layout:
        # <dataset>/fittings/{mosh|proxd}/<rec>/results/<frame>/000.pkl
        if fitting_root is None and cfg.load_fitting:
            base = osp.dirname(osp.dirname(recording_dir.rstrip("/")))
            for sub in ("mosh", "proxd"):
                cand = osp.join(base, "fittings", sub)
                if osp.isdir(cand):
                    fitting_root = cand
                    break
        self.fitting_root = fitting_root
        self.projection = (Projection(calib_dir)
                           if osp.isdir(calib_dir) else None)
        keyp_paths = sorted(glob.glob(
            osp.join(recording_dir, "keypoints", "*_keypoints.json")))
        keyp_paths = keyp_paths[TRIM_EDGES:-TRIM_EDGES] \
            if len(keyp_paths) > 2 * TRIM_EDGES else keyp_paths
        self.keyp_paths = keyp_paths
        frames = np.stack([read_keypoints(p) for p in keyp_paths]) \
            if keyp_paths else np.zeros((0, C.OP_NUM_JOINTS, 3), np.float32)
        if cfg.flip and frames.size:
            frames = flip_keypoints(frames, cfg.img_width)
        self.joints2d = frames
        self.num_frames = frames.shape[0]
        self.intervals, self.overlap = split_overlapping_windows(
            max(self.num_frames, 1), cfg.seq_len, cfg.overlap_len)
        if cam_mat is None and self.projection is not None:
            cam_mat = np.asarray(
                self.projection.color_cam["camera_mtx"], np.float32)
        self.cam_mat = cam_mat

    def observation_batch(self) -> Dict[str, np.ndarray]:
        T = min(self.cfg.seq_len, max(self.num_frames, 1))
        B = len(self.intervals)
        out: Dict[str, np.ndarray] = {
            "joints2d": np.zeros((B, T, C.OP_NUM_JOINTS, 3), np.float32),
            "seq_interval": np.asarray(self.intervals, np.int32),
        }
        for b, (s, e) in enumerate(self.intervals):
            out["joints2d"][b, : e - s] = self.joints2d[s:e]
        if self.cam_mat is not None:
            fx, fy = self.cam_mat[0, 0], self.cam_mat[1, 1]
            cx, cy = self.cam_mat[0, 2], self.cam_mat[1, 2]
            out["cam_f"] = np.tile([fx, fy], (B, 1)).astype(np.float32)
            out["cam_center"] = np.tile([cx, cy], (B, 1)).astype(np.float32)
        if self.cfg.use_depth and self.projection is not None:
            out["points3d"] = self._depth_clouds(T)
        return out

    def fitting_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Windowed PROXD/MoSh pseudo-GT SMPL fits aligned to the
        observation windows: returns {trans (B, T, 3),
        betas (B, T, 10), pose_body (B, T, 63), root_orient (B, T, 3),
        valid (B, T) bool} or None when no fitting root is configured.
        Frames without a fit (or with non-finite fits) are zero dummies
        with valid=False."""
        if self.fitting_root is None or not self.keyp_paths:
            return None
        rec_name = osp.basename(self.recording_dir.rstrip("/"))
        frame_names = ["_".join(osp.basename(p).split("_")[:-1])
                       for p in self.keyp_paths]
        paths = [osp.join(self.fitting_root, rec_name, "results", f,
                          "000.pkl") for f in frame_names]
        fits, valid = read_fitting_seq(paths, return_valid=True)
        valid = np.asarray(valid, bool)
        T = min(self.cfg.seq_len, max(self.num_frames, 1))
        B = len(self.intervals)
        out = {k: np.zeros((B, T) + v.shape[1:], np.float32)
               for k, v in fits.items()}
        out["valid"] = np.zeros((B, T), bool)
        for b, (s, e) in enumerate(self.intervals):
            for k, v in fits.items():
                out[k][b, : e - s] = v[s:e]
            out["valid"][b, : e - s] = valid[s:e]
        return out

    def _depth_paths(self, i: int) -> Tuple[str, str]:
        """Frame i's depth and body-index PNGs."""
        name = "_".join(osp.basename(self.keyp_paths[i]).split("_")[:-1])
        return (osp.join(self.recording_dir, "Depth", name + ".png"),
                osp.join(self.recording_dir, "BodyIndex", name + ".png"))

    def _depth_clouds(self, T: int) -> np.ndarray:
        B = len(self.intervals)
        clouds = np.full((B, T, self.cfg.max_points, 3), np.inf,
                         np.float32)
        for b, (s, e) in enumerate(self.intervals):
            for t in range(e - s):
                dpath, mpath = self._depth_paths(s + t)
                if not (osp.exists(dpath) and osp.exists(mpath)):
                    continue
                depth = read_depth_png(dpath).astype(np.float64) / 8000.0
                mask = read_gray_png(mpath)
                mask = np.where(mask == 255, 1, 0).astype(np.uint8)
                clouds[b, t] = self.projection.masked_point_cloud(
                    depth, mask, self.cfg.max_points, seed=s + t)
        return clouds

    def scene_floor_plane(self) -> np.ndarray:
        """(4,) floor plane of the recording's scene: `fit_floor_ransac`
        over the depth points off the person (body index 255) of the
        first frame with a depth image (at most 8 x MAX_POINTS of them),
        in the colour camera's frame.
        The reference fits its floor to the PROX scene mesh
        (prox_dataset.py:360-427), which the port does not read; the
        recording's depth images scan the same scene. Raises when the
        recording has no calibration or no depth frame."""
        if self.projection is None:
            raise ValueError(f"no PROX calibration for "
                             f"{self.recording_dir!r}")
        for i in range(len(self.keyp_paths)):
            dpath, mpath = self._depth_paths(i)
            if not (osp.exists(dpath) and osp.exists(mpath)):
                continue
            depth = read_depth_png(dpath).astype(np.float64) / 8000.0
            person = (read_gray_png(mpath) != 255).astype(np.uint8)
            pts = self.projection.masked_point_cloud(depth, person,
                                                     8 * MAX_POINTS, seed=0)
            pts = pts[np.isfinite(pts[:, 0])]
            if pts.shape[0] >= 3:
                return fit_floor_ransac(pts.astype(np.float64), seed=0)
        raise ValueError(
            f"no depth frame with scene points under {self.recording_dir!r}"
            "/Depth: the PROX fit takes its floor from the scene's depth")
