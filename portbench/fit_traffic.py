"""The general generator of test-time-fit traffic: seeded synthetic
observations of a seeded VPoser pose sequence, of the kind a traffic
file names ("joints3d", "rgb" or "prox"), with the parameters it gives.
Copied from chip_smoke.py's make_observations, make_rgb_observations and
make_prox_observations (themselves benchmarks/bench_tto.py's
workloads), computed with the plain reference's VPoser and SMPL so that
nothing of the program makes the inputs it is judged on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import geometry as geo
from portbench.reference import tto as RT
from portbench.reference import vposer as vp

# the 25 OpenPose joints of the 22-joint synthetic body (bench_tto.py's map)
SMPL2OP = tuple(i % 22 for i in range(25))


def make_observation(kind: str, p: Dict, models, batch: int, frames: int,
                     seed: int, device) -> Dict[str, torch.Tensor]:
    """One observation batch of `batch` windows x `frames` frames.
    `models` are the reference's TTOModels on `device`; `p` the traffic
    file's "observation" parameters."""
    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    B, T = batch, frames
    z = f(rng.randn(B, T, models.vposer_cfg.latent_dim) * p["pose_std"])
    if kind == "joints3d":
        trans = f(rng.randn(B, T, 3) * p["trans_std"])
        ro = f(np.tile(rng.randn(B, 1, 3) * p["root_std"], (1, T, 1)))
    else:
        trans = f(rng.randn(B, T, 3) * p["trans_std"] + p["trans_mean"])
        ro = f(np.tile(rng.randn(B, 1, 3) * p["root_std"] + p["root_mean"],
                       (1, T, 1)))
    full = kind == "prox"
    with torch.no_grad():
        pose = vp.latent2pose(models.vposer_cfg, models.vposer, z)
        gt = RT.smpl_results(models.body, trans, ro, pose,
                             torch.zeros(B, 16, device=device),
                             verts="full" if full else "none")
    if kind == "joints3d":
        return {"joints3d": gt["joints3d"]}
    cam_f = f(np.tile(p["cam_f"], (B, 1)))
    cam_c = f(np.tile(p["cam_center"], (B, 1)))
    with torch.no_grad():
        allj = torch.cat([gt["joints3d"], gt["joints3d_extra"]], dim=2)
        op3d = allj[:, :, list(SMPL2OP)].reshape(B * T, 25, 3)
        uv = geo.perspective_projection(
            op3d, torch.eye(3, device=device).expand(B * T, 3, 3),
            torch.zeros(B * T, 3, device=device),
            cam_f.repeat_interleave(T, 0), cam_c.repeat_interleave(T, 0))
    uv = uv.reshape(B, T, 25, 2).cpu().numpy() \
        + rng.randn(B, T, 25, 2) * p["keypoint_noise_px"]
    obs = {"joints2d": f(np.concatenate([uv, np.ones((B, T, 25, 1))], -1)),
           "cam_f": cam_f, "cam_center": cam_c,
           "floor_plane": f(np.tile(p["floor"], (B, 1)))}
    if kind == "rgb":
        start = np.arange(B) * (T - p["overlap_frames"])
        obs["seq_interval"] = torch.tensor(
            np.stack([start, start + T], 1), dtype=torch.int32,
            device=device)
    else:
        n = p["points"]
        verts = gt["points3d"].cpu().numpy()
        pick = rng.rand(*verts.shape[:3]).argsort(axis=-1)[..., :n]
        pts = np.take_along_axis(verts, pick[..., None], 2) \
            + rng.randn(B, T, n, 3) * p["point_noise_m"]
        n_out = int(p["outlier_share"] * n)
        off = rng.randn(B, T, n_out, 3)
        pts[:, :, :n_out] += p["outlier_m"] * off / np.linalg.norm(
            off, axis=-1, keepdims=True)
        pts[:, :, n - int(p["missing_share"] * n):] = np.inf
        obs["points3d"] = f(pts)
    return obs
