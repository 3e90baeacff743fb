"""Procedural AMASS-like motion windows from the synthetic body model, for
tests and chip runs (port of humor_tpu/data/synthetic.py).

The draws are numpy's, so a seed gives the JAX package's windows; the
joints come from this package's SMPL forward (float32, so the two agree
to rounding), velocities are forward differences and contacts a
velocity-and-height rule.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.body_model.smpl import SmplModel, forward, synthetic_smpl_model
from humor_torch.ops import transforms


def _smooth_noise(rng: np.random.RandomState, shape, scale, smooth=8):
    """Moving average of white noise over time (axis 1)."""
    x = rng.randn(*shape).astype(np.float32)
    smooth = min(smooth, shape[1])  # convolve('same') grows short inputs
    k = np.ones(smooth, np.float32) / smooth
    x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, x)
    return x * scale


def synthetic_world_batch(seed: int, batch: int, num_frames: int,
                          model: Optional[SmplModel] = None,
                          fps: float = 30.0, device="cpu"
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor]]:
    """(world, meta): world typed components (B, F, D) with matrix
    rotations; meta {"betas": (B, 16), "gender_ids": (B,)}. The body runs
    on the CPU; the outputs are moved to `device`."""
    if model is None:
        model = synthetic_smpl_model()
    model = model.to("cpu")
    rng = np.random.RandomState(seed)
    B, F = batch, num_frames

    betas = rng.randn(B, 16).astype(np.float32) * 0.5
    gender_ids = rng.randint(0, 2, size=B).astype(np.int32)

    heading = np.cumsum(_smooth_noise(rng, (B, F), 0.05), axis=1)
    speed = np.abs(_smooth_noise(rng, (B, F), 0.4)) + 0.2
    dx = np.cos(heading) * speed / fps
    dy = np.sin(heading) * speed / fps
    trans = np.stack([np.cumsum(dx, axis=1), np.cumsum(dy, axis=1),
                      0.9 + _smooth_noise(rng, (B, F), 0.02)],
                     axis=-1).astype(np.float32)
    trans += rng.randn(B, 1, 3).astype(np.float32) * np.asarray([2, 2, 0.02])

    tilt = _smooth_noise(rng, (B, F, 2), 0.08)
    root_aa = np.stack([tilt[..., 0], tilt[..., 1], heading], axis=-1)
    base = rng.randn(B, 1, 21, 3).astype(np.float32) * 0.2
    pose_aa = base + _smooth_noise(rng, (B, F, 21, 3), 0.15)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    with torch.no_grad():
        out = forward(model, f32(root_aa.reshape(B * F, 3)),
                      f32(pose_aa.reshape(B * F, 63)),
                      f32(np.repeat(betas, F, axis=0)),
                      f32(trans.reshape(B * F, 3)))
        root_mat = transforms.aa_to_rotmat(f32(root_aa)).numpy()
        pose_mat = transforms.aa_to_rotmat(f32(pose_aa)).numpy()
    joints = out.Jtr.numpy().reshape(B, F, -1, 3)[:, :, :C.NUM_SMPL_JOINTS]

    def fdiff(x):
        v = np.empty_like(x)
        v[:, :-1] = (x[:, 1:] - x[:, :-1]) * fps
        v[:, -1] = v[:, -2]
        return v

    trans_vel = fdiff(trans)
    joints_vel = fdiff(joints)
    # angular velocity: unskew of (R_{t+1} R_t^T - I) * fps
    dR = np.matmul(root_mat[:, 1:], np.swapaxes(root_mat[:, :-1], -1, -2))
    w = np.stack([dR[..., 2, 1] - dR[..., 1, 2],
                  dR[..., 0, 2] - dR[..., 2, 0],
                  dR[..., 1, 0] - dR[..., 0, 1]], axis=-1) * (0.5 * fps)
    root_orient_vel = np.concatenate([w, w[:, -1:]], axis=1)

    inds = np.asarray(C.CONTACT_INDS)
    contact_j = joints[:, :, inds]
    contact_v = joints_vel[:, :, inds]
    floor_z = joints[..., 2].min(axis=(1, 2), keepdims=True)[..., None]
    low = contact_j[..., 2] < (floor_z[..., 0] + 0.12)
    slow = np.linalg.norm(contact_v, axis=-1) < 0.5

    t = lambda a: f32(a).to(device)
    world = {
        "trans": t(trans),
        "trans_vel": t(trans_vel),
        "root_orient": t(root_mat.reshape(B, F, 9)),
        "root_orient_vel": t(root_orient_vel),
        "pose_body": t(pose_mat.reshape(B, F, 21 * 9)),
        "joints": t(joints.reshape(B, F, -1)),
        "joints_vel": t(joints_vel.reshape(B, F, -1)),
        "contacts": t(low & slow),
    }
    meta = {"betas": t(betas),
            "gender_ids": torch.as_tensor(gender_ids, device=device)}
    return world, meta
