"""Training traffic: seeded synthetic AMASS-like sequences, made in bulk
(numpy's smooth random walks of the root and the pose, copied from
humor_torch/data/synthetic.synthetic_world_batch; the joints from the
plain reference's SMPL on the device, with each sequence's own gendered
body), as the processed dicts `AmassDataset.from_processed` packs; and
the plain reference's own copy of the batches the program's device store
gathers from them (the same host window sampling, gather and per-step
canonicalization, frozen under portbench/reference).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import constants as C
from portbench.reference import sampler
from portbench.reference import smpl as RS
from portbench.reference import transforms as TR
from portbench.reference.windows import window_to_pairs

FPS = 30.0
# the components a training window is made of, in the device store's order
TRAIN_COLUMNS = ("trans", "trans_vel", "root_orient", "root_orient_vel",
                 "pose_body", "joints", "joints_vel", "contacts")


def _smooth_noise(rng, shape, scale, smooth=8):
    """Moving average of white noise over time (axis 1)."""
    x = rng.randn(*shape).astype(np.float32)
    smooth = min(smooth, shape[1])
    k = np.ones(smooth, np.float32) / smooth
    x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, x)
    return x * scale


def make_sequences(n: int, frames: int, seed: int, bodies: Dict, device
                   ) -> List[Dict[str, np.ndarray]]:
    """`n` processed sequences of `frames` frames; `bodies` the
    reference's {"male", "female"} SmplModels on `device`."""
    rng = np.random.RandomState(seed)
    B, F = n, frames
    betas = rng.randn(B, 16).astype(np.float32) * 0.5
    gender = rng.randint(0, 2, size=B)
    heading = np.cumsum(_smooth_noise(rng, (B, F), 0.05), axis=1)
    speed = np.abs(_smooth_noise(rng, (B, F), 0.4)) + 0.2
    trans = np.stack([np.cumsum(np.cos(heading) * speed / FPS, axis=1),
                      np.cumsum(np.sin(heading) * speed / FPS, axis=1),
                      0.9 + _smooth_noise(rng, (B, F), 0.02)],
                     axis=-1).astype(np.float32)
    trans += rng.randn(B, 1, 3).astype(np.float32) * np.asarray([2, 2, 0.02])
    tilt = _smooth_noise(rng, (B, F, 2), 0.08)
    root_aa = np.stack([tilt[..., 0], tilt[..., 1], heading],
                       axis=-1).astype(np.float32)
    pose_aa = (rng.randn(B, 1, 21, 3).astype(np.float32) * 0.2
               + _smooth_noise(rng, (B, F, 21, 3), 0.15))

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    with torch.no_grad():
        none = np.zeros((0,), np.int64)
        jt = None
        for gid, name in enumerate(("male", "female")):
            out = RS.forward(bodies[name], t(root_aa.reshape(B * F, 3)),
                             t(pose_aa.reshape(B * F, 63)),
                             t(np.repeat(betas, F, axis=0)),
                             t(trans.reshape(B * F, 3)), vert_ids=none)
            j = out.Jtr[:, :C.NUM_SMPL_JOINTS].reshape(B, F, -1, 3)
            sel = t(gender == gid)[:, None, None, None]
            jt = j if jt is None else torch.where(sel, j, jt)
        root_mat = TR.aa_to_rotmat(t(root_aa))
    joints = jt.cpu().numpy()
    root_mat = root_mat.cpu().numpy()

    def fdiff(x):
        v = np.empty_like(x)
        v[:, :-1] = (x[:, 1:] - x[:, :-1]) * FPS
        v[:, -1] = v[:, -2]
        return v

    trans_vel, joints_vel = fdiff(trans), fdiff(joints)
    dR = np.matmul(root_mat[:, 1:], np.swapaxes(root_mat[:, :-1], -1, -2))
    w = np.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                  dR[..., 1, 0] - dR[..., 0, 1]], axis=-1) * (0.5 * FPS)
    root_vel = np.concatenate([w, w[:, -1:]], axis=1)
    inds = np.asarray(C.CONTACT_INDS)
    floor_z = joints[..., 2].min(axis=(1, 2), keepdims=True)
    low = joints[:, :, inds, 2] < floor_z + 0.12
    slow = np.linalg.norm(joints_vel[:, :, inds], axis=-1) < 0.5
    contacts = np.zeros((B, F, C.NUM_SMPL_JOINTS), np.float32)
    contacts[:, :, inds] = low & slow
    z = lambda *s: np.zeros(s, np.float32)
    return [{"trans": trans[i], "trans_vel": trans_vel[i],
             "root_orient": root_aa[i], "root_orient_vel": root_vel[i],
             "pose_body": pose_aa[i].reshape(F, 63),
             "pose_body_vel": z(F, 63), "joints": joints[i],
             "joints_vel": joints_vel[i], "joint_orient_vel_seq": z(F, 1),
             "mojo_verts": z(F, C.NUM_KEYPT_VERTS, 3),
             "mojo_verts_vel": z(F, C.NUM_KEYPT_VERTS, 3),
             "contacts": contacts[i], "betas": betas[i],
             "gender": ("male", "female")[gender[i]], "fps": np.float32(FPS)}
            for i in range(B)]


class ReferenceStore:
    """The training columns of the sequences, packed by the reference
    (rotations as matrices), with their sequence table."""

    def __init__(self, seqs: Sequence[Dict[str, np.ndarray]]):
        def rot(x):
            return TR.aa_to_rotmat(torch.as_tensor(
                np.asarray(x, np.float32))).numpy().reshape(len(x), -1)

        cols = {k: [] for k in TRAIN_COLUMNS}
        for s in seqs:
            N = s["trans"].shape[0]
            cols["trans"].append(s["trans"])
            cols["trans_vel"].append(s["trans_vel"])
            cols["root_orient"].append(rot(s["root_orient"]))
            cols["root_orient_vel"].append(s["root_orient_vel"])
            cols["pose_body"].append(rot(s["pose_body"].reshape(N, -1, 3))
                                     .reshape(N, -1))
            cols["joints"].append(s["joints"].reshape(N, -1))
            cols["joints_vel"].append(s["joints_vel"].reshape(N, -1))
            cols["contacts"].append(
                s["contacts"][:, np.asarray(C.CONTACT_INDS)])
        self.cols = {k: np.concatenate(v).astype(np.float32)
                     for k, v in cols.items()}
        self.lengths = np.asarray([s["trans"].shape[0] for s in seqs],
                                  np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]])
        self.betas = np.stack([np.asarray(s["betas"], np.float32)[:16]
                               for s in seqs])
        self.gender = np.asarray([{"male": 0, "female": 1}[s["gender"]]
                                  for s in seqs], np.int64)

    def batch(self, seed: int, batch: int, window: int, device) -> Dict:
        """The batch the program's store gathers for one step seed
        (noise 0): (data_in, data_out) canonicalized pairs, betas,
        gender ids."""
        seq_idx, start = sampler.sample_windows(self.lengths, window, seed,
                                                batch)
        rows = (self.offsets[seq_idx][:, None] + start[:, None]
                + np.arange(window))
        world = {k: torch.as_tensor(v[rows], device=device)
                 for k, v in self.cols.items()}
        data_in, data_out, _ = window_to_pairs(world)
        return {"data_in": data_in, "data_out": data_out,
                "betas": torch.as_tensor(self.betas[seq_idx], device=device),
                "gender_ids": torch.as_tensor(self.gender[seq_idx],
                                              device=device)}
