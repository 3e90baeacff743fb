"""AMASS training dataset: processed sequences -> one flat float32 frame
store with per-sequence metadata, and batched world-frame windows (port
of humor_tpu/data/dataset.py).

Windows are sampled and gathered on the host (humor_torch.data.sampler);
the per-step canonicalization runs batched afterwards
(humor_torch.data.windows), on whatever device the batch is moved to.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from humor_torch.body_model import constants as C
from humor_torch.data import sampler
from humor_torch.models.state import data_dim
from humor_torch.ops import transforms

# every state component in the reference's DATA_NAMES order, mat rotations
DATA_NAMES = [
    "trans", "trans_vel", "root_orient", "root_orient_vel", "pose_body",
    "pose_body_vel", "joints", "joints_vel", "joints_orient_vel", "verts",
    "verts_vel", "contacts",
]
_FRAME_LAYOUT: List[Tuple[str, int]] = [(n, data_dim(n, 9))
                                        for n in DATA_NAMES]
FRAME_DIM = sum(d for _, d in _FRAME_LAYOUT)

_GENDER_IDS = {"male": 0, "female": 1, "neutral": 2}


def _offsets_of(layout):
    out, s = {}, 0
    for name, d in layout:
        out[name] = (s, s + d)
        s += d
    return out


FRAME_OFFSETS = _offsets_of(_FRAME_LAYOUT)


def pack_frames(seq: Dict[str, np.ndarray]) -> np.ndarray:
    """Processed sequence -> (N, FRAME_DIM) float32 frames; rotations go
    from axis-angle to matrices here, once."""
    N = seq["trans"].shape[0]
    aa = lambda x: transforms.aa_to_rotmat(torch.as_tensor(
        np.asarray(x, np.float32))).numpy().reshape(N, -1)

    def _fit(x, width):
        """Zero-pad or cut to the frame layout (synthetic bodies have
        fewer than 43 keypoint vertices)."""
        x = x.reshape(N, -1)
        if x.shape[1] < width:
            x = np.concatenate(
                [x, np.zeros((N, width - x.shape[1]), x.dtype)], axis=1)
        return x[:, :width]

    comp = {
        "trans": seq["trans"],
        "trans_vel": seq["trans_vel"],
        "root_orient": aa(seq["root_orient"]),
        "root_orient_vel": seq["root_orient_vel"],
        "pose_body": aa(seq["pose_body"].reshape(N, -1, 3)),
        "pose_body_vel": seq["pose_body_vel"].reshape(N, -1),
        "joints": seq["joints"].reshape(N, -1),
        "joints_vel": seq["joints_vel"].reshape(N, -1),
        "joints_orient_vel": seq["joint_orient_vel_seq"].reshape(N, 1),
        "verts": _fit(seq["mojo_verts"], C.NUM_KEYPT_VERTS * 3),
        "verts_vel": _fit(seq["mojo_verts_vel"], C.NUM_KEYPT_VERTS * 3),
        # only the 9 contact joints are stored
        "contacts": seq["contacts"][:, np.asarray(C.CONTACT_INDS)],
    }
    out = np.empty((N, FRAME_DIM), np.float32)
    for name, (s, e) in FRAME_OFFSETS.items():
        out[:, s:e] = comp[name].astype(np.float32)
    return out


def unpack_frames(frames: np.ndarray) -> Dict[str, np.ndarray]:
    """(..., FRAME_DIM) -> typed component dict (views)."""
    return {name: frames[..., s:e] for name, (s, e) in FRAME_OFFSETS.items()}


@dataclass
class AmassDataset:
    """Flat store over all sequences plus metadata tables."""

    store: np.ndarray       # (total_frames, FRAME_DIM)
    offsets: np.ndarray     # (S,) int64 first rows
    lengths: np.ndarray     # (S,) int64 frame counts
    betas: np.ndarray       # (S, 16)
    gender_ids: np.ndarray  # (S,) int32
    paths: List[str]
    fps: float = 30.0

    @property
    def num_seqs(self) -> int:
        return len(self.lengths)

    @property
    def total_frames(self) -> int:
        return int(self.lengths.sum())

    @staticmethod
    def from_processed(seqs: Sequence[Dict[str, np.ndarray]],
                       paths: Optional[List[str]] = None) -> "AmassDataset":
        packed = [pack_frames(s) for s in seqs]
        lengths = np.asarray([p.shape[0] for p in packed], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
            np.int64)
        betas = np.stack([np.asarray(s["betas"], np.float32)[:C.BETA_SIZE]
                          for s in seqs])
        gender = np.asarray(
            [_GENDER_IDS.get(str(s.get("gender", "neutral")), 2)
             for s in seqs], np.int32)
        fps = float(np.asarray(seqs[0]["fps"])) if seqs else 30.0
        return AmassDataset(np.concatenate(packed), offsets, lengths,
                            betas, gender, paths or [], fps)

    @staticmethod
    def from_npz_files(paths: Sequence[str]) -> "AmassDataset":
        seqs = []
        for p in paths:
            with np.load(p, allow_pickle=True) as f:
                seqs.append(dict(f))
        return AmassDataset.from_processed(seqs, list(paths))

    def sample_windows(self, seed: int, batch: int, window_frames: int,
                       noise_std: float = 0.0
                       ) -> Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]:
        """(world, meta): world components (B, W, D) float32 with matrix
        rotations; meta {betas (B, 16), gender_ids (B,), seq_idx, start}."""
        seq_idx, start = sampler.sample_windows(self.lengths, window_frames,
                                                seed, batch)
        frames = sampler.gather_windows(self.store, self.offsets, seq_idx,
                                        start, window_frames,
                                        noise_std=noise_std, seed=seed + 1)
        meta = {"betas": sampler.gather_rows(self.betas, seq_idx),
                "gender_ids": self.gender_ids[seq_idx],
                "seq_idx": seq_idx, "start": start}
        return unpack_frames(frames), meta

    def sequence(self, i: int) -> Dict[str, np.ndarray]:
        """Whole world-frame sequence i (components (N, D))."""
        s = int(self.offsets[i])
        return unpack_frames(self.store[s:s + int(self.lengths[i])])


def split_files(paths: Sequence[str], split_by: str = "dataset",
                fractions: Tuple[float, float, float] = (0.8, 0.1, 0.1),
                seed: int = 42) -> Dict[str, List[str]]:
    """Partition processed files into train/val/test by unit: 'sequence'
    (each file), 'subject' (data_root/<dataset>/<subject>), 'dataset'
    (whole mocap datasets) or 'single' (every split gets every file)."""
    if split_by == "single":
        return {"train": list(paths), "val": list(paths),
                "test": list(paths)}
    if split_by == "sequence":
        units = {p: p for p in paths}
    elif split_by == "subject":
        units = {p: os.path.dirname(p) for p in paths}
    elif split_by == "dataset":
        units = {p: os.path.dirname(os.path.dirname(p)) for p in paths}
    else:
        raise ValueError(f"unknown split_by {split_by!r}")
    keys = sorted(set(units.values()))
    np.random.RandomState(seed).shuffle(keys)
    n = len(keys)
    n_train = max(1, int(fractions[0] * n))
    n_val = max(1 if n > 2 else 0, int(fractions[1] * n))
    train_keys = set(keys[:n_train])
    val_keys = set(keys[n_train:n_train + n_val])
    out = {"train": [], "val": [], "test": []}
    for p in paths:
        k = units[p]
        out["train" if k in train_keys else "val" if k in val_keys
            else "test"].append(p)
    return out


def find_processed_files(data_root: str,
                         datasets: Optional[Sequence[str]] = None,
                         custom_split: Optional[Sequence[str]] = None
                         ) -> List[str]:
    """Processed npz files under data_root/<dataset>/<subject>/
    <seq>_<N>_frames_<fps>_fps.npz, for the named datasets (all when
    None), kept to paths containing one of `custom_split`'s fragments
    when given."""
    if datasets is None:
        datasets = (sorted(os.listdir(data_root))
                    if os.path.isdir(data_root) else [])
    paths: List[str] = []
    for ds in datasets:
        paths.extend(sorted(glob.glob(
            os.path.join(data_root, ds, "*", "*_frames_*_fps.npz"))))
    if custom_split:
        paths = [p for p in paths if any(f in p for f in custom_split)]
    return paths
