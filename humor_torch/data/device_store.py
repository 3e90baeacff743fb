"""Window sampling from a frame store held in device memory (port of
humor_tpu/data/device_store.py).

The training columns of the flat store are copied to the card once; each
batch then moves only its (B,) start rows, and the gather (and the noise)
run on the card. Window sampling stays on the host
(humor_torch.data.sampler), so the (sequence, start) pairs equal the host
path's. At noise_std 0 a batch equals the host gather's; the noise is
drawn from a torch.Generator seeded with seed + 1, not from the host
sampler's stream. `sample_window_chunk` gathers the k batches of a
k-step chunk at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from humor_torch.data import sampler
from humor_torch.data.dataset import FRAME_OFFSETS, AmassDataset
from humor_torch.utils import profiling as PR

# the components the training pairs are built from (train/cli.py)
TRAIN_COLUMNS: Tuple[str, ...] = (
    "trans", "trans_vel", "root_orient", "root_orient_vel",
    "pose_body", "joints", "joints_vel", "contacts")


def default_budget_bytes(device) -> int:
    """Auto-staging budget: a quarter of the card's memory
    (torch.cuda.mem_get_info's total), which leaves the rest to the
    weights, optimizer state and activations of a step. 0 on the CPU,
    where the host gather already reads the same memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(dev)[1]) // 4


def _column_layout(columns: Sequence[str]):
    idx, layout, s = [], {}, 0
    for name in columns:
        a, b = FRAME_OFFSETS[name]
        idx.extend(range(a, b))
        layout[name] = (s, s + (b - a))
        s += b - a
    return np.asarray(idx, np.int64), layout, s


@dataclass(frozen=True)
class DeviceWindowStore:
    """Column subset of an AmassDataset staged on one device."""

    store: torch.Tensor       # (total_frames, D_cols)
    betas: torch.Tensor       # (S, 16)
    gender_ids: torch.Tensor  # (S,) int64, already % 2
    layout: Dict[str, Tuple[int, int]]
    lengths: np.ndarray       # host, for window sampling
    offsets: np.ndarray       # host first rows

    @staticmethod
    def from_dataset(ds: AmassDataset, device,
                     columns: Sequence[str] = TRAIN_COLUMNS
                     ) -> "DeviceWindowStore":
        idx, layout, _ = _column_layout(columns)
        return DeviceWindowStore(
            store=torch.as_tensor(np.ascontiguousarray(ds.store[:, idx]),
                                  device=device),
            betas=torch.as_tensor(ds.betas, device=device),
            gender_ids=torch.as_tensor(ds.gender_ids.astype(np.int64) % 2,
                                       device=device),
            layout=layout, lengths=ds.lengths, offsets=ds.offsets)

    @staticmethod
    def staged_nbytes(ds: AmassDataset,
                      columns: Sequence[str] = TRAIN_COLUMNS) -> int:
        return int(ds.store.shape[0]) * _column_layout(columns)[2] * 4

    def _gather(self, seq_idx: np.ndarray, start: np.ndarray,
                window_frames: int, noise_std: float, noise_seed: int,
                rows: Optional[slice]):
        """(..., B) sampled windows -> (world, meta) gathered on the
        device, only the batch rows `rows` (the last index axis) when
        given; the noise is drawn for the whole batch and sliced, so a
        rank's rows equal the same rows of the whole batch."""
        dev = self.store.device
        shape = seq_idx.shape
        if rows is not None:
            seq_idx, start = seq_idx[..., rows], start[..., rows]
        rows0 = torch.as_tensor(self.offsets[seq_idx] + start).to(dev)
        frames = self.store[rows0[..., None]
                            + torch.arange(window_frames, device=dev)]
        if noise_std > 0.0:
            g = torch.Generator(device=dev).manual_seed(noise_seed)
            noise = torch.randn((*shape, window_frames, frames.shape[-1]),
                                generator=g, device=dev)
            if rows is not None:
                noise = noise[..., rows, :, :]
            frames = frames + noise_std * noise
        seq_dev = torch.as_tensor(seq_idx).to(dev)
        world = {n: frames[..., a:b] for n, (a, b) in self.layout.items()}
        return world, {"betas": self.betas[seq_dev],
                       "gender_ids": self.gender_ids[seq_dev]}

    def sample_windows(self, seed: int, batch: int, window_frames: int,
                       noise_std: float = 0.0, rows: Optional[slice] = None):
        """Host-sampled windows gathered on the device: (world, meta),
        world components (B, W, D), meta {betas, gender_ids}; with `rows`
        (a data-parallel rank's, parallel.mesh.local_rows) only those of
        the batch."""
        with PR.span("data.gather"):
            seq_idx, start = sampler.sample_windows(
                self.lengths, window_frames, seed, batch)
            return self._gather(seq_idx, start, window_frames, noise_std,
                                seed + 1, rows)

    def sample_window_chunk(self, seeds: Sequence[int], batch: int,
                            window_frames: int, noise_std: float = 0.0,
                            rows: Optional[slice] = None):
        """k per-step seeds -> one (k, B, W, D) gather on the device (the
        k-step trainer's chunk, train/step.make_multi_steps). The windows
        are sampled per seed on the host, so at noise 0 the chunk equals
        the k sample_windows(seed_i) results stacked, bit for bit; with
        noise the chunk draws from one generator seeded seeds[0] + 1, as
        the JAX package draws from one key: the same distribution, other
        draws."""
        with PR.span("data.gather"):
            sampled = [sampler.sample_windows(self.lengths, window_frames,
                                              s, batch) for s in seeds]
            return self._gather(np.stack([si for si, _ in sampled]),
                                np.stack([st for _, st in sampled]),
                                window_frames, noise_std, int(seeds[0]) + 1,
                                rows)


def maybe_stage(ds: AmassDataset, device, mode: int = -1,
                columns: Sequence[str] = TRAIN_COLUMNS,
                budget_bytes: Optional[int] = None
                ) -> Optional[DeviceWindowStore]:
    """mode 1 stages, 0 does not, -1 stages when the columns fit
    `budget_bytes` (default_budget_bytes(device) when None)."""
    if mode == 0:
        return None
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(device)
    if mode != 1 and DeviceWindowStore.staged_nbytes(ds, columns) > budget_bytes:
        return None
    return DeviceWindowStore.from_dataset(ds, device, columns)
