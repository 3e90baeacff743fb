"""Frozen copy of humor_torch/data/sampler.py, part of the benchmark's plain
reference; it imports nothing of humor_torch.

Window sampling and gathering over a flat frame store, in numpy (port
of humor_tpu/native/window_sampler.cpp's sample_windows, gather_windows
and gather_rows).

The same counter-based splitmix64 draws as the C++ library, so a seed
gives the same (sequence, start) pairs and the same gaussian noise as the
JAX package's native sampler (the noise to float32 rounding: the C++ may
fuse the final multiply-add).

    store   : (total_frames, frame_dim) float32, all sequences in a row
    offsets : each sequence's first row
    lengths : each sequence's frame count
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer of a uint64 array (wrapping arithmetic)."""
    x = np.asarray(x, np.uint64) + _U(0x9E3779B97F4A7C15)
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


def uniform01(bits: np.ndarray) -> np.ndarray:
    """Top 53 bits -> float64 in [0, 1)."""
    return (bits >> _U(11)).astype(np.float64) * (1.0 / 9007199254740992.0)


def sample_windows(lengths: np.ndarray, window_len: int, seed: int,
                   batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """`batch` windows of `window_len` frames, uniform over every valid
    (sequence, start) position: (seq_idx (B,), start (B,)) int64."""
    lengths = np.asarray(lengths, np.int64)
    avail = np.maximum(lengths - window_len + 1, 0)
    cum = np.concatenate([[0], np.cumsum(avail)])
    total = int(cum[-1])
    if total <= 0:
        raise ValueError("no sequence long enough for window")
    b = np.arange(batch, dtype=np.uint64)
    bits = splitmix64(_U(seed) ^ (b * _U(0x9E37)))
    pos = np.minimum((uniform01(bits) * total).astype(np.int64), total - 1)
    seq_idx = np.searchsorted(cum, pos, side="right") - 1
    return seq_idx.astype(np.int64), (pos - cum[seq_idx]).astype(np.int64)


def window_noise(shape: Tuple[int, int, int], seed: int) -> np.ndarray:
    """(B, W, D) float32 standard normals, Box-Muller from two counter
    draws per element, keyed by window b and element index."""
    B, W, D = shape
    base = splitmix64(_U(seed) ^ np.arange(B, dtype=np.uint64))[:, None]
    i = np.arange(W * D, dtype=np.uint64)[None, :]
    u1 = np.maximum(uniform01(splitmix64(base ^ (_U(2) * i))), 1e-12)
    u2 = uniform01(splitmix64(base ^ (_U(2) * i + _U(1))))
    g = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    return g.astype(np.float32).reshape(B, W, D)


def gather_windows(store: np.ndarray, offsets: np.ndarray,
                   seq_idx: np.ndarray, start: np.ndarray, window_len: int,
                   noise_std: float = 0.0, seed: int = 0) -> np.ndarray:
    """(B, window_len, frame_dim) float32 windows, plus noise_std times
    window_noise(seed) when noise_std > 0."""
    rows = (np.asarray(offsets, np.int64)[seq_idx, None]
            + np.asarray(start, np.int64)[:, None] + np.arange(window_len))
    out = np.asarray(store, np.float32)[rows]
    if noise_std > 0.0:
        out = out + np.float32(noise_std) * window_noise(out.shape, seed)
    return out


def gather_rows(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.asarray(table, np.float32)[np.asarray(idx, np.int64)]
