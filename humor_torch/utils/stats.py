"""Training statistics (port of humor_tpu/utils/stats.py): running
averages, a JSONL mirror of every step's stats (stats.jsonl), and
progress lines with an ETA. A step's stats dict of 0-d tensors, or a
k-step chunk's of (k,) tensors, reaches the host in one transfer."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class VectorMeter:
    def __init__(self):
        self.vals = []

    def reset(self):
        self.vals = []

    def update(self, arr):
        self.vals.append(np.asarray(arr).reshape(-1))

    def _cat(self):
        return (np.concatenate(self.vals) if self.vals
                else np.zeros((0,), np.float32))

    def mean(self):
        return float(self._cat().mean()) if self.vals else 0.0

    def std(self):
        return float(self._cat().std()) if self.vals else 0.0

    def median(self):
        return float(np.median(self._cat())) if self.vals else 0.0


def to_host(stats: Dict) -> Dict[str, float]:
    """0-d tensors (one device) or numbers -> floats, in one transfer; a
    k-step chunk's (k,) stats -> their means over the chunk, taken on the
    device before that transfer."""
    keys = list(stats)
    vals = [torch.as_tensor(stats[k]).detach().float().reshape(-1).mean()
            for k in keys]
    if not vals:
        return {}
    dev = vals[0].device
    return dict(zip(keys, torch.stack([v.to(dev) for v in vals])
                    .cpu().tolist()))


class StatTracker:
    """Accumulates per-step stats dicts; appends each to
    <out_dir>/stats.jsonl."""

    def __init__(self, out_dir: Optional[str] = None):
        self.meters: Dict[str, AverageMeter] = {}
        self.jsonl = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, "stats.jsonl"), "a")
        self._t0 = time.time()
        self._steps = 0

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None

    def update(self, stats: Dict, n: int = 1, global_step: int = 0):
        """Enter one step's stats, or a chunk's (k,) stats as their mean
        with weight n = k; one host read either way."""
        host = to_host(stats)
        for k, v in host.items():
            self.meters.setdefault(k, AverageMeter()).update(v, n)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps({**host, "step": int(global_step)})
                             + "\n")
            self.jsonl.flush()
        self._steps += 1

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()
        self._t0 = time.time()
        self._steps = 0

    def progress_str(self, step: int, total: int) -> str:
        per = (time.time() - self._t0) / max(self._steps, 1)
        core = " ".join(f"{k}={m.avg:.5f}"
                        for k, m in sorted(self.meters.items()))
        return (f"[{step}/{total}] {core} | {per:.3f}s/it "
                f"eta {per * (total - step) / 60:.1f}m")
