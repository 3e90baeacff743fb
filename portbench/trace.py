"""Reduction of a torch.profiler trace (CPU and CUDA activities) to what
the per-layer metrics and the result line read: device time by kernel
name, the union of the device's busy intervals, the device operations
with the most time, and the idle gaps named by what the host was doing.
Only device events are summed: host-side ranges that enclose them would
count their time twice.

`BusyMeter` reads the device's busy seconds alone, over work too long
for one trace: the end-to-end metric `fit_device_s_per_window`.
"""

from __future__ import annotations

import bisect
import collections
from typing import Iterable, List, Tuple

NAME_LEN = 100


class Profile:
    """The device events (name, start us, end us) and the host's op
    events of one profiled region."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]]):
        self.device = sorted(device, key=lambda e: e[1])
        self.host = sorted(host, key=lambda e: e[1])

    @staticmethod
    def from_profiler(prof) -> "Profile":
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            rec = (e.name, float(tr.start), float(tr.end))
            if e.device_type == DeviceType.CUDA:
                dev.append(rec)
            elif not e.name.startswith("cuda"):
                # runtime calls (cudaLaunchKernel, ...) name no layer
                host.append(rec)
        return Profile(dev, host)

    @property
    def launches(self) -> int:
        return len(self.device)

    def seconds_of(self, patterns: Iterable[str]) -> Tuple[float, int]:
        """(device seconds, events) of the events whose name holds any of
        `patterns`."""
        pats = tuple(patterns)
        hits = [(e - s) for n, s, e in self.device
                if any(p in n for p in pats)]
        return sum(hits) / 1e6, len(hits)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return union([(s, e) for _, s, e in self.device])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        per = collections.defaultdict(float)
        for name, s, e in self.device:
            per[name[:NAME_LEN]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between the device's busy intervals, summed by the
        host op that was running just before the gap closed (the op that
        launched the next device work), the longest first."""
        busy = self.busy_intervals()
        starts = [s for _, s, _ in self.host]
        per = collections.defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            per[self._host_at(s1 - 1.0, starts)] += (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, starts: List[float]) -> str:
        """The innermost host op that spans time t (the latest-starting
        one of those that do), else "host, between ops"."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 400), -1):
            name, _, e = self.host[j]
            if e >= t:
                return name[:NAME_LEN]
        return "host, between ops"


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals in
    order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class BusyMeter:
    """The device's busy seconds over a stretch of work: torch.profiler
    with the device's activity alone (CUDA; on the CPU, the CPU's ops, for
    the tests), in segments that `roll` closes and reopens, so that no
    segment grows large enough to overflow the profiler's buffers of
    device records. Each closed segment adds the union of its device
    events' intervals; closing one waits for the device."""

    def __init__(self, device):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity

        self.cuda = torch.device(device).type == "cuda"
        self.activity = (ProfilerActivity.CUDA if self.cuda
                         else ProfilerActivity.CPU)
        self.kind = DeviceType.CUDA if self.cuda else DeviceType.CPU
        self.busy_s, self.events, self.segments = 0.0, 0, 0
        self._prof = None

    def start(self):
        from torch.profiler import profile as _profile

        self._prof = _profile(activities=[self.activity])
        self._prof.start()

    def stop(self):
        import torch

        prof, self._prof = self._prof, None
        if prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        spans = [(e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == self.kind]
        self.busy_s += sum(e - s for s, e in union(spans)) / 1e9
        self.events += len(spans)
        self.segments += 1

    def roll(self):
        self.stop()
        self.start()


def profile(fn) -> Tuple[Profile, float]:
    """Run fn() under torch.profiler (CPU and CUDA), synchronised inside;
    -> (the trace's reduction, the profiled wall seconds)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return Profile.from_profiler(prof), wall
