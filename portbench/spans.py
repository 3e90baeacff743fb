#!/usr/bin/env python3
"""The program's spans and counters (humor_torch/utils/profiling) read by
the benchmark: device time by the span that caused it, from a
torch.profiler trace taken while the spans are recorded, and the
regions of a --trace 1 run that read them.

`SpanTrace` reduces a trace taken with spans on:
  * the device events are the trace's own, less the user annotations
    that each span also leaves on the device's timeline (trace.Profile
    would count those as kernels and as busy time);
  * a kernel goes to the innermost span open, on the thread that
    launched it, when its launch ran: the kernel and its runtime call
    share a correlation id, and both are linked to the host op that was
    innermost at the launch, whose enclosing spans are the launching
    thread's;
  * a kernel launched by the backward of an autograd node goes to the
    span that was innermost when the node's forward op ran: the node's
    backward event carries the forward op's sequence number and thread.
    So the backward of the SMPL forward counts as "smpl", not as the
    "*.backward" span around `autograd.grad`;
  * a kernel that neither rule places goes to the innermost span open
    on the main thread (the thread with the most spans) at its launch;
  * each idle gap between the device's busy intervals goes to the
    innermost span open on the main thread 1 us before the gap closed,
    as trace.Profile names gaps by host op.

`fit_regions` and `train_regions` are the span regions of a --trace 1
run, to be called after everything else the run's cell module
(fit_cell.run, train_cell.run) runs: one plain recorded fit at the cut
budget (or one chunk) with syncs counted, then one more under
torch.profiler with spans on. Against a program without the recorder
they do nothing, and the readers of their metrics find nothing.

    python3 portbench/spans.py --workload tto_rgb --seed 7 --repeat 3

runs a cell's set-up, then the cut fit (or a chunk) plain and recorded
in turns, then the regions, and prints one JSON line: the four span
metrics, the breakdown's span keys, the walls with and without
recording, and how far each in-memory span lies inside its annotation
event in the trace.
"""

from __future__ import annotations

import bisect
import collections
import os
import statistics
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

NO_SPAN = "(no span)"
GAP_PROBE_NS = 1000       # the host is read 1 us before a gap closes
TOP = 10
FIT_METRICS = ("tto_syncs_per_iter", "lbfgs_host_ms_per_iter")
TRAIN_METRICS = ("train_gather_ms_per_chunk", "train_smpl_device_share")
# the spans an L-BFGS iteration is made of (fitting/lbfgs.py); the
# evaluation's spans lie below "lbfgs.search" in an iteration, and beside
# the iterations for each run's first evaluation
ITER_PARTS = ("lbfgs.direction", "lbfgs.search", "lbfgs.update")


class Host(NamedTuple):
    """A host event of torch: an op or a span's annotation."""
    name: str
    thread: int
    start: int          # ns
    end: int
    corr: int           # its correlation id
    seq: int            # autograd sequence number, -1 for none
    fwd_thread: int     # on a backward node: its forward op's thread
    span: bool          # a user annotation, i.e. a program span


class Kernel(NamedTuple):
    name: str
    start: int          # ns
    end: int
    corr: int           # shared with its runtime call
    linked: int         # the launching host op's correlation id


class Runtime(NamedTuple):
    corr: int
    start: int          # ns
    linked: int


class SpanTrace:
    """One profiled region, with every kernel given to a span instance
    (an index into `hosts`, -1 for none) by the rules of the module
    docstring."""

    def __init__(self, kernels: List[Kernel], hosts: List[Host],
                 runtime: List[Runtime] = (), dropped: int = 0):
        self.kernels = sorted(kernels, key=lambda k: k.start)
        self.hosts = sorted(hosts, key=lambda h: (h.thread, h.start, -h.end))
        self.runtime = {r.corr: r for r in runtime}
        self.dropped = dropped
        self._nest()
        self.rules = collections.Counter()
        self.owners = [self._owner(k) for k in self.kernels]

    @staticmethod
    def from_profiler(prof) -> "SpanTrace":
        """From a torch.profiler.profile that has stopped."""
        from torch.autograd import DeviceType

        kernels, hosts, runtime, dropped = [], [], [], 0
        for e in prof.profiler.kineto_results.events():
            annotation = e.is_user_annotation()
            if e.device_type() != DeviceType.CPU:
                if annotation:
                    dropped += 1
                else:
                    kernels.append(Kernel(e.name(), e.start_ns(), e.end_ns(),
                                          e.correlation_id(),
                                          e.linked_correlation_id()))
            elif e.linked_correlation_id() > 0:
                runtime.append(Runtime(e.correlation_id(), e.start_ns(),
                                       e.linked_correlation_id()))
            else:
                hosts.append(Host(e.name(), e.start_thread_id(), e.start_ns(),
                                  e.end_ns(), e.correlation_id(),
                                  e.sequence_nr(), e.fwd_thread_id(),
                                  annotation))
        return SpanTrace(kernels, hosts, runtime, dropped)

    # -- nesting --------------------------------------------------------

    def _nest(self):
        """Each host event's parent on its thread, innermost enclosing
        span, and innermost enclosing backward node; the forward spans
        by (thread, sequence number); the main thread's spans."""
        H = self.hosts
        n = len(H)
        self.parent = [-1] * n
        self.span_of = [-1] * n
        bwd_of = [-1] * n
        stack: List[int] = []
        for i, h in enumerate(H):
            if stack and H[stack[-1]].thread != h.thread:
                stack = []
            while stack and H[stack[-1]].end <= h.start:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent[i] = p
            self.span_of[i] = i if h.span else (
                self.span_of[p] if p >= 0 else -1)
            backward = h.seq >= 0 and h.fwd_thread > 0
            bwd_of[i] = i if backward else (bwd_of[p] if p >= 0 else -1)
            stack.append(i)
        self.bwd_of = bwd_of
        self.by_corr = {h.corr: i for i, h in enumerate(H) if h.corr > 0}
        self.forward = {}
        for i, h in enumerate(H):
            if h.seq >= 0 and h.fwd_thread <= 0:
                self.forward.setdefault((h.thread, h.seq), self.span_of[i])
        per = collections.Counter(h.thread for h in H if h.span)
        self.main = min(per, key=lambda t: (-per[t], t)) if per else None
        self.main_spans = [i for i, h in enumerate(H)
                           if h.span and h.thread == self.main]
        self.main_starts = [H[i].start for i in self.main_spans]

    def span_parent(self, i: int) -> int:
        p = self.parent[i]
        return self.span_of[p] if p >= 0 else -1

    def main_span_at(self, t: int) -> int:
        """The innermost span open on the main thread at time t."""
        j = bisect.bisect_right(self.main_starts, t) - 1
        i = self.main_spans[j] if j >= 0 else -1
        while i >= 0 and self.hosts[i].end < t:
            i = self.span_parent(i)
        return i

    def _owner(self, k: Kernel) -> int:
        rt = self.runtime.get(k.corr)
        op = self.by_corr.get(k.linked, -1)
        if op < 0 and rt is not None:
            op = self.by_corr.get(rt.linked, -1)
        if op >= 0:
            b = self.bwd_of[op]
            if b >= 0:
                f = self.forward.get((self.hosts[b].fwd_thread,
                                      self.hosts[b].seq), -1)
                if f >= 0:
                    self.rules["backward"] += 1
                    return f
            if self.span_of[op] >= 0:
                self.rules["launching thread"] += 1
                return self.span_of[op]
        t = rt.start if rt is not None else (
            self.hosts[op].start if op >= 0 else k.start)
        self.rules["main thread"] += 1
        return self.main_span_at(t)

    # -- readings -------------------------------------------------------

    def name(self, i: int) -> str:
        return self.hosts[i].name if i >= 0 else NO_SPAN

    def within(self, i: int, names) -> bool:
        """Whether span instance i is, or lies below, a span with a name
        in `names`."""
        while i >= 0:
            if self.hosts[i].name in names:
                return True
            i = self.span_parent(i)
        return False

    def device_s(self) -> Dict[str, float]:
        """Device seconds by the name of the span each kernel went to."""
        out = collections.defaultdict(float)
        for k, o in zip(self.kernels, self.owners):
            out[self.name(o)] += (k.end - k.start) / 1e9
        return dict(out)

    def subtree_s(self, name: str) -> float:
        """Device seconds of the kernels given to a span called `name` or
        to one below it."""
        memo: Dict[int, bool] = {}
        total = 0
        for k, o in zip(self.kernels, self.owners):
            if o not in memo:
                memo[o] = self.within(o, (name,))
            if memo[o]:
                total += k.end - k.start
        return total / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for k in self.kernels:
            if out and k.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], k.end)
            else:
                out.append([k.start, k.end])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, float]]:
        """(span instance, seconds) of each gap between busy intervals."""
        b = self.busy()
        return [(self.main_span_at(s1 - GAP_PROBE_NS), (s1 - e0) / 1e9)
                for (_, e0), (s1, _) in zip(b, b[1:])]

    def idle_by_span(self) -> Dict[str, float]:
        out = collections.defaultdict(float)
        for o, s in self.idle_gaps():
            out[self.name(o)] += s
        return dict(out)

    def idle_share_within(self, names) -> Optional[float]:
        """The share of the idle seconds put down to a span that is, or
        lies below, one with a name in `names`."""
        gaps = self.idle_gaps()
        total = sum(s for _, s in gaps)
        if not total:
            return None
        return sum(s for o, s in gaps if self.within(o, names)) / total

    def annotations(self) -> Dict[str, List[Tuple[int, int]]]:
        """The main thread's spans by name, (start, end) in order."""
        out = collections.defaultdict(list)
        for i in self.main_spans:
            out[self.hosts[i].name].append((self.hosts[i].start,
                                            self.hosts[i].end))
        return out


def clock_gaps_us(trace: SpanTrace, record) -> Dict[str, float]:
    """How far the in-memory spans of `record` (a profiling.Record of the
    traced block) lie inside their annotation events: the i-th span of a
    name on the recording's first thread against the i-th annotation of
    that name on the trace's main thread; medians and largest, in us."""
    if not record.spans:
        return {}
    thread = record.spans[0].thread
    mine = collections.defaultdict(list)
    for s in record.spans:
        if s.thread == thread:
            mine[s.name].append(s)
    starts, ends = [], []
    for name, anns in trace.annotations().items():
        for (a0, a1), s in zip(anns, mine.get(name, ())):
            starts.append((s.t0_ns - a0) / 1e3)
            ends.append((a1 - s.t1_ns) / 1e3)
    if not starts:
        return {}
    return {"pairs": len(starts),
            "start_median_us": statistics.median(starts),
            "start_max_abs_us": max(abs(x) for x in starts),
            "end_median_us": statistics.median(ends),
            "end_max_abs_us": max(abs(x) for x in ends)}


def recorder():
    """humor_torch's recorder, None where the program has none."""
    from humor_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def profiled(fn, device) -> SpanTrace:
    """fn() under torch.profiler (CPU, and CUDA on the card),
    synchronised inside."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.fit_cell import sync

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync(device)
    with profile(activities=activities) as prof:
        fn()
        sync(device)
    return SpanTrace.from_profiler(prof)


def breakdown_keys(rec, st: SpanTrace) -> Dict[str, list]:
    """The result line's span keys: the spans with the most device
    seconds with their host self ms and count (from the plain recorded
    run `rec`), the idle gaps and the syncs by span."""
    host = rec.by_name()
    dev = sorted(st.device_s().items(), key=lambda kv: -kv[1])[:TOP]
    spans = [[n, s, host.get(n, {}).get("self_ms"),
              host.get(n, {}).get("count")] for n, s in dev]
    idle = sorted(st.idle_by_span().items(), key=lambda kv: -kv[1])[:TOP]
    syncs = {n: d["syncs"] for n, d in host.items() if d["syncs"]}
    if rec.syncs_outside:
        syncs[NO_SPAN] = rec.syncs_outside
    return {"spans": spans,
            "idle_gaps_by_span": [[n, s] for n, s in idle],
            "syncs_by_span": sorted(([n, c] for n, c in syncs.items()),
                                    key=lambda x: -x[1])}


def fit_regions(fc, cell, record, breakdown, device) -> None:
    """After a --trace 1 fit run: the cut fit recorded with syncs
    counted, then recorded under torch.profiler. Sets record["fit_spans"]
    and the breakdown's span keys."""
    PR = recorder()
    if PR is None:
        return
    from portbench.fit_cell import cut_schedule, sync

    it, fr = cut_schedule(cell.traffic, cell.traffic["profile_scale"])
    cut = fc.runner(it, fr)
    obs = fc.observations[0]
    sync(device)
    t0 = time.perf_counter()
    with PR.recording(syncs=True) as rec:
        cut(obs)
    sync(device)
    wall = time.perf_counter() - t0
    with PR.recording() as traced:
        st = profiled(lambda: cut(obs), device)
    iters = [i for i, s in enumerate(rec.spans) if s.name == "lbfgs.iter"]
    record["fit_spans"] = {
        "recorded_wall_s": wall, "syncs": rec.syncs, "iters": len(iters),
        "stage3_iter_ms": [rec.spans[i].ns / 1e6 for i in iters
                           if rec.under(i, "fit.stage3")],
        "counters": dict(rec.counters),
        "idle_share_below_iter": st.idle_share_within(ITER_PARTS),
        "idle_share_lbfgs": st.idle_share_within(
            ITER_PARTS + ("lbfgs.forward", "lbfgs.backward")),
        "clock_gap": clock_gaps_us(st, traced),
        "attribution": dict(st.rules, annotations_dropped=st.dropped)}
    breakdown.update(breakdown_keys(rec, st))


def train_regions(tc, state, record, breakdown, device):
    """After a --trace 1 training run: one chunk (its gather included)
    recorded with syncs counted, then one recorded under torch.profiler.
    Sets record["train_spans"] and the breakdown's span keys; returns
    the state."""
    PR = recorder()
    if PR is None:
        return state
    from portbench.fit_cell import sync

    sync(device)
    t0 = time.perf_counter()
    with PR.recording(syncs=True) as rec:
        stacked, _, draws = tc.chunk(tc.k)
        state, stats = tc.step(tc.multi, state, stacked, draws)
        stats["total_loss"].cpu()
    wall = time.perf_counter() - t0
    stacked, _, draws = tc.chunk(tc.k)
    with PR.recording() as traced:
        st = profiled(lambda: tc.step(tc.multi, state, stacked, draws)[1][
            "total_loss"].cpu(), device)
    host = rec.by_name()
    record["train_spans"] = {
        "recorded_chunk_s": wall,
        "gather_ms": sum(host.get(n, {}).get("host_ms", 0.0)
                         for n in ("data.gather", "data.pairs")),
        "smpl_device_s": st.subtree_s("train.smpl_losses"),
        "busy_s": st.busy_s(),
        "clock_gap": clock_gaps_us(st, traced),
        "attribution": dict(st.rules, annotations_dropped=st.dropped)}
    breakdown.update(breakdown_keys(rec, st))
    return state


# ---------------------------------------------------------------------------
# python3 portbench/spans.py --workload <cell> --seed <n>
# ---------------------------------------------------------------------------

def _timed(fn, device) -> float:
    from portbench.fit_cell import sync

    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def _fit(cell, seed, repeat, device):
    from portbench.fit_cell import FitCell, cut_schedule

    PR = recorder()
    fc = FitCell(cell, seed, device)
    fc.runner(cell.traffic["warmup_iters"],
              cell.traffic["warmup_freeze"])(fc.observations[0])
    cut = fc.runner(*cut_schedule(cell.traffic,
                                  cell.traffic["profile_scale"]))
    obs = fc.observations[0]

    def recorded():
        with PR.recording(syncs=True):
            cut(obs)

    walls = {"plain": [], "recorded": []}
    for _ in range(repeat):
        walls["plain"].append(_timed(lambda: cut(obs), device))
        walls["recorded"].append(_timed(recorded, device))
    record, breakdown = {}, {}
    fit_regions(fc, cell, record, breakdown, device)
    return walls, record, breakdown, FIT_METRICS


def _train(cell, seed, repeat, device):
    from portbench.train_cell import TrainCell

    PR = recorder()
    tc = TrainCell(cell, seed, device)
    state = tc.TS.make_train_state(tc.weights, tc.opt)

    def chunk():
        stacked, _, draws = tc.chunk(tc.k)
        tc.step(tc.multi, state, stacked, draws)[1]["total_loss"].cpu()

    def recorded():
        with PR.recording(syncs=True):
            chunk()

    chunk()
    walls = {"plain": [], "recorded": []}
    for _ in range(repeat):
        walls["plain"].append(_timed(chunk, device))
        walls["recorded"].append(_timed(recorded, device))
    record, breakdown = {}, {}
    train_regions(tc, state, record, breakdown, device)
    return walls, record, breakdown, TRAIN_METRICS


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench import run as R

    R.set_env()
    cell = R.Cell(json.load(open(os.path.join(root, "BENCHMARK.json"))),
                  args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 3
    if recorder() is None:
        print("portbench.spans: humor_torch records no spans",
              file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _fit if cell.traffic["kind"] == "fit" else _train
    walls, record, breakdown, names = run(cell, args.seed, args.repeat,
                                          "cuda")
    metrics = {m: R.load_file(os.path.join(root, "portbench", "metrics",
                                           m + ".py"), "m").read(record)
               for m in names}
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0),
                      "walls": walls, "metrics": metrics,
                      "spans": record.get("fit_spans",
                                          record.get("train_spans")),
                      "breakdown": breakdown}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
