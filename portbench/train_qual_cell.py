#!/usr/bin/env python3
"""The HuMoR-Qual training cell (traffic kind "train_qual"):
configs/train_humor_qual.cfg's training step, the training cells' step
(portbench/train_cell.py) with `use_smpl_joint_inputs`: each frame that
scheduled sampling feeds back goes through the gendered SMPL body, and
the joints the model is fed come from that body, not from the decoder.

The set-up, the window and the output check are the training cells':
`TrainCell` builds the program's steps through
`humor_torch.train.step.make_train_steps(..., use_smpl_joint_inputs=True)`
and `make_multi_steps`, and `qual_reference()` has train_check build the
reference's (portbench/reference/step.py) the same way, so the first
chunk is held to the reference by the same three gaps. A step's model
FLOP adds the feedback's body evaluations to counts.train_step_flops.
--trace 1 adds `feedback_regions`: the feedback's span and counter.

The readings that the limits are set from (portbench/control.py's, with
the reference's steps built for HuMoR-Qual, then the fault of this
configuration, the feedback switched off):

    python3 portbench/train_qual_cell.py --program 20 --control 6 \
        --faults 2 [--first-seed N]
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import counts, faults, spans, trace, train_check  # noqa: E402
from portbench import train_cell  # noqa: E402
from portbench.fit_cell import sync  # noqa: E402

WORKLOAD = "train_qual_sched_samp"
FEEDBACK = "train.smpl_feedback"
FEEDBACK_ROWS = "smpl.feedback_rows"
FAULTS = ("feedback_off",)


class TrainCell(train_cell.TrainCell):
    """A training cell whose steps feed back the SMPL body's joints, as
    the configuration's `model_use_smpl_joint_inputs` says."""

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        TS = self.TS
        sup, ss, _ = TS.make_train_steps(
            self.hcfg, self.loss_cfg, self.opt, self.bodies,
            use_smpl_joint_inputs=self.conf["model_use_smpl_joint_inputs"])
        self.multi = TS.make_multi_steps(sup, ss, self.k)[
            1 if self.sched else 0]


@contextlib.contextmanager
def qual_reference():
    """While the block runs, the reference's steps are built with the
    SMPL joint feedback: train_check and control.py build them with
    portbench.reference.step.make_train_steps' defaults."""
    from portbench.reference import step as RS

    make = RS.make_train_steps
    RS.make_train_steps = functools.partial(make, use_smpl_joint_inputs=True)
    try:
        yield
    finally:
        RS.make_train_steps = make


@contextlib.contextmanager
def qual_fault(name: str):
    """feedback_off: the decoder's regressed joints fed back, as HuMoR
    feeds them (humor_torch.train.step builds no joint feedback)."""
    from humor_torch.train import step as TS

    if name != "feedback_off":
        raise ValueError(f"unknown fault {name!r}")
    with faults._patched(TS, "make_rollout_joint_fn",
                         lambda *a, **kw: None):
        yield


def step_flops(batch: int, steps: int, verts: int, genders: int = 2
               ) -> float:
    """A training step's model FLOP: counts.train_step_flops and the
    feedback's body evaluations, each gender's joints (the shape blend,
    the joint regression and the kinematic chain; no vertex is skinned)
    for every row of the steps - 1 fed frames, forward only: the fed
    frames are detached (detach_sched_samp), so no gradient reaches
    them."""
    feedback = genders * (steps - 1) * counts.smpl_flops(batch, 0, verts)
    return counts.train_step_flops(batch, steps, verts, genders) + feedback


def feedback_regions(tc, state, record, breakdown, device):
    """After a --trace 1 run: one chunk (its gather included) recorded
    with syncs counted, then one recorded under torch.profiler, as
    spans.train_regions records them. Sets record["feedback"] (the
    feedback spans' host ms, device seconds and syncs, None where the
    program records no feedback span) and the breakdown's span keys and
    counters; returns the state."""
    PR = spans.recorder()
    if PR is None:
        return state
    sync(device)
    with PR.recording(syncs=True) as rec:
        stacked, _, draws = tc.chunk(tc.k)
        state, stats = tc.step(tc.multi, state, stacked, draws)
        stats["total_loss"].cpu()
    stacked, _, draws = tc.chunk(tc.k)
    with PR.recording():
        st = spans.profiled(lambda: tc.step(tc.multi, state, stacked, draws)[
            1]["total_loss"].cpu(), device)
    host = rec.by_name().get(FEEDBACK)
    below = [s.syncs for i, s in enumerate(rec.spans)
             if s.name == FEEDBACK or rec.under(i, FEEDBACK)]
    record["feedback"] = {
        "steps": tc.k,
        "host_ms": host["host_ms"] if host else None,
        "spans": host["count"] if host else 0,
        "device_s": st.subtree_s(FEEDBACK) if host else None,
        "busy_s": st.busy_s(),
        "syncs_per_step": sum(below) / tc.k if host else None,
        "rows_per_step": rec.counters.get(FEEDBACK_ROWS, 0) / tc.k}
    breakdown.update(spans.breakdown_keys(rec, st))
    breakdown["counters"] = dict(rec.counters)
    breakdown["feedback"] = record["feedback"]
    return state


def run(cell, args, t_start: float, device="cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = TrainCell(cell, args.seed, device)
    TS = tc.TS
    state = TS.make_train_state(tc.weights, tc.opt)
    # the first chunk, held to the reference after the window
    stacked, seeds, draws = tc.chunk(tc.k)
    state, stats = tc.step(tc.multi, state, stacked, draws)
    first = {"seeds": seeds, "draws": draws,
             "losses": stats["total_loss"].tolist(),
             "moment": [m.detach().clone() for m in
                        TS.tree_leaves(state.opt_state["mu"])],
             "params": [p.detach().clone()
                        for p in TS.tree_leaves(state.params)]}
    sync(device)
    setup_s = time.perf_counter() - t_start

    walls, losses = [], []
    longest = 0.0
    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if walls and t_open + args.seconds - t0 < longest:
            break
        stacked, _, draws = tc.chunk(tc.k)
        state, stats = tc.step(tc.multi, state, stacked, draws)
        losses.append(stats["total_loss"].cpu())   # one read a chunk
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        longest = max(longest, t1 - t0)
        t_last = t1
    span = t_last - t_open
    steps = len(walls) * tc.k
    cuda = tc.device.type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if cuda else 0)}
    failed = int(sum(int((~torch.isfinite(l)).sum()) for l in losses))
    record = {"step_s": span / steps, "chunk_s": span / len(walls),
              "step_flops": step_flops(tc.B, tc.T, cell.config["num_verts"])}
    breakdown = None
    if args.trace:
        import warnings

        stacked, _, draws = tc.chunk(tc.k)
        sync(device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, stats = tc.step(tc.multi, state, stacked, draws)
                stats["total_loss"].cpu()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        record["syncs_per_step"] = sum(
            1 for w in caught if "synchroniz" in str(w.message)) / tc.k
        stacked, _, draws = tc.chunk(tc.k)

        def one_chunk():
            tc.step(tc.multi, state, stacked, draws)[1]["total_loss"].cpu()

        prof, wall = trace.profile(one_chunk)
        record["profile"] = prof
        dev_info["busy_s"] = prof.busy_s()
        dev_info["window_s"] = wall
        breakdown = {"device_ops": prof.top_ops(),
                     "idle_gaps": prof.idle_gaps()}
        state = feedback_regions(tc, state, record, breakdown, device)
    del state, stacked, stats, draws
    tc.multi = None
    if cuda:
        torch.cuda.empty_cache()
    with qual_reference():
        compared = train_check.compare(tc, first, cell.limits)
    return {"end_to_end": {"train_samples_per_s": steps * tc.B / span,
                           "setup_s": setup_s},
            "record": record, "compared": compared, "walls": walls,
            "attempted": steps, "failed": failed, "device": dev_info,
            "breakdown": breakdown}


def main(argv=None):
    """portbench/control.py's readings for this cell (the program, the
    faults of faults.py, the control), then the feedback_off fault's."""
    import argparse
    import json

    from portbench import control as CT
    from portbench import run as R

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    with qual_reference():
        CT.main(["--workload", WORKLOAD, "--program", str(args.program),
                 "--control", str(args.control), "--seconds",
                 str(args.seconds), "--faults", str(args.faults),
                 "--first-seed", str(args.first_seed)])
    cell = R.Cell(json.load(open(os.path.join(R.ROOT, "BENCHMARK.json"))),
                  WORKLOAD)
    for name in FAULTS:
        for i in range(args.faults):
            seed = args.first_seed + 3000 + i
            t0 = time.perf_counter()
            with qual_fault(name):
                rec = CT.program_reading(cell, seed, args.seconds)
            print(json.dumps({"cell": cell.name, "side": "fault:" + name,
                              "seed": seed,
                              "seconds": time.perf_counter() - t0, **rec}),
                  flush=True)


if __name__ == "__main__":
    main()
