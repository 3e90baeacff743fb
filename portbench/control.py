#!/usr/bin/env python3
"""The readings that the output check's limits are set from, on the card
at each cell's own size:

    python3 portbench/control.py --workload tto_rgb --program 12 \
        --control 3 [--seconds 1] [--first-seed N]

prints one JSON line a run: the program's compared numbers over
`--program` seeds (each a benchmark run of `--seconds`, the window then
holding one fit or one chunk: the lower readings), the program's with
each fault of portbench/faults.py planted over `--faults` seeds, and the
control's over `--control` seeds (the upper readings). The control is the plain
reference put in the program's place and computed in the precision just
below the one the configurations state: float32 products in TF32. For a
fit it is the reference's own whole fit (its runner, the typed rollout,
the plain nearest neighbour) at the traffic's budget on the cell's first
observation; for training, its first chunk of k steps. Each is then
judged as the program is, against the reference in float32.
"""

import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run as R  # noqa: E402


def program_reading(cell, seed: int, seconds: float, device="cuda"):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    out = cell.module().run(cell, args, time.perf_counter(), device=device)
    return {**{k: c["value"] for k, c in out["compared"].items()},
            "detail": out.get("detail")}


def tf32(on: bool):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def control_reading(cell, seed: int, device="cuda"):
    """The control's compared numbers for one seed."""
    mod = cell.module()
    if cell.traffic["kind"] == "fit":
        from portbench import fit_check

        fc = mod.FitCell(cell, seed, device)
        obs = fc.observations[0]
        # the runner turns TF32 off when it is made (device.resolve_device)
        runner = fc.RT.make_runner(fc.ref_cfg, fc.ref_models, device=device)
        tf32(True)
        try:
            with fit_check.lbfgs_starts(fc.RT) as starts:
                res = runner(obs)
        finally:
            tf32(False)
        detail = {}
        g = fit_check.gaps(fc.RT, fc.ref_cfg, fc.ref_models, obs, res,
                           fit_check.stage3_start(starts), cell.limits,
                           device, detail)
        return {**g, "detail": detail}
    from portbench import train_check

    tc = mod.TrainCell(cell, seed, device)
    _, seeds, draws = tc.chunk(tc.k)
    tf32(True)
    try:
        losses, moment, params = train_check.reference_steps(tc, draws,
                                                             seeds)
    finally:
        tf32(False)
    first = {"seeds": seeds, "draws": draws, "losses": losses,
             "moment": moment, "params": params}
    return train_check.gaps(tc, first)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", type=int, default=0,
                    help="seeds for each fault of portbench/faults.py")
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    R.set_env()
    bench = json.load(open(os.path.join(R.ROOT, "BENCHMARK.json")))
    cell = R.Cell(bench, args.workload)
    for i in range(args.program):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        rec = program_reading(cell, seed, args.seconds)
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed,
                          "seconds": time.perf_counter() - t0, **rec}),
              flush=True)
    from portbench import faults as F

    fit = cell.traffic["kind"] == "fit"
    for name in (F.FIT_FAULTS if fit else F.TRAIN_FAULTS):
        for i in range(args.faults):
            seed = args.first_seed + 2000 + i
            ctx = (F.fit_fault(name, cell.config["batch_windows"]) if fit
                   else F.train_fault(name))
            t0 = time.perf_counter()
            with ctx:
                rec = program_reading(cell, seed, args.seconds)
            print(json.dumps({"cell": cell.name, "side": "fault:" + name,
                              "seed": seed,
                              "seconds": time.perf_counter() - t0, **rec}),
                  flush=True)
    for i in range(args.control):
        seed = args.first_seed + 1000 + i
        t0 = time.perf_counter()
        rec = control_reading(cell, seed)
        print(json.dumps({"cell": cell.name, "side": "control", "seed": seed,
                          "seconds": time.perf_counter() - t0, **rec}),
              flush=True)


if __name__ == "__main__":
    main()
