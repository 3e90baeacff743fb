#!/usr/bin/env python3
"""Profile chip_smoke.py's phase-5 fit alone (the PROX RGB-D fit at its
reduced iterations), or with --cell rgb phase 6's RGB video fit at the
same iterations, and count every device kernel by name.

    python3 scripts/profile_fit_study.py TAG [--cell prox|rgb] [--iters 30,70,70]

Run from the root of the tree to measure: the script imports chip_smoke.py
and humor_torch from the current directory, so one copy of it can profile
an older tree unpacked (`git archive REV | tar -x -C DIR`) into a
directory .gitignore lists:

    (cd DIR && python3 /path/to/scripts/profile_fit_study.py parent)

Builds the kernels, runs the fit once to warm up and once unprofiled
(host clock), then once under torch.profiler. Prints one JSON line: the
tag, the rollout kernels' calls, the device kernels enqueued, the device
time, the unprofiled wall and busy share, and the count and device ms of
every kernel name. Compare two trees in one call, in turns (a b b a).
Needs a GPU and nvcc.
"""

import argparse
import collections
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tag", nargs="?", default="")
    ap.add_argument("--cell", choices=("prox", "rgb"), default="prox")
    ap.add_argument("--iters", default=None,
                    help="L-BFGS iterations of the three stages, e.g. "
                    "30,70,70 (default: chip_smoke.PROFILE_ITERS)")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import cuda_build
    from humor_torch.ops import rollout_kernel as RK

    if not torch.cuda.is_available():
        sys.exit("profile_fit_study: no CUDA device")
    cuda_build.build(["rollout_fwd", "rollout_bwd", "nn_distance"], force=True)
    iters = (tuple(int(n) for n in args.iters.split(",")) if args.iters
             else CS.PROFILE_ITERS)
    if args.cell == "rgb":
        models = CS.make_models()
        runner = O.make_runner(CS.rgb_config(iters), models,
                               device="cuda")
        obs = CS.make_rgb_observations(models, seed=0, device="cuda")
    else:
        models = CS.prox_models(CS.make_models())
        runner = O.make_runner(CS.prox_config(iters), models,
                               device="cuda")
        obs = CS.make_prox_observations(models, seed=0)
    runner(obs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    before = dict(RK.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner(obs)
        torch.cuda.synchronize()
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name[:90]][0] += 1
            per_name[e.name[:90]][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in per_name.values())
    print(json.dumps({
        "tag": args.tag, "cell": args.cell, "iters": iters,
        "calls": {k: RK.launches[k] - before[k] for k in before},
        "kernel_launches": sum(n for n, _ in per_name.values()),
        "device_busy_ms": busy_ms, "unprofiled_wall_s": wall,
        "busy_share_unprofiled": busy_ms / 1e3 / wall,
        "per_name": per_name}))


if __name__ == "__main__":
    main()
