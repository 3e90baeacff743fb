#!/usr/bin/env python3
"""Where a training step's time goes on the card: chip_smoke.py's phase-8
step (configs/train_humor.cfg's HuMoR 1024/48 with the SMPL losses on
6890-vertex synthetic male and female bodies) at B windows x 10
transitions.

    python3 scripts/profile_train_step.py [--batch 200] [--reps 5]

For the supervised and the scheduled-sampling (use_gt_p 0.5) step:
the step's ms (host clock over `reps` steps to torch.cuda.synchronize)
and peak memory; the same work split into its parts, each synchronized
and timed alone (model forward, the ELBO without and with the SMPL terms,
autograd's backward, the optimizer update); then one step under
torch.profiler: device kernels enqueued, device-busy ms and share, and
the 15 kernel names with the most device time. Prints one JSON line.
Needs a GPU.
"""

import argparse
import collections
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from humor_torch import resolve_device
    from humor_torch.losses.elbo import LossConfig, elbo_loss
    from humor_torch.models import humor as H
    from humor_torch.train import step as TS

    if not torch.cuda.is_available():
        sys.exit("profile_train_step: no CUDA device")
    dev = resolve_device("cuda")
    bodies = {k: v.to(dev) for k, v in CS.train_bodies().items()}
    cfg, loss_cfg = H.HumorConfig(), LossConfig()
    opt = TS.make_optimizer()
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                dev)
    sup, ss, _ = TS.make_train_steps(cfg, loss_cfg, opt, bodies)
    data = CS.train_batch(bodies, args.batch, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def timed(fn, reps=args.reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps, out

    past, t_in, gt, gender, betas = TS._flatten_supervised(cfg, data)
    parts = {}
    parts["model_forward"], out = timed(
        lambda: H.single_step(cfg, state.params, past, t_in, generator=gen))
    parts["elbo_no_smpl"], _ = timed(lambda: elbo_loss(
        loss_cfg, out.pred, out.posterior, out.prior, gt, 10))
    parts["elbo_with_smpl"], (loss, _) = timed(lambda: elbo_loss(
        loss_cfg, out.pred, out.posterior, out.prior, gt, 10,
        gender_ids=gender, betas=betas, smpl_models=bodies))
    leaves = TS.tree_leaves(state.params)

    def backward():
        o = H.single_step(cfg, state.params, past, t_in, generator=gen)
        lo, _ = elbo_loss(loss_cfg, o.pred, o.posterior, o.prior, gt, 10,
                          gender_ids=gender, betas=betas,
                          smpl_models=bodies)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = torch.autograd.grad(lo, leaves)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, g

    bw = [backward() for _ in range(args.reps + 1)][1:]
    parts["backward"] = 1e3 * sum(t for t, _ in bw) / args.reps
    grads = list(bw[-1][1])
    parts["optimizer_update"], _ = timed(
        lambda: opt.update(grads, state.opt_state, state.params))

    rec = {"batch": args.batch, "transitions": CS.TRAIN_T,
           "device": torch.cuda.get_device_name(0),
           "supervised_parts_ms": parts}
    steps = {"supervised": lambda s: sup(s, data, 10, generator=gen),
             "sched_samp": lambda s: ss(s, data, 10, 0.5, generator=gen)}
    for name, step in steps.items():
        state, _ = step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            state, stats = step(state)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / args.reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, stats = step(state)
            torch.cuda.synchronize()
        per_name = collections.defaultdict(lambda: [0, 0.0])
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name[:80]][0] += 1
                per_name[e.name[:80]][1] += e.time_range.elapsed_us() / 1e3
        busy = sum(v[1] for v in per_name.values())
        rec[name] = {
            "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kernel_launches": sum(v[0] for v in per_name.values()),
            "device_busy_ms": busy, "busy_share": busy / ms,
            "top": sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]}
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
