#!/usr/bin/env python3
"""How the synthetic-GT accuracy fits' errors spread over the trained
fixture's random draws, in the port (on the card by default) and in the
JAX package (on the CPU).

The mini-HuMoR/VPoser fixture trains for 450 steps in float32; the
trained weights, and so the accuracy fits' errors, depend on the initial
weights, the posterior noise and the curriculum's draws. This script
trains the fixture once per seed and runs both accuracy fits of
tests/test_tto_accuracy.py on it, printing each metric beside its bound.

    python3 scripts/fixture_seed_study.py [--seeds 0 1 2] [--device cpu]
    JAX_PLATFORMS=cpu python3 scripts/fixture_seed_study.py --jax \\
        [--seeds 0 1 2] [--nudge-px 1e-4] [--port-observation] \\
        [--cache NPZ] [--rgb-only]

Port seed s: initial HuMoR weights from a CPU generator seeded 1000 s,
VPoser's from 1000 s + 3, the draws from a generator seeded 1000 s + 1
on the device (seed 0 is humor_torch.testing's own fixture). JAX seed
s: every PRNGKey(k) of humor_tpu/testing.py's training taken as
PRNGKey(k + 1000 s) (seed 0 is the JAX package's fixture); the fits are
tests/test_tto_accuracy.py's own fixtures, with the RGB keypoints moved
by --nudge-px when it is given, or the RGB observation built by the port
(humor_torch.testing.rgb_case: the same construction in torch, equal to
JAX's within float32 rounding, its largest gap printed) with
--port-observation. --cache reads (or writes) the JAX package's seed-0
fixture at that npz (humor_tpu.testing.trained_tto_models); --rgb-only
skips the joints3d fit. Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def port_seed(seed, device):
    import torch

    from humor_torch import testing as TST
    from humor_torch.body_model.smpl import synthetic_smpl_model
    from humor_torch.fitting.optimizer import TTOModels
    from humor_torch.models import humor as H
    from humor_torch.models import vposer as vp

    body = synthetic_smpl_model(device=device)
    cfg = H.HumorConfig()
    vcfg = vp.VPoserConfig(hidden=96)
    t0 = time.perf_counter()
    humor = TST.train_mini_humor(
        body, cfg, device=device,
        params=H.init_params(cfg, torch.Generator().manual_seed(1000 * seed)),
        generator=torch.Generator(device=device).manual_seed(1000 * seed + 1))
    _, vparams = TST.train_mini_vposer(
        body, device=device, params=vp.init_params(
            vcfg, torch.Generator().manual_seed(1000 * seed + 3)))
    train_s = time.perf_counter() - t0
    models = TTOModels(body=body, vposer_cfg=vcfg, vposer=vparams,
                       humor_cfg=cfg, humor=humor, init_gmm=None)
    j3, _ = TST.joints3d_accuracy(models, device)
    rgb, _ = TST.rgb_accuracy(models, device)
    return {"package": "port", "device": str(device), "seed": seed,
            "train_seconds": train_s,
            "vposer_mae_rad": TST.vposer_roundtrip_mae(
                vcfg, vparams, TST.vposer_training_poses(body.to("cpu"))),
            "joints3d": j3, "joints3d_missed": TST.misses(
                j3, TST.JOINTS3D_BOUNDS),
            "rgb": rgb, "rgb_missed": TST.misses(rgb, TST.RGB_BOUNDS)}


def jax_seed(seed, nudge_px, port_observation=False, cache=None,
             rgb_only=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_tto_accuracy as A
    from humor_tpu import testing as JTST
    from humor_tpu.fitting import optimizer as O

    t0 = time.perf_counter()
    if cache:
        if seed != 0:
            sys.exit("--cache holds the seed-0 fixture")
        models = JTST.trained_tto_models(cache=cache)
    else:
        real_key = jax.random.PRNGKey
        jax.random.PRNGKey = lambda k: real_key(k + 1000 * seed)
        try:
            humor = JTST.train_mini_humor(A.MODEL, A.CFG)
            vcfg, vparams = JTST.train_mini_vposer(A.MODEL)
        finally:
            jax.random.PRNGKey = real_key
        models = O.TTOModels(body=A.MODEL, vposer_cfg=vcfg, vposer=vparams,
                             humor_cfg=A.CFG, humor=humor, init_gmm=None)
    train_s = time.perf_counter() - t0
    rec = {"package": "jax", "device": "cpu", "seed": seed,
           "nudge_px": nudge_px, "port_observation": port_observation,
           "train_seconds": train_s}
    fixture = A.rgb_fixture.__wrapped__()
    if nudge_px:
        obs2 = dict(fixture[0])
        obs2["joints2d"] = obs2["joints2d"].at[..., :2].add(nudge_px)
        fixture = (obs2,) + tuple(fixture[1:])
    if port_observation:
        import types

        from humor_torch import testing as TTST
        from humor_torch.body_model.smpl import synthetic_smpl_model

        _, obs_t, _, _ = TTST.rgb_case(types.SimpleNamespace(
            body=synthetic_smpl_model(device="cpu")))
        obs2 = {k: jnp.asarray(v.numpy()) for k, v in obs_t.items()}
        rec["observation_max_gap"] = {
            k: float(np.abs(np.asarray(obs2[k], np.float64)
                            - np.asarray(fixture[0][k])).max())
            for k in obs2}
        fixture = (obs2,) + tuple(fixture[1:])
    if not rgb_only:
        rec["joints3d"] = _jax_joints3d(A, O, models)
    rec["rgb"] = _jax_rgb(A, models, fixture)
    return rec


def _jax_joints3d(A, O, models):
    gt = A.gt_joints.__wrapped__()
    obs = A.observed.__wrapped__(gt)
    cfg = A.tto_cfg.__wrapped__()
    res, joints = A.recovered.__wrapped__(cfg, models, obs)
    vis = A.VIS
    init_vars = O.init_variables(cfg, models, A.B, obs)
    pred0, _ = O._stage12_pred(models, init_vars)
    init_m = A._mpjpe(pred0["joints3d"], gt, vis)
    j3 = {"vis_init_m": init_m,
          "vis_stage2_m": A._mpjpe(joints["stage2"], gt, vis),
          "vis_stage3_m": A._mpjpe(joints["stage3"], gt, vis),
          "occ_stage2_m": A._mpjpe(joints["stage2"], gt, ~vis),
          "occ_stage3_m": A._mpjpe(joints["stage3"], gt, ~vis)}
    return j3


def _jax_rgb(A, models, fixture):
    import numpy as np

    rres, rjoints = A.rgb_recovered.__wrapped__(models, fixture)
    _, rgt, plane4, _ = fixture
    rv = A.RGB_VIS
    fl = np.asarray(rres.final["floor_plane"])
    rgb = {"vis_stage2_m": A._rgb_mpjpe(rjoints["stage2"], rgt["joints3d"], rv),
           "vis_stage3_m": A._rgb_mpjpe(rjoints["stage3"], rgt["joints3d"], rv),
           "vis_stage3_root_aligned_m": A._rgb_mpjpe(
               rjoints["stage3"], rgt["joints3d"], rv, align_root=True),
           "occ_stage2_m": A._rgb_mpjpe(rjoints["stage2"], rgt["joints3d"],
                                        ~rv),
           "occ_stage3_m": A._rgb_mpjpe(rjoints["stage3"], rgt["joints3d"],
                                        ~rv),
           "floor_cos": np.sum(fl[..., :3] * plane4[:3], -1).tolist(),
           "floor_offset_err_m": np.abs(fl[..., 3] - plane4[3]).tolist()}
    return rgb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=(0, 1, 2))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--nudge-px", type=float, default=0.0)
    ap.add_argument("--port-observation", action="store_true")
    ap.add_argument("--cache")
    ap.add_argument("--rgb-only", action="store_true")
    args = ap.parse_args()
    for s in args.seeds:
        rec = (jax_seed(s, args.nudge_px, args.port_observation, args.cache,
                        args.rgb_only) if args.jax
               else port_seed(s, args.device))
        print(json.dumps(rec), flush=True)
    if not args.jax and args.device != "cpu":
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())


if __name__ == "__main__":
    main()
