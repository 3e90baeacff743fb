#!/usr/bin/env python3
"""The JAX package's reprojection error and overlap gap on chip_smoke.py's
RGB fit, on the CPU: the seeded models and observation that chip_smoke.py
makes with the port (B=2 windows x 60 frames, the 6890-vertex synthetic
body, bench_tto.py's RGB weights), carried over to humor_tpu, fitted by
its runner through stages 1-2 of chip_smoke's budget (30/70; stage 3 at 0
iterations), and scored by chip_smoke.reprojection_px and
chip_smoke.overlap_gap_m. Prints the JAX values (chip_smoke's
RGB_REPROJ_JAX and RGB_GAP_JAX) and the limits chip_smoke derives from
them; with --port the port's own CPU run of the same stages; with
--drop-overlap the port's CPU run with the overlap consistency at 0 in
every stage (what the limits must refuse).

    JAX_PLATFORMS=cpu python3 scripts/rgb_reproj_reference.py \
        [--port] [--drop-overlap]

Takes a few minutes and ~3 GB on the CPU (the runner's compile).
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def jax_models(tm):
    """The port's seeded models as humor_tpu's TTOModels (the synthetic
    body is the same numpy stream in both packages; checked)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from humor_tpu.body_model.smpl import synthetic_smpl_model
    from humor_tpu.fitting import optimizer as JO
    from humor_tpu.models import gmm as jgmm
    from humor_tpu.models import humor as JH
    from humor_tpu.models import vposer as jvp

    tree = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.detach().cpu().numpy()), t)
    body = synthetic_smpl_model(num_verts=tm.body.num_verts,
                                num_joints=22)
    np.testing.assert_array_equal(np.asarray(body.v_template),
                                  tm.body.v_template.numpy())
    g = tm.init_gmm
    return JO.TTOModels(
        body=body, vposer_cfg=jvp.VPoserConfig(), vposer=tree(tm.vposer),
        humor_cfg=JH.HumorConfig(), humor=tree(tm.humor),
        init_gmm=jgmm.GmmParams(*[jnp.asarray(t.numpy()) for t in g]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port's runner on the CPU")
    ap.add_argument("--drop-overlap", action="store_true",
                    help="also run the port's runner on the CPU with the "
                         "overlap consistency at 0")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from humor_tpu.fitting import energies as JE
    from humor_tpu.fitting import optimizer as JO

    iters = cs.RGB_ITERS[:2] + (0,)
    tm = cs.make_models()
    obs = cs.make_rgb_observations(tm, seed=0)
    cfg_t = cs.rgb_config(iters)
    w = tuple(JE.StageWeights(**dataclasses.asdict(s))
              for s in cfg_t.stage_weights)
    cfg_j = JO.TTOConfig(
        seq_len=cfg_t.seq_len, stage_weights=w,
        energy=JE.EnergyConfig(smpl2op_map=cs.SMPL2OP), num_iters=iters,
        optim_floor=True, stage3_tune_init_num_frames=15,
        stage3_freeze_start=0, stage3_freeze_end=0)
    jm = jax_models(tm)
    res = JO.make_runner(cfg_j, jm)({k: jnp.asarray(v.numpy())
                                      for k, v in obs.items()})
    out = {"iterations": list(iters)}
    for st in ("stage1", "stage2"):
        stage = {k: torch.tensor(jax.device_get(v)) for k, v in
                 res.per_stage[st].items()}
        out[f"jax_{st}_reproj_px"] = cs.reprojection_px(tm, obs, stage)
        out[f"jax_{st}_final_loss"] = float(res.losses[st][-1])
        if st == "stage2":
            out["jax_stage2_overlap_gap_m"] = cs.overlap_gap_m(tm, obs, stage)
    out["limits_px"] = [cs.band(out[f"jax_{st}_reproj_px"],
                                cs.RGB_REPROJ_RTOL)
                        for st in ("stage1", "stage2")]
    out["limits_gap_m"] = cs.band(out["jax_stage2_overlap_gap_m"],
                                  cs.RGB_GAP_RTOL)

    from humor_torch.fitting import optimizer as TO

    torch.set_num_threads(4)
    runs = []
    if args.port:
        runs.append(("port_cpu", cfg_t))
    if args.drop_overlap:
        runs.append(("port_cpu_no_overlap", dataclasses.replace(
            cfg_t, stage_weights=tuple(
                dataclasses.replace(s, rgb_overlap_consist=0.0)
                for s in cfg_t.stage_weights))))
    for tag, cfg in runs:
        rt = TO.make_runner(cfg, tm, device="cpu")(obs)
        for st in ("stage1", "stage2"):
            out[f"{tag}_{st}_reproj_px"] = cs.reprojection_px(
                tm, obs, rt.per_stage[st])
            out[f"{tag}_{st}_final_loss"] = float(rt.losses[st][-1])
        out[f"{tag}_stage2_overlap_gap_m"] = cs.overlap_gap_m(
            tm, obs, rt.per_stage["stage2"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
