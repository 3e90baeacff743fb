#!/usr/bin/env python3
"""How many probes the zoom line search makes an iteration on the RGB
fit's stage 3, in the JAX package and in the port, on the CPU.

chip_smoke.py's seeded models and RGB observation (B=2 windows x 60
frames, the 6890-vertex synthetic body, bench_tto.py's RGB weights),
carried over to humor_tpu as scripts/rgb_reproj_reference.py does. Both
runners fit stages 1-2 with the parallel search, then stage 3 in one
phase (no init-state tuning) with the zoom search. Every evaluation of
the stage-3 objective (`energies.motion_fit`) is recorded, in order, with
its value: the port's are its start point and its probes (a non-finite
probe adds one evaluation); JAX's run_lbfgs also evaluates once more at
the point it returns. Prints the counts, the probes an iteration of each
package, both stage-3 histories and both evaluation sequences.

    JAX_PLATFORMS=cpu python3 scripts/zoom_probe_count.py \
        [--iters 10 10 4] [--damp 1.0] [--trained NPZ]

`--damp` scales the HuMoR decoder's output layer (chip_smoke.damped), 0.1
making the 59-step rollout well-conditioned. `--trained NPZ` takes the
trained mini-HuMoR/VPoser fixture instead (the JAX package's
trained_tto_models(cache=NPZ), trained and written there if absent, read
into the port through its checkpoint reader) and the RGB accuracy fit's
observation and weights (humor_torch.testing.rgb_case: two windows of 10
frames of the 256-vertex synthetic body). Takes a few minutes and a few
GB on the CPU (the JAX runner's compile; the fixture's training ~2 min).
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, nargs=3, default=(10, 10, 4))
    ap.add_argument("--damp", type=float, default=1.0)
    ap.add_argument("--trained", metavar="NPZ", default=None)
    args = ap.parse_args()
    if args.trained and args.damp != 1.0:
        ap.error("--damp applies to the random-weight models only")

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from humor_torch.fitting import energies as TE
    from humor_torch.fitting import optimizer as TO
    from humor_tpu.fitting import energies as JE
    from humor_tpu.fitting import optimizer as JO
    from rgb_reproj_reference import jax_models

    torch.set_num_threads(4)
    iters = tuple(args.iters)
    if args.trained:
        from humor_torch import testing as TTST
        from humor_tpu import testing as JTST

        jm = JTST.trained_tto_models(cache=args.trained)
        tm = TTST.trained_tto_models(cache=args.trained, device="cpu")
        base, obs, _, _ = TTST.rgb_case(tm)
    else:
        tm = cs.make_models()
        obs = cs.make_rgb_observations(tm, seed=0)
        base = cs.rgb_config(iters)
    if args.damp != 1.0:
        tm = tm._replace(humor=cs.damped(tm.humor, args.damp))
    if not args.trained:
        jm = jax_models(tm)
    search = ("parallel", "parallel", "zoom")
    cfg_t = dataclasses.replace(base, num_iters=iters,
                                lbfgs_linesearch=search,
                                stage3_tune_init_state=False)
    w = tuple(JE.StageWeights(**dataclasses.asdict(s))
              for s in cfg_t.stage_weights)
    cfg_j = JO.TTOConfig(
        seq_len=cfg_t.seq_len, stage_weights=w,
        energy=JE.EnergyConfig(smpl2op_map=cfg_t.energy.smpl2op_map),
        num_iters=iters, lbfgs_linesearch=search, optim_floor=True,
        stage3_tune_init_state=False)

    evals = {"jax": [], "port": []}
    j_fit, t_fit = JE.motion_fit, TE.motion_fit

    def j_counted(*a, **kw):
        out = j_fit(*a, **kw)
        jax.debug.callback(lambda v: evals["jax"].append(float(v)), out[0])
        return out

    def t_counted(*a, **kw):
        out = t_fit(*a, **kw)
        evals["port"].append(float(out.detach().sum()))
        return out

    JE.motion_fit, TE.motion_fit = j_counted, t_counted
    rj = JO.make_runner(cfg_j, jm)(
        {k: jnp.asarray(v.numpy()) for k, v in obs.items()})
    jax.block_until_ready(rj.final["trans"])
    jax.effects_barrier()
    rt = TO.make_runner(cfg_t, tm, device="cpu")(obs)

    n3 = iters[2]
    out = {"iterations": list(iters), "damp": args.damp,
           "trained": args.trained,
           "jax_evaluations": len(evals["jax"]),
           "port_evaluations": len(evals["port"]),
           "jax_probes_per_iteration": (len(evals["jax"]) - 2) / n3,
           "port_probes_per_iteration": (len(evals["port"]) - 1) / n3,
           "jax_stage3": [float(v) for v in rj.losses["stage3"]],
           "port_stage3": rt.losses["stage3"].tolist(),
           "jax_values": evals["jax"], "port_values": evals["port"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
