"""The test-time-fit cells (traffic kind "fit"): HuMoR's
3-stage fit of SMPL motion to a batch of 60-frame windows, through
`humor_torch.fitting.optimizer.make_runner(cfg, models)(observed)`.

Set-up makes the weights on the device from the seed, the synthetic body
and `observation.distinct` observation batches, builds the runner, and
warms every shape with one fit at a small budget that visits every stage
and stage-3 phase. The window runs whole fits back to back, each on the
next observation, and starts another only while the time left is at
least the longest fit seen so far, so it never stops in the middle of a
fit; the first fit always counts. Each fit is a fixed amount of work:
the parallel line search makes one K-candidate value-and-gradient
evaluation an iteration, for a fixed number of iterations.

With --trace 0 the window's fits run under `trace.BusyMeter`, which
reads the device's busy seconds a window (`fit_device_s_per_window`),
its trace cut into a segment every `ROLL_EVERY` loss evaluations. With
--trace 1 they run plainly and pass the runner its `timings=`: the
window's rate on the host's clock and stage 3's seconds are read there;
after the window one fit of the same shapes at a budget cut by the
traffic's `profile_scale` runs plainly, then under torch.profiler.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from portbench import counts, fit_check, trace
from portbench import fit_traffic as FT
from portbench import weights as W


# loss evaluations (L-BFGS iterations) a segment of the busy meter's
# trace: some 3,300 kernels each, so a segment holds ~40,000 device
# events (~467,000 a fit in 12 segments on the H100)
ROLL_EVERY = 16


def sub_seeds(seed: int, n: int):
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n)]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tto_config(O, E, conf, traffic, num_iters=None, freeze=None):
    """The TTOConfig of either package (its optimizer and energies
    modules O, E) for a configuration and a traffic mix."""
    w = traffic["stage_weights"]
    stages = tuple(E.StageWeights(**{k: float(v[i]) for k, v in w.items()})
                   for i in range(3))
    num_iters = tuple(num_iters or traffic["num_iters"])
    freeze = tuple(freeze or traffic["stage3_freeze"])
    energy = E.EnergyConfig(robust_loss=traffic["robust_loss"],
                            robust_tuning_const=traffic["robust_tuning_const"],
                            joints2d_sigma=traffic["joints2d_sigma"],
                            smpl2op_map=FT.SMPL2OP)
    return O.TTOConfig(
        seq_len=conf["seq_len"], stage_weights=stages, energy=energy,
        num_iters=num_iters, lbfgs_history=conf["lbfgs_history"],
        lbfgs_linesearch=conf["lbfgs_linesearch"],
        lbfgs_candidates=conf["lbfgs_candidates"],
        optim_floor=traffic["optim_floor"],
        stage3_tune_init_num_frames=traffic["stage3_tune_init_num_frames"],
        stage3_freeze_start=min(freeze[0], num_iters[2]),
        stage3_freeze_end=min(freeze[1], num_iters[2]))


def cut_schedule(traffic, scale):
    """The budget cut in proportion (at least one iteration a stage and
    stage-3 phase), with its freeze points."""
    it = [max(1, int(round(n * scale))) for n in traffic["num_iters"]]
    f0 = min(max(1, int(round(traffic["stage3_freeze"][0] * scale))),
             it[2] - 1)
    f1 = min(max(f0 + 1, int(round(traffic["stage3_freeze"][1] * scale))),
             it[2] - 1)
    return it, (f0, f1)


def humor_kwargs(conf):
    return dict(latent_size=conf["humor_latent"],
                in_rot_rep=conf["humor_in_rot_rep"],
                out_rot_rep=conf["humor_out_rot_rep"],
                model_data_config=conf["humor_model_data_config"])


def make_models(pkgs, conf, traffic, gen, device):
    """The TTOModels of the program and of the reference over the same
    seeded weights and body."""
    O, H, V, S, G = pkgs["program"]
    RT, RH, RV, RS, RG = pkgs["reference"]
    body = W.synthetic_body(conf["body_seed"], conf["num_verts"],
                            conf["num_joints"])
    if traffic["root_centred_body"]:
        body = W.root_centred(body)
    hkw = humor_kwargs(conf)
    hcfg, rhcfg = H.HumorConfig(**hkw), RH.HumorConfig(**hkw)
    vcfg = V.VPoserConfig(latent_dim=conf["vposer_latent"],
                          hidden=conf["vposer_hidden"])
    rvcfg = RV.VPoserConfig(latent_dim=conf["vposer_latent"],
                            hidden=conf["vposer_hidden"])
    humor = W.humor_weights(rhcfg, conf["humor_hidden"], gen,
                            conf["decoder_out_scale"])
    vposer = W.vposer_weights(rvcfg, gen)
    gmm = W.gmm_arrays(conf["gmm_components"], conf["gmm_dim"], device)
    prog = O.TTOModels(body=W.body_model(S.SmplModel, body, device),
                       vposer_cfg=vcfg, vposer=vposer, humor_cfg=hcfg,
                       humor=humor, init_gmm=G.GmmParams(*gmm))
    ref = RT.TTOModels(body=W.body_model(RS.SmplModel, body, device),
                       vposer_cfg=rvcfg, vposer=vposer, humor_cfg=rhcfg,
                       humor=humor, init_gmm=RG.GmmParams(*gmm))
    return prog, ref


def packages():
    from humor_torch.body_model import smpl as S
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O
    from humor_torch.models import gmm as G
    from humor_torch.models import humor as H
    from humor_torch.models import vposer as V
    from portbench.reference import energies as RE
    from portbench.reference import gmm as RG
    from portbench.reference import humor as RH
    from portbench.reference import smpl as RS
    from portbench.reference import tto as RT
    from portbench.reference import vposer as RV

    return {"program": (O, H, V, S, G), "reference": (RT, RH, RV, RS, RG),
            "energies": (E, RE)}


class FitCell:
    """Set-up of one fit cell: models, observations, configurations."""

    def __init__(self, cell, seed: int, device):
        self.conf, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        s = sub_seeds(seed, 3)
        gen = torch.Generator(device=self.device).manual_seed(s[0])
        pk = packages()
        self.O = pk["program"][0]
        self.RT = pk["reference"][0]
        E, RE = pk["energies"]
        self.models, self.ref_models = make_models(pk, self.conf,
                                                   self.traffic, gen,
                                                   self.device)
        self.B, self.T = self.conf["batch_windows"], self.conf["seq_len"]
        p = self.traffic["observation"]
        obs_seeds = sub_seeds(s[1], p["distinct"])
        self.observations = [FT.make_observation(
            p["kind"], p, self.ref_models, self.B, self.T, os_, self.device)
            for os_ in obs_seeds]
        self.check_rng = np.random.RandomState(s[2])
        self.cfg = tto_config(self.O, E, self.conf, self.traffic)
        self.ref_cfg = tto_config(self.RT, RE, self.conf, self.traffic)

    def runner(self, num_iters=None, freeze=None):
        from humor_torch.fitting import energies as E

        cfg = (self.cfg if num_iters is None else tto_config(
            self.O, E, self.conf, self.traffic, num_iters, freeze))
        return self.O.make_runner(cfg, self.models, device=self.device)

    def work(self, num_iters, freeze):
        p = self.traffic["observation"]
        pose_prior3 = self.traffic["stage_weights"].get(
            "pose_prior", [0, 0, 0])[2] > 0
        evals = counts.fit_evaluations(
            num_iters, freeze, self.traffic["stage3_tune_init_num_frames"],
            self.B, self.T, self.conf["lbfgs_candidates"], pose_prior3)
        kind = p["kind"]
        verts = {"prox": self.conf["num_verts"], "rgb": 43}.get(kind, 0)
        return counts.fit_work(evals, self.B, self.T, verts,
                               self.conf["num_verts"],
                               p["points"] if kind == "prox" else 0)


@contextlib.contextmanager
def rolling(module, meter, every: int):
    """Roll `meter` over to a new segment every `every` loss evaluations
    of the L-BFGS runs that `module`'s runner makes (its `run_lbfgs`)."""
    inner = module.run_lbfgs
    calls = [0]

    def rolled(loss_fn, init_params, *a, **kw):
        def counted(*la, **lkw):
            calls[0] += 1
            if calls[0] % every == 0:
                meter.roll()
            return loss_fn(*la, **lkw)

        return inner(counted, init_params, *a, **kw)

    module.run_lbfgs = rolled
    try:
        yield meter
    finally:
        module.run_lbfgs = inner


def run(cell, args, t_start: float, device="cuda"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fc = FitCell(cell, args.seed, device)
    runner = fc.runner()
    warm = cell.traffic["warmup_iters"]
    fc.runner(warm, cell.traffic["warmup_freeze"])(fc.observations[0])
    # the profiler starts (CUPTI's, ~10 s on the H100) in the window's
    # first fit, on the host: set-up stays the program's own
    meter = None if args.trace else trace.BusyMeter(device)
    sync(device)
    setup_s = time.perf_counter() - t_start

    # (observation index, result, wall, timings, start, end, the stage-3
    # start the check follows from)
    fits = []
    longest = 0.0
    with contextlib.ExitStack() as stack:
        starts = stack.enter_context(fit_check.lbfgs_starts(fc.O))
        if meter is not None:
            stack.enter_context(rolling(fc.O, meter, ROLL_EVERY))
        t_open = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if fits and t_open + args.seconds - t0 < longest:
                break
            i = len(fits) % len(fc.observations)
            timings = {} if args.trace else None
            n0 = len(starts)
            if meter is not None:
                meter.start()
            res = runner(fc.observations[i], timings=timings)
            if meter is not None:
                meter.stop()
            sync(device)
            t1 = time.perf_counter()
            fits.append((i, res, t1 - t0, timings, t0, t1,
                         fit_check.stage3_start(starts[n0:])))
            longest = max(longest, t1 - t0)
        starts.clear()
    span = fits[-1][5] - fits[0][4]
    walls = [f[2] for f in fits]
    rate = len(fits) * fc.B / span
    end_to_end = {"setup_s": setup_s}
    if meter is not None:
        end_to_end["fit_device_s_per_window"] = (meter.busy_s
                                                 / (len(fits) * fc.B))
        print(f"portbench: busy {meter.busy_s!r} s over {meter.events} "
              f"device events in {meter.segments} segments",
              file=sys.stderr)
    dev_info = {"platform": "gpu" if fc.device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0)
                         if fc.device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if fc.device.type == "cuda" else 0)}
    failed = sum(1 for f in fits if not all(
        bool(torch.isfinite(v).all()) for v in f[1].losses.values()))

    record = {"fit_wall_s": walls, "work": fc.work(
        tuple(cell.traffic["num_iters"]), tuple(cell.traffic["stage3_freeze"]))}
    breakdown = None
    if args.trace:
        record["stage3_s"] = [f[3]["stage3"] for f in fits]
        record["windows_per_s"] = rate
        it, fr = cut_schedule(cell.traffic, cell.traffic["profile_scale"])
        cut = fc.runner(it, fr)
        obs = fc.observations[0]
        sync(device)
        t0 = time.perf_counter()
        cut(obs)
        sync(device)
        record["cut_plain_wall_s"] = time.perf_counter() - t0
        prof, wall = trace.profile(lambda: cut(obs))
        record.update(profile=prof, profile_wall_s=wall,
                      cut_iters=sum(it), work_cut=fc.work(it, fr))
        dev_info["busy_s"] = prof.busy_s()
        dev_info["window_s"] = wall
        breakdown = {"device_ops": prof.top_ops(),
                     "idle_gaps": prof.idle_gaps()}
        del cut

    # the check: a fit of the window drawn from the seed, after the
    # program's state is freed
    pick = fits[int(fc.check_rng.randint(len(fits)))]
    checked = (fc.observations[pick[0]], pick[1], pick[6])
    del runner, fits
    if fc.device.type == "cuda":
        torch.cuda.empty_cache()
    detail = {}
    compared = fit_check.compare(fc.RT, fc.ref_cfg, fc.ref_models,
                                 *checked, cell.limits, fc.device, detail)
    return {"end_to_end": end_to_end,
            "record": record, "compared": compared,
            "walls": walls, "attempted": len(walls), "failed": failed, "device": dev_info,
            "breakdown": breakdown, "detail": detail}
