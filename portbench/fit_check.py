"""The output check of the fit cells: the plain reference
(portbench/reference, a frozen copy of the port's plain path that rolls
out through the typed rollout and searches nearest neighbours in plain
torch, in float32 without TF32) follows one fit of the window.

A fit on random weights parts from any other float32 computation of it
within some tens of iterations, and the runner returns each stage's
result and loss history but not its internal variables. So the
reference checks each stage from the program's own state at its start,
and the start itself:

  stage1_gap   stage 1 from the observation: the reference's first
               `stage1_iters` loss-history values against the program's
               (the largest relative gap); this also holds the start;
  stage2_gap   stage 2 from the program's stage-1 result (its root
               translation and orientation; the pose latent and shape
               stay at their zero start in stage 1): `stage2_iters`
               values, as above;
  stage3_gap   stage 3 from the program's stage-2 result: the reference
               infers the latent motion and the initial state again (the
               decoded pose stands in for the pose latent there, as the
               inference only decodes it), takes the program's own
               first-frame pose latent (recorded by `lbfgs_starts`, the
               only stage-3 variable the result does not carry), and runs
               the stage-3 sub-phases for `stage3_iters` values, as above:
               the latent-motion inference, the rollout forward and
               backward, every stage-3 term and the L-BFGS update.

A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


@contextlib.contextmanager
def lbfgs_starts(module):
    """Record the start of each L-BFGS run that `module`'s runner makes
    (its `run_lbfgs`): yields the list the dict each run is handed is
    appended to. Nothing is copied and nothing waits for the device."""
    seen = []
    inner = module.run_lbfgs

    def recording(loss_fn, init_params, *a, **kw):
        seen.append(init_params)
        return inner(loss_fn, init_params, *a, **kw)

    module.run_lbfgs = recording
    try:
        yield seen
    finally:
        module.run_lbfgs = inner


def stage3_start(starts) -> Dict[str, torch.Tensor]:
    """The first stage-3 start among one fit's recorded starts."""
    return next(s for s in starts if "latent_motion" in s)


def _lbfgs(RT, cfg, loss_fn, vars_, iters, observed, trainable):
    """The runner's L-BFGS over per-window losses, the K line-search
    candidates folded into the window batch (the parallel search)."""
    from portbench.reference.lbfgs import make_mask, run_lbfgs

    B = RT.batch_size_of(observed)
    tiled = {}

    def batched(vk):
        K = next(iter(vk.values())).shape[0]
        if K not in tiled:
            tiled[K] = RT.tile_observations(observed, K)
        flat = {k: v.reshape(K * B, *v.shape[2:]) for k, v in vk.items()}
        return loss_fn(flat, tiled[K]).reshape(K, B).sum(dim=1)

    return run_lbfgs(batched, vars_, iters, mask=make_mask(vars_, trainable),
                     history_size=cfg.lbfgs_history, linesearch="parallel",
                     num_candidates=RT.resolve_candidates(
                         cfg.lbfgs_candidates, B))


def _rel_gaps(program: torch.Tensor, ref: torch.Tensor) -> list:
    p = program.detach().double().cpu()
    r = ref.detach().double().cpu()
    return ((p - r).abs() / r.abs().clamp_min(1e-30)).tolist()


def gaps(RT, cfg, models, observed, res, start3, limits, device,
         detail=None) -> Dict[str, float]:
    """The three numbers of the module docstring for the fit `res` whose
    stage 3 started from `start3`; with a `detail` dict, the gap of every
    compared value goes there too."""
    d = {} if detail is None else detail
    dev = torch.device(device)
    obs = {k: v.to(dev) for k, v in observed.items()}
    fm = RT.prepare_models(models, dev)
    B = RT.batch_size_of(obs)
    out = {}
    n1, n2 = limits["stage1_iters"], limits["stage2_iters"]
    with torch.no_grad():
        v0 = RT.init_variables(cfg, fm.models, B, obs, dev)
    h1 = _lbfgs(RT, cfg, RT.stage1_objective(cfg, fm, v0,
                                             RT.verts_mode_for(obs)),
                v0, n1, obs, lambda k: k in ("trans", "root_orient")
                ).loss_history
    d["stage1"] = _rel_gaps(res.losses["stage1"][:n1], h1)
    d["stage1_values"] = [res.losses["stage1"][:n1].tolist(), h1.tolist()]
    out["stage1_gap"] = max(d["stage1"])

    s1 = res.per_stage["stage1"]
    v1 = {"trans": s1["trans"].to(dev).clone(),
          "root_orient": s1["root_orient"].to(dev).clone(),
          "latent_pose": torch.zeros_like(v0["latent_pose"]),
          "betas": s1["betas"].to(dev).clone()}
    if "floor_plane" in v0:
        v1["floor_plane"] = v0["floor_plane"]
    h2 = _lbfgs(RT, cfg, RT.stage2_objective(cfg, fm), v1, n2, obs,
                lambda k: k != "floor_plane").loss_history
    d["stage2"] = _rel_gaps(res.losses["stage2"][:n2], h2)
    d["stage2_values"] = [res.losses["stage2"][:n2].tolist(), h2.tolist()]
    out["stage2_gap"] = max(d["stage2"])

    s2 = res.per_stage["stage2"]
    v2 = {"trans": s2["trans"].to(dev), "root_orient": s2["root_orient"]
          .to(dev), "latent_pose": s2["pose_body"].to(dev),
          "betas": s2["betas"].to(dev)}
    if "floor_plane" in v0:
        v2["floor_plane"] = v0["floor_plane"]
    with torch.no_grad():
        s3 = RT.stage3_setup(cfg, fm, v2)
    s3["latent_pose"] = start3["latent_pose"].to(dev)
    n3, h3 = limits["stage3_iters"], []
    for wts, nsteps, scale, n, trainable in RT.stage3_phases(cfg):
        n = min(n, n3 - len(h3))
        if n <= 0:
            break
        r = _lbfgs(RT, cfg, RT.stage3_objective(
            fm, wts, nsteps, scale, cfg.energy, cfg.optim_floor),
            s3, n, obs, trainable)
        s3 = r.params
        h3 += r.loss_history.tolist()
    h3 = torch.tensor(h3, dtype=torch.float64)
    d["stage3"] = _rel_gaps(res.losses["stage3"][:n3], h3)
    d["stage3_values"] = [res.losses["stage3"][:n3].tolist(), h3.tolist()]
    out["stage3_gap"] = max(d["stage3"])
    return out


def compare(RT, cfg, models, observed, res, start3, limits, device,
            detail=None) -> Dict:
    """{name: {"value", "limit"}} for the result line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = gaps(RT, cfg, models, observed, res, start3, limits, device, detail)
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()
            if k in limits}
