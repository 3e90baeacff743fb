"""The plain reference held to humor_torch on the CPU at small sizes
(the test imports both; the reference imports nothing of humor_torch)."""

import pytest
import torch

from helpers import run_small, small_cell
from portbench import fit_cell as FD
from portbench.reference import chamfer as RC


@pytest.mark.parametrize("name", ["tto_rgb", "tto_proxd"])
def test_stage_objectives_match_the_port(name):
    """Each stage's objective and gradient, the reference's against the
    port's, from the same start, on the same observation."""
    cell = small_cell(name, frames=8)
    fc = FD.FitCell(cell, 21, "cpu")
    O, RT = fc.O, fc.RT
    obs = fc.observations[0]
    errs = []
    for mod, cfg, models in ((O, fc.cfg, fc.models),
                             (RT, fc.ref_cfg, fc.ref_models)):
        fm = mod.prepare_models(models, "cpu")
        with torch.no_grad():
            v = mod.init_variables(cfg, fm.models, 2, obs, "cpu")
            v["latent_pose"] = v["latent_pose"] + 0.1
            v3 = mod.stage3_setup(cfg, fm, v)
        w3 = cfg.stage_weights[2]
        out = []
        for make, vv, keys in (
                (lambda: mod.stage1_objective(cfg, fm, v,
                                              mod.verts_mode_for(obs)),
                 v, ("trans", "root_orient")),
                (lambda: mod.stage2_objective(cfg, fm), v,
                 ("trans", "root_orient", "latent_pose", "betas")),
                (lambda: mod.stage3_objective(fm, w3, 8, 1.0, cfg.energy,
                                              True), v3, tuple(v3))):
            leaves = {k: t.clone().requires_grad_(k in keys)
                      for k, t in vv.items()}
            val = make()(leaves, obs).sum()
            grads = torch.autograd.grad(val, [leaves[k] for k in keys])
            out.append((float(val.detach()), grads))
        errs.append(out)
    # values rtol 1e-5, gradients 1e-3 of their largest entry: the
    # tolerances the port's CPU tests hold these objectives to (the
    # kernels' plain rollout and the typed one sum in other orders)
    for (vp, gp), (vr, gr) in zip(*errs):
        assert vp == pytest.approx(vr, rel=1e-5)
        for a, b in zip(gp, gr):
            assert float((a - b).abs().max()) <= 1e-3 * float(
                b.abs().max())


def test_reference_nearest_neighbour_matches_the_port():
    from humor_torch.ops import chamfer as CH

    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 100, 3, generator=g)
    y = torch.randn(3, 70, 3, generator=g, requires_grad=True)
    xr = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    yr = y.detach().clone().requires_grad_(True)
    dp, ip = CH.nn_distance(xp, y)
    dr, ir = RC.nn_distance(xr, yr)
    assert torch.equal(ip, ir) and torch.equal(dp, dr)
    dp.sum().backward()
    dr.sum().backward()
    assert torch.equal(xp.grad, xr.grad) and torch.equal(y.grad, yr.grad)


@pytest.mark.parametrize("name", ["tto_rgb", "tto_proxd", "train_sched_samp",
                                  "train_supervised"])
def test_sound_small_run_is_correct(name):
    """A whole run of the small cell on the CPU: the check passes, each
    number far inside its limit. Stage 3's values after an update read
    the program's CPU rollout (the kernels' plain path) against the
    reference's typed rollout, which sum in other orders: a tenth of the
    limit there, a hundredth where both sides run the same operations."""
    res = run_small(small_cell(name))
    assert res["correct"], res["compared"]
    for k, c in res["compared"].items():
        share = 0.1 if k == "stage3_gap" else 0.01
        assert c["value"] <= share * c["limit"], (k, c)
