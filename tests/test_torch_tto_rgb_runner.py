"""The whole RGB video fit of humor_torch against humor_tpu's runner on
the CPU: the observation, models and weights of test_torch_tto_rgb.py
(B=3 windows of T=8 cut from one 18-frame video, 2D keypoints, the floor
plane optimized, the overlap consistency at 200 in every stage, the depth
init from bone lengths), with the decoder head damped x0.1 as in
test_torch_tto_prox.py; and stage 2 alone with the zoom search against
JAX's, evaluation by evaluation.
"""

import dataclasses

import jax
import numpy as np
import torch

from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import lbfgs as JL
from humor_tpu.fitting import optimizer as JO

from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO

from test_torch_tto import models  # noqa: F401
from test_torch_tto_prox import damped_models  # noqa: F401
from test_torch_tto_rgb import (B, CFG_J, CFG_T, T, _jx, _th,  # noqa: F401
                                observed)

torch.set_num_threads(2)

# stage 3 stops after phases A and B (one iteration each): see the test
ITERS = (3, 3, 2)


def test_rgb_runner_matches_jax(damped_models, observed):
    """Both runners end to end on the RGB windows: per-iteration loss
    histories (rtol 1e-4) and the final camera-frame outputs, the
    prior-frame trajectory and the parsed floor plane (5e-3 abs, the
    PROX runner test's bound). Measured on the CPU: histories within
    8.2e-6, finals within 3.1e-3 (joints3d_rollout; prior_trans 2.8e-3,
    pose_body 1.3e-3, latent_motion 8.9e-4).

    A third stage-3 iteration (phase C, everything free) is not pinned:
    on this 8-frame chain it moves the rollout's pose by 0.09 when the
    2D keypoints are nudged by 1e-4 px (the port against itself,
    measured), so two float32 packages cannot agree there to 5e-3 (they
    part by 0.098 in pose_body while their histories agree to 4.3e-5)."""
    jm, tm = damped_models
    cfg_j = dataclasses.replace(CFG_J, num_iters=ITERS)
    cfg_t = dataclasses.replace(CFG_T, num_iters=ITERS)
    rj = JO.make_runner(cfg_j, jm)(_jx(observed))
    rt = TO.make_runner(cfg_t, tm, device="cpu")(_th(observed))
    for st, n in zip(("stage1", "stage2", "stage3"), ITERS):
        assert rt.losses[st].shape == (n,), st
        np.testing.assert_allclose(rt.losses[st].numpy(),
                                   np.asarray(rj.losses[st]), rtol=1e-4,
                                   err_msg=st)
    for k in ("trans", "root_orient", "pose_body", "betas", "latent_motion",
              "prior_trans", "prior_root_orient", "joints3d_rollout",
              "contacts", "floor_plane"):
        np.testing.assert_allclose(rt.final[k].numpy(),
                                   np.asarray(rj.final[k]), atol=5e-3,
                                   err_msg=k)
    assert tuple(rt.final["floor_plane"].shape) == (B, 4)
    assert tuple(rt.final["trans"].shape) == (B, T, 3)



def test_rgb_zoom_stage2_matches_jax(models, observed, monkeypatch):
    """Stage 2 of the port's RGB runner with the zoom search (each probe
    one evaluation of the objective at K=1, the overlap terms included),
    8 iterations, against JAX's zoom run_lbfgs on JAX's stage-2 objective
    and mask (its runner's `_stage2_body`, compiled alone: the whole JAX
    runner would also compile stage 3) from JAX's initial variables: the
    history within rtol 1e-5, and every objective evaluation, in order,
    within rtol 1e-5 of JAX's, so the searches probed the same points
    the same number of times. JAX's run_lbfgs evaluates once more, at
    the point it returns (its `final_loss`); the port reuses that value.
    Measured on the CPU: 12 evaluations each, the start, then 4 probes in
    the first iteration (step 1 fails the decrease test, and 3 zoom steps
    into the bracket), then 1 an iteration; JAX's first 12 within 3.8e-6."""
    jm, tm = models
    iters = 8
    cfg_t = dataclasses.replace(CFG_T, num_iters=(0, iters, 0),
                                lbfgs_linesearch="zoom")
    evals = {"jax": [], "torch": []}
    t_fit = TE.smpl_fit

    def t_counted(*a, **kw):
        out = t_fit(*a, **kw)
        evals["torch"].append(float(out.detach().sum()))
        return out
    monkeypatch.setattr(TE, "smpl_fit", t_counted)
    rt = TO.make_runner(cfg_t, tm, device="cpu")(_th(observed))

    obs = _jx(observed)
    w2 = CFG_J.stage_weights[1]

    def stage2_loss(v, o):
        pred, _ = JO._stage12_pred(jm, v, o)
        loss, _ = JE.smpl_fit(CFG_J.energy, w2, o, pred, T)
        jax.debug.callback(lambda x: evals["jax"].append(float(x)), loss)
        return loss

    v0 = JO.init_variables(CFG_J, jm, B, obs)
    mask = JL.make_mask(v0, lambda k: k != "floor_plane")
    rj = jax.jit(lambda v, o: JL.run_lbfgs(
        stage2_loss, v, iters, o, mask=mask, linesearch="zoom",
        history_size=CFG_J.lbfgs_history,
        max_linesearch_steps=CFG_J.lbfgs_max_linesearch))(v0, obs)
    jax.effects_barrier()
    np.testing.assert_allclose(rt.losses["stage2"].numpy(),
                               np.asarray(rj.loss_history), rtol=1e-5)
    n = len(evals["torch"])
    assert len(evals["jax"]) == n + 1
    np.testing.assert_allclose(evals["torch"], evals["jax"][:n], rtol=1e-5)
