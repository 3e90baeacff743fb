"""The PROX RGB-D fit's stage 2 in short runs, both packages: the port's
and the JAX package's runners at 5/10/10 (chip_smoke's profiled budget)
on chip_smoke.make_prox_observations (8 frames, 192 of the 256-vertex
body's vertices a frame here, so that the CPU fits it), with
configs/fit_proxd.cfg's weights (chip_smoke.prox_config) and the same
seeded models (the decoder head damped x0.1, as
tests/test_torch_tto_prox.py's runner test, since the random-weight
stage 3 is chaotic). Slow: JAX compiles this runner in
about a minute.

The question it answers (ROADMAP C): does stage 2 stall, its history
flat after the first iterations, in the port alone or in both? At this
size neither stalls: both lower stage 2 from 3071.1 to 1662.6 (port) /
1665.5 (JAX) over its 10 iterations, steadily (measured on the CPU). Stages 1-2
do not roll HuMoR out; stage 1's history is held within 1e-4 relative
(measured 3.6e-6), stage 2's within 5e-3 (measured 1.8e-3 at its last
iteration: the two part slowly from its sixth on, as float32 L-BFGS
paths on the bisquare-weighted cloud do), and each stage-2 history must
end at least 30% below its start (measured 46%).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import optimizer as JO

from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO
from humor_torch.ops import transforms as TT

from test_torch_tto import models  # noqa: F401
from test_torch_tto_prox import damped_models  # noqa: F401

torch.set_num_threads(2)

ITERS = (5, 10, 10)
FRAMES, POINTS = 8, 192


def _prox_config(O, E):
    """chip_smoke.prox_config in either package."""
    w12 = E.StageWeights(points3d=1.0, joints2d=0.001, pose_prior=0.1,
                         shape_prior=0.034, joints3d_smooth=100.0)
    w3 = E.StageWeights(points3d=1.0, joints2d=0.001, shape_prior=0.034,
                        motion_prior=0.075, init_motion_prior=0.075,
                        joint_consistency=100.0, bone_length=2000.0,
                        contact_vel=100.0, contact_height=10.0, floor_reg=1.0)
    return O.TTOConfig(
        seq_len=FRAMES, stage_weights=(w12, w12, w3),
        energy=E.EnergyConfig(robust_loss="bisquare",
                              robust_tuning_const=4.6851,
                              smpl2op_map=CS.SMPL2OP),
        num_iters=ITERS, optim_floor=True,
        stage3_tune_init_num_frames=min(15, FRAMES),
        stage3_freeze_start=min(30, ITERS[2]),
        stage3_freeze_end=min(55, ITERS[2]))


@pytest.mark.slow
def test_prox_stage2_history_matches_jax(damped_models):
    jm, tm = damped_models
    tm = CS.prox_models(tm)
    j0 = np.asarray(jm.body.j_regressor[0] @ jm.body.v_template)
    jm = jm._replace(body=dataclasses.replace(
        jm.body, v_template=jm.body.v_template - j0))
    assert np.allclose(np.asarray(jm.body.v_template),
                       tm.body.v_template.numpy(), atol=1e-6)
    cfg_t = _prox_config(TO, TE)
    assert cfg_t == CS.prox_config(ITERS, frames=FRAMES)
    obs = CS.make_prox_observations(tm, seed=0, frames=FRAMES, points=POINTS)
    rt = TO.make_runner(cfg_t, tm, device="cpu")(obs)
    rj = JO.make_runner(_prox_config(JO, JE), jm)(
        {k: jnp.asarray(v.numpy()) for k, v in obs.items()})
    for st, rtol in (("stage1", 1e-4), ("stage2", 5e-3)):
        ht, hj = rt.losses[st].numpy(), np.asarray(rj.losses[st])
        np.testing.assert_allclose(ht, hj, rtol=rtol, err_msg=st)
    for h in (rt.losses["stage2"].numpy(), np.asarray(rj.losses["stage2"])):
        assert h[-1] <= 0.7 * h[0], h
    # stage 2's result: translation 7.0e-4, root orientation 1.2e-4, betas
    # 9.2e-6 apart (measured on the CPU); the body pose, which 192 noisy
    # points and 2D joints at weight 1e-3 hold loosely, parts with the
    # histories: its rotation matrices 0.19 apart (as axis-angle 5.3: an
    # angle near pi flips its axis), held at 0.5
    got, want = rt.per_stage["stage2"], rj.per_stage["stage2"]
    for k, atol in (("trans", 5e-3), ("root_orient", 1e-3), ("betas", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, err_msg=k)
    rot = lambda a: TT.aa_to_rotmat(torch.as_tensor(np.asarray(a)).reshape(
        -1, 3))
    gap = float((rot(got["pose_body"]) - rot(want["pose_body"])).abs().max())
    assert gap <= 0.5, gap
