"""The whole joints3d and keypoint-vertex 3-stage fits of humor_torch
against humor_tpu's runner on the CPU: T=8, B=2, L-BFGS iterations
(3, 3, 3), the bench_tto weights of each, the models of test_torch_tto.py
(the keypts fit with the decoder head damped x0.1).
"""

import jax.numpy as jnp
import numpy as np
import torch

from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import optimizer as JO
from humor_tpu.models import vposer as jvp

from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO

from test_torch_tto import B, CFG_J, CFG_T, ITERS, T, models, observed  # noqa: F401
from test_torch_tto_prox import damped_models  # noqa: F401

torch.set_num_threads(2)


def test_runner_matches_jax(models, observed):
    """Both runners end to end, on their per-iteration loss histories
    (rtol 1e-4) and final outputs (1e-3). The line searches pick from a
    discrete candidate grid, so float drift could flip a candidate; at
    this size and seed none flips, and the histories agree to ~1e-5
    (measured)."""
    jm, tm = models
    rj = JO.make_runner(CFG_J, jm)({"joints3d": jnp.asarray(observed)})
    rt = TO.make_runner(CFG_T, tm, device="cpu")(
        {"joints3d": torch.tensor(observed)})
    for st, n in zip(("stage1", "stage2", "stage3"), ITERS):
        assert rt.losses[st].shape == (n,), st
        np.testing.assert_allclose(rt.losses[st].numpy(),
                                   np.asarray(rj.losses[st]), rtol=1e-4,
                                   err_msg=st)
    for k in ("trans", "root_orient", "pose_body", "betas", "latent_motion",
              "joints3d_rollout", "contacts"):
        np.testing.assert_allclose(rt.final[k].numpy(),
                                   np.asarray(rj.final[k]), atol=1e-3,
                                   err_msg=k)
    assert tuple(rt.final["contacts"].shape) == (B, T, 22)


def _keypts_weights(mod):
    """benchmarks/bench_tto.py's keypts stage weights."""
    return (
        mod.StageWeights(verts3d=1.0, joints3d_smooth=0.1),
        mod.StageWeights(verts3d=1.0, pose_prior=2e-4, shape_prior=1.67e-4,
                         joints3d_smooth=0.1),
        mod.StageWeights(verts3d=1.0, shape_prior=1.67e-4, motion_prior=5e-4,
                         init_motion_prior=5e-4, joint_consistency=1.0,
                         bone_length=10.0, contact_vel=1.0,
                         contact_height=1.0))


def test_keypts_runner_matches_jax(damped_models):
    """The keypoint-vertex ("verts3d") fit end to end, with the decoder
    head damped x0.1: noisy keypoint vertices (2 cm), the highest 40%
    occluded (inf), as bench_tto.py's make_obs_keypts makes them.
    Measured on the CPU: histories within 8.1e-7 (rtol 3e-6 here),
    finals within 1.3e-5 (latent_pose; atol 4e-5 here)."""
    jm, tm = damped_models
    rng = np.random.RandomState(3)
    z = jnp.asarray(rng.randn(B, T, 32) * 0.3, jnp.float32)
    pose = jvp.latent2pose(jm.vposer_cfg, jm.vposer, z)
    trans = jnp.asarray(rng.randn(B, T, 3) * 0.1, jnp.float32)
    ro = jnp.asarray(np.tile(rng.randn(B, 1, 3) * 0.2, (1, T, 1)),
                     jnp.float32)
    gt = JO.smpl_results(jm.body, trans, ro, pose, jnp.zeros((B, 16)),
                         verts="keypt")
    v = np.asarray(gt["verts3d"]) + rng.randn(
        *gt["verts3d"].shape).astype(np.float32) * 0.02
    v = np.where(v[..., 2:3] > np.quantile(v[..., 2], 0.6), np.inf,
                 v).astype(np.float32)
    kw = dict(seq_len=T, num_iters=ITERS, stage3_tune_init_num_frames=5,
              stage3_freeze_start=1, stage3_freeze_end=2)
    rj = JO.make_runner(JO.TTOConfig(stage_weights=_keypts_weights(JE),
                                     **kw), jm)({"verts3d": jnp.asarray(v)})
    rt = TO.make_runner(TO.TTOConfig(stage_weights=_keypts_weights(TE),
                                     **kw), tm, device="cpu")(
        {"verts3d": torch.tensor(v)})
    for st, n in zip(("stage1", "stage2", "stage3"), ITERS):
        assert rt.losses[st].shape == (n,), st
        np.testing.assert_allclose(rt.losses[st].numpy(),
                                   np.asarray(rj.losses[st]), rtol=3e-6,
                                   err_msg=st)
    for k in ("trans", "root_orient", "pose_body", "betas", "latent_motion",
              "latent_pose", "prior_trans", "prior_root_orient",
              "joints3d_rollout", "contacts"):
        np.testing.assert_allclose(rt.final[k].numpy(),
                                   np.asarray(rj.final[k]), atol=4e-5,
                                   err_msg=k)
