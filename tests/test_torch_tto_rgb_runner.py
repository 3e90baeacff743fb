"""The whole RGB video fit of humor_torch against humor_tpu's runner on
the CPU: the observation, models and weights of test_torch_tto_rgb.py
(B=3 windows of T=8 cut from one 18-frame video, 2D keypoints, the floor
plane optimized, the overlap consistency at 200 in every stage, the depth
init from bone lengths), with the decoder head damped x0.1 as in
test_torch_tto_prox.py.
"""

import dataclasses

import numpy as np
import torch

from humor_tpu.fitting import optimizer as JO

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
