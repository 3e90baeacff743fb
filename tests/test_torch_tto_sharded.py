"""humor_torch's windows-sharded test-time fit on the CPU (mirroring
tests/test_tto_sharded.py): make_runner(..., mesh=) with the 8 windows
split over 4 gloo ranks in 4 processes (2 windows a rank, so the overlap
terms pair windows within a rank and across ranks, and the middle ranks
exchange with both neighbours), against the port's plain runner and
against the JAX package's sharded runner on its 8-device CPU mesh; the
early exit under sharding at 2 ranks (both early-exit configurations in
one launch: stopping together needs only two ranks); a batch the ranks
do not divide. The plain fit is run once for the module. The
configuration is the JAX test's: joints3d with the overlap consistency
in stages 1-2, the zoom search, no stage-3 init tuning, 2/2/2
iterations, at B = 8 windows of T = 4 frames sharing 2.

Limits, each beside the gap measured on the CPU:
  * sharded against plain, in the port: loss histories within 5e-6
    relative (measured 9.4e-7; a sharded dot product sums in another
    order), finals within the JAX test's atol 2e-3, rtol 1e-2 (measured
    4.0e-4 abs, on pose_body);
  * the port's sharded against JAX's sharded: the JAX test's own limits
    (finals atol 2e-3, rtol 1e-2, measured 1.9e-3 abs on pose_body: the
    random-weight fit amplifies float32 differences, as between JAX's
    own plain and sharded runs; losses rtol 2e-2, atol 1e-3, measured
    5.8e-7 relative);
  * every rank returns the same result, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import constants as JC
from humor_tpu.body_model.smpl import synthetic_smpl_model
from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import optimizer as JO
from humor_tpu.models import humor as JH
from humor_tpu.models import vposer as jvp
from humor_tpu.parallel.mesh import make_mesh as jax_mesh

from humor_torch import convert
from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO
from humor_torch.models import humor as TH
from humor_torch.models import vposer as tvp
from humor_torch.parallel import launch
from humor_torch.parallel import mesh as P

import torch_parallel_workers as W

torch.set_num_threads(2)

B, T, WORLD = 8, 4, 4
TIMEOUT = 240.0
KEYS = ("trans", "root_orient", "pose_body")


@pytest.fixture(scope="module")
def models():
    vcfg = jvp.VPoserConfig(hidden=32)
    jm = JO.TTOModels(
        body=synthetic_smpl_model(), vposer_cfg=vcfg,
        vposer=jvp.init_params(vcfg, jax.random.PRNGKey(1)),
        humor_cfg=JH.HumorConfig(),
        humor=JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(2)))
    tree = lambda t: convert.params_tree(jax.tree_util.tree_map(np.asarray,
                                                                t))
    tm = TO.TTOModels(
        body=convert.smpl_model(jm.body),
        vposer_cfg=tvp.VPoserConfig(hidden=32), vposer=tree(jm.vposer),
        humor_cfg=TH.HumorConfig(), humor=tree(jm.humor))
    return jm, tm


@pytest.fixture(scope="module")
def observed(models):
    """The JAX test's observation: 8 windows of 4 frames, consecutive
    ones sharing 2."""
    jm, _ = models
    rng = np.random.RandomState(0)
    z = jnp.asarray(rng.randn(B, T, jm.vposer_cfg.latent_dim) * 0.3,
                    jnp.float32)
    pose = jvp.latent2pose(jm.vposer_cfg, jm.vposer, z)
    trans = jnp.asarray(rng.randn(B, T, 3) * 0.1, jnp.float32)
    ro = jnp.asarray(rng.randn(B, T, 3) * 0.2, jnp.float32)
    pred = JO.smpl_results(jm.body, trans, ro, pose,
                           jnp.zeros((B, JC.BETA_SIZE)))
    iv = np.stack([np.arange(B) * (T - 2), np.arange(B) * (T - 2) + T],
                  axis=1)
    obs = {"joints3d": np.array(pred["joints3d"]),
           "verts3d": np.array(pred["verts3d"]),
           "seq_interval": iv.astype(np.int32)}
    return obs, {k: torch.as_tensor(v) for k, v in obs.items()}


def _cfg(opt, energies, **kw):
    w1 = energies.StageWeights(joints3d=1.0, rgb_overlap_consist=1.0)
    w2 = energies.StageWeights(joints3d=1.0, pose_prior=4e-4,
                               rgb_overlap_consist=1.0)
    w3 = energies.StageWeights(joints3d=1.0, motion_prior=1e-4,
                               joint_consistency=1.0)
    # zoom, as the JAX test: its step moves continuously under the
    # reordered sums of a sharded fit; the parallel search's discrete
    # grid can flip a candidate at a Wolfe edge
    return opt.TTOConfig(seq_len=T, stage_weights=(w1, w2, w3),
                         num_iters=(2, 2, 2), stage3_tune_init_state=False,
                         lbfgs_linesearch="zoom", **kw)


def _same_on_every_rank(res):
    for r in res[1:]:           # every rank holds the whole result
        for part in ("final", "losses"):
            for k, v in res[0][part].items():
                assert torch.equal(r[part][k], v), (part, k)
    return res[0]


EXIT_TOLS = {"jax_test_tols": dict(lbfgs_tol_grad=1e-7, lbfgs_tol_change=1e-9),
             "stops_at_once": dict(lbfgs_tol_grad=1e9)}


@pytest.fixture(scope="module")
def plain(models, observed):
    """The port's plain fit under the JAX test's configuration."""
    return TO.make_runner(_cfg(TO, TE), models[1], device="cpu")(observed[1])


@pytest.fixture(scope="module")
def early_exit(models, observed):
    """Each early-exit configuration: (its sharded fit at 2 ranks, both
    fitted in one launch; its plain fit)."""
    _, tm = models
    _, obs_t = observed
    cfgs = [dataclasses.replace(_cfg(TO, TE), **t) for t in EXIT_TOLS.values()]
    ranks = launch.spawn(W.fits, 2, args=(cfgs, tm, obs_t), timeout=TIMEOUT)
    shard = [_same_on_every_rank([r[i] for r in ranks])
             for i in range(len(cfgs))]
    plains = [TO.make_runner(c, tm, device="cpu")(obs_t) for c in cfgs]
    return dict(zip(EXIT_TOLS, zip(shard, plains)))


def _close(a, b, atol, rtol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


def test_sharded_matches_unsharded_and_jax(models, observed, plain):
    jm, tm = models
    obs_j, obs_t = observed
    shard = _same_on_every_rank(launch.spawn(
        W.fit, WORLD, args=(_cfg(TO, TE), tm, obs_t), timeout=TIMEOUT))
    for st in ("stage1", "stage2", "stage3"):
        assert shard["losses"][st].shape == (2,)
        _close(shard["losses"][st], plain.losses[st], 0.0, 5e-6, st)
    for k in KEYS:
        assert shard["final"][k].shape == plain.final[k].shape
        _close(shard["final"][k], plain.final[k], 2e-3, 1e-2, k)
    for k, v in plain.per_stage["stage2"].items():
        assert shard["per_stage"]["stage2"][k].shape == v.shape, k

    assert jax.device_count() >= 8, "conftest gives 8 CPU devices"
    jres = JO.make_runner(_cfg(JO, JE), jm, mesh=jax_mesh(jax.devices()[:8]))(
        {k: jnp.asarray(v) for k, v in obs_j.items()})
    for k in KEYS:
        _close(shard["final"][k], jres.final[k], 2e-3, 1e-2, k)
    for st in ("stage1", "stage2", "stage3"):
        _close(shard["losses"][st], jres.losses[st], 1e-3, 2e-2, st)


@pytest.mark.parametrize("tols", list(EXIT_TOLS))
def test_sharded_early_exit(early_exit, plain, tols):
    """The convergence early exit decides on norms reduced over ranks, so
    every rank stops together: at the JAX test's tolerances (the exit
    armed, not reached in 2 iterations) and at a gradient tolerance that
    stops every stage after its first iteration (the history's tail is
    the final value). Finite, and within the JAX test's limits of the
    plain runner's result."""
    shard, ref = early_exit[tols]
    for k in KEYS:
        assert torch.isfinite(shard["final"][k]).all()
        _close(shard["final"][k], ref.final[k], 2e-3, 1e-2, k)
    for st in ("stage1", "stage2", "stage3"):
        _close(shard["losses"][st], ref.losses[st], 0.0, 5e-6, st)
    if tols == "stops_at_once":
        # each stage stopped after 1 of its 2 iterations
        assert (plain.final["trans"] - shard["final"]["trans"]).abs().max() \
            > 1e-4


def test_sharded_batch_must_divide(models, observed):
    """8 windows over 3 ranks: every rank raises (no rank waits)."""
    _, tm = models
    _, obs_t = observed
    errs = launch.spawn(W.fit_odd_batch, 3, args=(_cfg(TO, TE), tm, obs_t),
                        timeout=TIMEOUT)
    assert all(e is not None and "does not split over 3" in e
               for e in errs), errs


def test_sharded_runner_needs_a_process_group():
    """No process group, no mesh: make_mesh raises instead of running on
    one rank."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        P.make_mesh()
