"""humor_torch's ELBO loss against humor_tpu's on the CPU: the value,
every stat and the gradient with respect to the prediction and the
latent distributions, with the SMPL joint, mesh and consistency losses on
through synthetic male and female bodies carried over with
convert.smpl_model; plus the KL annealing schedules.

Tolerances: loss and stats 1e-5 relative (1e-7 abs), gradients 1e-5
max-scaled (float32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.losses import elbo as JE
from humor_tpu.ops import transforms as JT

from humor_torch import convert
from humor_torch.losses import elbo as TE

torch.set_num_threads(2)

N, L = 24, 48
SMPL_J = {"male": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(10)),
          "female": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(20))}
SMPL_T = {k: convert.smpl_model(v) for k, v in SMPL_J.items()}


def _inputs(seed=0):
    """gt: 24 canonical transitions; pred: gt with noise, rotations
    composed with small random rotations; latents random."""
    rng = np.random.RandomState(seed)
    world, meta = synthetic_world_batch(seed, 4, 7, model=SMPL_J["male"])
    _, dout, _ = window_to_pairs(world)
    gt = {k: np.array(v).reshape(N, -1) for k, v in dout.items()}
    pred = {}
    for k, v in gt.items():
        if k in ("root_orient", "pose_body"):
            R = v.reshape(N, -1, 3, 3)
            d = np.asarray(JT.aa_to_rotmat(jnp.asarray(
                rng.randn(*R.shape[:2], 3).astype(np.float32) * 0.2)))
            pred[k] = np.matmul(d, R).reshape(N, -1).astype(np.float32)
        elif k == "contacts":
            pred[k] = (rng.randn(*v.shape) * 2).astype(np.float32)
        else:
            pred[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
    lat = [rng.randn(N, L).astype(np.float32) * s for s in (1, 0.3, 1, 0.3)]
    post = (lat[0], np.exp(lat[1]))
    prior = (lat[2], np.exp(lat[3]))
    gid = np.repeat(np.array(meta["gender_ids"]), 6)
    betas = np.repeat(np.array(meta["betas"]), 6, axis=0)
    return pred, gt, post, prior, gid, betas


@pytest.mark.parametrize("smpl", [True, False], ids=["smpl", "no_smpl"])
def test_elbo_matches_jax(smpl):
    pred, gt, post, prior, gid, betas = _inputs()
    cfg_j, cfg_t = JE.LossConfig(), TE.LossConfig()
    epoch = 10

    def jfn(p, q, pr):
        return JE.elbo_loss(cfg_j, p, q, pr, gt, epoch,
                            gender_ids=jnp.asarray(gid),
                            betas=jnp.asarray(betas),
                            smpl_models=SMPL_J if smpl else None)

    (lj, sj), gj = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                      has_aux=True)(pred, post, prior)
    t = lambda x: torch.as_tensor(x).requires_grad_(True)
    p_t = {k: t(v) for k, v in pred.items()}
    q_t, pr_t = tuple(t(x) for x in post), tuple(t(x) for x in prior)
    lt, st = TE.elbo_loss(cfg_t, p_t, q_t, pr_t,
                          {k: torch.as_tensor(v) for k, v in gt.items()},
                          epoch, gender_ids=torch.as_tensor(gid).long(),
                          betas=torch.as_tensor(betas),
                          smpl_models=SMPL_T if smpl else None)
    assert set(st) == set(sj)
    assert ("smpl_mesh_loss" in st) == smpl
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for k, v in sj.items():
        np.testing.assert_allclose(float(st[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    leaves = list(p_t.values()) + list(q_t) + list(pr_t)
    grads = torch.autograd.grad(lt, leaves)
    ref = [gj[0][k] for k in p_t] + list(gj[1]) + list(gj[2])
    for name, a, b in zip(list(p_t) + ["qm", "qv", "pm", "pv"], grads, ref):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("kw", [
    {}, {"kl_loss_cycle_len": 8}, {"kl_loss_anneal_start": 3,
                                   "kl_loss_anneal_end": 3}])
def test_kl_anneal_weight_matches_jax(kw):
    for epoch in (0, 1, 2, 5, 7, 25, 49, 50, 80):
        np.testing.assert_allclose(
            float(TE.kl_anneal_weight(TE.LossConfig(**kw), epoch)),
            float(JE.kl_anneal_weight(JE.LossConfig(**kw), epoch)),
            rtol=1e-7, err_msg=str(epoch))
