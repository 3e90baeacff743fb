"""humor_torch's training forwards against humor_tpu's on the CPU:
rotmat_to_aa's gradient near the identity and near pi (the SMPL losses
differentiate through it), the gendered SMPL forward and its gradient,
and single_step / scheduled_sampling (plain and with HuMoR-Qual's SMPL
joint feedback) at full width, B=4, T=5, given JAX's random draws.

Tolerances: rotations' gradients 1e-5 max-scaled; the gendered forward
1e-5 m, its gradient 1e-5 max-scaled; model outputs 3e-4 abs (the
RESULTS.md precedent per model head) over the T-step chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import gendered as jgend
from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.models import humor as JH
from humor_tpu.ops import transforms as JT

from humor_torch import convert
from humor_torch.body_model import gendered as tgend
from humor_torch.models import humor as TH
from humor_torch.ops import transforms as TT

torch.set_num_threads(2)

B, T, L = 4, 5, 48
SMPL_J = {"male": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(10)),
          "female": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(20))}
SMPL_T = {k: convert.smpl_model(v) for k, v in SMPL_J.items()}
PARAMS_J = JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0))
PARAMS_T = convert.params_tree(PARAMS_J)


def _t(x):
    return torch.as_tensor(np.array(x))


def _max_scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("angle", [1e-2, 1e-4, 0.0, np.pi - 1e-2,
                                   np.pi - 1e-4, np.pi],
                         ids=["id-1e-2", "id-1e-4", "id", "pi-1e-2",
                              "pi-1e-4", "pi"])
def test_rotmat_to_aa_gradient(angle):
    """d(w . rotmat_to_aa(R)) / dR at rotations of `angle` about random
    axes: no NaN where JAX has none, 1e-5 max-scaled."""
    rng = np.random.RandomState(0)
    axis = rng.randn(16, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    R = np.asarray(JT.aa_to_rotmat(jnp.asarray(
        (axis * angle).astype(np.float32))))
    w = rng.randn(16, 3).astype(np.float32)
    gj = np.asarray(jax.grad(lambda r: jnp.sum(JT.rotmat_to_aa(r) * w))(
        jnp.asarray(R)))
    Rt = _t(R).requires_grad_(True)
    (gt,) = torch.autograd.grad(torch.sum(TT.rotmat_to_aa(Rt) * _t(w)), Rt)
    assert np.isfinite(gj).all() and torch.isfinite(gt).all()
    assert _max_scaled(gt.numpy(), gj) <= 1e-5


def test_gendered_forward_and_gradient():
    rng = np.random.RandomState(1)
    n = 6
    gid = np.array([0, 1, 1, 0, 1, 0], np.int32)
    inp = [rng.randn(n, 3).astype(np.float32) * 0.3,
           rng.randn(n, 63).astype(np.float32) * 0.2,
           rng.randn(n, 16).astype(np.float32) * 0.5,
           rng.randn(n, 3).astype(np.float32)]
    w = rng.randn(n, 256, 3).astype(np.float32)

    def jloss(ro, pb):
        out = jgend.gendered_forward(SMPL_J, jnp.asarray(gid), ro, pb,
                                     jnp.asarray(inp[2]), jnp.asarray(inp[3]))
        return jnp.sum(out.v * w) + jnp.sum(out.Jtr ** 2), out

    (lj, outj), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp[0]), jnp.asarray(inp[1]))
    ro, pb = _t(inp[0]).requires_grad_(True), _t(inp[1]).requires_grad_(True)
    out = tgend.gendered_forward(SMPL_T, _t(gid).long(), ro, pb, _t(inp[2]),
                                 _t(inp[3]))
    lt = torch.sum(out.v * _t(w)) + torch.sum(out.Jtr ** 2)
    gt = torch.autograd.grad(lt, (ro, pb))
    np.testing.assert_allclose(out.v.detach().numpy(), np.asarray(outj.v),
                               atol=1e-5)
    np.testing.assert_allclose(out.Jtr.detach().numpy(),
                               np.asarray(outj.Jtr), atol=1e-5)
    for a, b in zip(gt, gj):
        assert _max_scaled(a.numpy(), b) <= 1e-5


def _pairs(seed):
    world, meta = synthetic_world_batch(seed, B, T + 1,
                                        model=SMPL_J["male"])
    din, dout, _ = window_to_pairs(world)
    return din, dout, meta


def test_single_step_matches_jax():
    din, dout, _ = _pairs(0)
    cfg_j, cfg_t = JH.HumorConfig(), TH.HumorConfig()
    flat = lambda d: {k: v.reshape(B * T, -1) for k, v in d.items()}
    past_j = JH.state_to_input(cfg_j, flat(din))
    tin_j = JH.state_to_input(cfg_j, flat(dout))
    key = jax.random.PRNGKey(7)
    ref = JH.single_step(cfg_j, PARAMS_J, key, past_j, tin_j)
    eps = _t(jax.random.normal(key, (B * T, L)))
    out = TH.single_step(cfg_t, PARAMS_T, _t(past_j), _t(tin_j), eps=eps)
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.z), atol=3e-4)
    for a, b in zip(out.posterior + out.prior, ref.posterior + ref.prior):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)
    for k, v in ref.pred.items():
        np.testing.assert_allclose(out.pred[k].numpy(), np.asarray(v),
                                   atol=3e-4, err_msg=k)


@pytest.mark.parametrize("qual", [False, True], ids=["plain", "smpl_joints"])
def test_scheduled_sampling_matches_jax(qual):
    """JAX's draws for key 4 take GT at steps 0 and 4 and the model's own
    re-canonicalized prediction at steps 1-3."""
    din, dout, meta = _pairs(1)
    cfg_j, cfg_t = JH.HumorConfig(), TH.HumorConfig()
    key = jax.random.PRNGKey(4)
    k2, choice_key = jax.random.split(key)
    eps = torch.stack([_t(jax.random.normal(k, (B, L)))
                       for k in jax.random.split(k2, T)])
    use_gt = np.array(jax.random.bernoulli(choice_key, 0.5, (T,)))
    use_gt[0] = True
    assert use_gt.tolist() == [True, False, False, False, True]
    fn_j = fn_t = None
    if qual:
        fn_j = jgend.make_rollout_joint_fn(SMPL_J, meta["gender_ids"],
                                           meta["betas"])
        fn_t = tgend.make_rollout_joint_fn(SMPL_T, _t(meta["gender_ids"])
                                           .long(), _t(meta["betas"]))
    ref = JH.scheduled_sampling(
        cfg_j, PARAMS_J, key, JH.state_to_input(cfg_j, din),
        JH.state_to_input(cfg_j, dout), {k: v[:, 0] for k, v in din.items()},
        0.5, smpl_joint_fn=fn_j)
    out = TH.scheduled_sampling(
        cfg_t, PARAMS_T, _t(JH.state_to_input(cfg_j, din)),
        _t(JH.state_to_input(cfg_j, dout)),
        {k: _t(v[:, 0]) for k, v in din.items()}, 0.5, smpl_joint_fn=fn_t,
        use_gt=use_gt, eps=eps)
    for a, b in zip(out.posterior + out.prior, ref.posterior + ref.prior):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)
    for k, v in ref.pred.items():
        np.testing.assert_allclose(out.pred[k].numpy(), np.asarray(v),
                                   atol=3e-4, err_msg=k)
