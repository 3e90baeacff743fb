"""humor_torch's training steps and optimizer against humor_tpu's on the
CPU, at full width (HuMoR 1024/48) with the SMPL losses on synthetic
gendered bodies.

Both packages get the same numpy-seeded batch, the same weights
(convert.params_tree) and the same random draws: the port is handed the
posterior noise and the curriculum's choices that JAX's keys give.
Tolerances, set from the spreads measured on the CPU (loss 2.0e-7
relative, grad_norm 8.6e-8, gradients 1.4e-6 max-scaled): loss 1e-5
relative, grad_norm 1e-5 relative, gradients 1e-5 max-scaled (largest
abs difference over the largest abs gradient, leaf by leaf), params after
the update 1e-6 abs where the gradient is over 1e-3 of its leaf's
largest (one Adamax step moves a weight by lr * g / (|g| + 1e-8), lr =
1e-4, so where g is within its error of 0 the two may step apart by up
to 2 lr).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.losses.elbo import LossConfig as JLossConfig
from humor_tpu.models import humor as JH
from humor_tpu.train import step as JTS
from humor_tpu.utils import checkpoint as jckpt

from humor_torch import convert
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as TH
from humor_torch.train import step as TS
from humor_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

B, T, L = 4, 5, 48
EPOCH = 10          # KL annealing at 0.2
USE_GT_P = 0.5
SMPL_J = {"male": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(10)),
          "female": jsmpl.synthetic_smpl_model(jax.random.PRNGKey(20))}
SMPL_T = {k: convert.smpl_model(v) for k, v in SMPL_J.items()}


def _batches(seed=0):
    world, meta = synthetic_world_batch(seed, B, T + 1,
                                        model=SMPL_J["male"])
    data_in, data_out, _ = window_to_pairs(world)
    bj = {"data_in": data_in, "data_out": data_out,
          "betas": meta["betas"], "gender_ids": meta["gender_ids"]}
    t = lambda x: torch.as_tensor(np.array(x))
    bt = {"data_in": {k: t(v) for k, v in data_in.items()},
          "data_out": {k: t(v) for k, v in data_out.items()},
          "betas": t(meta["betas"]),
          "gender_ids": t(meta["gender_ids"]).long()}
    return bj, bt


def _ss_draws(key, p):
    """JAX scheduled_sampling's draws for `key`: (use_gt (T,), eps (T, B,
    L)) (models/humor.py: choice_key, step_keys from one split)."""
    key, choice_key = jax.random.split(key)
    step_keys = jax.random.split(key, T)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, L), jnp.float32))
                    for k in step_keys])
    use_gt = np.array(jax.random.bernoulli(choice_key, p, (T,)))
    use_gt[0] = True
    return use_gt, torch.as_tensor(eps)


def _max_scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_side():
    """One compile each of JAX's train steps and loss gradients."""
    opt = JTS.make_optimizer(lr=1e-4, steps_per_epoch=10)
    sup, ss, _ = JTS.make_train_steps(JH.HumorConfig(), JLossConfig(), opt,
                                      SMPL_J)
    sup_grad = jax.jit(jax.value_and_grad(JTS.supervised_loss_fn(
        JH.HumorConfig(), JLossConfig(), SMPL_J), has_aux=True))
    ss_grad = jax.jit(jax.value_and_grad(JTS.sched_samp_loss_fn(
        JH.HumorConfig(), JLossConfig(), SMPL_J), has_aux=True))
    state = JTS.init_train_state(JH.HumorConfig(), opt,
                                 jax.random.PRNGKey(0))
    return opt, sup, ss, sup_grad, ss_grad, state


def _check_step(jout, jgrad, tout, tgrads, params_before):
    (jstate, jstats), ((jloss, jaux), jg) = jout, jgrad
    tstate, tstats = tout
    np.testing.assert_allclose(float(tstats["total_loss"]), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tstats["total_loss"]),
                               float(jstats["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(tstats[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(tgrads)
    worst = max(_max_scaled(g.numpy(), j) for g, j in zip(tgrads, jleaves))
    assert worst <= 1e-5, worst
    jp = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
    tp = [p.detach().numpy() for p in TS.tree_leaves(tstate.params)]
    moved = max(np.abs(a - b.numpy()).max()
                for a, b in zip(jp, params_before))
    assert moved > 1e-5     # the step was applied
    # Adamax's first step is lr * g / (|g| + 1e-8): lr * sign(g) where the
    # gradient is well above its 1e-4 max-scaled error, anything within
    # +-lr where it is not
    for a, b, g in zip(tp, jp, jleaves):
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        assert np.abs(a - b)[big].max(initial=0.0) <= 1e-6
        assert np.abs(a - b).max() <= 2.0001e-4


def test_supervised_step_matches_jax(jax_side):
    opt_j, sup, _, sup_grad, _, state_j = jax_side
    bj, bt = _batches(0)
    key = jax.random.PRNGKey(3)
    jout = sup(state_j, bj, key, EPOCH)
    jgrad = sup_grad(state_j.params, bj, key, EPOCH)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (B * T, L))))

    opt = TS.make_optimizer(lr=1e-4, steps_per_epoch=10)
    state = TS.make_train_state(convert.params_tree(state_j.params), opt)
    before = [p.detach().clone() for p in TS.tree_leaves(state.params)]
    sup_t, _, _ = TS.make_train_steps(TH.HumorConfig(), LossConfig(), opt,
                                      SMPL_T)
    loss_fn = TS.supervised_loss_fn(TH.HumorConfig(), LossConfig(), SMPL_T)
    loss, _ = loss_fn(state.params, bt, EPOCH, eps=eps)
    grads = torch.autograd.grad(loss, TS.tree_leaves(state.params))
    tout = sup_t(state, bt, EPOCH, eps=eps)
    _check_step(jout, jgrad, tout, grads, before)


@pytest.mark.parametrize("qual", [False, True], ids=["plain", "smpl_joints"])
def test_sched_samp_step_matches_jax(jax_side, qual):
    """Scheduled sampling with mixed GT and own inputs; with qual the loss
    gradient (not the step) also runs HuMoR-Qual's SMPL-joint feedback."""
    opt_j, _, ss, _, ss_grad, state_j = jax_side
    bj, bt = _batches(1)
    key = jax.random.PRNGKey(4)
    use_gt, eps = _ss_draws(key, USE_GT_P)
    # steps 1-3 take the model's own (detached) predictions
    assert use_gt.tolist() == [True, False, False, False, True]
    cfg_t = TH.HumorConfig()
    if qual:
        jfn = jax.jit(jax.value_and_grad(JTS.sched_samp_loss_fn(
            JH.HumorConfig(), JLossConfig(), SMPL_J,
            use_smpl_joint_inputs=True), has_aux=True))
        (jloss, jaux), jg = jfn(state_j.params, bj, key, EPOCH, USE_GT_P)
        loss_fn = TS.sched_samp_loss_fn(cfg_t, LossConfig(), SMPL_T,
                                        use_smpl_joint_inputs=True)
        params = TS.make_train_state(convert.params_tree(state_j.params),
                                     TS.make_optimizer()).params
        loss, stats = loss_fn(params, bt, EPOCH, USE_GT_P, use_gt=use_gt,
                              eps=eps)
        grads = torch.autograd.grad(loss, TS.tree_leaves(params))
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
        worst = max(_max_scaled(g.numpy(), j)
                    for g, j in zip(grads, jleaves))
        assert worst <= 1e-5, worst
        return
    jout = ss(state_j, bj, key, EPOCH, USE_GT_P)
    jgrad = ss_grad(state_j.params, bj, key, EPOCH, USE_GT_P)
    opt = TS.make_optimizer(lr=1e-4, steps_per_epoch=10)
    state = TS.make_train_state(convert.params_tree(state_j.params), opt)
    before = [p.detach().clone() for p in TS.tree_leaves(state.params)]
    _, ss_t, _ = TS.make_train_steps(cfg_t, LossConfig(), opt, SMPL_T)
    loss_fn = TS.sched_samp_loss_fn(cfg_t, LossConfig(), SMPL_T)
    loss, _ = loss_fn(state.params, bt, EPOCH, USE_GT_P, use_gt=use_gt,
                      eps=eps)
    grads = torch.autograd.grad(loss, TS.tree_leaves(state.params))
    tout = ss_t(state, bt, EPOCH, USE_GT_P, use_gt=use_gt, eps=eps)
    _check_step(jout, jgrad, tout, grads, before)


def _adam_state(tree):
    """optax's ScaleByAdamState inside the chain's nested state tuples."""
    if hasattr(tree, "mu"):
        return tree
    for sub in tree:
        if isinstance(sub, tuple):
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def test_adamax_matches_optax_with_skip_and_milestone():
    """4 steps: a NaN gradient at step 2 is skipped (params, moments and
    the schedule's count unchanged); the milestone at 2 applied steps
    falls inside the run, so step 4 runs at the decayed rate. 1e-5
    relative on params and moments (float32 rounding of the same
    expressions: 2.8e-6 measured)."""
    rng = np.random.RandomState(0)
    params = {"a": [{"w": rng.randn(5, 3).astype(np.float32)}],
              "b": rng.randn(7).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32) * 10 ** i, params)
        for i in range(4)]
    grads[1]["b"][3] = np.nan
    opt_j = JTS.make_optimizer(lr=0.1, milestones=(1, 3), decays=(0.5, 0.2),
                               steps_per_epoch=2, grad_clip=5.0)
    opt_t = TS.make_optimizer(lr=0.1, milestones=(1, 3), decays=(0.5, 0.2),
                              steps_per_epoch=2, grad_clip=5.0)
    pj, sj = params, opt_j.init(params)
    state = TS.make_train_state(convert.params_tree(params), opt_t)
    st = state.opt_state
    for i, g in enumerate(grads):
        upd, sj = opt_j.update(g, sj, pj)
        pj = optax.apply_updates(pj, upd)
        gt = [torch.as_tensor(np.array(x))
              for x in jax.tree_util.tree_leaves(g)]
        st = opt_t.update(gt, st, state.params)
        for a, b in zip(jax.tree_util.tree_leaves(pj),
                        TS.tree_leaves(state.params)):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}")
        adam = _adam_state(sj.inner_state)
        assert int(st["count"]) == int(adam.count), i
        assert bool(st["last_finite"]) == bool(sj.last_finite)
        assert int(st["total_notfinite"]) == int(sj.total_notfinite)
    assert int(st["count"]) == 3 and int(st["total_notfinite"]) == 1
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(adam, name)),
                        TS.tree_leaves(st[name])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-12)


def test_checkpoint_read_by_jax_and_resumed(tmp_path):
    """A port checkpoint loads in humor_tpu.utils.checkpoint.load_state
    with params equal, and a resumed optimizer continues with the same
    state: the next step from the reloaded state equals the next step of
    the original, bit for bit."""
    cfg = TH.HumorConfig()
    opt = TS.make_optimizer(lr=1e-3)
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    _, bt = _batches(2)
    sup, _, _ = TS.make_train_steps(cfg, LossConfig(), opt, SMPL_T)
    eps = torch.as_tensor(np.random.RandomState(1).randn(B * T, L)
                          .astype(np.float32))
    state, _ = sup(state, bt, 0, eps=eps)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, state.params, state.opt_state, epoch=4,
                     min_train_loss=1.5, min_val_loss=2.5)

    tmpl = JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(1))
    restored = jckpt.load_state(path, tmpl)
    assert (restored["epoch"], restored["min_train_loss"],
            restored["min_val_loss"]) == (4, 1.5, 2.5)
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    TS.tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())

    back = tckpt.load_state(path)
    resumed = TS.make_train_state(back["params"], opt)._replace(
        opt_state=back["opt_state"])
    a, _ = sup(state, bt, 0, eps=eps)
    b, _ = sup(resumed, bt, 0, eps=eps)
    assert int(a.opt_state["count"]) == int(b.opt_state["count"]) == 2
    for x, y in zip(TS.tree_leaves(a.params), TS.tree_leaves(b.params)):
        assert torch.equal(x, y)
