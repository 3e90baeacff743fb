"""humor_torch's bf16 precision policy against the JAX package's in bf16,
on the CPU: `compute_dtype="bfloat16"` for the HuMoR MLPs
(humor_tpu/ops/mlp.py, models/humor.py) and the loss bodies' bf16
skinning (`smpl_loss_dtype`, humor_tpu/body_model/smpl.py lbs), through
the model heads, SMPL, the ELBO, the train steps, the runner and both
CLIs.

A bf16 product rounds its inputs to 8 significant bits, so two f32
computations that differ by a summation order (the port's GroupNorm
reduces in another order than JAX's one-hot product) can round an
activation to neighbouring bf16 values: one rounding step is 2^-8 to
2^-7 (3.9e-3 to 7.8e-3) of the value. A single product therefore agrees
with JAX to f32 rounding, and anything downstream of a rounded
activation to a few rounding steps. Limits, each beside the gap measured
on the CPU and the f32-vs-bf16 gap that shows the check has teeth:
  * one product (1024 wide): 1e-5 abs (measured 6.0e-7; f32 4.9e-3);
    its gradients: each element within one bf16 rounding step of JAX's
    (or 1e-6 of the leaf's largest, where a sum cancels to near 0);
  * the 3-layer stack with the skip, the heads and their gradients:
    1.5e-3 abs on the outputs (measured up to 8.1e-4; f32 5.7e-3), 1e-2
    max-scaled on the gradients (measured up to 3.4e-3);
  * SMPL in bf16: the vertices within 1e-6 of JAX's (measured 0.0; the
    bf16 vertices are 1.4e-2 from f32, within JAX's own 2e-2 bound), the
    joints bit-equal to the port's f32 call, the mesh loss's gradient
    1e-5 max-scaled against JAX's op-by-op gradient (measured 7.4e-7; f32
    1.1e-2);
  * the ELBO, the train steps and the fit with the knobs: see each
    test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as JS
from humor_tpu.body_model.gendered import gendered_forward as j_gendered
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.fitting import optimizer as JO
from humor_tpu.losses import elbo as JL
from humor_tpu.models import humor as JH
from humor_tpu.ops import mlp as JM
from humor_tpu.train import step as JTS

from humor_torch import convert
from humor_torch.body_model import smpl as TS
from humor_torch.body_model.gendered import gendered_forward as t_gendered
from humor_torch.fitting import optimizer as TO
from humor_torch.losses import elbo as TL
from humor_torch.models import humor as TH
from humor_torch.ops import mlp as TM
from humor_torch.train import step as TTS

from test_torch_tto import CFG_J, CFG_T, ITERS, models, observed  # noqa: F401
from test_torch_tto_prox import damped_models  # noqa: F401

torch.set_num_threads(2)

BF = "bfloat16"
STEP = 2.0 ** -7            # one bf16 rounding step, relative, at most


def _tree(t):
    return convert.params_tree(jax.tree_util.tree_map(np.asarray, t))


def _max_scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves_by_name(jtree, ttree):
    """JAX's gradient leaves in the order of the port's param leaves."""
    if isinstance(ttree, dict):
        return [x for k in ttree for x in _leaves_by_name(jtree[k], ttree[k])]
    if isinstance(ttree, (list, tuple)):
        return [x for j, t in zip(jtree, ttree)
                for x in _leaves_by_name(j, t)]
    return [np.asarray(jtree)]


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


# --------------------------------------------------------------------------
# ops.mlp


def test_one_product_matches_jax():
    """One layer, 16 x 1024 @ 1024 x 1024: the product of bf16-rounded
    inputs, accumulated and returned in f32, as JAX's
    preferred_element_type=f32; its gradients are JAX's VJP (each
    cotangent rounded to bf16, then cast back to f32)."""
    rng = np.random.RandomState(0)
    jp = JM.init_mlp(jax.random.PRNGKey(1), [1024, 1024])
    tp = _tree(jp)
    x = rng.randn(16, 1024).astype(np.float32)
    c = rng.randn(16, 1024).astype(np.float32)
    jy = np.asarray(JM.mlp_apply(jp, jnp.asarray(x), compute_dtype=BF))
    ty = TM.mlp_apply(tp, torch.as_tensor(x), compute_dtype=BF)
    assert ty.dtype == torch.float32
    assert np.abs(ty.numpy() - jy).max() <= 1e-5
    f32 = TM.mlp_apply(tp, torch.as_tensor(x)).numpy()
    assert np.abs(f32 - jy).max() > 1e-3           # the policy is not f32

    def jloss(p, x):
        return jnp.sum(jnp.asarray(c) * JM.mlp_apply(p, x, compute_dtype=BF))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    leaves = [v.requires_grad_(True) for v in _flat(tp)]
    loss = (torch.as_tensor(c) * TM.mlp_apply(tp, xt, compute_dtype=BF)).sum()
    grads = torch.autograd.grad(loss, [xt] + leaves)
    for g, j in zip(grads, [np.asarray(jgx)] + _leaves_by_name(jg, tp)):
        g = g.numpy()
        assert g.dtype == np.float32
        # one rounding step, or f32 summation order where the sum cancels
        # to near 0 (measured: 1 element of 16,384 in dx, 1.5e-7 apart)
        assert (np.abs(g - j) <= STEP * np.abs(j)
                + 1e-6 * np.abs(j).max()).all()


def test_mlp_stack_matches_jax():
    """A 4-layer stack with GroupNorm, ReLU and the skip concat: the
    outputs and gradients within a few bf16 rounding steps of JAX's."""
    rng = np.random.RandomState(1)
    jp = JM.init_mlp(jax.random.PRNGKey(0), [1024 + 48, 1024, 1024, 256],
                     skip_dim=48)
    tp = _tree(jp)
    x = rng.randn(16, 1024 + 48).astype(np.float32)
    c = rng.randn(16, 256).astype(np.float32)
    run_j = lambda p, x, cd: JM.mlp_apply(p, x, skip_dim=48, compute_dtype=cd)
    jy = np.asarray(run_j(jp, jnp.asarray(x), BF))
    ty = TM.mlp_apply(tp, torch.as_tensor(x), skip_dim=48, compute_dtype=BF)
    assert np.abs(ty.numpy() - jy).max() <= 1.5e-3
    assert np.abs(np.asarray(run_j(jp, jnp.asarray(x), None)) - jy).max() \
        > 3e-3

    jg = jax.grad(lambda p: jnp.sum(jnp.asarray(c) * run_j(
        p, jnp.asarray(x), BF)))(jp)
    leaves = [v.requires_grad_(True) for v in _flat(tp)]
    loss = (torch.as_tensor(c) * TM.mlp_apply(
        tp, torch.as_tensor(x), skip_dim=48, compute_dtype=BF)).sum()
    grads = torch.autograd.grad(loss, leaves)
    worst = max(_max_scaled(g.numpy(), j)
                for g, j in zip(grads, _leaves_by_name(jg, tp)))
    assert worst <= 1e-2, worst


def test_compute_dtype_names():
    assert TM.resolve_compute_dtype(None) is None
    assert TM.resolve_compute_dtype("") is None
    assert TM.resolve_compute_dtype(BF) is torch.bfloat16
    assert TH.HumorConfig(compute_dtype=BF).compute_dtype == BF


@pytest.mark.parametrize("name", ["float32", "float16", "bf16"])
def test_unknown_compute_dtype_raises(name):
    """Only bfloat16 is a policy of the JAX package's that the port
    takes; a name JAX would read as another dtype raises here."""
    with pytest.raises(ValueError, match="compute dtype"):
        TM.resolve_compute_dtype(name)
    with pytest.raises(ValueError, match="compute dtype"):
        TH.HumorConfig(compute_dtype=name)


def test_resolve_device_keeps_f32_split_k_reductions():
    """The entry points' device setting pins bf16 GEMMs' split-K partial
    sums to f32, as JAX accumulates them."""
    from humor_torch.device import resolve_device

    flags = torch.backends.cuda.matmul
    old = flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        assert resolve_device("cpu").type == "cpu"
        assert flags.allow_bf16_reduced_precision_reduction is False
    finally:
        flags.allow_bf16_reduced_precision_reduction = old


# --------------------------------------------------------------------------
# models.humor


@pytest.fixture(scope="module")
def humor():
    jp = JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0))
    return jp, _tree(jp)


def test_heads_match_jax_bf16(humor):
    """prior, posterior and decode in bf16 (mirroring
    tests/test_humor_model.py::TestComputeDtype, held to JAX's bf16
    outputs), with the gradients of a loss over all three."""
    jp, tp = humor
    jcfg, tcfg = JH.HumorConfig(compute_dtype=BF), TH.HumorConfig(
        compute_dtype=BF)
    rng = np.random.RandomState(4)
    d = jcfg.input_data_dim
    past = rng.randn(3, d).astype(np.float32) * 0.5
    cur = rng.randn(3, d).astype(np.float32) * 0.5
    z = rng.randn(3, jcfg.latent_size).astype(np.float32)
    c = {k: rng.randn(*s).astype(np.float32) for k, s in (
        ("pm", (3, 48)), ("qm", (3, 48)))}

    def jloss(p):
        pm, pv = JH.prior(jcfg, p, jnp.asarray(past))
        qm, qv = JH.posterior(jcfg, p, jnp.asarray(past), jnp.asarray(cur))
        dec = JH.decode(jcfg, p, jnp.asarray(z), jnp.asarray(past))
        out = (jnp.sum(jnp.asarray(c["pm"]) * pm) + jnp.sum(jnp.log(pv))
               + jnp.sum(jnp.asarray(c["qm"]) * qm) + jnp.sum(jnp.log(qv))
               + sum(jnp.sum(v) for v in dec.values()))
        return out, (pm, pv, qm, qv, dec)

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves = [v.requires_grad_(True) for v in _flat(tp)]
    T = torch.as_tensor
    pm, pv = TH.prior(tcfg, tp, T(past))
    qm, qv = TH.posterior(tcfg, tp, T(past), T(cur))
    dec = TH.decode(tcfg, tp, T(z), T(past))
    loss = ((T(c["pm"]) * pm).sum() + torch.log(pv).sum()
            + (T(c["qm"]) * qm).sum() + torch.log(qv).sum()
            + sum(v.sum() for v in dec.values()))
    for a, b in zip((pm, pv, qm, qv), jout[:4]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1.5e-3, rtol=STEP)
    for k, v in jout[4].items():
        np.testing.assert_allclose(dec[k].detach().numpy(), np.asarray(v),
                                   atol=1.5e-3, err_msg=k)
    # teeth: the f32 heads are farther from JAX's bf16 than the port is
    pm32, _ = TH.prior(TH.HumorConfig(), tp, T(past))
    assert (pm32 - T(np.asarray(jout[0]))).abs().max() > 3e-3
    grads = torch.autograd.grad(loss, leaves)
    worst = max(_max_scaled(g.numpy(), j)
                for g, j in zip(grads, _leaves_by_name(jg, tp)))
    assert worst <= 1e-2, worst


def test_bf16_config_rolls_out_through_the_typed_rollout():
    """The f32 rollout kernels never serve a bf16 model: the runner takes
    them for the default configuration only."""
    assert TO.uses_rollout_kernels(TH.HumorConfig())
    assert not TO.uses_rollout_kernels(TH.HumorConfig(compute_dtype=BF))
    assert not TO.uses_rollout_kernels(TH.HumorConfig(
        compute_dtype=BF, detach_sched_samp=False))


# --------------------------------------------------------------------------
# SMPL


J_MODEL = JS.synthetic_smpl_model()
T_MODEL = convert.smpl_model(J_MODEL)


def _body_inputs(B=8, seed=7):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        0.3 * rng.randn(B, 3), 0.3 * rng.randn(B, 63), 0.5 * rng.randn(B, 16),
        rng.randn(B, 3))]


def test_smpl_bf16_matches_jax():
    """forward/lbs in bf16 (mirroring tests/test_body_model.py
    TestBf16LossPipeline): joints bit-equal to the f32 call, vertices f32
    and within JAX's 2e-2 of f32, and equal to JAX's bf16 vertices."""
    ro, pose, betas, trans = _body_inputs()
    J, T = jnp.asarray, torch.as_tensor
    j16 = JS.forward(J_MODEL, J(ro), J(pose), J(betas), J(trans),
                     compute_dtype=jnp.bfloat16)
    t32 = TS.forward(T_MODEL, T(ro), T(pose), T(betas), T(trans))
    t16 = TS.forward(T_MODEL, T(ro), T(pose), T(betas), T(trans),
                     compute_dtype=torch.bfloat16)
    assert t16.v.dtype == torch.float32
    assert torch.equal(t16.Jtr[:, :22], t32.Jtr[:, :22])
    gap = float((t16.v - t32.v).abs().max())
    assert 1e-4 < gap < 2e-2, gap
    assert np.abs(t16.v.numpy() - np.asarray(j16.v)).max() <= 1e-6
    # a vertex selection (vert_ids) skins the same rows
    ids = np.arange(0, T_MODEL.num_verts, 7)
    sel = TS.forward(T_MODEL, T(ro), T(pose), T(betas), T(trans),
                     vert_ids=ids, compute_dtype=torch.bfloat16)
    assert torch.equal(sel.v, t16.v[:, ids])


def test_smpl_mesh_loss_grads_match_jax():
    ro, pose, betas, trans = _body_inputs(4, seed=8)
    J, T = jnp.asarray, torch.as_tensor
    target = np.asarray(JS.forward(J_MODEL, J(ro), J(pose), J(betas),
                                   J(trans)).v)
    at = pose + 0.05

    def jloss(p, cd):
        out = JS.forward(J_MODEL, J(ro), p, J(betas), J(trans),
                         compute_dtype=cd)
        return jnp.mean((out.v - J(target)) ** 2)

    def tgrad(cd):
        p = T(at).clone().requires_grad_(True)
        out = TS.forward(T_MODEL, T(ro), p, T(betas), T(trans),
                         compute_dtype=cd)
        return torch.autograd.grad(((out.v - T(target)) ** 2).mean(),
                                   p)[0].numpy()

    # op by op: jit reorders JAX's own f32 arithmetic, and bf16 rounding
    # makes that visible (jitted, JAX's gradient is 3.5e-3 max-scaled from
    # its op-by-op one and from the port's)
    jg16 = np.asarray(jax.grad(lambda p: jloss(p, jnp.bfloat16))(J(at)))
    assert _max_scaled(tgrad(torch.bfloat16), jg16) <= 1e-5
    assert _max_scaled(tgrad(None), jg16) > 1e-3


def test_gendered_forward_threads_bf16():
    ro, pose, betas, trans = _body_inputs(4, seed=9)
    jm = {"male": J_MODEL, "female": JS.synthetic_smpl_model(
        jax.random.PRNGKey(20))}
    tm = {k: convert.smpl_model(v) for k, v in jm.items()}
    gid = np.array([0, 1, 0, 1])
    J, T = jnp.asarray, torch.as_tensor
    j16 = j_gendered(jm, J(gid), J(ro), J(pose), J(betas), J(trans),
                     compute_dtype=jnp.bfloat16)
    t16 = t_gendered(tm, T(gid), T(ro), T(pose), T(betas), T(trans),
                     compute_dtype=torch.bfloat16)
    t32 = t_gendered(tm, T(gid), T(ro), T(pose), T(betas), T(trans))
    assert torch.equal(t16.Jtr[:, :22], t32.Jtr[:, :22])
    assert np.abs(t16.v.numpy() - np.asarray(j16.v)).max() <= 1e-6
    assert float((t16.v - t32.v).abs().max()) < 2e-2


# --------------------------------------------------------------------------
# the ELBO and the train steps


B, T, L = 4, 5, 48
EPOCH = 10
USE_GT_P = 0.5
SMPL_J = {"male": JS.synthetic_smpl_model(jax.random.PRNGKey(10)),
          "female": JS.synthetic_smpl_model(jax.random.PRNGKey(20))}
SMPL_T = {k: convert.smpl_model(v) for k, v in SMPL_J.items()}


def _batch(seed):
    world, meta = synthetic_world_batch(seed, B, T + 1, model=SMPL_J["male"])
    data_in, data_out, _ = window_to_pairs(world)
    bj = {"data_in": data_in, "data_out": data_out, "betas": meta["betas"],
          "gender_ids": meta["gender_ids"]}
    t = lambda x: torch.as_tensor(np.array(x))
    bt = {"data_in": {k: t(v) for k, v in data_in.items()},
          "data_out": {k: t(v) for k, v in data_out.items()},
          "betas": t(meta["betas"]),
          "gender_ids": t(meta["gender_ids"]).long()}
    return bj, bt


def test_loss_dtype_names():
    assert TL.LossConfig().smpl_compute_dtype is None
    assert TL.LossConfig(smpl_loss_dtype=BF).smpl_compute_dtype \
        is torch.bfloat16
    with pytest.raises(ValueError, match="smpl_loss_dtype"):
        TL.LossConfig(smpl_loss_dtype="float16")


def test_elbo_bf16_loss_bodies_match_jax():
    """The ELBO with smpl_loss_dtype="bfloat16" on the inputs of
    tests/test_torch_train_elbo.py: the loss within 1e-5 relative
    (measured 1.2e-6), every stat 1e-4 relative, 1e-7 abs (measured
    1.2e-5, the mesh term: a rotation that the two packages leave one f32
    ulp apart can round to neighbouring bf16 values), the gradients with
    respect to the prediction and the latents 1e-2 max-scaled (measured
    1.1e-3; JAX's own jitted and op-by-op gradients part by 1.3e-4 in
    the train step); the f32 mesh term is farther from JAX's bf16 one."""
    from test_torch_train_elbo import _inputs

    pred, gt, post, prior, gid, betas = _inputs()
    cfg_j = JL.LossConfig(smpl_loss_dtype=BF)
    cfg_t = TL.LossConfig(smpl_loss_dtype=BF)
    epoch = 10
    SJ = {"male": SMPL_J["male"], "female": SMPL_J["female"]}

    def jfn(p, q, pr):
        return JL.elbo_loss(cfg_j, p, q, pr, gt, epoch,
                            gender_ids=jnp.asarray(gid),
                            betas=jnp.asarray(betas), smpl_models=SJ)

    (lj, sj), gj = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(pred, post, prior)
    t = lambda x: torch.as_tensor(x).requires_grad_(True)
    p_t = {k: t(v) for k, v in pred.items()}
    q_t, pr_t = tuple(t(x) for x in post), tuple(t(x) for x in prior)

    def tfn(cfg):
        return TL.elbo_loss(cfg, p_t, q_t, pr_t,
                            {k: torch.as_tensor(v) for k, v in gt.items()},
                            epoch, gender_ids=torch.as_tensor(gid).long(),
                            betas=torch.as_tensor(betas), smpl_models=SMPL_T)

    lt, st = tfn(cfg_t)
    assert set(st) == set(sj)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for k, v in sj.items():
        np.testing.assert_allclose(float(st[k].detach()), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    _, st32 = tfn(TL.LossConfig())
    mesh = float(sj["smpl_mesh_loss"])
    assert abs(float(st32["smpl_mesh_loss"]) - mesh) > abs(
        float(st["smpl_mesh_loss"]) - mesh)
    leaves = list(p_t.values()) + list(q_t) + list(pr_t)
    grads = torch.autograd.grad(lt, leaves)
    ref = [gj[0][k] for k in p_t] + list(gj[1]) + list(gj[2])
    for name, a, b in zip(list(p_t) + ["qm", "qv", "pm", "pv"], grads, ref):
        assert _max_scaled(a.numpy(), b) <= 1e-2, name


def _ss_draws(key, p):
    """JAX scheduled_sampling's draws for `key` (as in
    tests/test_torch_train_step.py)."""
    key, choice_key = jax.random.split(key)
    step_keys = jax.random.split(key, T)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, L), jnp.float32))
                    for k in step_keys])
    use_gt = np.array(jax.random.bernoulli(choice_key, p, (T,)))
    use_gt[0] = True
    return use_gt, torch.as_tensor(eps)


def _grad_gap(a, b):
    """|a - b| / |b| over every leaf together."""
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2))
              for x, y in zip(a, b))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("phase", ["sup", "ss"])
def test_train_step_bf16_matches_jax(phase):
    """A supervised and a scheduled-sampling step with both knobs on
    (compute_dtype="bfloat16", smpl_loss_dtype="bfloat16") at full width
    with the SMPL losses, the port handed JAX's draws, against JAX's
    bf16 loss and gradients.

    Through five bf16 layers an activation that the two packages'
    products leave one f32 ulp apart (torch and XLA accumulate in other
    orders) rounds to neighbouring bf16 values, and ReLUs near 0 switch:
    the port's own step moves by 5.4e-5 in the loss and 4.3e-3 of the
    gradient's norm (5.3e-2 max-scaled, on one channel) when only its
    products accumulate in f64 instead of f32 (measured on the CPU). So
    the limits are on the loss (3e-4 relative; measured 7.8e-5
    supervised, 7.6e-5 scheduled sampling) and on the gradient as a
    whole: its gap within 2e-2 of JAX's norm (measured 1.2e-2 / 1.3e-2)
    and at most half the f32 model's gap to JAX's bf16 (2.7e-2 /
    3.8e-2). Without the SMPL terms the MLPs' rounding is most of the
    gradient, and the two gaps come within 0.6 of each other (measured:
    1.9e-2 against 3.2e-2, scheduled sampling), so the terms stay. Then
    the step is applied: the port's step reports the same loss and moves
    the weights by at most 2 lr."""
    jcfg = JH.HumorConfig(compute_dtype=BF)
    tcfg = TH.HumorConfig(compute_dtype=BF)
    jl, tl = JL.LossConfig(smpl_loss_dtype=BF), TL.LossConfig(
        smpl_loss_dtype=BF)
    params_j = JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0))
    bj, bt = _batch(0 if phase == "sup" else 1)
    key = jax.random.PRNGKey(3 if phase == "sup" else 4)
    if phase == "sup":
        jfn = JTS.supervised_loss_fn(jcfg, jl, SMPL_J)
        (jloss, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            params_j, bj, key, EPOCH)
        draws = dict(eps=torch.as_tensor(np.array(
            jax.random.normal(key, (B * T, L)))))
        args = (EPOCH,)
        tfn = TTS.supervised_loss_fn
    else:
        jfn = JTS.sched_samp_loss_fn(jcfg, jl, SMPL_J)
        (jloss, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            params_j, bj, key, EPOCH, USE_GT_P)
        use_gt, eps = _ss_draws(key, USE_GT_P)
        draws = dict(use_gt=use_gt, eps=eps)
        args = (EPOCH, USE_GT_P)
        tfn = TTS.sched_samp_loss_fn
    opt = TTS.make_optimizer(lr=1e-4, steps_per_epoch=10)
    state = TTS.make_train_state(_tree(params_j), opt)
    jleaves = _leaves_by_name(jg, state.params)

    def grads(cfg, loss_cfg):
        loss, _ = tfn(cfg, loss_cfg, SMPL_T)(state.params, bt, *args,
                                            **draws)
        g = torch.autograd.grad(loss, TTS.tree_leaves(state.params))
        return float(loss.detach()), [x.numpy() for x in g]

    loss, g16 = grads(tcfg, tl)
    np.testing.assert_allclose(loss, float(jloss), rtol=3e-4)
    gap16 = _grad_gap(g16, jleaves)
    gap32 = _grad_gap(grads(TH.HumorConfig(), TL.LossConfig())[1], jleaves)
    assert gap16 <= 2e-2 and gap16 <= 0.5 * gap32, (gap16, gap32)

    before = [p.detach().clone() for p in TTS.tree_leaves(state.params)]
    sup, ss, _ = TTS.make_train_steps(tcfg, tl, opt, SMPL_T)
    new, stats = (sup if phase == "sup" else ss)(state, bt, *args, **draws)
    assert float(stats["total_loss"]) == pytest.approx(loss, rel=1e-6)
    moved = max(float((a - b).abs().max()) for a, b in
                zip(TTS.tree_leaves(new.params), before))
    assert 1e-5 < moved <= 2.0001e-4


# --------------------------------------------------------------------------
# the runner and the CLIs


def test_typed_rollout_bf16_matches_jax(humor):
    """The rollout that a bf16 fit's stage 3 runs (the typed rollout, in
    place of the f32 kernels) against JAX's lax.scan rollout in bf16:
    B=3, 6 steps from one injected latent sequence, the decoder head
    damped x0.1 (the random-weight chain is chaotic otherwise), the
    input canonicalized and the output returned to the world frame. The
    trajectory within 1e-4 (measured 3.2e-6; the f32 rollout is 3.8e-3
    from JAX's bf16 one) and the prior's mean and variance, whose MLP is
    not damped, within 3e-3 abs / relative (measured 1.1e-3 / 1.1e-3)."""
    from test_torch_modules import _state

    jp, _ = humor
    last = jp["decoder"][-1]
    jp = dict(jp, decoder=jp["decoder"][:-1] + [
        dict(last, w=last["w"] * 0.1, b=last["b"] * 0.1)])
    tp = _tree(jp)
    rng = np.random.RandomState(7)
    st = _state(rng, 3)
    z = (0.5 * rng.randn(3, 6, 48)).astype(np.float32)
    kw = dict(canonicalize_input=True, uncanonicalize_output=True)
    ref = JH.rollout(JH.HumorConfig(compute_dtype=BF), jp,
                     jax.random.PRNGKey(0),
                     {k: jnp.asarray(v) for k, v in st.items()}, 6,
                     z_seq=jnp.asarray(z), **kw)

    def port(cd):
        return TH.rollout(TH.HumorConfig(compute_dtype=cd), tp,
                          {k: torch.as_tensor(v) for k, v in st.items()}, 6,
                          z_seq=torch.as_tensor(z), **kw)

    out, out32 = port(BF), port(None)
    gap = max(float(np.abs(out.world[k].numpy() - np.asarray(v)).max())
              for k, v in ref.world.items())
    gap32 = max(float(np.abs(out32.world[k].numpy() - np.asarray(v)).max())
                for k, v in ref.world.items())
    assert gap <= 1e-4 and gap32 > 1e-3, (gap, gap32)
    np.testing.assert_allclose(out.prior[0].numpy(), np.asarray(ref.prior[0]),
                               atol=3e-3)
    np.testing.assert_allclose(out.prior[1].numpy(), np.asarray(ref.prior[1]),
                               rtol=3e-3)


@pytest.mark.slow
def test_joints3d_fit_bf16_matches_jax(damped_models, observed):
    """The joints3d fit of tests/test_torch_tto_runner.py at 3/3/3 with
    compute_dtype="bfloat16" in both packages, the decoder head damped
    x0.1 (tests/test_torch_tto_prox.py): stage 3 rolls out through the
    port's typed rollout (no kernel) and JAX's lax.scan, both in bf16.
    Slow: JAX compiles this runner in 50-100 s on the CPU (its weights
    are constants of the program); test_typed_rollout_bf16_matches_jax
    stands for it in tier 1.

    Stages 1-2 do not run HuMoR and agree as in f32 (rtol 1e-4; measured
    1.1e-6); stage 3's history within 2e-3 relative (measured 3.9e-4).
    The finals are held finite only: a bf16 stage 3 is chaotic at random
    weights, JAX's own bf16 and f32 fits ending 5.8 rad apart in
    pose_body after these 3 iterations, the port's bf16 fit 5.7 rad from
    JAX's (both damped; the f32 fits agree to 7.5e-5; measured on the CPU)."""
    jm, tm = damped_models
    jm = jm._replace(humor_cfg=JH.HumorConfig(compute_dtype=BF))
    tm = tm._replace(humor_cfg=TH.HumorConfig(compute_dtype=BF))
    rj = JO.make_runner(CFG_J, jm)({"joints3d": jnp.asarray(observed)})
    rt = TO.make_runner(CFG_T, tm, device="cpu")(
        {"joints3d": torch.tensor(observed)})
    for st, n in zip(("stage1", "stage2", "stage3"), ITERS):
        assert rt.losses[st].shape == (n,), st
        np.testing.assert_allclose(rt.losses[st].numpy(),
                                   np.asarray(rj.losses[st]),
                                   rtol=2e-3 if st == "stage3" else 1e-4,
                                   err_msg=st)
    for k in ("trans", "root_orient", "pose_body", "betas", "latent_motion",
              "joints3d_rollout", "contacts"):
        assert bool(torch.isfinite(rt.final[k]).all()), k


@pytest.mark.parametrize("phase", ["sup", "ss"])
def test_multi_steps_bf16_equal_single_steps(phase):
    """The k-step chunk carries the bf16 configuration unchanged: a chunk
    of 2 steps with compute_dtype="bfloat16" (and the bf16 loss bodies)
    equals 2 single steps bit for bit, and differs from the f32 model's
    chunk."""
    batches = [_batch(s)[1] for s in range(2)]
    params = _tree(JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0)))

    def run(cfg, loss_cfg, chunk):
        opt = TTS.make_optimizer(lr=1e-4, steps_per_epoch=10)
        sup, ss, _ = TTS.make_train_steps(cfg, loss_cfg, opt, SMPL_T)
        st = TTS.make_train_state(
            TTS.tree_map(lambda p: p.clone(), params), opt)
        g = torch.Generator().manual_seed(5)
        if chunk:
            msup, mss = TTS.make_multi_steps(sup, ss, 2)
            stacked = TTS.stack_batches(batches)
            st, stats = (msup(st, stacked, EPOCH, generator=g)
                         if phase == "sup" else
                         mss(st, stacked, EPOCH, 0.5, generator=g))
            return TTS.tree_leaves(st.params), stats["total_loss"]
        losses = []
        for b in batches:
            st, s = (sup(st, b, EPOCH, generator=g) if phase == "sup"
                     else ss(st, b, EPOCH, 0.5, generator=g))
            losses.append(s["total_loss"])
        return TTS.tree_leaves(st.params), torch.stack(losses)

    bf = (TH.HumorConfig(compute_dtype=BF), TL.LossConfig(smpl_loss_dtype=BF))
    p_chunk, l_chunk = run(*bf, chunk=True)
    p_single, l_single = run(*bf, chunk=False)
    assert torch.equal(l_chunk, l_single)
    assert all(torch.equal(a, b) for a, b in zip(p_chunk, p_single))
    _, l32 = run(TH.HumorConfig(), TL.LossConfig(), chunk=True)
    assert not torch.equal(l32, l_chunk)


def _count_products(monkeypatch):
    """Counts the bf16 products (ops.mlp._product_f32 calls)."""
    calls = []
    real = TM._product_f32

    def counted(a, b):
        calls.append(a.dtype)
        return real(a, b)

    monkeypatch.setattr(TM, "_product_f32", counted)
    return calls


def test_train_cli_bf16(tmp_path, monkeypatch):
    """`--model-compute-dtype bfloat16` trains (one short epoch on the
    synthetic sequences) through the bf16 products; an unknown name
    raises."""
    from humor_torch.train import cli as TC
    from humor_torch.utils.config import TrainCLIConfig, parse_into
    from test_torch_train_cli import CFG, _argv, _stats

    calls = _count_products(monkeypatch)
    out = tmp_path / "bf16"
    res = TC.main(_argv(CFG, out, "--epochs", "1",
                        "--model-compute-dtype", BF))
    assert np.isfinite(res["min_train_loss"])
    rows = _stats(out)
    assert rows and all(np.isfinite(r["total_loss"]) for r in rows)
    assert calls and set(calls) == {torch.bfloat16}
    # the checkpoint resumes under the flag (the config is not stored in
    # it: the flag is given again, as in the JAX package)
    calls.clear()
    TC.main(_argv(CFG, out, "--epochs", "2", "--model-compute-dtype", BF,
                  "--ckpt", str(out / "final_model.npz")))
    with open(out / "train.log") as f:
        assert "at epoch 1" in f.read()
    assert calls and set(calls) == {torch.bfloat16}
    for name in ("float16", "fp32"):
        with pytest.raises(ValueError, match="compute dtype"):
            parse_into(TrainCLIConfig, ["@" + CFG, "--model-compute-dtype",
                                        name])


def test_fit_cli_bf16(tmp_path, monkeypatch):
    """The fit CLI's AMASS joints fit with `--model-compute-dtype
    bfloat16` on the synthetic sequences: the runner gets the bf16 model
    (so the typed rollout), finite losses; an unknown name raises."""
    from humor_torch.fitting import cli as TF
    from humor_torch.utils.config import FitCLIConfig, parse_into
    from test_torch_amass_fit_cli import CFG, FAST

    calls = _count_products(monkeypatch)
    seen = []
    real = TO.make_runner

    def recording(cfg, models, *a, **kw):
        seen.append(models.humor_cfg)
        return real(cfg, models, *a, **kw)

    monkeypatch.setattr(TO, "make_runner", recording)
    res = TF.main([f"@{CFG}/fit_amass_joints.cfg", *FAST,
                   "--data-path", str(tmp_path / "no_data"),
                   "--smplh-root", str(tmp_path / "no_bodies"),
                   "--out", str(tmp_path / "out"), "--device", "cpu",
                   "--model-compute-dtype", BF])
    assert res["failed_batches"] == 0 and res["results"]
    assert seen and all(c.compute_dtype == BF for c in seen)
    assert not TO.uses_rollout_kernels(seen[0])
    for r in res["results"]:
        for st in ("stage1", "stage2", "stage3"):
            assert bool(torch.isfinite(r.losses[st]).all()), st
    assert calls and set(calls) == {torch.bfloat16}
    with pytest.raises(ValueError, match="compute dtype"):
        parse_into(FitCLIConfig, [f"@{CFG}/fit_amass_joints.cfg",
                                  "--model-compute-dtype", "float16"])
