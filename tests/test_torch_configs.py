"""The HuMoR configurations other than the default, humor_torch against
humor_tpu on the CPU: the rotation conversions they need, decode for
every (in, out, delta) combination, the standard-normal prior, the
S-frame past windows (every case of tests/test_steps_in.py), the losses
and a train step at steps_in = 2 and without contacts, a checkpoint of a
non-default configuration, and the runner at a non-default
configuration (which rolls out through the typed rollout, not the
kernels).

Both packages get the same numpy-seeded inputs, the same weights
(convert.params_tree) and the same draws. Tolerances: conversions and
decode 1e-6 (decode in float64, where both compute the same expression;
in float32 the 1024-wide MLP's sums part further: test_torch_modules.py
holds the heads at 3e-4; the SVD projection
also in float64, as two float32 LAPACK paths part by 1.1e-6, measured:
float32 at 1e-5); the SVD projection's gradient 1e-5 max-scaled, away
from repeated singular values; the losses 2e-7 relative and gradients
2e-6 max-scaled (the spreads measured at full width in
test_torch_train_step.py), in float64 for the 9d-output
model (in float32 its gradients part by 1.4e-4 max-scaled through the
SVD's backward, by 5e-15 in float64, measured); the steps_in = 2
rollout 3e-5 (measured 9.1e-6 over 5 steps), the inferred distributions
5e-6 (measured 1.4e-6) and the non-default checkpoint's decode 2e-5
(measured 6.0e-6), a few times each measured gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs as jwindow_to_pairs
from humor_tpu.data.windows import window_to_pairs_multi as jpairs_multi
from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import optimizer as JO
from humor_tpu.losses.elbo import LossConfig as JLossConfig
from humor_tpu.models import humor as JH
from humor_tpu.ops import transforms as JT
from humor_tpu.train import step as JTS
from humor_tpu.utils import checkpoint as jckpt

from humor_torch import convert
from humor_torch.data.windows import window_to_pairs, window_to_pairs_multi
from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as TH
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops import transforms as TT
from humor_torch.train import step as TS

torch.set_num_threads(2)

B, F, S = 3, 8, 2
L = 48
NO_SMPL = dict(smpl_joint_loss=0.0, smpl_mesh_loss=0.0,
               smpl_joint_consistency_loss=0.0)


def _np(x):
    return np.asarray(x)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _tree(jp):
    return convert.params_tree(jax.tree_util.tree_map(np.asarray, jp))


def _cfgs(**kw):
    return JH.HumorConfig(**kw), TH.HumorConfig(**kw)


@pytest.fixture(scope="module")
def world():
    w, _ = synthetic_world_batch(0, B, F)
    return w


def _max_scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# rotation conversions
# ---------------------------------------------------------------------------

def _separated_9d(rng, n):
    """(n, 9) matrices U diag(s) V^T with singular values 3, 2, 1 (+-0.1)
    and random signs of det: far from the SVD gradient's ties."""
    def orth():
        q, _ = np.linalg.qr(rng.randn(n, 3, 3))
        return q
    s = np.array([3.0, 2.0, 1.0]) + 0.1 * rng.randn(n, 3)
    m = orth() @ (s[:, :, None] * orth())
    return m.reshape(n, 9)


def test_conversions_match_jax():
    rng = np.random.RandomState(0)
    x9 = _separated_9d(rng, 64)
    q = rng.randn(64, 4).astype(np.float32)
    R = _np(JT.aa_to_rotmat(jnp.asarray(rng.randn(64, 3).astype(np.float32))))
    with jax.enable_x64(True):
        np.testing.assert_allclose(
            TT.rot9d_to_rotmat(_t(x9, torch.float64)).numpy(),
            _np(JT.rot9d_to_rotmat(jnp.asarray(x9))), atol=1e-6)
    x9 = x9.astype(np.float32)
    np.testing.assert_allclose(TT.rot9d_to_rotmat(_t(x9)).numpy(),
                               _np(JT.rot9d_to_rotmat(jnp.asarray(x9))),
                               atol=1e-5)
    np.testing.assert_allclose(TT.quat_to_rotmat(_t(q)).numpy(),
                               _np(JT.quat_to_rotmat(jnp.asarray(q))),
                               atol=1e-6)
    np.testing.assert_array_equal(TT.rotmat_to_rot6d(_t(R)).numpy(),
                                  _np(JT.rotmat_to_rot6d(jnp.asarray(R))))
    packed = {"aa": rng.randn(5, 21 * 3), "6d": rng.randn(5, 21 * 6),
              "9d": _separated_9d(rng, 5 * 21).reshape(5, 21 * 9),
              "mat": R[:63].reshape(3, 21 * 9)}
    for rep, x in packed.items():
        dtype = np.float64 if rep == "9d" else np.float32
        x = x.astype(dtype)
        out = TT.convert_to_rotmat(_t(x, torch.from_numpy(x).dtype), rep)
        assert out.shape == (x.shape[0], 21 * 9)
        with jax.enable_x64(dtype == np.float64):
            ref = _np(JT.convert_to_rotmat(jnp.asarray(x), rep))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, err_msg=rep)
    with pytest.raises(ValueError, match="unknown rotation rep"):
        TT.convert_to_rotmat(_t(x9), "euler")


def test_rot9d_gradient_matches_jax():
    """d(sum W * proj(x))/dx through the SVD, away from ties."""
    rng = np.random.RandomState(1)
    x = _separated_9d(rng, 32).astype(np.float32)
    w = rng.randn(32, 3, 3).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(JT.rot9d_to_rotmat(a) * w))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(torch.sum(TT.rot9d_to_rotmat(xt) * _t(w)),
                                xt)
    assert _max_scaled(gt.numpy(), _np(gj)) <= 1e-5


# ---------------------------------------------------------------------------
# configurations, decode, prior
# ---------------------------------------------------------------------------

CONFIGS = [dict(steps_in=2), dict(conditional_prior=False),
           dict(in_rot_rep="aa", out_rot_rep="6d", output_delta=False),
           dict(model_data_config="smpl+joints"),
           dict(model_data_config="all", in_rot_rep="6d",
                out_rot_rep="9d")]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_dims_and_param_shapes_match_jax(kw):
    cj, ct = _cfgs(**kw)
    for name in ("input_data_dim", "past_data_dim", "output_data_dim",
                 "pred_contacts", "need_trans2joint"):
        assert getattr(ct, name) == getattr(cj, name), name
    assert (ct.mat_spec.names, ct.mat_spec.rot_rep) == (
        cj.mat_spec.names, cj.mat_spec.rot_rep)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), JH.init_params(cj, jax.random.PRNGKey(0)))
    tshapes = TS.tree_map(lambda a: tuple(a.shape),
                          TH.init_params(ct, torch.Generator().manual_seed(0)))
    assert set(tshapes) == set(jshapes)
    for k in jshapes:
        assert [sorted(layer.items()) for layer in tshapes[k]] == \
            [sorted(layer.items()) for layer in jshapes[k]], k


def test_refused_reps_and_configs():
    for kw in (dict(in_rot_rep="9d"), dict(out_rot_rep="mat"),
               dict(model_data_config="smpl"), dict(steps_in=0)):
        with pytest.raises(ValueError):
            TH.HumorConfig(**kw)


DECODE_CASES = [(i, o, d) for i in ("mat", "aa", "6d")
                for o in ("aa", "6d", "9d") for d in (True, False)]


@pytest.mark.parametrize("in_rep,out_rep,delta", DECODE_CASES)
def test_decode_and_input_match_jax(world, in_rep, out_rep, delta):
    """state_to_input in `in_rep`, then decode with `out_rep` outputs,
    residual or absolute, in float64 in both packages."""
    kw = dict(in_rot_rep=in_rep, out_rot_rep=out_rep, output_delta=delta)
    cj, ct = _cfgs(**kw)
    rng = np.random.RandomState(2)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64),
            JH.init_params(cj, jax.random.PRNGKey(1)))
        tp = convert.params_tree(jax.tree_util.tree_map(np.asarray, jp))
        tp = TS.tree_map(lambda a: a.double(), tp)
        din, _, _ = jwindow_to_pairs(world)
        state = {k: np.asarray(v, np.float64).reshape(B * (F - 1), -1)
                 for k, v in din.items()}
        past_j = JH.state_to_input(cj, {k: jnp.asarray(v)
                                        for k, v in state.items()})
        past_t = TH.state_to_input(ct, {k: _t(v, torch.float64)
                                        for k, v in state.items()})
        np.testing.assert_allclose(past_t.numpy(), _np(past_j), atol=1e-6)
        z = rng.randn(B * (F - 1), L)
        dj = JH.decode(cj, jp, jnp.asarray(z), past_j)
        dt = TH.decode(ct, tp, _t(z, torch.float64), past_t)
        assert set(dt) == set(dj)
        for k in dj:
            np.testing.assert_allclose(dt[k].numpy(), _np(dj[k]), atol=1e-6,
                                       err_msg=k)


def test_unconditional_prior_matches_jax():
    cj, ct = _cfgs(conditional_prior=False)
    jp = JH.init_params(cj, jax.random.PRNGKey(0))
    assert "prior" not in jp
    tp = TH.init_params(ct, torch.Generator().manual_seed(0))
    assert "prior" not in tp
    past = np.random.RandomState(3).randn(2, 5, ct.past_data_dim)
    jm, jv = JH.prior(cj, jp, jnp.asarray(past, jnp.float32))
    tm, tv = TH.prior(ct, tp, _t(past))
    assert tm.shape == (2, 5, L)
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))


# ---------------------------------------------------------------------------
# S-frame past windows (tests/test_steps_in.py, mirrored)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup_s2():
    cj, ct = _cfgs(steps_in=S)
    jp = JH.init_params(cj, jax.random.PRNGKey(0))
    return cj, ct, jp, _tree(jp)


def _world_t(world):
    return {k: _t(v) for k, v in world.items()}


def test_input_dims(setup_s2):
    _, ct, _, tp = setup_s2
    assert ct.past_data_dim == S * ct.input_data_dim
    assert tp["prior"][0]["w"].shape[0] == ct.past_data_dim


@pytest.mark.parametrize("steps_in", [1, 2, 3])
def test_window_pairs_multi_matches_jax(world, steps_in):
    jin, jout = jpairs_multi(world, steps_in)
    tin, tout = window_to_pairs_multi(_world_t(world), steps_in)
    for k in jin:
        assert tuple(tin[k].shape) == tuple(jin[k].shape)
        np.testing.assert_allclose(tin[k].numpy(), _np(jin[k]), atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(tout[k].numpy(), _np(jout[k]), atol=1e-6,
                                   err_msg=k)


def test_window_pairs_multi_matches_single(world):
    w = _world_t(world)
    d1_in, d1_out, _ = window_to_pairs(w)
    dm_in, dm_out = window_to_pairs_multi(w, 1)
    for k in d1_in:
        np.testing.assert_allclose(dm_in[k][..., 0, :].numpy(),
                                   d1_in[k].numpy(), atol=1e-5)
        np.testing.assert_allclose(dm_out[k].numpy(), d1_out[k].numpy(),
                                   atol=1e-5)


def test_window_pairs_multi_layout(world):
    w = _world_t(world)
    dm_in, dm_out = window_to_pairs_multi(w, S)
    T = F - S
    assert tuple(dm_in["trans"].shape) == (B, T, S, 3)
    assert tuple(dm_out["trans"].shape) == (B, T, 3)
    d1_in, d1_out, _ = window_to_pairs(w)
    for k in dm_in:
        np.testing.assert_allclose(dm_in[k][:, :, S - 1].numpy(),
                                   d1_in[k][:, S - 1:].numpy(), atol=1e-4)
        np.testing.assert_allclose(dm_out[k].numpy(),
                                   d1_out[k][:, S - 1:].numpy(), atol=1e-4)


def test_rollout_steps_in_2(setup_s2, world):
    """Against JAX (5 steps, prior mean, canonicalized in and out), and
    the port's +5 m equivariance (JAX's 2e-3)."""
    cj, ct, jp, tp = setup_s2
    names = ct.input_spec.names
    init = {k: v[:, :S] for k, v in world.items() if k in names}
    ref = JH.rollout(cj, jp, jax.random.PRNGKey(1), init, 5, use_mean=True,
                     canonicalize_input=True, uncanonicalize_output=True)
    init_t = {k: _t(v) for k, v in init.items()}
    out = TH.rollout(ct, tp, init_t, 5, use_mean=True,
                     canonicalize_input=True, uncanonicalize_output=True)
    assert tuple(out.world["trans"].shape) == (B, 5, 3)
    for k in ref.world:
        assert torch.isfinite(out.world[k]).all()
        np.testing.assert_allclose(out.world[k].numpy(), _np(ref.world[k]),
                                   atol=3e-5, err_msg=k)
    shift = torch.tensor([5.0, 5.0, 0.0])
    shifted = dict(init_t)
    shifted["trans"] = init_t["trans"] + shift
    shifted["joints"] = (init_t["joints"].reshape(B, S, -1, 3)
                         + shift).reshape(B, S, -1)
    out2 = TH.rollout(ct, tp, shifted, 5, use_mean=True,
                      canonicalize_input=True, uncanonicalize_output=True)
    np.testing.assert_allclose(out2.world["trans"].numpy(),
                               (out.world["trans"] + shift).numpy(),
                               atol=2e-3)
    with pytest.raises(ValueError, match="steps_in=2"):
        TH.rollout(ct, tp, {k: v[:, -1] for k, v in init_t.items()}, 2,
                   use_mean=True)


def test_infer_global_seq_steps_in_2(setup_s2, world):
    cj, ct, jp, tp = setup_s2
    ref = JH.infer_global_seq(cj, jp, world)
    out = TH.infer_global_seq(ct, tp, _world_t(world))
    assert tuple(out.posterior[0].shape) == (B, F - S, L)
    for a, b in ((out.prior, ref.prior), (out.posterior, ref.posterior)):
        np.testing.assert_allclose(a[0].numpy(), _np(b[0]), atol=5e-6)
        np.testing.assert_allclose(a[1].numpy(), _np(b[1]), rtol=5e-6)


TRAIN_CONFIGS = {   # name: (config, dtype of the JAX comparison)
    "steps_in2": (dict(steps_in=S), np.float32),
    "6d_9d_nocontacts_uncond": (dict(in_rot_rep="6d", out_rot_rep="9d",
                                     model_data_config="smpl+joints",
                                     conditional_prior=False), np.float64),
}


def _train_batch(world, steps_in, dtype=np.float32):
    if steps_in == 1:
        din, dout, _ = jwindow_to_pairs(world)
    else:
        din, dout = jpairs_multi(world, steps_in)
    cast = lambda tree: {k: np.asarray(v, dtype) for k, v in tree.items()}
    din, dout = cast(din), cast(dout)
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    bj = {"data_in": {k: jnp.asarray(v) for k, v in din.items()},
          "data_out": {k: jnp.asarray(v) for k, v in dout.items()},
          "betas": jnp.zeros((B, 16), dtype),
          "gender_ids": jnp.zeros((B,), jnp.int32)}
    bt = {"data_in": {k: _t(v, tdt) for k, v in din.items()},
          "data_out": {k: _t(v, tdt) for k, v in dout.items()},
          "betas": torch.zeros(B, 16, dtype=tdt),
          "gender_ids": torch.zeros(B, dtype=torch.long)}
    return bj, bt


@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_losses_and_train_step_match_jax(world, name):
    """The supervised and scheduled-sampling losses and gradients (JAX's
    draws handed to the port), then one supervised and one scheduled-
    sampling train step, as tests/test_steps_in.py takes them."""
    kw, dtype = TRAIN_CONFIGS[name]
    with jax.enable_x64(dtype == np.float64):
        _losses_and_train_step(world, kw, dtype)


def _losses_and_train_step(world, kw, dtype):
    cj, ct = _cfgs(**kw)
    steps_in = kw.get("steps_in", 1)
    bj, bt = _train_batch(world, steps_in, dtype)
    tdt = bt["betas"].dtype
    T = F - steps_in
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), dtype),
        JH.init_params(cj, jax.random.PRNGKey(0)))
    lj = JLossConfig(**NO_SMPL)
    lt = LossConfig(**NO_SMPL)
    key = jax.random.PRNGKey(3)
    epoch, p = 15, 0.5

    def port_grads(fn, *args, **kwargs):
        params = TS.tree_map(lambda a: a.to(tdt).requires_grad_(True),
                             _tree(jp))
        loss, _ = fn(params, bt, *args, **kwargs)
        grads = torch.autograd.grad(loss, TS.tree_leaves(params))
        return float(loss.detach()), [g.numpy() for g in grads]

    def check(jout, tout):
        (jl, _), jg = jout
        tl, tg = tout
        assert abs(tl - float(jl)) <= 2e-7 * abs(float(jl)), (tl, float(jl))
        jleaves = [_np(x) for x in jax.tree_util.tree_leaves(jg)]
        assert len(jleaves) == len(tg)
        worst = max(_max_scaled(a, b) for a, b in zip(tg, jleaves))
        assert worst <= 2e-6, worst

    sup_j = jax.value_and_grad(JTS.supervised_loss_fn(cj, lj, None),
                               has_aux=True)(jp, bj, key, epoch)
    eps = _t(jax.random.normal(key, (B * T, L), dtype), tdt)
    check(sup_j, port_grads(TS.supervised_loss_fn(ct, lt, None), epoch,
                            eps=eps))

    ss_j = jax.value_and_grad(JTS.sched_samp_loss_fn(cj, lj, None),
                              has_aux=True)(jp, bj, key, epoch, p)
    k2, choice_key = jax.random.split(key)
    step_keys = jax.random.split(k2, T)
    eps_ss = torch.stack([_t(jax.random.normal(k, (B, L), dtype), tdt)
                          for k in step_keys])
    use_gt = np.array(jax.random.bernoulli(choice_key, p, (T,)))
    check(ss_j, port_grads(TS.sched_samp_loss_fn(ct, lt, None), epoch, p,
                           use_gt=use_gt, eps=eps_ss))

    opt = TS.make_optimizer()
    sup, ss, _ = TS.make_train_steps(ct, lt, opt, None)
    state = TS.init_train_state(ct, opt, torch.Generator().manual_seed(0))
    bt = {k: ({n: v.float() for n, v in b.items()} if isinstance(b, dict)
              else (b.float() if b.is_floating_point() else b))
          for k, b in bt.items()}
    gen = torch.Generator().manual_seed(1)
    state, stats = sup(state, bt, 0, generator=gen)
    assert torch.isfinite(stats["total_loss"])
    state, stats = ss(state, bt, 15, 0.5, generator=gen)
    assert torch.isfinite(stats["total_loss"])
    assert state.step == 2


def test_load_checkpoint_of_a_non_default_config(tmp_path):
    """A JAX checkpoint of a steps_in=2, 6d-output, unconditional model
    (no "prior", wider input layers) loads into the port's pytree, and
    the port's model runs on it."""
    cj, ct = _cfgs(steps_in=2, out_rot_rep="6d", conditional_prior=False)
    jp = JH.init_params(cj, jax.random.PRNGKey(4))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_state(path, jp, epoch=3)
    out = convert.load_checkpoint(path)
    assert out["epoch"] == 3 and "prior" not in out["params"]
    jl = jax.tree_util.tree_leaves(jp)
    tl = TS.tree_leaves(out["params"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    past = np.random.RandomState(5).randn(2, ct.past_data_dim)
    z = np.random.RandomState(6).randn(2, L)
    dj = JH.decode(cj, jp, jnp.asarray(z, jnp.float32),
                   jnp.asarray(past, jnp.float32))
    dt = TH.decode(ct, out["params"], _t(z), _t(past))
    for k in dj:
        np.testing.assert_allclose(dt[k].numpy(), _np(dj[k]), atol=2e-5)


# ---------------------------------------------------------------------------
# the runner at a non-default configuration
# ---------------------------------------------------------------------------

RUN_T, RUN_ITERS = 8, (3, 3, 2)


def _runner_weights(mod):
    """benchmarks/bench_tto.py's joints3d stage weights."""
    return (
        mod.StageWeights(joints3d=1.0),
        mod.StageWeights(joints3d=1.0, pose_prior=2e-4, shape_prior=1.67e-4,
                         joints3d_smooth=10.0),
        mod.StageWeights(joints3d=1.0, shape_prior=1.67e-4, motion_prior=1e-3,
                         init_motion_prior=1e-3, joint_consistency=1.0,
                         bone_length=10.0, contact_vel=1.0,
                         contact_height=1.0))


def test_runner_unconditional_6d_matches_jax(monkeypatch):
    """The whole joints3d runner with a 6d-output, unconditional model,
    3/3/2 on B=2 x 8: per-iteration histories (rtol 3e-6, measured
    6.3e-7) and finals (atol 4e-5, measured 2.5e-5) against JAX, the
    tolerances of test_torch_tto_runner.py's damped keypts runner. The
    decoder head is damped x0.1 toward the identity: 6d outputs are
    normalized, so a head merely scaled down still gives O(1) random
    rotation deltas and a chaotic chain (finals parted by 5.7 rad with
    the zoom search, measured), so the head's rotation slots are biased
    to the identity's 6d code. A 1e-6 m nudge of the observations moves
    the port's own finals by up to 1.4e-2, far above the JAX gap. The
    port takes the typed rollout: its kernels' wrapper is never
    called."""
    from humor_tpu.body_model.smpl import synthetic_smpl_model
    from humor_tpu.models import gmm as jgmm
    from humor_tpu.models import vposer as jvp

    from humor_torch.models import vposer as tvp

    cj, ct = _cfgs(out_rot_rep="6d", conditional_prior=False)
    body = synthetic_smpl_model()
    vcfg = jvp.VPoserConfig()
    humor = JH.init_params(cj, jax.random.PRNGKey(2))
    last = humor["decoder"][-1]
    ident = np.zeros(cj.output_data_dim, np.float32)
    for name, a, e in cj.out_spec.offsets:
        if name in ("root_orient", "pose_body"):
            ident[a:e] = np.tile([1, 0, 0, 1, 0, 0], (e - a) // 6)
    humor = dict(humor, decoder=humor["decoder"][:-1] + [
        dict(last, w=last["w"] * 0.1, b=last["b"] * 0.1 + ident)])
    jm = JO.TTOModels(
        body=body, vposer_cfg=vcfg,
        vposer=jvp.init_params(vcfg, jax.random.PRNGKey(1)),
        humor_cfg=cj, humor=humor,
        init_gmm=jgmm.GmmParams(jnp.ones((12,)) / 12, jnp.zeros((12, 138)),
                                jnp.broadcast_to(jnp.eye(138),
                                                 (12, 138, 138))))
    tm = TO.TTOModels(
        body=convert.smpl_model(body), vposer_cfg=tvp.VPoserConfig(),
        vposer=_tree(jm.vposer), humor_cfg=ct, humor=_tree(humor),
        init_gmm=convert.gmm_params(*[_np(a) for a in jm.init_gmm]))
    assert TO.prepare_models(tm, "cpu").rollout_weights is None
    assert not TO.uses_rollout_kernels(ct)
    assert TO.uses_rollout_kernels(TH.HumorConfig(detach_sched_samp=False))

    def refused(*a, **k):
        raise AssertionError("the kernels' wrapper was called")
    monkeypatch.setattr(RK, "rollout", refused)

    rng = np.random.RandomState(4)
    z = jnp.asarray(rng.randn(2, RUN_T, 32) * 0.3, jnp.float32)
    pose = jvp.latent2pose(vcfg, jm.vposer, z)
    trans = jnp.asarray(rng.randn(2, RUN_T, 3) * 0.1, jnp.float32)
    ro = jnp.asarray(np.tile(rng.randn(2, 1, 3) * 0.2, (1, RUN_T, 1)),
                     jnp.float32)
    obs = _np(JO.smpl_results(body, trans, ro, pose, jnp.zeros((2, 16)),
                              verts="none")["joints3d"])
    kw = dict(seq_len=RUN_T, num_iters=RUN_ITERS,
              stage3_tune_init_num_frames=5, stage3_freeze_start=1,
              stage3_freeze_end=2)
    rj = JO.make_runner(JO.TTOConfig(stage_weights=_runner_weights(JE),
                                     **kw), jm)({"joints3d": jnp.asarray(obs)})
    rt = TO.make_runner(TO.TTOConfig(stage_weights=_runner_weights(TE),
                                     **kw), tm, device="cpu")(
        {"joints3d": torch.tensor(obs)})
    for st, n in zip(("stage1", "stage2", "stage3"), RUN_ITERS):
        assert rt.losses[st].shape == (n,), st
        np.testing.assert_allclose(rt.losses[st].numpy(),
                                   _np(rj.losses[st]), rtol=3e-6,
                                   err_msg=st)
    for k in ("trans", "root_orient", "pose_body", "betas", "latent_motion",
              "latent_pose", "prior_trans", "prior_root_orient",
              "joints3d_rollout", "contacts"):
        np.testing.assert_allclose(rt.final[k].numpy(), _np(rj.final[k]),
                                   atol=4e-5, err_msg=k)


@pytest.mark.parametrize("flags,kw", [
    (["--model-steps-in", "2"], dict(steps_in=2)),
    (["--in-rot-rep", "6d", "--out-rot-rep", "9d", "--no-conditional-prior",
      "--no-output-delta", "--model-data-config", "smpl+joints"],
     dict(in_rot_rep="6d", out_rot_rep="9d", conditional_prior=False,
          output_delta=False, model_data_config="smpl+joints"))])
def test_train_cli_trains_other_configs(tmp_path, flags, kw):
    """The port's train CLI at batch 2 through a supervised and a
    scheduled-sampling epoch (the SMPL losses off, synthetic sequences):
    finite stats, and a checkpoint of that configuration's shapes."""
    import json
    import os

    from humor_torch.train import cli as TC

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "run"
    TC.main(["@" + os.path.join(root, "configs", "train_humor.cfg"),
             "--device", "cpu", "--batch-size", "2", "--epochs", "2",
             "--steps-per-epoch", "1", "--sched-samp-start", "0",
             "--sched-samp-end", "1", "--no-use-smpl-losses",
             "--out", str(out), "--data-path", str(out / "no_data"),
             "--smplh-root", str(out / "no_bodies"), *flags])
    with open(out / "stats.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2 and all(np.isfinite(r["total_loss"])
                                  for r in rows)
    params = convert.load_checkpoint(str(out / "final_model.npz"))["params"]
    cfg = TH.HumorConfig(**kw)
    assert ("prior" in params) == cfg.conditional_prior
    assert params["decoder"][0]["w"].shape[0] == cfg.past_data_dim + L
    assert params["decoder"][-1]["w"].shape[1] == cfg.output_data_dim
