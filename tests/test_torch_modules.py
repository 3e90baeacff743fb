"""humor_torch modules against their humor_tpu counterparts on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
weights are carried over with humor_torch.convert. Tolerances are stated
per test: float32 summation-order differences for the rotation and
skinning math, and the RESULTS.md precedents for the networks (3e-4 per
model head, 5e-3 over a rollout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.models import gmm as jgmm
from humor_tpu.models import canonical as jcan
from humor_tpu.models import humor as JH
from humor_tpu.models import vposer as jvp
from humor_tpu.ops import mlp as jmlp
from humor_tpu.ops import rollout_step as JRS
from humor_tpu.ops import transforms as JT
from humor_tpu.utils import checkpoint as jckpt

from humor_torch import convert
from humor_torch.body_model import smpl as tsmpl
from humor_torch.models import canonical as tcan
from humor_torch.models import gmm as tgmm
from humor_torch.models import humor as TH
from humor_torch.models import vposer as tvp
from humor_torch.ops import mlp as tmlp
from humor_torch.ops import rollout_kernel as RK
from humor_torch.ops import transforms as TT

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _rot_inputs(rng, n):
    aa = rng.randn(n, 3).astype(np.float32)
    return aa, _np(JT.aa_to_rotmat(jnp.asarray(aa)))


# ---------------------------------------------------------------------------
# transforms: 1e-6 on generic inputs, 1e-5 at the singularities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", [
    "aa_to_rotmat", "rot6d_to_rotmat", "rotmat_to_quat", "quat_to_aa",
    "rotmat_to_aa", "compute_aligned_from_right",
    "compute_world2aligned_mat"])
def test_transforms_match(fn):
    rng = np.random.RandomState(0)
    aa, R = _rot_inputs(rng, 64)
    inputs = {
        "aa_to_rotmat": aa,
        "rot6d_to_rotmat": rng.randn(64, 6).astype(np.float32),
        "rotmat_to_quat": R,
        "quat_to_aa": rng.randn(64, 4).astype(np.float32),
        "rotmat_to_aa": R,
        "compute_aligned_from_right": rng.randn(64, 3).astype(np.float32),
        "compute_world2aligned_mat": R,
    }[fn]
    ref = _np(getattr(JT, fn)(jnp.asarray(inputs)))
    out = getattr(TT, fn)(_t(inputs)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_rotmat_products_match():
    rng = np.random.RandomState(1)
    A = rng.randn(8, 3, 3).astype(np.float32)
    Bm = rng.randn(8, 3, 3).astype(np.float32)
    pts = rng.randn(8, 5, 3).astype(np.float32)
    np.testing.assert_allclose(
        TT.rotmat_multiply(_t(A), _t(Bm)).numpy(),
        _np(JT.rotmat_multiply(jnp.asarray(A), jnp.asarray(Bm))), atol=1e-6)
    np.testing.assert_allclose(
        TT.rotmat_apply(_t(A), _t(pts)).numpy(),
        _np(JT.rotmat_apply(jnp.asarray(A), jnp.asarray(pts))), atol=1e-6)


def test_transforms_singularities_values_and_grads():
    """Identity, near-identity, pi rotations and vertical headings: the
    float32-scale epsilons must give the same values and gradients."""
    aa = np.array([[0, 0, 0], [1e-7, 0, 0], [1e-3, -2e-3, 5e-4],
                   [np.pi, 0, 0], [0, np.pi - 1e-4, 0]], np.float32)
    R = _np(JT.aa_to_rotmat(jnp.asarray(aa)))
    right = np.array([[0, 0, 1], [1e-7, 0, 1], [1, 0, 0]], np.float32)

    def jfun(a, r, b):
        return (jnp.sum(jnp.sin(JT.aa_to_rotmat(a)))
                + jnp.sum(jnp.cos(JT.rotmat_to_aa(r)))
                + jnp.sum(JT.compute_aligned_from_right(b) ** 2 * 0.3
                          + JT.compute_aligned_from_right(b)))

    def tfun(a, r, b):
        return (torch.sum(torch.sin(TT.aa_to_rotmat(a)))
                + torch.sum(torch.cos(TT.rotmat_to_aa(r)))
                + torch.sum(TT.compute_aligned_from_right(b) ** 2 * 0.3
                            + TT.compute_aligned_from_right(b)))

    jv = jfun(jnp.asarray(aa), jnp.asarray(R), jnp.asarray(right))
    jg = jax.grad(jfun, argnums=(0, 1, 2))(jnp.asarray(aa), jnp.asarray(R),
                                           jnp.asarray(right))
    ts = [_t(x).requires_grad_() for x in (aa, R, right)]
    tv = tfun(*ts)
    tg = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# MLP / GroupNorm
# ---------------------------------------------------------------------------

def test_group_norm_and_mlp_match():
    rng = np.random.RandomState(2)
    params = jmlp.init_mlp(jax.random.PRNGKey(3), [20, 64, 32, 10],
                           skip_dim=4)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.randn(*p.shape), jnp.float32),
        params)
    x = rng.randn(5, 20).astype(np.float32)
    ref = _np(jmlp.mlp_apply(params, jnp.asarray(x), skip_dim=4))
    tp = convert.params_tree(jax.tree_util.tree_map(np.asarray, params))
    out = tmlp.mlp_apply(tp, _t(x), skip_dim=4).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# SMPL: lbs and forward in all three vert_ids modes, 1e-5
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bodies():
    jb = jsmpl.synthetic_smpl_model(num_verts=300)
    return jb, convert.smpl_model(jb)


def test_synthetic_body_matches_numpy_stream(bodies):
    jb, _ = bodies
    tb = tsmpl.synthetic_smpl_model(num_verts=300)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.parents, np.asarray(jb.parents))


@pytest.mark.parametrize("mode", ["full", "keypt", "none"])
def test_smpl_lbs_and_forward_match(bodies, mode):
    jb, tb = bodies
    rng = np.random.RandomState(4)
    B = 4
    vert_ids = {"full": None, "keypt": np.arange(0, 300, 7),
                "none": np.zeros((0,), np.int32)}[mode]
    betas = (rng.randn(B, 16) * 0.5).astype(np.float32)
    root = rng.randn(B, 3).astype(np.float32)
    pose = (rng.randn(B, 63) * 0.4).astype(np.float32)
    trans = rng.randn(B, 3).astype(np.float32)
    ref = jsmpl.forward(jb, jnp.asarray(root), jnp.asarray(pose),
                        jnp.asarray(betas), jnp.asarray(trans),
                        vert_ids=vert_ids)
    out = tsmpl.forward(tb, _t(root), _t(pose), _t(betas), _t(trans),
                        vert_ids=vert_ids)
    np.testing.assert_allclose(out.Jtr.numpy(), _np(ref.Jtr), atol=1e-5)
    np.testing.assert_allclose(out.v.numpy(), _np(ref.v), atol=1e-5)
    mats = _np(JT.aa_to_rotmat(jnp.asarray(
        np.concatenate([root[:, None], pose.reshape(B, 21, 3)], 1))))
    ref = jsmpl.lbs(jb, jnp.asarray(betas), jnp.asarray(mats),
                    jnp.asarray(trans), vert_ids=vert_ids)
    out = tsmpl.lbs(tb, _t(betas), _t(mats), _t(trans), vert_ids=vert_ids)
    np.testing.assert_allclose(out.v.numpy(), _np(ref.v), atol=1e-5)
    np.testing.assert_allclose(out.Jtr.numpy(), _np(ref.Jtr), atol=1e-5)
    np.testing.assert_allclose(
        tsmpl.rest_root_joint(tb, _t(betas)).numpy(),
        _np(jsmpl.rest_root_joint(jb, jnp.asarray(betas))), atol=1e-5)


def test_load_smpl_npz_matches(tmp_path):
    rng = np.random.RandomState(5)
    V, J = 50, 22
    path = str(tmp_path / "model.npz")
    np.savez(path, v_template=rng.randn(V, 3), shapedirs=rng.randn(V, 3, 10),
             posedirs=rng.randn(V, 3, 9 * (J - 1)),
             J_regressor=rng.rand(J, V), weights=rng.rand(V, J),
             kintree_table=np.stack([np.arange(J) - 1, np.arange(J)]),
             f=rng.randint(0, V, (20, 3)))
    jb = jsmpl.load_smpl_npz(path)
    tb = tsmpl.load_smpl_npz(path)
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      _np(getattr(jb, f)))
    np.testing.assert_array_equal(tb.parents, np.asarray(jb.parents))


# ---------------------------------------------------------------------------
# HuMoR: heads <= 3e-4, rollout <= 5e-3, infer_global_seq
# ---------------------------------------------------------------------------

CFG_J = JH.HumorConfig()
CFG_T = TH.HumorConfig()


@pytest.fixture(scope="module")
def humor_params():
    jp = JH.init_params(CFG_J, jax.random.PRNGKey(0))
    return jp, convert.params_tree(jax.tree_util.tree_map(np.asarray, jp))


def _state(rng, B, lead=()):
    sh = (B,) + lead
    return {
        "trans": rng.randn(*sh, 3).astype(np.float32),
        "trans_vel": (0.1 * rng.randn(*sh, 3)).astype(np.float32),
        "root_orient": _np(JT.aa_to_rotmat(jnp.asarray(
            rng.randn(*sh, 3).astype(np.float32)))).reshape(*sh, 9),
        "root_orient_vel": (0.1 * rng.randn(*sh, 3)).astype(np.float32),
        "pose_body": _np(JT.aa_to_rotmat(jnp.asarray(
            (0.3 * rng.randn(*sh, 21, 3)).astype(np.float32)))).reshape(
                *sh, 189),
        "joints": (0.5 * rng.randn(*sh, 66)).astype(np.float32),
        "joints_vel": (0.1 * rng.randn(*sh, 66)).astype(np.float32),
    }


def test_humor_heads_match(humor_params):
    jp, tp = humor_params
    rng = np.random.RandomState(6)
    past = rng.randn(4, 339).astype(np.float32)
    nxt = rng.randn(4, 339).astype(np.float32)
    z = rng.randn(4, 48).astype(np.float32)
    pairs = [
        (JH.prior(CFG_J, jp, jnp.asarray(past)), TH.prior(CFG_T, tp, _t(past))),
        (JH.posterior(CFG_J, jp, jnp.asarray(past), jnp.asarray(nxt)),
         TH.posterior(CFG_T, tp, _t(past), _t(nxt))),
    ]
    for (jm, jv), (tm, tv) in pairs:
        np.testing.assert_allclose(tm.numpy(), _np(jm), atol=3e-4)
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=3e-4)
    jd = JH.decode(CFG_J, jp, jnp.asarray(z), jnp.asarray(past))
    td = TH.decode(CFG_T, tp, _t(z), _t(past))
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), _np(jd[k]), atol=3e-4,
                                   err_msg=k)


@pytest.mark.parametrize("canon", [False, True])
def test_humor_rollout_matches(humor_params, canon):
    jp, tp = humor_params
    rng = np.random.RandomState(7)
    B, T = 3, 6
    st = _state(rng, B)
    z = (0.5 * rng.randn(B, T, 48)).astype(np.float32)
    ref = JH.rollout(CFG_J, jp, jax.random.PRNGKey(0),
                     {k: jnp.asarray(v) for k, v in st.items()}, T,
                     z_seq=jnp.asarray(z), canonicalize_input=canon,
                     uncanonicalize_output=canon)
    out = TH.rollout(CFG_T, tp, {k: _t(v) for k, v in st.items()}, T,
                     z_seq=_t(z), canonicalize_input=canon,
                     uncanonicalize_output=canon)
    for k in ref.world:
        np.testing.assert_allclose(out.world[k].numpy(), _np(ref.world[k]),
                                   atol=5e-3, err_msg=k)
    np.testing.assert_allclose(out.prior[0].numpy(), _np(ref.prior[0]),
                               atol=5e-3)
    np.testing.assert_allclose(out.prior[1].numpy(), _np(ref.prior[1]),
                               rtol=5e-3)


@pytest.mark.parametrize("invert", [False, True])
def test_canonical_frame_and_transform_match(invert):
    """frame_from_state + apply_world2local (both directions), 1e-5."""
    rng = np.random.RandomState(11)
    st = _state(rng, 4)
    jf = jcan.frame_from_state({k: jnp.asarray(v) for k, v in st.items()})
    tf = tcan.frame_from_state({k: _t(v) for k, v in st.items()})
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)
    ref = jcan.apply_world2local(jf, {k: jnp.asarray(v)
                                      for k, v in st.items()}, invert=invert)
    out = tcan.apply_world2local(tf, {k: _t(v) for k, v in st.items()},
                                 invert=invert)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), _np(ref[k]), atol=1e-5,
                                   err_msg=k)


def test_rollout_step_matches(humor_params):
    """One flat-carry transition: the plain step of the rollout kernels'
    layout (ops/rollout_kernel.step_forward, what the CPU runs), the
    state, g_rot and g_trans packed into its carry, against JAX's
    rollout_step; 3e-4 (the per-head precedent)."""
    jp, tp = humor_params
    rng = np.random.RandomState(12)
    st = _state(rng, 3)
    g_rot = _np(JT.aa_to_rotmat(jnp.asarray(rng.randn(3, 3).astype(
        np.float32))))
    g_trans = rng.randn(3, 3).astype(np.float32)
    t2j = (0.1 * rng.randn(3, 3)).astype(np.float32)
    z = (0.5 * rng.randn(3, 48)).astype(np.float32)
    jc, jo = JRS.rollout_step(
        CFG_J, jp, JRS.StepCarry({k: jnp.asarray(v) for k, v in st.items()},
                                 jnp.asarray(g_rot), jnp.asarray(g_trans)),
        jnp.asarray(z), jnp.asarray(t2j))
    carry = torch.cat([_t(st[k]) for k in RK.IN_NAMES]
                      + [_t(g_rot).reshape(3, 9), _t(g_trans)], dim=-1)
    out, nxt = RK.step_forward(RK.RolloutWeights(tp, "cpu"), carry, _t(z),
                               _t(t2j))
    world = {k: v[:, 0] for k, v in RK.world_to_dict(out[None]).items()}
    for k in jo.world:
        np.testing.assert_allclose(
            world[k].numpy(), _np(jo.world[k]).reshape(3, -1), atol=3e-4,
            err_msg=k)
    local = RK.world_to_dict(nxt[None])
    for k in jc.local:
        np.testing.assert_allclose(
            local[k][:, 0].numpy(), _np(jc.local[k]).reshape(3, -1),
            atol=3e-4, err_msg=k)
    np.testing.assert_allclose(nxt[:, 339:348].numpy(),
                               _np(jc.g_rot).reshape(3, 9), atol=1e-5)
    np.testing.assert_allclose(nxt[:, 348:351].numpy(), _np(jc.g_trans),
                               atol=3e-4)
    np.testing.assert_allclose(out[:, 396:444].numpy(), _np(jo.prior_var),
                               rtol=3e-4)


def test_infer_global_seq_matches(humor_params):
    jp, tp = humor_params
    rng = np.random.RandomState(8)
    seq = _state(rng, 2, (5,))
    ref = JH.infer_global_seq(CFG_J, jp,
                              {k: jnp.asarray(v) for k, v in seq.items()})
    out = TH.infer_global_seq(CFG_T, tp, {k: _t(v) for k, v in seq.items()})
    for (a, b) in ((out.prior, ref.prior), (out.posterior, ref.posterior)):
        np.testing.assert_allclose(a[0].numpy(), _np(b[0]), atol=3e-4)
        np.testing.assert_allclose(a[1].numpy(), _np(b[1]), rtol=3e-4)


def test_checkpoint_npz_converts(humor_params, tmp_path):
    """The npz files humor_tpu/utils/checkpoint.py writes load into the
    port's pytree bit for bit."""
    jp, tp = humor_params
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_state(path, jp, epoch=7, min_train_loss=1.5)
    loaded = convert.load_checkpoint(path)
    assert loaded["epoch"] == 7 and loaded["min_train_loss"] == 1.5
    flat_a = jax.tree_util.tree_leaves(tp)
    flat_b = jax.tree_util.tree_leaves(loaded["params"])
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# VPoser and the GMM
# ---------------------------------------------------------------------------

def test_vposer_matches():
    cfg_j, cfg_t = jvp.VPoserConfig(), tvp.VPoserConfig()
    jp = jvp.init_params(cfg_j, jax.random.PRNGKey(1))
    tp = convert.params_tree(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.RandomState(9)
    z = (0.5 * rng.randn(6, 32)).astype(np.float32)
    pose = _np(jvp.latent2pose(cfg_j, jp, jnp.asarray(z)))
    np.testing.assert_allclose(tvp.latent2pose(cfg_t, tp, _t(z)).numpy(),
                               pose, atol=1e-4)
    np.testing.assert_allclose(
        tvp.decode_matrot(cfg_t, tp, _t(z)).numpy(),
        _np(jvp.decode_matrot(cfg_j, jp, jnp.asarray(z))), atol=1e-5)
    np.testing.assert_allclose(
        tvp.pose2latent(cfg_t, tp, _t(pose)).numpy(),
        _np(jvp.pose2latent(cfg_j, jp, jnp.asarray(pose))), atol=1e-4)
    mu, std = tvp.encode(cfg_t, tp, _t(pose))
    jmu, jstd = jvp.encode(cfg_j, jp, jnp.asarray(pose))
    np.testing.assert_allclose(std.numpy(), _np(jstd), rtol=1e-4)


def test_gmm_log_prob_matches_and_nan_on_non_pd():
    rng = np.random.RandomState(10)
    K, D = 3, 138
    A = rng.randn(K, D, D).astype(np.float32) * 0.1
    covs = np.einsum("kij,klj->kil", A, A) + np.eye(D, dtype=np.float32)
    w = np.array([0.2, 0.5, 0.3], np.float32)
    means = rng.randn(K, D).astype(np.float32)
    x = rng.randn(5, D).astype(np.float32)
    jg = jgmm.GmmParams(jnp.asarray(w), jnp.asarray(means), jnp.asarray(covs))
    tg = convert.gmm_params(w, means, covs)
    np.testing.assert_allclose(tgmm.log_prob(tg, _t(x)).numpy(),
                               _np(jgmm.log_prob(jg, jnp.asarray(x))),
                               rtol=1e-4)
    bad = covs.copy()
    bad[1] = -np.eye(D, dtype=np.float32)
    ref = _np(jgmm.log_prob(jgmm.GmmParams(jnp.asarray(w), jnp.asarray(means),
                                           jnp.asarray(bad)),
                            jnp.asarray(x)))
    out = tgmm.log_prob(convert.gmm_params(w, means, bad), _t(x)).numpy()
    assert np.all(np.isnan(ref)) and np.all(np.isnan(out))
