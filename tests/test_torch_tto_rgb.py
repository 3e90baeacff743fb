"""The RGB video fit of humor_torch against humor_tpu on the CPU: OpenPose
2D keypoints of a seeded 18-frame video cut into B=3 windows of T=8
(seq_interval [[0, 8], [5, 13], [10, 18]]), a floor plane, the 256-vertex
synthetic body (2 of its vertices are keypoint vertices), bench_tto.py's
RGB stage weights with the overlap consistency at 200 and `optim_floor`.
The overlap terms themselves at every overlap length, the folding of
K=8 line-search candidates into the rows, the depth init from bone
lengths, and each stage objective with and without the previous batch's
result. The whole runner is in test_torch_tto_rgb_runner.py.

Tolerances: the overlap functions 1e-10 (float64 on both sides); the
folded candidates' row sums rtol 1e-6 of JAX's per-candidate scalars
(float32); the depth init rtol 1e-5; objective values rtol 1e-4 and
gradients 1e-3 of their max (test_torch_tto_prox.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humor_tpu.body_model import smpl as jsmpl
from humor_tpu.fitting import energies as JE
from humor_tpu.fitting import geometry as JG
from humor_tpu.fitting import optimizer as JO
from humor_tpu.models import vposer as jvp

from humor_torch import device as D
from humor_torch.body_model import constants as C
from humor_torch.fitting import energies as TE
from humor_torch.fitting import optimizer as TO

from test_torch_tto import _compare, models  # noqa: F401
from test_torch_tto_prox import _jax_cam2prior

torch.set_num_threads(2)

B, T, K = 3, 8, 8
FRAMES = 18
SEQ_INTERVAL = np.asarray([[0, 8], [5, 13], [10, 18]], np.int32)
ITERS = (3, 3, 3)
SMPL2OP = tuple(i % 22 for i in range(25))
CAM_F = np.tile([[1060.5, 1060.4]], (B, 1)).astype(np.float32)
CAM_C = np.tile([[951.3, 536.8]], (B, 1)).astype(np.float32)
FLOOR = np.tile([[0.0, 1.0, 0.0, 1.5]], (B, 1)).astype(np.float32)
# the previous batch's last window [-5, 3): 3 frames shared with window 0
PREV_INTERVAL = np.asarray([-5, 3], np.int32)


def _weights(mod):
    """benchmarks/bench_tto.py's RGB stage weights."""
    return (
        mod.StageWeights(joints2d=0.001, joints3d_smooth=100.0,
                         rgb_overlap_consist=200.0),
        mod.StageWeights(joints2d=0.001, pose_prior=2e-4, shape_prior=1.67e-4,
                         joints3d_smooth=100.0, rgb_overlap_consist=200.0),
        mod.StageWeights(joints2d=0.001, pose_prior=2e-4, shape_prior=1.67e-4,
                         motion_prior=1e-3, init_motion_prior=1e-3,
                         joint_consistency=1.0, bone_length=10.0,
                         contact_vel=1.0, contact_height=1.0, floor_reg=0.167,
                         rgb_overlap_consist=200.0))


def _cfg(O, E):
    return O.TTOConfig(
        seq_len=T, stage_weights=_weights(E),
        energy=E.EnergyConfig(smpl2op_map=SMPL2OP), num_iters=ITERS,
        optim_floor=True, stage3_tune_init_num_frames=5,
        stage3_freeze_start=1, stage3_freeze_end=2)


CFG_J, CFG_T = _cfg(JO, JE), _cfg(TO, TE)


def _jx(tree):
    """numpy tree -> JAX, float32 except the integer intervals."""
    if isinstance(tree, dict):
        return {k: _jx(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return jnp.asarray(a if a.dtype.kind == "i" else a.astype(np.float32))


def _th(tree):
    if isinstance(tree, dict):
        return {k: _th(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.tensor(a if a.dtype.kind == "i" else a.astype(np.float32))


@pytest.fixture(scope="module")
def observed(models):
    """A VPoser pose sequence of 18 frames ~2.5 m in front of the camera
    (-y up), its OpenPose joints projected with 2 px noise and confidence
    1, cut into the three overlapping windows."""
    jm, _ = models
    rng = np.random.RandomState(0)
    z = jnp.asarray(rng.randn(1, FRAMES, 32) * 0.3, jnp.float32)
    pose = jvp.latent2pose(jm.vposer_cfg, jm.vposer, z)
    trans = jnp.asarray(rng.randn(1, FRAMES, 3) * 0.1 + [0.0, 0.3, 2.5],
                        jnp.float32)
    ro = jnp.asarray(np.tile(rng.randn(1, 1, 3) * 0.2, (1, FRAMES, 1)),
                     jnp.float32)
    gt = JO.smpl_results(jm.body, trans, ro, pose, jnp.zeros((1, 16)),
                         verts="none")
    full = jnp.concatenate([gt["joints3d"], gt["joints3d_extra"]], axis=2)
    op3d = full[:, :, np.asarray(SMPL2OP)].reshape(FRAMES, 25, 3)
    uv = JG.perspective_projection(
        op3d, jnp.broadcast_to(jnp.eye(3), (FRAMES, 3, 3)),
        jnp.zeros((FRAMES, 3)), jnp.repeat(CAM_F[:1], FRAMES, 0),
        jnp.repeat(CAM_C[:1], FRAMES, 0))
    uv = np.asarray(uv) + rng.randn(FRAMES, 25, 2) * 2.0
    video = np.concatenate([uv, np.ones((FRAMES, 25, 1))], -1)
    j2d = np.stack([video[s:e] for s, e in SEQ_INTERVAL]).astype(np.float32)
    return {"joints2d": j2d, "cam_f": CAM_F, "cam_center": CAM_C,
            "floor_plane": FLOOR, "seq_interval": SEQ_INTERVAL}


def _prev_result(seed, nv=2, tp=T):
    rng = np.random.RandomState(seed)
    return {"verts3d": rng.randn(tp, nv, 3) * 0.1 + [0.0, 0.3, 2.5],
            "betas": rng.randn(16) * 0.1,
            "floor_plane": np.asarray([0.02, 0.999, 0.03, 1.45]),
            "seq_interval": PREV_INTERVAL}


# ---------------------------------------------------------------------------
# The overlap terms
# ---------------------------------------------------------------------------

@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _intervals(ov_a, ov_b):
    """Three windows of T frames overlapping by ov_a, then by ov_b."""
    s1 = T - ov_a
    s2 = s1 + T - ov_b
    return np.asarray([[0, T], [s1, s1 + T], [s2, s2 + T]], np.int64)


@pytest.mark.parametrize("overlap", [0, 1, 3, T - 1, T])
def test_overlap_functions_match_jax(x64, overlap):
    """_masked_overlap_l2 (with and without velocities),
    overlap_consist_loss (its two pairs overlapping by `overlap` and by
    T - overlap, the pair on its first window's row) and
    xbatch_overlap_loss, in float64."""
    rng = np.random.RandomState(overlap)
    prev, cur = rng.randn(T, 4, 3), rng.randn(T, 4, 3)
    for vel in (False, True):
        ref = JE._masked_overlap_l2(jnp.asarray(prev), jnp.asarray(cur),
                                    jnp.asarray(overlap), vel)
        out = TE._masked_overlap_l2(torch.tensor(prev), torch.tensor(cur),
                                    torch.tensor(overlap), vel)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12)
    verts = rng.randn(B, T, 4, 3)
    iv = _intervals(overlap, T - overlap)
    rows = TE.overlap_consist_loss(torch.tensor(verts), torch.tensor(iv))
    assert tuple(rows.shape) == (B,) and float(rows[-1]) == 0.0
    for b in range(B - 1):
        ref = sum(JE._masked_overlap_l2(jnp.asarray(verts[b]),
                                        jnp.asarray(verts[b + 1]),
                                        jnp.asarray(iv[b, 1] - iv[b + 1, 0]),
                                        True))
        np.testing.assert_allclose(float(rows[b]), float(ref), rtol=1e-10,
                                   atol=1e-12)
    ref = JE.overlap_consist_loss(jnp.asarray(verts), jnp.asarray(iv))
    np.testing.assert_allclose(float(rows.sum()), float(ref), rtol=1e-10,
                               atol=1e-12)
    out = TE.xbatch_overlap_loss(torch.tensor(verts[:1]), torch.tensor(prev),
                                 torch.tensor(overlap))
    ref = JE.xbatch_overlap_loss(jnp.asarray(verts[0]), jnp.asarray(prev),
                                 jnp.asarray(overlap))
    np.testing.assert_allclose(float(out[0]), float(ref), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("tp,overlap", [(5, 3), (5, 7), (3, 8), (12, 4),
                                        (12, 10)])
def test_xbatch_overlap_other_lengths(x64, tp, overlap):
    """The cross-batch term against a previous window of Tp != T frames,
    including an overlap longer than it (a stage-3 sub-window cache)."""
    rng = np.random.RandomState(tp * 31 + overlap)
    cur, prev = rng.randn(2, T, 4, 3), rng.randn(tp, 4, 3)
    out = TE.xbatch_overlap_loss(torch.tensor(cur), torch.tensor(prev),
                                 torch.tensor(overlap))
    for k in range(2):
        ref = JE.xbatch_overlap_loss(jnp.asarray(cur[k]), jnp.asarray(prev),
                                     jnp.asarray(overlap))
        np.testing.assert_allclose(float(out[k]), float(ref), rtol=1e-10,
                                   atol=1e-12)


def test_overlap_terms_fold_candidates():
    """K=8 distinct candidates folded into K*B rows, as the line search
    evaluates them: every overlap term of root_fit, smpl_fit and
    motion_fit (within the batch and against the previous batch) returns
    one value per row, and each candidate's row sum is JAX's scalar for
    that candidate's (B, ...) slice. A roll over the flat rows would pair
    candidate k's last window with candidate k+1's first and fail."""
    rng = np.random.RandomState(5)
    w = JE.StageWeights(rgb_overlap_consist=200.0)
    wt = TE.StageWeights(rgb_overlap_consist=200.0)
    pred = {"verts3d": rng.randn(K * B, T, 2, 3),
            "betas": rng.randn(K * B, 16) * 0.1,
            "floor_plane": rng.randn(K * B, 3) * 0.1 + [0.0, 1.5, 0.0],
            "joints3d": np.zeros((K * B, T, 22, 3))}   # only its rows read
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    ecfg_j, ecfg_t = JE.EnergyConfig(), TE.EnergyConfig()
    for with_prev in (False, True):
        obs = {"seq_interval": SEQ_INTERVAL}
        if with_prev:
            obs["prev_batch_overlap_res"] = _prev_result(6)
        obs_j, obs_t = _jx(obs), _th(obs)
        tp = _th(pred)
        rows = {
            "root": TE.root_fit(ecfg_t, wt, obs_t, tp),
            "smpl": TE.smpl_fit(ecfg_t, wt, obs_t, tp, T),
            "motion": TE.motion_fit(ecfg_t, wt, obs_t, {}, tp, T)}
        for name, r in rows.items():
            assert tuple(r.shape) == (K * B,), name
            per_cand = r.reshape(K, B).sum(1).numpy()
            for k in range(K):
                pk = _jx({n: v[k * B:(k + 1) * B] for n, v in pred.items()})
                if name == "root":
                    ref = JE.root_fit(ecfg_j, w, obs_j, pk)[0]
                elif name == "smpl":
                    ref = JE.smpl_fit(ecfg_j, w, obs_j, pk, T)[0]
                else:
                    ref = JE.motion_fit(ecfg_j, w, obs_j, {}, pk, T)[0]
                np.testing.assert_allclose(per_cand[k], float(ref),
                                           rtol=1e-6,
                                           err_msg=f"{name} {k} {with_prev}")


# ---------------------------------------------------------------------------
# Init, helpers, phases
# ---------------------------------------------------------------------------

def test_depth_init_matches_jax(models, observed):
    """init_variables' depth from bone lengths: at the fixture (every
    frame fully confident, so every frame ties and both take the first),
    and with zero confidences: window 0's frame 0 has no keypoints,
    frames 2 and 5 tie with the most (different 2D bones: taking the
    last would move the depth), window 2 has half its joints at zero."""
    jm, tm = models
    obs = dict(observed)
    j2d = obs["joints2d"].copy()
    j2d[0, :, 3:6, 2] = 0.0
    j2d[0, 0, :, 2] = 0.0
    j2d[0, 2, 3:6, 2] = 1.0
    j2d[0, 5, 3:6, 2] = 0.7
    j2d[0, 5, :, :2] *= 1.3
    j2d[2, :, ::2, 2] = 0.0
    j2d[1, 4, :, 2] = 0.0
    for o in (observed, dict(obs, joints2d=j2d)):
        ref = JO.init_variables(CFG_J, jm, B, _jx(o))
        out = TO.init_variables(CFG_T, tm, B, _th(o), "cpu")
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    # the tie goes to the first frame: frame 5's bones are 1.3x frame 2's
    z = out["trans"][0, 0, 2].item()
    o2 = dict(obs, joints2d=j2d.copy())
    o2["joints2d"][0, 5, 3:6, 2] = 0.0
    z2 = TO.init_variables(CFG_T, tm, B, _th(o2), "cpu")["trans"][0, 0, 2]
    assert abs(z - float(z2)) < 1e-6 * abs(z)


def test_helpers_and_phases():
    """The keypoint vertices are skinned for the overlap term, the batch
    size skips the previous batch's result, and stage 3's first phase
    runs without the overlap terms."""
    obs = _th({"prev_batch_overlap_res": _prev_result(1, tp=4),
               "seq_interval": SEQ_INTERVAL,
               "cam_f": np.ones((B, 2), np.float32)})
    assert TO.verts_mode_for(obs) == JO.verts_mode_for(obs) == "keypt"
    assert TO.batch_size_of(obs) == B
    phases = TO.stage3_phases(CFG_T)
    assert [p[0].rgb_overlap_consist for p in phases] == [0.0, 200.0, 200.0]
    assert [p[1] for p in phases] == [5, T, T]


def test_tile_observations():
    """For K candidates the per-window observations are tiled
    candidate-major to K*B rows; seq_interval and the previous batch's
    result pass through as they are."""
    K = 3
    obs = _th({"joints2d": np.arange(B * T * 25 * 3, dtype=np.float32)
               .reshape(B, T, 25, 3), "seq_interval": SEQ_INTERVAL,
               "prev_batch_overlap_res": _prev_result(1, tp=4)})
    out = TO.tile_observations(obs, K)
    assert out["seq_interval"] is obs["seq_interval"]
    assert out["prev_batch_overlap_res"] is obs["prev_batch_overlap_res"]
    assert tuple(out["joints2d"].shape) == (K * B, T, 25, 3)
    for k in range(K):
        assert torch.equal(out["joints2d"][k * B:(k + 1) * B],
                           obs["joints2d"])


# ---------------------------------------------------------------------------
# Stage objectives
# ---------------------------------------------------------------------------

def _stage12_vars(seed):
    rng = np.random.RandomState(seed)
    root = rng.randn(B, T, 3) * 0.3
    root[..., 0] += np.pi
    return {"trans": rng.randn(B, T, 3) * 0.1 + [0.0, 0.3, 2.5],
            "root_orient": root, "latent_pose": rng.randn(B, T, 32) * 0.3,
            "betas": rng.randn(B, 16) * 0.1,
            "floor_plane": FLOOR[:, :3] * FLOOR[:, 3:]
            + rng.randn(B, 3) * 0.05}


def _with_prev(observed, prev):
    return dict(observed, prev_batch_overlap_res=_prev_result(9)) \
        if prev else observed


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("stage", [1, 2])
def test_stage12_objective_matches(models, observed, stage, prev):
    """Stages 1-2 (the port's stage 1 on its skin-once rigid path) with
    the keypoint-vertex and betas overlap terms, against JAX's full
    LBS objective."""
    jm, tm = models
    v = _stage12_vars(stage)
    obs = _with_prev(observed, prev)
    obs_j = _jx(obs)

    def jloss(vv):
        pred, _ = JO._stage12_pred(jm, vv, obs_j)
        if stage == 1:
            return JE.root_fit(CFG_J.energy, CFG_J.stage_weights[0], obs_j,
                               pred)[0]
        return JE.smpl_fit(CFG_J.energy, CFG_J.stage_weights[1], obs_j, pred,
                           T)[0]

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(_jx(v))
    fm = TO.prepare_models(tm, "cpu")
    tv = _th(v)
    if stage == 1:
        fn = TO.stage1_objective(CFG_T, fm, tv, TO.verts_mode_for(obs))
        keys = ("trans", "root_orient")
    else:
        fn = TO.stage2_objective(CFG_T, fm)
        keys = ("trans", "root_orient", "latent_pose", "betas")
    obs_t = _th(obs)
    _compare(jval, jgrad, lambda vv: fn(vv, obs_t), tv, keys)


def _jax_stage3_setup(jm, v):
    """optimizer.make_runner's _stage3_setup_body with optim_floor."""
    body_pose = jvp.latent2pose(jm.vposer_cfg, jm.vposer, v["latent_pose"])
    R, t, rh = _jax_cam2prior(jm, v)
    pr = JG.apply_cam2prior(
        v["trans"], v["root_orient"], R, t, rh, jnp.zeros((B,), jnp.int32),
        smpl_root_joint_fn=lambda tr, ro: JO.smpl_results(
            jm.body, tr, ro, body_pose, v["betas"],
            verts="none")["joints3d"][..., 0, 2])
    z = JO.infer_latent_motion(jm, pr["trans"], pr["root_orient"], body_pose,
                               v["betas"], CFG_J.data_fps)
    tv, jv, rv = JO.estimate_velocities(jm.body, pr["trans"],
                                        pr["root_orient"], body_pose,
                                        v["betas"], CFG_J.data_fps)
    return {"trans": v["trans"][:, :1], "root_orient": v["root_orient"][:, :1],
            "latent_pose": v["latent_pose"][:, :1], "betas": v["betas"],
            "latent_motion": z, "trans_vel": tv[:, :1],
            "joints_vel": jv[:, :1], "root_orient_vel": rv[:, :1],
            "floor_plane": v["floor_plane"]}


def _jax_stage3_loss(jm, weights, nsteps, scale):
    """optimizer.make_runner's stage3_loss_fn with optim_floor."""
    def loss(v, observed):
        c2p = _jax_cam2prior(jm, v)
        zm = v["latent_motion"][:, : nsteps - 1]
        prior_out, _ = JO.rollout_latent_motion(CFG_J, jm, v, zm,
                                                cam2prior=c2p)
        pred = JO.smpl_results(jm.body, prior_out["trans"],
                               prior_out["root_orient"],
                               prior_out["pose_body"], v["betas"],
                               verts=JO.verts_mode_for(observed))
        pred["latent_pose"] = jvp.pose2latent(jm.vposer_cfg, jm.vposer,
                                              prior_out["pose_body"])
        pred["betas"] = v["betas"]
        pred["latent_motion"] = zm
        for k in ("joints_vel", "trans_vel", "root_orient_vel"):
            pred[k] = v[k]
        pred["joints3d_rollout"] = prior_out["joints"]
        pred["contacts_conf"] = prior_out["contacts_conf"]
        R, t, _ = c2p
        j0 = jsmpl.rest_root_joint(jm.body, v["betas"])
        shift = (prior_out["trans"][:, 0] + j0)[:, None, None]
        off = (j0 - t)[:, None, None]
        cam_pred = {k: jnp.einsum("bji,btnj->btni", R, pred[k] - shift,
                                  precision=jax.lax.Precision.HIGHEST) + off
                    for k in ("joints3d", "joints3d_extra", "verts3d")}
        cam_pred["latent_pose"] = pred["latent_pose"]
        cam_pred["betas"] = v["betas"]
        cam_pred["floor_plane"] = v["floor_plane"]
        obs = JO.slice_observations(observed, nsteps)
        return JE.motion_fit(CFG_J.energy, weights, obs, pred, cam_pred,
                             nsteps, gmm=jm.init_gmm,
                             cond_prior=prior_out["cond_prior"],
                             init_motion_scale=scale)[0]
    return loss


@pytest.mark.parametrize("prev", [False, True])
def test_stage3_objective_matches(models, observed, prev):
    """Stage 3 over the whole window (phases B and C) with cam2prior, the
    rigid camera map, and the keypoint-vertex, betas and floor overlap
    terms, through the rollout's autograd Function."""
    jm, tm = models
    base = jax.jit(lambda vv: _jax_stage3_setup(jm, vv))(
        _jx(_stage12_vars(4)))
    v = {k: np.asarray(x) for k, x in base.items()}
    obs = _with_prev(observed, prev)
    obs_j = _jx(obs)
    scale = T / 5.0
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda vv: _jax_stage3_loss(jm, CFG_J.stage_weights[2], T, scale)(
            vv, obs_j)))(_jx(v))
    fn = TO.stage3_objective(TO.prepare_models(tm, "cpu"),
                             CFG_T.stage_weights[2], T, scale, CFG_T.energy,
                             optim_floor=True)
    obs_t = _th(obs)
    _compare(jval, jgrad, lambda vv: fn(vv, obs_t), _th(v), tuple(v))


def test_stage3_indices_stay_on_the_device(models, observed):
    """One stage-3 evaluation on the CPU (value and gradient) leaves its
    constant index tensors in device._INDEX: the OpenPose map, the
    skeleton's parents, the contact joints and the skinned vertices; a
    second evaluation makes none."""
    _, tm = models
    fm = TO.prepare_models(tm, "cpu")
    v = TO.stage3_setup(CFG_T, fm, _th(_stage12_vars(4)))
    fn = TO.stage3_objective(fm, CFG_T.stage_weights[2], T, T / 5.0,
                             CFG_T.energy, optim_floor=True)
    obs = _th(_with_prev(observed, True))

    def evaluate():
        leaves = {k: x.detach().clone().requires_grad_(True)
                  for k, x in v.items()}
        torch.autograd.grad(fn(leaves, obs).sum(), list(leaves.values()))

    evaluate()
    skinned = np.concatenate([TO._keypt_ids(fm.models.body),
                              fm.models.body.vtx_joint_ids])
    for name, ids in (("smpl2op_map", SMPL2OP),
                      ("parents", C.SMPL_PARENTS[1:]),
                      ("contacts", C.CONTACT_INDS), ("skinned", skinned)):
        key = (np.asarray(ids, np.int64).tobytes(), torch.device("cpu"))
        assert key in D._INDEX, name
    kept = dict(D._INDEX)
    evaluate()
    assert D._INDEX.keys() == kept.keys()
    assert all(D._INDEX[key] is idx for key, idx in kept.items())
