"""The in-repo model fixture of humor_torch (humor_torch/testing.py)
against humor_tpu's (humor_tpu/testing.py) on the CPU, piece by piece:
optax.adam, the VPoser training loss, the mini-training loops' schedules
and batches, VPoser's sample_poses and the fixture's npz cache both ways.
The whole fixture's accuracy is in test_torch_accuracy.py (slow).

JAX's keys cannot be replayed in torch, so the loops are compared with
their steps recorded (the train steps and the VPoser loss replaced by
recorders in both packages): the batches, epochs and use-GT
probabilities must agree step by step. Tolerances: Adam 1e-12 in float64
and 1e-6 in float32 (relative); the VPoser loss and gradients 1e-6
(relative, max-scaled; in float64); batches 1e-6 (float32 rotations through
rotmat_to_aa in two packages), the joints and velocities at
test_torch_train_data.py's bounds; poses from the same latents 1e-4 (the
test_torch_modules.py VPoser precedent).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from humor_tpu import testing as JTST
from humor_tpu.body_model.smpl import synthetic_smpl_model
from humor_tpu.models import humor as JH
from humor_tpu.models import vposer as jvp
from humor_tpu.train import step as JTS
from humor_tpu.utils import checkpoint as jckpt

from humor_torch import convert
from humor_torch import testing as TTST
from humor_torch.models import humor as TH
from humor_torch.models import vposer as tvp
from humor_torch.train import step as TS
from humor_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

BODY_J = synthetic_smpl_model()
BODY_T = convert.smpl_model(BODY_J)


def _np(x):
    return np.asarray(x)


def _tree(jp):
    return convert.params_tree(jax.tree_util.tree_map(np.asarray, jp))


def _max_scaled(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_adam_matches_optax(dtype, rtol):
    """make_optimizer(optim="adam") against the JAX package's (optax.adam
    behind apply_if_finite and the piecewise schedule, a milestone after
    2 applied steps) over 5 steps, one of them with a NaN gradient
    (skipped); and Adam(2e-3) against plain optax.adam(2e-3), the VPoser
    fixture's."""
    rng = np.random.RandomState(0)
    params = {"a": [{"w": rng.randn(5, 3).astype(dtype)}],
              "b": rng.randn(7).astype(dtype)}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** (i - 2)).astype(dtype),
        params) for i in range(5)]
    grads[2]["b"][1] = np.nan
    with jax.enable_x64(dtype == np.float64):
        for opt_j, opt_t in (
                (JTS.make_optimizer(lr=0.1, milestones=(1,), decays=(0.5,),
                                    steps_per_epoch=2, optim="adam"),
                 TS.make_optimizer(lr=0.1, milestones=(1,), decays=(0.5,),
                                   steps_per_epoch=2, optim="adam")),
                (optax.adam(2e-3), TS.Adam(lr=2e-3))):
            plain = opt_t.boundaries == ()
            pj = jax.tree_util.tree_map(jnp.asarray, params)
            sj = opt_j.init(pj)
            state = TS.make_train_state(
                TS.tree_map(lambda a: torch.as_tensor(a),
                            {"a": [{"w": params["a"][0]["w"]}],
                             "b": params["b"]}), opt_t)
            st = state.opt_state
            for i, g in enumerate(grads):
                if plain and i == 2:
                    continue        # plain optax.adam applies NaNs
                upd, sj = opt_j.update(jax.tree_util.tree_map(jnp.asarray,
                                                              g), sj, pj)
                pj = optax.apply_updates(pj, upd)
                st = opt_t.update([torch.as_tensor(x) for x in
                                   jax.tree_util.tree_leaves(g)], st,
                                  state.params)
                for a, b in zip(jax.tree_util.tree_leaves(pj),
                                TS.tree_leaves(state.params)):
                    assert b.dtype == torch.from_numpy(params["b"]).dtype
                    np.testing.assert_allclose(
                        b.detach().numpy(), _np(a), rtol=rtol, atol=0,
                        err_msg=f"step {i}")
            assert int(st["count"]) == 4
            if not plain:
                assert int(st["total_notfinite"]) == 1


# ---------------------------------------------------------------------------
# VPoser: training loss, sample_poses
# ---------------------------------------------------------------------------

def _jax_vposer_loss(vcfg, p, batch):
    """humor_tpu/testing.py's loss_fn in train_mini_vposer, verbatim."""
    mu, std = jvp.encode(vcfg, p, batch)
    rec = jvp.latent2pose(vcfg, p, mu)
    kl = 0.5 * jnp.mean(mu ** 2 + std ** 2
                        - 2 * jnp.log(std + 1e-8) - 1)
    return jnp.mean(jnp.square(rec - batch)) + 1e-3 * kl


def test_vposer_train_loss_matches_jax():
    """In float64, where both evaluate the same expression (in float32
    the gradients part by 1.9e-5 max-scaled, measured: the encoder's
    softplus and the 6d Gram-Schmidt round differently)."""
    vcfg = jvp.VPoserConfig(hidden=96)
    with jax.enable_x64(True):
        _vposer_train_loss(vcfg)


def _vposer_train_loss(vcfg):
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64),
        jvp.init_params(vcfg, jax.random.PRNGKey(3)))
    poses = _np(TTST.vposer_training_poses(BODY_T, 13))[:256].astype(
        np.float64)
    lj, gj = jax.value_and_grad(lambda p: _jax_vposer_loss(
        vcfg, p, jnp.asarray(poses)))(jp)
    tp = TS.tree_map(lambda a: a.double().requires_grad_(True), _tree(jp))
    lt = tvp.train_loss(tvp.VPoserConfig(hidden=96), tp,
                        torch.as_tensor(poses))
    gt = torch.autograd.grad(lt, TS.tree_leaves(tp))
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * abs(float(lj))
    jleaves = [_np(x) for x in jax.tree_util.tree_leaves(gj)]
    assert len(jleaves) == len(gt)
    worst = max(_max_scaled(a.numpy(), b) for a, b in zip(gt, jleaves))
    assert worst <= 1e-6, worst


def test_sample_poses_matches_jax():
    vcfg = jvp.VPoserConfig()
    jp = jvp.init_params(vcfg, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(5)
    ref = jvp.sample_poses(vcfg, jp, key, 6)
    z = torch.as_tensor(_np(jax.random.normal(key, (6, vcfg.latent_dim))))
    out = tvp.sample_poses(tvp.VPoserConfig(), _tree(jp), 6, z=z)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-4)
    drawn = tvp.sample_poses(tvp.VPoserConfig(), _tree(jp), 6,
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 63) and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# the training loops, recorded
# ---------------------------------------------------------------------------

SUP, SS, BATCH, FRAMES, SS_LEN = 130, 110, 4, 3, 4
# test_torch_train_data.py's bounds on the synthetic generator's joints
# and velocities ((x_{t+1} - x_t) * fps of 1e-5 m joints)
BATCH_ATOL = {"joints": 1e-5, "root_orient_vel": 1e-5, "joints_vel": 1e-3}


def _record_humor_jax(monkeypatch):
    calls = []

    def fake_steps(cfg, loss_cfg, opt, smpl_models, **kw):
        def sup(state, batch, key, epoch):
            calls.append(("sup", batch, epoch, None))
            return state, {}

        def ss(state, batch, key, epoch, p_gt):
            calls.append(("ss", batch, epoch, p_gt))
            return state, {}
        return sup, ss, None
    monkeypatch.setattr(JTS, "make_train_steps", fake_steps)
    JTST.train_mini_humor(BODY_J, JH.HumorConfig(), sup_steps=SUP,
                          ss_steps=SS, batch=BATCH, frames=FRAMES,
                          ss_len=SS_LEN)
    return calls


def _record_humor_port(monkeypatch):
    calls = []

    def fake_steps(cfg, loss_cfg, opt, smpl_models, **kw):
        assert smpl_models["male"] is smpl_models["female"]

        def sup(state, batch, epoch, generator=None):
            calls.append(("sup", batch, epoch, None))
            return state, {}

        def ss(state, batch, epoch, p_gt, generator=None):
            calls.append(("ss", batch, epoch, p_gt))
            return state, {}
        return sup, ss, None
    monkeypatch.setattr(TS, "make_train_steps", fake_steps)
    TTST.train_mini_humor(BODY_T, TH.HumorConfig(), sup_steps=SUP,
                          ss_steps=SS, batch=BATCH, frames=FRAMES,
                          ss_len=SS_LEN, device="cpu")
    return calls


def test_mini_humor_schedule_and_batches_match_jax(monkeypatch):
    """Every step's phase, batch, epoch and use-GT probability, the
    scheduled sampling on ss_len-frame windows of seeds 100..119, at
    batch 4 x 3 (epochs 0-2, p_gt down to 0)."""
    jc = _record_humor_jax(monkeypatch)
    tc = _record_humor_port(monkeypatch)
    assert len(jc) == len(tc) == SUP + SS
    assert [(c[0], c[2]) for c in tc] == [(c[0], int(c[2])) for c in jc]
    np.testing.assert_array_equal([c[3] or 0.0 for c in tc],
                                  [float(c[3] or 0.0) for c in jc])
    assert {c[2] for c in tc[:SUP]} == {0, 1, 2} and tc[-1][3] == 0.0
    for (_, bt, _, _), (_, bj, _, _) in zip(tc, jc):
        for part in ("data_in", "data_out"):
            for k, v in bj[part].items():
                np.testing.assert_allclose(bt[part][k].numpy(), _np(v),
                                           atol=BATCH_ATOL.get(k, 1e-6),
                                           err_msg=k)
        np.testing.assert_array_equal(bt["gender_ids"].numpy(),
                                      _np(bj["gender_ids"]))
        np.testing.assert_allclose(bt["betas"].numpy(), _np(bj["betas"]),
                                   atol=1e-7)
    assert tc[SUP][1]["data_in"]["trans"].shape[1] == SS_LEN


def test_mini_vposer_batches_match_jax(monkeypatch):
    """The batches of 256 poses numpy's RandomState(0) picks, step by
    step (the step replaced by a recorder in JAX, the loss in the
    port)."""
    steps, n_seqs = 4, 13
    jb, tb = [], []
    real_jit = jax.jit

    def fake_jit(fn, *args, **kwargs):
        if getattr(fn, "__name__", "") != "vstep":
            return real_jit(fn, *args, **kwargs)

        def step(params, ostate, batch):
            jb.append(_np(batch))
            return params, ostate, 0.0
        return step
    monkeypatch.setattr(jax, "jit", fake_jit)
    JTST.train_mini_vposer(BODY_J, steps=steps, n_seqs=n_seqs)
    monkeypatch.undo()

    def fake_loss(cfg, params, batch):
        tb.append(batch.numpy().copy())
        return sum((p * 0).sum() for p in TS.tree_leaves(params))
    monkeypatch.setattr(tvp, "train_loss", fake_loss)
    TTST.train_mini_vposer(BODY_T, steps=steps, n_seqs=n_seqs,
                           device="cpu")
    assert len(jb) == len(tb) == steps
    for a, b in zip(tb, jb):
        assert a.shape == (256, 63)
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_mini_training_runs_at_small_size():
    """The real loops for a few steps on the CPU: the weights move and
    stay finite, VPoser's round trip is finite."""
    cfg = TH.HumorConfig()
    p0 = TH.init_params(cfg, torch.Generator().manual_seed(0))
    p1 = TTST.train_mini_humor(BODY_T, cfg, sup_steps=2, ss_steps=2,
                               batch=2, frames=3, ss_len=4, params=p0,
                               device="cpu")
    moved = max(float((a - b).abs().max()) for a, b in
                zip(TS.tree_leaves(p0), TS.tree_leaves(p1)))
    assert moved > 0 and all(torch.isfinite(x).all()
                             for x in TS.tree_leaves(p1))
    vcfg, vp1 = TTST.train_mini_vposer(BODY_T, steps=2, n_seqs=13,
                                       device="cpu")
    assert vcfg.hidden == 96
    mae = TTST.vposer_roundtrip_mae(vcfg, vp1,
                                    TTST.vposer_training_poses(BODY_T, 13))
    assert np.isfinite(mae)


# ---------------------------------------------------------------------------
# the npz cache, both ways
# ---------------------------------------------------------------------------

def test_cache_reads_a_jax_written_npz(tmp_path):
    path = str(tmp_path / "fixture.npz")
    jh = JH.init_params(JH.HumorConfig(), jax.random.PRNGKey(0))
    jv = jvp.init_params(jvp.VPoserConfig(hidden=96), jax.random.PRNGKey(3))
    jckpt.save_state(path, {"humor": jh, "vposer": jv})
    m = TTST.trained_tto_models(cache=path, device="cpu")
    assert m.vposer_cfg.hidden == 96 and m.humor_cfg == TH.HumorConfig()
    for a, b in zip(jax.tree_util.tree_leaves(jh),
                    TS.tree_leaves(m.humor)):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    for a, b in zip(jax.tree_util.tree_leaves(jv),
                    TS.tree_leaves(m.vposer)):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    np.testing.assert_array_equal(m.body.v_template.numpy(),
                                  _np(BODY_J.v_template))


def test_port_cache_read_by_jax(tmp_path):
    """The port writes its cache in the JAX package's layout: JAX's
    trained_tto_models reads it."""
    path = str(tmp_path / "fixture.npz")
    th = TH.init_params(TH.HumorConfig(), torch.Generator().manual_seed(0))
    tv = tvp.init_params(tvp.VPoserConfig(hidden=96),
                         torch.Generator().manual_seed(3))
    tckpt.save_state(path, {"humor": th, "vposer": tv})
    m = JTST.trained_tto_models(cache=path)
    for a, b in zip(jax.tree_util.tree_leaves(m.humor),
                    TS.tree_leaves(th)):
        np.testing.assert_array_equal(_np(a), b.numpy())
    assert os.path.exists(path)


def test_fixture_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTST.trained_tto_models()
