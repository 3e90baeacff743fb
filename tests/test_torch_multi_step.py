"""humor_torch's k-step train dispatch on the CPU: make_multi_steps and
stack_batches (against k single steps in the port, and against the JAX
package's make_multi_steps), the device store's chunk gather and the
train CLI's chunk source (against stacked batches, and against the JAX
package's store), and the trainer's chunk loop (mirroring
tests/test_train_multi.py, tests/test_device_store.py and
tests/test_trainer_loop.py).

The draws are injected: the port is handed the posterior noise and the
curriculum's choices that JAX's split keys give, and a port chunk gets
the noise of its k single steps. Limits, each beside the gap measured on
the CPU:
  * chunk against k single steps in the port: equal, bit for bit (the
    same code in the same order);
  * against JAX over K = 3 Adamax steps (lr 1e-3): the first step's
    loss agrees to 6.7e-8 relative, as one step does
    (tests/test_torch_train_step.py); after it a weight whose gradient
    is within its float32 error of 0 may step the other way (Adamax
    moves it by about lr * g / (|g| + 1e-8)), and the gaps grow. So the
    per-step losses are held within 1e-5 relative (measured 2.0e-6), the
    grad norms within 3e-6 (measured 5.3e-7), and the params after K
    steps: every weight within 2 K lr, at most 1% of them more than 1e-5
    apart (measured 0.015% supervised, 0.19% scheduled sampling), and
    the gap's norm within 1e-2 of the update's (measured 6.4e-4,
    2.5e-3);
  * chunk gathers and chunk sources against stacked batches: equal at
    noise 0; the port's chunk against JAX's: within the gap of the two
    packed stores (one float32 ulp, 1.2e-7).
"""

import os

import jax
import numpy as np
import pytest
import torch

from humor_tpu.body_model.smpl import synthetic_smpl_model
from humor_tpu.data import dataset as JD
from humor_tpu.data import device_store as JDS
from humor_tpu.data.synthetic import synthetic_world_batch
from humor_tpu.data.windows import window_to_pairs
from humor_tpu.losses.elbo import LossConfig as JLossConfig
from humor_tpu.models import humor as JH
from humor_tpu.train import step as JTS

from humor_torch import convert
from humor_torch.data import dataset as TD
from humor_torch.data import device_store as TDS
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as TH
from humor_torch.train import step as TS
from humor_torch.train.trainer import (Trainer, TrainRunConfig,
                                       _AUTO_STEPS_PER_DISPATCH)
from humor_torch.utils.stats import StatTracker
from tests.test_dataset import _make_processed

torch.set_num_threads(2)

B, T, L, K = 8, 4, 48, 3
EPOCH = 3
LR = 1e-3
MODEL = synthetic_smpl_model()
NO_SMPL = LossConfig(smpl_joint_loss=0.0, smpl_mesh_loss=0.0,
                     smpl_joint_consistency_loss=0.0)


def _jax_batch(seed, b=B, t=T):
    world, meta = synthetic_world_batch(seed, b, t + 1, model=MODEL)
    data_in, data_out, _ = window_to_pairs(world)
    return {"data_in": data_in, "data_out": data_out,
            "betas": meta["betas"], "gender_ids": meta["gender_ids"]}


def _to_torch(bj):
    t = lambda x: torch.as_tensor(np.array(x))
    return {"data_in": {k: t(v) for k, v in bj["data_in"].items()},
            "data_out": {k: t(v) for k, v in bj["data_out"].items()},
            "betas": t(bj["betas"]), "gender_ids": t(bj["gender_ids"]).long()}


def _ss_draws(key, p, b=B, t=T):
    """JAX scheduled_sampling's draws for `key`: use_gt (T,), eps (T, B,
    L) (as tests/test_torch_train_step.py takes them)."""
    key, choice_key = jax.random.split(key)
    step_keys = jax.random.split(key, t)
    eps = np.stack([np.asarray(jax.random.normal(k, (b, L)))
                    for k in step_keys])
    use_gt = np.array(jax.random.bernoulli(choice_key, p, (t,)))
    use_gt[0] = True
    return use_gt, eps


def _port_steps(lr=LR):
    opt = TS.make_optimizer(lr=lr, steps_per_epoch=10)
    sup, ss, _ = TS.make_train_steps(TH.HumorConfig(), LossConfig(), opt,
                                     None)
    return opt, sup, ss


def _fresh(opt, params):
    return TS.make_train_state(params, opt)


def _leaves(state):
    return [p.detach().clone() for p in TS.tree_leaves(state.params)]


@pytest.fixture(scope="module")
def setup():
    opt_j = JTS.make_optimizer(lr=LR, steps_per_epoch=10)
    sup_j, ss_j, _ = JTS.make_train_steps(JH.HumorConfig(), JLossConfig(),
                                          opt_j, None)
    multi_sup_j, multi_ss_j = JTS.make_multi_steps(sup_j, ss_j, K)
    state_j = lambda: JTS.init_train_state(JH.HumorConfig(), opt_j,
                                           jax.random.PRNGKey(0))
    params = convert.params_tree(state_j().params)
    batches_j = [_jax_batch(s) for s in range(K)]
    batches_t = [_to_torch(b) for b in batches_j]
    return (multi_sup_j, multi_ss_j, state_j, params, batches_j,
            batches_t)


def _sup_eps(key):
    return np.stack([np.asarray(jax.random.normal(k, (B * T, L)))
                     for k in jax.random.split(key, K)])


@pytest.mark.parametrize("phase", ["sup", "ss"])
def test_multi_steps_equal_single_steps(setup, phase):
    """A chunk of K steps equals K single steps with the same draws, bit
    for bit: params, optimizer state and every stat."""
    *_, params, _, batches = setup
    opt, sup, ss = _port_steps()
    multi_sup, multi_ss = TS.make_multi_steps(sup, ss, K)
    g_single = torch.Generator().manual_seed(5)
    g_multi = torch.Generator().manual_seed(5)
    st = _fresh(opt, params)
    singles = []
    for b in batches:
        if phase == "sup":
            st, s = sup(st, b, EPOCH, generator=g_single)
        else:
            st, s = ss(st, b, 12, 0.5, generator=g_single)
        singles.append(s)
    stacked = TS.stack_batches(batches)
    if phase == "sup":
        st_k, stats_k = multi_sup(_fresh(opt, params), stacked, EPOCH,
                                  generator=g_multi)
    else:
        st_k, stats_k = multi_ss(_fresh(opt, params), stacked, 12, 0.5,
                                 generator=g_multi)
    assert st_k.step == st.step == K
    for a, b in zip(_leaves(st_k), _leaves(st)):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(TS.tree_leaves(st_k.opt_state[name]),
                        TS.tree_leaves(st.opt_state[name])):
            assert torch.equal(a, b)
    assert set(stats_k) == set(singles[0])
    for key, v in stats_k.items():
        assert v.shape == (K,)
        assert torch.equal(v, torch.stack([s[key] for s in singles])), key
    # the generators were drawn alike
    assert torch.equal(torch.rand(3, generator=g_single),
                       torch.rand(3, generator=g_multi))


def _check_against_jax(st_j, stats_j, st_t, stats_t, params0):
    np.testing.assert_allclose(stats_t["total_loss"].numpy(),
                               np.asarray(stats_j["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(stats_t["grad_norm"].numpy(),
                               np.asarray(stats_j["grad_norm"]), rtol=3e-6)
    jp = [np.asarray(x) for x in jax.tree_util.tree_leaves(st_j.params)]
    tp = [p.detach().numpy() for p in TS.tree_leaves(st_t.params)]
    apart = sum(int((np.abs(a - b) > 1e-5).sum()) for a, b in zip(tp, jp))
    assert apart <= 0.01 * sum(b.size for b in jp), apart
    for a, b in zip(tp, jp):
        assert np.abs(a - b).max() <= 2 * K * LR + 1e-7
    gap = sum(float(((a - b) ** 2).sum()) for a, b in zip(tp, jp))
    moved = sum(float(((b - p0.numpy()) ** 2).sum())
                for b, p0 in zip(jp, params0))
    assert moved > 0 and gap <= (1e-2) ** 2 * moved


def test_multi_sup_matches_jax(setup):
    multi_sup_j, _, state_j, params, batches_j, batches_t = setup
    key = jax.random.PRNGKey(42)
    st_j, stats_j = multi_sup_j(state_j(), JTS.stack_batches(batches_j),
                                key, EPOCH)
    opt, sup, ss = _port_steps()
    multi_sup, _ = TS.make_multi_steps(sup, ss, K)
    st0 = _fresh(opt, params)
    before = _leaves(st0)
    st_t, stats_t = multi_sup(st0, TS.stack_batches(batches_t), EPOCH,
                              eps=torch.as_tensor(_sup_eps(key)))
    _check_against_jax(st_j, stats_j, st_t, stats_t, before)


def test_multi_ss_matches_jax(setup):
    _, multi_ss_j, state_j, params, batches_j, batches_t = setup
    key = jax.random.PRNGKey(7)
    st_j, stats_j = multi_ss_j(state_j(), JTS.stack_batches(batches_j),
                               key, 12, 0.5)
    draws = [_ss_draws(k, 0.5) for k in jax.random.split(key, K)]
    opt, sup, ss = _port_steps()
    _, multi_ss = TS.make_multi_steps(sup, ss, K)
    st0 = _fresh(opt, params)
    before = _leaves(st0)
    st_t, stats_t = multi_ss(
        st0, TS.stack_batches(batches_t), 12, 0.5,
        use_gt=np.stack([u for u, _ in draws]),
        eps=torch.as_tensor(np.stack([e for _, e in draws])))
    _check_against_jax(st_j, stats_j, st_t, stats_t, before)


def test_stack_batches_stays_on_the_device():
    """Tensors stack with torch.stack on their own device (no host round
    trip); numbers become tensors."""
    dev = [{"a": torch.arange(3.0) + i, "b": [torch.full((2,), i)]}
           for i in range(4)]
    s = TS.stack_batches(dev)
    assert isinstance(s["a"], torch.Tensor) and s["a"].device == dev[0][
        "a"].device
    assert torch.equal(s["a"], torch.stack([d["a"] for d in dev]))
    assert torch.equal(s["b"][0], torch.stack([d["b"][0] for d in dev]))


@pytest.mark.parametrize("n", [K, 0], ids=["longer", "empty"])
def test_multi_step_rejects_a_chunk_of_the_wrong_size(setup, n):
    """A chunk holds 1 to k batches: K batches for k = K - 1, and none."""
    *_, params, _, batches = setup
    opt, sup, ss = _port_steps()
    multi_sup, _ = TS.make_multi_steps(sup, ss, K - 1)
    stacked = TS.tree_map(lambda x: x[:n], TS.stack_batches(batches))
    with pytest.raises(ValueError, match=f"chunk of {n} "):
        multi_sup(_fresh(opt, params), stacked, EPOCH)


# ---------------------------------------------------------------------------
# The chunk gather and the CLI's chunk source
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def processed():
    return _make_processed()


@pytest.fixture(scope="module")
def dataset(processed):
    return TD.AmassDataset.from_processed(processed)


@pytest.fixture(scope="module")
def staged(dataset):
    return TDS.maybe_stage(dataset, "cpu", mode=1)


def test_chunk_gather_matches_stacked_batches(staged):
    """One (k, B) gather equals k sample_windows calls stacked, bit for
    bit at noise 0."""
    seeds = [11, 12, 13]
    world_c, meta_c = staged.sample_window_chunk(seeds, 5, 11)
    for j, s in enumerate(seeds):
        world_b, meta_b = staged.sample_windows(s, 5, 11)
        for k in world_b:
            assert torch.equal(world_c[k][j], world_b[k]), k
        assert torch.equal(meta_c["betas"][j], meta_b["betas"])
        assert torch.equal(meta_c["gender_ids"][j], meta_b["gender_ids"])


def test_chunk_gather_matches_jax(processed, dataset, staged):
    """The port's chunk is the JAX package's store's chunk at noise 0:
    the same host-sampled windows, gathered from stores that the two
    packages pack from the same sequences to within one float32 ulp."""
    jds = JD.AmassDataset.from_processed(processed)
    store_gap = np.abs(dataset.store - jds.store).max()
    assert store_gap <= 2.4e-7
    jstore = JDS.DeviceWindowStore.from_dataset(jds)
    seeds = [3, 4]
    wj, mj = jstore.sample_window_chunk(seeds, 6, 11)
    wt, mt = staged.sample_window_chunk(seeds, 6, 11)
    for k in wj:
        assert wt[k].shape == wj[k].shape
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]),
                                   atol=store_gap, rtol=0)
    np.testing.assert_array_equal(mt["betas"].numpy(),
                                  np.asarray(mj["betas"]))
    np.testing.assert_array_equal(mt["gender_ids"].numpy(),
                                  np.asarray(mj["gender_ids"]))


def test_chunk_noise_draws_from_the_first_seed(staged):
    """With noise the chunk draws one (k, B, W, D) normal from a
    generator seeded seeds[0] + 1, and a rank's rows are those rows of
    the whole chunk."""
    seeds = [21, 22]
    clean, _ = staged.sample_window_chunk(seeds, 4, 11)
    noisy, _ = staged.sample_window_chunk(seeds, 4, 11, noise_std=0.05)
    frames = lambda w: torch.cat([w[n] for n, _ in sorted(
        staged.layout.items(), key=lambda kv: kv[1])], dim=-1)
    g = torch.Generator().manual_seed(seeds[0] + 1)
    want = 0.05 * torch.randn(frames(clean).shape, generator=g)
    torch.testing.assert_close(frames(noisy) - frames(clean), want,
                               atol=1e-6, rtol=0)
    half, _ = staged.sample_window_chunk(seeds, 4, 11, noise_std=0.05,
                                         rows=slice(2, 4))
    for k in noisy:
        assert torch.equal(half[k], noisy[k][:, 2:4]), k


def _cli_cfg(on_device, batch=4):
    from types import SimpleNamespace

    return SimpleNamespace(batch_size=batch, data_noise_std=0.0,
                           model_steps_in=1, data_on_device=on_device)


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert torch.equal(a, b)


def test_train_chunk_fn_matches_stacked_batch_fn(dataset):
    """The CLI's chunk source equals stack_batches of its batch source:
    full chunks, and each remainder batch stacked alone."""
    from humor_torch.train.cli import make_batch_fns

    batches, chunks = make_batch_fns(dataset, _cli_cfg(1), 11, 5, 3, "cpu")
    assert chunks is not None
    got = list(chunks(0, 2))
    ref = list(batches(0))
    assert [n for _, n in got] == [2, 2, 1]
    for ci, (payload, n) in enumerate(got):
        want = TS.stack_batches(ref[2 * ci:2 * ci + n])
        _assert_tree_equal(payload, want)


def test_batch_fns_budget_passthrough(dataset):
    """No budget left (the val store after the train store) takes the
    host path in auto mode, which has no chunk source."""
    from humor_torch.train.cli import make_batch_fns

    _, chunks = make_batch_fns(dataset, _cli_cfg(-1), 11, 1, 0, "cpu",
                               budget_bytes=0)
    assert chunks is None
    _, chunks = make_batch_fns(dataset, _cli_cfg(-1), 11, 1, 0, "cpu",
                               budget_bytes=1 << 40)
    assert chunks is not None


def test_trainer_chunk_source_parity(dataset, tmp_path):
    """A trainer fed the store's chunk source reaches the same params,
    bit for bit, as one stacking the batch source itself (supervised
    epoch 0, scheduled-sampling epoch 1)."""
    from humor_torch.train.cli import make_batch_fns

    def fit(use_chunks, out):
        batches, chunks = make_batch_fns(dataset, _cli_cfg(1), 11, 5, 3,
                                         "cpu")
        rc = TrainRunConfig(out_dir=str(tmp_path / out), epochs=2,
                            val_every=10, save_every=10, sched_samp_start=1,
                            sched_samp_end=3, steps_per_dispatch=2)
        tr = Trainer(TH.HumorConfig(), NO_SMPL, rc, train_batches=batches,
                     train_chunks=chunks if use_chunks else None,
                     steps_per_epoch=5, seed=0, device="cpu")
        tr.fit()
        return _leaves(tr.state)

    for a, b in zip(fit(True, "chunk"), fit(False, "stack")):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The trainer's loop (tests/test_trainer_loop.py)
# ---------------------------------------------------------------------------

_BATCHES = {}     # (seed, b, t) -> batch, shared by the trainer tests


def _batch_fn(n, b=4, t=5):
    def gen(epoch):
        for i in range(n):
            s = (epoch * 1000 + i, b, t)
            if s not in _BATCHES:
                _BATCHES[s] = _to_torch(_jax_batch(*s))
            yield _BATCHES[s]
    return gen


def _run_cfg(tmp_path, **kw):
    kw.setdefault("out_dir", str(tmp_path))
    kw.setdefault("epochs", 2)
    kw.setdefault("val_every", 1)
    kw.setdefault("save_every", 100)
    kw.setdefault("print_every", 1)
    kw.setdefault("sched_samp_start", 1)
    kw.setdefault("sched_samp_end", 3)
    return TrainRunConfig(**kw)


def test_auto_steps_per_dispatch_resolves(tmp_path):
    tr = Trainer(TH.HumorConfig(), NO_SMPL, _run_cfg(tmp_path),
                 train_batches=_batch_fn(1), device="cpu")
    assert tr.k == _AUTO_STEPS_PER_DISPATCH
    assert tr.multi_sup is not None and tr.mesh is None


def test_fit_chunks_and_checkpoints(tmp_path):
    """5 batches at k = 2: two chunks and a single step an epoch, over
    the supervised and the scheduled-sampling epoch; the checkpoints and
    one stats row a chunk or single step."""
    tr = Trainer(TH.HumorConfig(), NO_SMPL,
                 _run_cfg(tmp_path, steps_per_dispatch=2),
                 train_batches=_batch_fn(5), val_batches=_batch_fn(2),
                 steps_per_epoch=5, seed=3, device="cpu")
    out = tr.fit()
    assert np.isfinite(out["min_train_loss"])
    assert np.isfinite(out["min_val_loss"])
    assert tr.state.step == 10
    for name in ("best_train_model.npz", "best_model.npz",
                 "final_model.npz"):
        assert os.path.exists(os.path.join(str(tmp_path), name)), name
    import json
    with open(os.path.join(str(tmp_path), "stats.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [2, 4, 5, 7, 9, 10]


def test_remainder_steps_all_feed_tracker(tmp_path):
    """Every one of 5 steps at k = 2 weighs in the epoch's averages: two
    chunks of weight 2 and the remainder's single step."""
    tr = Trainer(TH.HumorConfig(), NO_SMPL,
                 _run_cfg(tmp_path, steps_per_dispatch=2),
                 train_batches=_batch_fn(5), steps_per_epoch=5, seed=3,
                 device="cpu")
    tracker = StatTracker(str(tmp_path))
    tr._run_epoch(0, tracker)
    tracker.close()
    assert tracker.meters["total_loss"].count == 5


def test_chunked_trainer_equals_single_steps(tmp_path):
    """k = 2 and k = 1 trainers reach the same params bit for bit (the
    same batches, the same generator), and their epoch averages agree."""
    outs = []
    for k in (1, 2):
        tr = Trainer(TH.HumorConfig(), NO_SMPL,
                     _run_cfg(tmp_path / f"k{k}", steps_per_dispatch=k),
                     train_batches=_batch_fn(5), steps_per_epoch=5, seed=3,
                     device="cpu")
        res = tr.fit()
        outs.append((_leaves(tr.state), res["min_train_loss"]))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-6)


def test_prefetch_off_matches_on(tmp_path):
    losses = []
    for depth in (0, 2):
        tr = Trainer(TH.HumorConfig(), NO_SMPL,
                     _run_cfg(tmp_path / f"d{depth}", steps_per_dispatch=2,
                              epochs=1, prefetch_depth=depth),
                     train_batches=_batch_fn(3), steps_per_epoch=3, seed=7,
                     device="cpu")
        losses.append(tr.fit()["min_train_loss"])
    assert losses[0] == losses[1]
