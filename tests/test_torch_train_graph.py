"""The training step as the replay of one captured CUDA graph
(train/step.make_multi_steps), and what makes the step capturable:

  * scheduled sampling's curriculum chosen on the device (a `where` on
    use_gt) against the host branch of the benchmark's plain reference
    (portbench/reference/humor.py): predictions, posterior, prior and the
    params' gradients bit for bit, with the curriculum all GT, all fed
    and mixed, detach_sched_samp on and off;
  * Adamax and Adam with their state updated in place against the
    reference's optimizer, which returns fresh state tensors, over steps
    with a non-finite gradient and a rate milestone;
  * the step's draws (train/step.step_draws, which a graphed chunk
    also draws by, outside the graph) against the reference's steps,
    which draw inside the model, from equal generators: bit for bit;
  * on the CPU the chunk runs eagerly and counts its steps, a full
    chunk and one shorter than k;
  * the Trainer at k = 1, and with an epoch's remainder at k = 2, runs
    every step through make_multi_steps and logs the stats rows of single
    steps read a chunk at a time;
  * marked `cuda`: a graphed chunk against k calls of the single step
    on the card, bit for bit, over two chunks (the first captures), with
    the draws drawn from a generator and injected, for the supervised,
    the scheduled-sampling and the HuMoR-Qual step, with the counters,
    and no host sync in a chunk of replays; chunks shorter than k replay
    the same graph; a k = 1 Trainer epoch on the card equals single
    eager steps with one capture.

CPU, small sizes, no JAX, a few seconds. The card's tests, with no
conftest (it sets up JAX):

    python -m pytest --noconftest tests/test_torch_train_graph.py -q
"""

import json
import os

import pytest
import torch

from humor_torch.body_model.smpl import SmplModel
from humor_torch.data.synthetic import synthetic_world_batch
from humor_torch.data.windows import window_to_pairs
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as H
from humor_torch.train import step as TS
from humor_torch.train.trainer import Trainer, TrainRunConfig
from humor_torch.utils import profiling as PR
from humor_torch.utils.stats import to_host
from portbench import weights as W
from portbench.reference import humor as RH
from portbench.reference import step as RS

B, T, K, VERTS, HIDDEN, L = 4, 5, 3, 256, 64, 48
EPOCH = 30
USE_GT = {"all_gt": [True] * T, "all_fed": [True] + [False] * (T - 1),
          "mixed": [True, False, True, False, False]}


def _bodies(device="cpu"):
    return {g: W.body_model(SmplModel, W.synthetic_body(seed, VERTS), device)
            for g, seed in (("male", 10), ("female", 20))}


def _batch(seed, bodies, device="cpu"):
    world, meta = synthetic_world_batch(seed, B, T + 1, model=bodies["male"])
    data_in, data_out, _ = window_to_pairs(world)
    batch = {"data_in": data_in, "data_out": data_out,
             "betas": meta["betas"], "gender_ids": meta["gender_ids"]}
    return TS.tree_map(lambda x: x.to(device), batch)


def _weights(device="cpu"):
    return TS.tree_map(lambda x: x.to(device), W.humor_weights(
        RH.HumorConfig(), HIDDEN, torch.Generator().manual_seed(1)))


def _outputs(out):
    return ([out.pred[k] for k in sorted(out.pred)] + list(out.posterior)
            + list(out.prior))


@pytest.mark.parametrize("detach", [True, False], ids=["detach", "no_detach"])
@pytest.mark.parametrize("choice", sorted(USE_GT))
def test_device_choice_equals_the_host_branch(choice, detach):
    bodies = _bodies()
    batch = _batch(0, bodies)
    weights = _weights()
    data_in, data_out = batch["data_in"], batch["data_out"]
    cfg = H.HumorConfig(detach_sched_samp=detach)
    rcfg = RH.HumorConfig(detach_sched_samp=detach)
    x_past = H.state_to_input(cfg, data_in)
    x_t = H.state_to_input(cfg, data_out)
    init = {k: v[:, 0] for k, v in data_in.items()}
    eps = torch.randn(T, B, L, generator=torch.Generator().manual_seed(3))
    use_gt = torch.tensor(USE_GT[choice])
    results = []
    for mod, c in ((H, cfg), (RH, rcfg)):
        params = TS.tree_map(lambda p: p.clone().requires_grad_(True),
                             weights)
        out = mod.scheduled_sampling(c, params, x_past, x_t, init, 0.5,
                                     use_gt=use_gt, eps=eps)
        outs = _outputs(out)
        objective = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
        grads = torch.autograd.grad(objective, TS.tree_leaves(params))
        results.append(([o.detach() for o in outs], grads))
    (outs, grads), (ref_outs, ref_grads) = results
    assert all(torch.equal(a, b) for a, b in zip(outs, ref_outs))
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    assert any(bool((g != 0).any()) for g in grads)


@pytest.mark.parametrize("optim", ["adamax", "adam"])
def test_optimizer_state_in_place_equals_fresh_state(optim):
    """Six steps, the third with a NaN gradient (skipped) and a rate
    milestone after two applied steps."""
    g = torch.Generator().manual_seed(4)
    params0 = {"a": torch.randn(3, 4, generator=g),
               "b": [torch.randn(5, generator=g), torch.randn(2, generator=g)]}
    kw = dict(lr=1e-2, milestones=(2,), decays=(0.5,), steps_per_epoch=1,
              optim=optim, grad_clip=1.0)
    opt, ref_opt = TS.make_optimizer(**kw), RS.make_optimizer(**kw)
    params = TS.tree_map(lambda p: p.clone(), params0)
    ref_params = TS.tree_map(lambda p: p.clone(), params0)
    state, ref = opt.init(params), ref_opt.init(ref_params)
    ptrs = [x.data_ptr() for x in TS.tree_leaves(state)]
    for i in range(6):
        grads = [torch.randn(p.shape, generator=g)
                 for p in TS.tree_leaves(params)]
        if i == 2:
            grads[1][0] = float("nan")
        state = opt.update(grads, state, params)
        ref = ref_opt.update([x.clone() for x in grads], ref, ref_params)
        assert [x.data_ptr() for x in TS.tree_leaves(state)] == ptrs
        for name in ("count", "notfinite_count", "total_notfinite",
                     "last_finite"):
            assert torch.equal(state[name], ref[name]), (i, name)
            assert state[name].dtype == ref[name].dtype
        for tree in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(
                TS.tree_leaves(state[tree]), TS.tree_leaves(ref[tree])))
        assert all(torch.equal(a, b) for a, b in zip(
            TS.tree_leaves(params), TS.tree_leaves(ref_params)))
    assert int(state["count"]) == 5 and int(state["total_notfinite"]) == 1


def _steps(device, qual=False, smpl=True):
    """The optimizer, the bodies and the steps; without `smpl` the steps
    leave the SMPL losses out (the CPU's cheap cases)."""
    opt = TS.make_optimizer(lr=1e-3, steps_per_epoch=10)
    bodies = _bodies(device)
    sup, ss, _ = TS.make_train_steps(H.HumorConfig(), LossConfig(), opt,
                                     bodies if smpl else None,
                                     use_smpl_joint_inputs=qual)
    return opt, bodies, sup, ss


def _chunk(bodies, first_seed, device):
    return TS.stack_batches([_batch(first_seed + i, bodies, device)
                             for i in range(K)])


def _state_leaves(state):
    return [x.detach().clone() for x in TS.tree_leaves(state[:2])]


@pytest.mark.parametrize("kind", ["sup", "ss"])
def test_step_draws_as_the_reference_draws(kind):
    """Two steps that draw their noise (and the curriculum) from a
    generator, against the reference's steps drawing from an equal one:
    losses and params bit for bit."""
    opt, bodies, sup, ss = _steps("cpu", smpl=False)
    ref_opt = RS.make_optimizer(lr=1e-3, steps_per_epoch=10)
    ref_sup, ref_ss = RS.make_train_steps(RH.HumorConfig(), LossConfig(),
                                          ref_opt)
    extra = (0.5,) if kind == "ss" else ()
    runs = []
    for step, o in (((ss, opt) if kind == "ss" else (sup, opt)),
                    ((ref_ss, ref_opt) if kind == "ss" else (ref_sup,
                                                              ref_opt))):
        gen = torch.Generator().manual_seed(5)
        state = TS.make_train_state(_weights(), o)
        losses = []
        for seed in range(2):
            state, stats = step(state, _batch(seed, bodies), EPOCH, *extra,
                                generator=gen)
            losses.append(stats["total_loss"])
        runs.append((torch.stack(losses), _state_leaves(state)))
    (loss, leaves), (ref_loss, ref_leaves) = runs
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))


@pytest.mark.parametrize("n", [K, 1], ids=["full", "short"])
def test_cpu_chunk_runs_eagerly(n):
    opt, bodies, sup, ss = _steps("cpu", smpl=False)
    multi_ss = TS.make_multi_steps(sup, ss, K)[1]
    state = TS.make_train_state(_weights(), opt)
    stacked = TS.tree_map(lambda x: x[:n], _chunk(bodies, 0, "cpu"))
    with PR.recording() as rec:
        state, stats = multi_ss(state, stacked, EPOCH, 0.0,
                                generator=torch.Generator().manual_seed(6))
    assert rec.counters["train.eager_steps"] == n
    assert "train.graph_captures" not in rec.counters
    assert "train.graph_replays" not in rec.counters
    assert rec.by_name()["train.step"]["count"] == n
    assert stats["total_loss"].shape == (n,) and state.step == n


STEPS = 3     # an epoch's steps in the trainer tests


def _trainer_and_singles(tmp_path, device, k, epochs, samp=(1, 3)):
    """A Trainer at k over `epochs` epochs of STEPS batches (supervised
    before samp[0], scheduled sampling after it), its single steps
    replaced by ones that raise, against the same steps run one at a
    time from the same start and generator, their stats read a chunk of
    k (and each remainder step) at a time. -> ((trainer rows, leaves,
    counters), (single-step rows, leaves))."""
    bodies = _bodies(device)
    data = {e: [_batch(100 * e + i, bodies, device) for i in range(STEPS)]
            for e in range(epochs)}
    rc = TrainRunConfig(out_dir=str(tmp_path), epochs=epochs,
                        sched_samp_start=samp[0], sched_samp_end=samp[1],
                        save_every=100, steps_per_dispatch=k,
                        prefetch_depth=0, use_mesh=False)
    tr = Trainer(H.HumorConfig(), LossConfig(), rc,
                 train_batches=lambda e: iter(data[e]),
                 steps_per_epoch=STEPS, seed=3, device=device)
    sup, ss = tr.sup_step, tr.ss_step

    def single(*a, **kw):
        raise AssertionError("the trainer called a single train step")

    tr.sup_step = tr.ss_step = single
    with PR.recording() as rec:
        tr.fit()
    with open(os.path.join(str(tmp_path), "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]

    state = TS.init_train_state(H.HumorConfig(), tr.opt,
                                torch.Generator().manual_seed(3), device)
    gen = torch.Generator(device=device).manual_seed(4)
    ref = []
    full = STEPS - STEPS % k
    for e in range(epochs):
        gt_p = TS.sched_samp_prob(e, *samp)
        step, extra = (sup, ()) if gt_p >= 1.0 else (ss, (gt_p,))
        for group in ([data[e][i:i + k] for i in range(0, full, k)]
                      + [[b] for b in data[e][full:]]):
            stats = []
            for b in group:
                state, s = step(state, b, e, *extra, generator=gen)
                stats.append(s)
            ref.append({**to_host({key: torch.stack([s[key] for s in stats])
                                   for key in stats[0]}),
                        "step": state.step})
    return ((rows, _state_leaves(tr.state), dict(rec.counters)),
            (ref, _state_leaves(state)))


@pytest.mark.parametrize("k", [1, 2], ids=["k1", "remainder"])
def test_trainer_runs_every_step_through_the_chunk(tmp_path, k):
    """k = 1: three chunks of 1 an epoch; k = 2: a chunk of 2 and the
    remainder's chunk of 1. Over a supervised and a scheduled-sampling
    epoch on the CPU every step is eager inside make_multi_steps, and the
    log's rows and the params equal single steps' bit for bit."""
    (rows, leaves, counters), (ref, ref_leaves) = _trainer_and_singles(
        tmp_path, "cpu", k, epochs=2)
    assert counters["train.eager_steps"] == 2 * STEPS
    assert rows == ref
    assert [r["step"] for r in rows] == (
        [1, 2, 3, 4, 5, 6] if k == 1 else [2, 3, 5, 6])
    assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is captured in a CUDA "
                    "graph only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _singles(step):
    """A call of the single step a batch of a chunk, with the chunk's
    draws sliced per step: the chunk it should equal."""
    def run(state, stacked, *extra, generator=None, **draws):
        stats = []
        for i in range(TS.tree_leaves(stacked)[0].shape[0]):
            state, s = step(state, TS.tree_map(lambda x: x[i], stacked),
                            *extra, generator=generator,
                            **{n: v[i] for n, v in draws.items()})
            stats.append(s)
        return state, {key: torch.stack([s[key] for s in stats])
                       for key in stats[0]}
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [False, True], ids=["generator", "given"])
@pytest.mark.parametrize("kind", ["sup", "ss", "qual"])
def test_graphed_chunk_equals_single_steps(card, kind, inject):
    opt, bodies, sup, ss = _steps(card, qual=kind == "qual")
    sched = kind != "sup"
    extra = (0.5,) if kind == "ss" else (0.0,) if kind == "qual" else ()
    graphed = TS.make_multi_steps(sup, ss, K)[sched]
    eager = _singles(ss if sched else sup)
    chunks = [_chunk(bodies, 10 * c, card) for c in range(2)]
    g = torch.Generator(device=card).manual_seed(7)
    given = [{"eps": torch.randn(K, T, B, L, generator=g, device=card),
              "use_gt": torch.rand(K, T, generator=g, device=card) < 0.5}
             if sched else
             {"eps": torch.randn(K, B * T, L, generator=g, device=card)}
             for _ in chunks]
    runs = []
    for multi in (eager, graphed):
        state = TS.make_train_state(_weights(card), opt)
        gen = torch.Generator(device=card).manual_seed(8)
        out, counters = [], []
        for c, stacked in enumerate(chunks):
            draws = given[c] if inject else {}
            with PR.recording() as rec:
                if multi is graphed and c == 1:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    state, stats = multi(state, stacked, EPOCH, *extra,
                                         generator=gen, **draws)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            counters.append(dict(rec.counters))
            out.append(({k: v.clone() for k, v in stats.items()},
                        _state_leaves(state)))
        runs.append((out, counters, state.step))
    (ref, ref_counters, ref_step), (got, counters, step) = runs
    assert step == ref_step == 2 * K
    for (stats, leaves), (ref_stats, ref_leaves) in zip(got, ref):
        assert list(stats) == list(ref_stats)
        assert all(torch.equal(stats[k], ref_stats[k]) for k in stats)
        assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))
    first, second = counters
    assert (first["train.graph_captures"], first["train.graph_replays"],
            first["train.eager_steps"]) == (1, K - 1, 1)
    assert second.get("train.graph_captures", 0) == 0
    assert second.get("train.eager_steps", 0) == 0
    assert second["train.graph_replays"] == K


@pytest.mark.cuda
def test_short_chunks_replay_one_graph(card):
    """Chunks of K - 1 and then 1 batch for k = K: the first captures,
    the second replays the same graph; both equal the single steps bit
    for bit."""
    opt, bodies, sup, ss = _steps(card)
    graphed = TS.make_multi_steps(sup, ss, K)[0]
    chunks = [TS.tree_map(lambda x, n=n: x[:n], _chunk(bodies, 10 * c, card))
              for c, n in enumerate((K - 1, 1))]
    runs = []
    for multi in (_singles(sup), graphed):
        state = TS.make_train_state(_weights(card), opt)
        gen = torch.Generator(device=card).manual_seed(8)
        out = []
        with PR.recording() as rec:
            for stacked in chunks:
                state, stats = multi(state, stacked, EPOCH, generator=gen)
                out.append({k: v.clone() for k, v in stats.items()})
        runs.append((out, _state_leaves(state), dict(rec.counters)))
    (ref, ref_leaves, _), (got, leaves, counters) = runs
    for stats, ref_stats in zip(got, ref):
        assert list(stats) == list(ref_stats)
        assert all(torch.equal(stats[k], ref_stats[k]) for k in stats)
    assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))
    assert (counters["train.graph_captures"], counters["train.eager_steps"],
            counters["train.graph_replays"]) == (1, 1, K - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sup", "ss"])
def test_k1_trainer_epoch_equals_single_steps(card, tmp_path, kind):
    """A k = 1 Trainer epoch on the card, a supervised one or one fully
    scheduled-sampled: one capture, the other steps replays, and the log's
    rows and the params bit for bit those of single eager steps."""
    (rows, leaves, counters), (ref, ref_leaves) = _trainer_and_singles(
        tmp_path, card, 1, epochs=1, samp=(1, 3) if kind == "sup" else (0, 0))
    assert (counters["train.graph_captures"], counters["train.eager_steps"],
            counters["train.graph_replays"]) == (1, 1, STEPS - 1)
    assert rows == ref
    assert all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))
