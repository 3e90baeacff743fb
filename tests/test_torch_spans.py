"""humor_torch's span and counter recorder (utils/profiling): off by
default at the cost of one flag check, nested and per thread while
recording, and the spans and counters the L-BFGS loop and the train step
record. CPU only, no JAX, a few seconds."""

import threading
import warnings

import pytest
import torch

from humor_torch.body_model.smpl import synthetic_smpl_model
from humor_torch.data.synthetic import synthetic_world_batch
from humor_torch.data.windows import window_to_pairs
from humor_torch.fitting.lbfgs import run_lbfgs
from humor_torch.losses.elbo import LossConfig
from humor_torch.models import humor as H
from humor_torch.train import step as TS
from humor_torch.utils import profiling as PR

A = torch.diag(torch.arange(1.0, 7.0, dtype=torch.float64))


def _quadratic(v):
    x = v["x"]
    return 0.5 * torch.einsum("ki,ij,kj->k", x, A, x)


def _x0():
    return {"x": torch.linspace(1.0, 2.0, 6, dtype=torch.float64)}


def test_off_a_span_is_one_shared_null_context_and_records_nothing():
    assert PR.span("a") is PR.span("b")
    PR.count("c", 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_lbfgs(_quadratic, _x0(), 3)
    events = prof.profiler.kineto_results.events()
    assert events and not any(e.is_user_annotation() for e in events)
    with PR.recording() as rec:
        pass
    assert not rec.spans and not rec.counters


def test_rollout_wait_counters_read_only_while_recording():
    """The rollout kernels' wait tally (the first two int32 of a call's
    scratch) reaches the counters rollout.waits and rollout.waits_stalled
    while recording, and is not read otherwise (a poisoned scratch would
    raise from the read)."""
    from humor_torch.ops import rollout_kernel as RK

    assert not PR.active()

    class Unread:
        def __getitem__(self, index):
            raise AssertionError("scratch read with recording off")

    RK._count_waits(Unread())
    scratch = torch.zeros(8)
    scratch[:2].view(torch.int32).copy_(torch.tensor([7, 3],
                                                     dtype=torch.int32))
    with PR.recording() as rec:
        assert PR.active()
        RK._count_waits(scratch)
        RK._count_waits(scratch)
    assert not PR.active()
    assert rec.counters["rollout.waits"] == 14
    assert rec.counters["rollout.waits_stalled"] == 6


def test_nested_spans_parents_self_times_and_threads():
    seen = {}

    def other():
        with PR.span("worker"):
            with PR.span("worker.inner"):
                seen["ok"] = True

    with PR.recording() as rec:
        with PR.span("outer"):
            with PR.span("a"):
                sum(range(20000))
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            with PR.span("b"):
                with PR.span("b.inner"):
                    sum(range(20000))
    assert not t.is_alive() and seen["ok"]
    assert PR.span("x") is PR.span("y")      # off again after the block
    by = {s.name: i for i, s in enumerate(rec.spans)}
    sp = rec.spans
    assert sp[by["outer"]].parent is None
    assert sp[by["a"]].parent == by["outer"] == sp[by["b"]].parent
    assert sp[by["b.inner"]].parent == by["b"]
    # the worker thread's spans start their own stack
    assert sp[by["worker"]].parent is None
    assert sp[by["worker.inner"]].parent == by["worker"]
    assert sp[by["worker"]].thread != sp[by["outer"]].thread
    assert rec.under(by["b.inner"], "outer")
    assert not rec.under(by["worker.inner"], "outer")
    self_ns = rec.self_ns()
    assert self_ns[by["outer"]] == (sp[by["outer"]].ns - sp[by["a"]].ns
                                    - sp[by["b"]].ns)
    assert self_ns[by["b"]] == sp[by["b"]].ns - sp[by["b.inner"]].ns
    assert self_ns[by["a"]] == sp[by["a"]].ns > 0
    assert all(s.t0_ns <= s.t1_ns for s in sp)
    assert rec.by_name()["b.inner"]["count"] == 1


def test_a_second_recording_block_is_refused():
    with PR.recording():
        with pytest.raises(RuntimeError):
            with PR.recording():
                pass


@pytest.mark.parametrize("linesearch", ["parallel", "zoom"])
def test_run_lbfgs_spans_and_counters(linesearch):
    calls = [0]

    def counting(v):
        calls[0] += 1
        return _quadratic(v)

    n = 4
    with PR.recording() as rec:
        run_lbfgs(counting, _x0(), n, linesearch=linesearch)
    by = rec.by_name()
    c = rec.counters
    for name in ("lbfgs.iter", "lbfgs.direction", "lbfgs.search",
                 "lbfgs.update"):
        assert by[name]["count"] == n, name
    assert (c["lbfgs.evaluations"] == calls[0]
            == by["lbfgs.forward"]["count"])
    if linesearch == "parallel":
        assert c["lbfgs.evaluations"] == n + 1
        assert c["lbfgs.points"] == 1 + 8 * n
        assert "lbfgs.zoom_probes" not in c
    else:
        # every evaluation but the first is a probe of the search
        assert c["lbfgs.zoom_probes"] == calls[0] - 1 >= n
        assert c["lbfgs.points"] == calls[0]
    iters = [i for i, s in enumerate(rec.spans) if s.name == "lbfgs.iter"]
    for i, s in enumerate(rec.spans):
        if s.name in ("lbfgs.direction", "lbfgs.search", "lbfgs.update"):
            assert s.parent in iters
        if s.name == "lbfgs.forward" and s.parent is not None:
            assert rec.spans[s.parent].name == "lbfgs.search"


def test_supervised_train_step_records_each_span_once():
    bodies = {"male": synthetic_smpl_model(10), "female":
              synthetic_smpl_model(20)}
    cfg = H.HumorConfig()
    world, meta = synthetic_world_batch(0, 2, 3, model=bodies["male"])
    data_in, data_out, _ = window_to_pairs(world)
    batch = {"data_in": data_in, "data_out": data_out,
             "betas": meta["betas"], "gender_ids": meta["gender_ids"]}
    opt = TS.make_optimizer()
    sup, _, _ = TS.make_train_steps(cfg, LossConfig(), opt, bodies)
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    with PR.recording() as rec:
        sup(state, batch, 10, generator=torch.Generator().manual_seed(1))
    by = rec.by_name()
    for name in ("train.step", "train.forward", "train.elbo",
                 "train.smpl_losses", "train.backward", "train.optimizer"):
        assert by[name]["count"] == 1, name
    assert by["smpl"]["count"] == 4       # two bodies, predicted and true
    parent = {s.name: rec.spans[s.parent].name for s in rec.spans
              if s.parent is not None and s.name != "smpl"}
    assert parent == {"train.forward": "train.step",
                      "train.elbo": "train.step",
                      "train.smpl_losses": "train.elbo",
                      "train.backward": "train.step",
                      "train.optimizer": "train.step"}
    assert all(rec.spans[s.parent].name == "train.smpl_losses"
               for s in rec.spans if s.name == "smpl")


def test_a_sync_warning_counts_against_the_innermost_span():
    shown = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: shown.append(str(m))
        with PR.recording(syncs=True) as rec:
            with PR.span("outer"):
                with PR.span("inner"):
                    warnings.warn(PR.SYNC_MESSAGE)
                    warnings.warn(PR.SYNC_MESSAGE)
                warnings.warn(PR.SYNC_MESSAGE + " (elsewhere)")
            warnings.warn(PR.SYNC_MESSAGE)
            warnings.warn("unrelated")
    by = rec.by_name()
    assert by["inner"]["syncs"] == 2 and by["outer"]["syncs"] == 1
    assert rec.syncs_outside == 1 and rec.syncs == 4
    # other warnings reach the handler that was in place
    assert shown == ["unrelated"]
