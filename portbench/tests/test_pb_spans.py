"""portbench/spans.py on synthetic trace events: the spans' device
annotations are dropped, a kernel goes to the span open on its launching
thread, a backward kernel to its forward span by sequence number, the
rest to the main thread's span, and idle gaps are named by span; then
the sequence-number link on a real CPU trace of humor_torch's spans."""

import collections

import torch

from portbench import spans as S

US = 1000   # the trace's times are in ns


class Ev:
    """A stand-in for torch's _KinetoEvent."""

    def __init__(self, name, start, end, device=False, kind="cpu_op",
                 thread=1, corr=0, linked=0, seq=-1, fwd=0):
        from torch.autograd import DeviceType

        self.v = dict(name=name, start_ns=start * US, end_ns=end * US,
                      correlation_id=corr, linked_correlation_id=linked,
                      start_thread_id=thread, sequence_nr=seq,
                      fwd_thread_id=fwd,
                      is_user_annotation=kind.endswith("user_annotation"),
                      device_type=DeviceType.CUDA if device
                      else DeviceType.CPU)

    def __getattr__(self, k):
        return lambda: self.v[k]


def fake_prof(events):
    results = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {
        "kineto_results": results})()})()


def span(name, s, e, corr, thread=1):
    return Ev(name, s, e, kind="user_annotation", thread=thread, corr=corr)


def synthetic():
    """train.step [0, 1000] on thread 1, with train.forward [10, 300]
    (its smpl [50, 200]) and train.backward [400, 900]; the backward's
    nodes run on thread 2."""
    ev = [
        span("train.step", 0, 1000, 1), span("train.forward", 10, 300, 2),
        span("smpl", 50, 200, 3), span("train.backward", 400, 900, 4),
        # each span's device annotation, as CUDA gives it
        Ev("smpl", 120, 190, device=True, kind="gpu_user_annotation"),
        Ev("train.step", 100, 990, device=True, kind="gpu_user_annotation"),
        # forward ops: an mm in smpl (sequence 5), an add outside it (6)
        Ev("aten::mm", 60, 100, corr=11, seq=5),
        Ev("aten::add", 250, 280, corr=12, seq=6),
        # their runtime calls and kernels
        Ev("cudaLaunchKernel", 70, 75, corr=101, linked=11, thread=77),
        Ev("gemm", 120, 150, device=True, kind="kernel", corr=101, linked=11),
        Ev("cudaLaunchKernel", 260, 262, corr=102, linked=12, thread=77),
        Ev("add_kernel", 300, 330, device=True, kind="kernel", corr=102,
           linked=12),
        # the mm's backward node on thread 2, and a node with no forward
        Ev("autograd::engine::evaluate_function: MmBackward0", 500, 600,
           thread=2, corr=20, seq=5, fwd=1),
        Ev("aten::mm", 510, 550, thread=2, corr=21),
        Ev("cudaLaunchKernel", 520, 522, corr=103, linked=21, thread=78),
        Ev("gemm_bwd", 560, 620, device=True, kind="kernel", corr=103,
           linked=21),
        Ev("autograd::engine::evaluate_function: AccumulateGrad", 650, 700,
           thread=2, corr=30, seq=99, fwd=1),
        Ev("aten::add_", 660, 690, thread=2, corr=31),
        Ev("cudaLaunchKernel", 690, 691, corr=104, linked=31, thread=78),
        Ev("acc_kernel", 710, 720, device=True, kind="kernel", corr=104,
           linked=31),
    ]
    return S.SpanTrace.from_profiler(fake_prof(ev))


def test_annotations_are_dropped_from_the_device_events():
    st = synthetic()
    assert st.dropped == 2
    assert sum(h.span for h in st.hosts) == 4
    assert [k.name for k in st.kernels] == ["gemm", "add_kernel", "gemm_bwd",
                                            "acc_kernel"]
    assert abs(st.busy_s() - 130e-6) < 1e-12


def test_kernels_go_to_the_launching_span_and_backward_to_its_forward():
    st = synthetic()
    owners = [st.name(o) for o in st.owners]
    # the backward gemm counts as smpl's; the node with no forward op
    # falls to the span the main thread had open at its launch
    assert owners == ["smpl", "train.forward", "smpl", "train.backward"]
    assert st.rules == collections.Counter(
        {"launching thread": 2, "backward": 1, "main thread": 1})
    d = st.device_s()
    assert abs(d["smpl"] - 90e-6) < 1e-12
    assert abs(st.subtree_s("train.forward") - 120e-6) < 1e-12
    assert abs(st.subtree_s("train.step") - 130e-6) < 1e-12
    assert st.subtree_s("train.backward") == d["train.backward"]


def test_idle_gaps_are_named_by_the_main_threads_span():
    st = synthetic()
    gaps = st.idle_by_span()
    # 150-300 closes in train.forward (smpl has ended), 330-560 and
    # 620-710 in train.backward
    assert set(gaps) == {"train.forward", "train.backward"}
    assert abs(gaps["train.forward"] - 150e-6) < 1e-12
    assert abs(gaps["train.backward"] - 320e-6) < 1e-12
    assert st.idle_share_within(("train.step",)) == 1.0
    assert abs(st.idle_share_within(("train.forward",)) - 15 / 47) < 1e-12
    assert st.idle_share_within(("smpl", "nothing")) == 0.0
    assert st.main_span_at(5000 * US) == -1


def test_the_backward_link_on_a_real_trace():
    """On the CPU: humor_torch's spans reach the profiler's trace as user
    annotations, and each autograd node's backward event finds the span
    its forward op ran in."""
    from humor_torch.utils import profiling as PR

    x = torch.randn(16, 16, requires_grad=True)
    with PR.recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with PR.span("outer"):
            with PR.span("smpl"):
                y = (x @ x).sin()
            with PR.span("loss"):
                z = y.sum()
            with PR.span("train.backward"):
                torch.autograd.grad(z, x)
    st = S.SpanTrace.from_profiler(prof)
    names = collections.Counter(st.hosts[i].name for i in st.main_spans)
    assert names == {"outer": 1, "smpl": 1, "loss": 1, "train.backward": 1}
    # each node's event (and the engine's event around it) -> its span
    linked = {(h.name.split(": ")[-1], st.name(st.forward.get(
        (h.fwd_thread, h.seq), -1)))
        for i, h in enumerate(st.hosts) if st.bwd_of[i] == i}
    assert linked == {("SinBackward0", "smpl"), ("MmBackward0", "smpl"),
                      ("SumBackward0", "loss")}
    gaps = S.clock_gaps_us(st, rec)
    assert gaps["pairs"] == 4 and gaps["start_median_us"] >= 0
