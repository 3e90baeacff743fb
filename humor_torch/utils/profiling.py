"""Profiling (port of humor_tpu/utils/profiling.py, widened): named spans
and counters inside the program, and a torch.profiler trace of a block
with the spans in it.

    with profiling.recording(syncs=True) as rec:
        runner(observed)
    rec.by_name()["lbfgs.iter"]    # {"count", "host_ms", "self_ms", "syncs"}

`span(name)` marks a stretch of host code at a layer boundary and
`count(name, n)` adds to a counter. Both do nothing unless a
`recording()` block is open: `span` then returns one shared null context
after a single flag check. While recording, a span keeps its name, its
parent (the span open on the same thread when it began), its thread and
its start and end in nanoseconds of `time.time_ns()`: the Unix clock to
which torch.profiler converts its own stamps. Each span also enters
`torch.profiler.record_function(name)`, so a trace taken meanwhile holds
it as a user annotation on the profiler's own clock, over the kernels it
launched.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import torch

# torch.cuda's sync debug mode words each warning so
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_on = False                  # the one flag an idle span checks
_record: Optional["Record"] = None
_NULL = contextlib.nullcontext()
_threads = threading.local()


class SpanRecord:
    """One span: `parent` indexes the record's spans (None at the top of
    its thread), `syncs` counts the synchronising operations made while it
    was the innermost span open on its thread."""

    __slots__ = ("name", "parent", "thread", "t0_ns", "t1_ns", "syncs")

    def __init__(self, name: str, parent: Optional[int], thread: int):
        self.name, self.parent, self.thread = name, parent, thread
        self.t0_ns = self.t1_ns = 0
        self.syncs = 0

    @property
    def ns(self) -> int:
        return self.t1_ns - self.t0_ns


class Record:
    """What one `recording()` block kept: spans in the order they began,
    counters by name, and the synchronising operations made outside every
    span (`syncs_outside`)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.lock = threading.Lock()
        self.counters: Dict[str, int] = collections.Counter()
        self.syncs_outside = 0

    def self_ns(self) -> List[int]:
        """Each span's duration minus what its children cover."""
        out = [s.ns for s in self.spans]
        for s in self.spans:
            if s.parent is not None:
                out[s.parent] -= s.ns
        return out

    def under(self, i: int, name: str) -> bool:
        """Whether span i lies below a span called `name`."""
        p = self.spans[i].parent
        while p is not None:
            if self.spans[p].name == name:
                return True
            p = self.spans[p].parent
        return False

    @property
    def syncs(self) -> int:
        return self.syncs_outside + sum(s.syncs for s in self.spans)

    def by_name(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "host_ms", "self_ms", "syncs"}} over every
        span of that name."""
        out: Dict[str, Dict[str, float]] = {}
        for s, self_ns in zip(self.spans, self.self_ns()):
            d = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                        "self_ms": 0.0, "syncs": 0})
            d["count"] += 1
            d["host_ms"] += s.ns / 1e6
            d["self_ms"] += self_ns / 1e6
            d["syncs"] += s.syncs
        return out


def _stack() -> List[int]:
    st = getattr(_threads, "stack", None)
    if st is None:
        st = _threads.stack = []
    return st


class _Span:
    __slots__ = ("record", "name", "span", "annotation")

    def __init__(self, record: Record, name: str):
        self.record, self.name = record, name

    def __enter__(self):
        stack = _stack()
        spans = self.record.spans
        self.span = SpanRecord(self.name, stack[-1] if stack else None,
                               threading.get_ident())
        with self.record.lock:
            stack.append(len(spans))
            spans.append(self.span)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.span.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.span.t1_ns = time.time_ns()
        self.annotation.__exit__(*exc)
        _stack().pop()
        return False


def span(name: str):
    """`with span(name):` around a layer's call; a no-op unless
    recording."""
    if not _on:
        return _NULL
    return _Span(_record, name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` while recording."""
    if _on:
        _record.counters[name] += n


def active() -> bool:
    """Whether a `recording()` block is open: a counter that costs a read
    of the card is read only then."""
    return _on


def _count_sync(record: Record) -> None:
    stack = _stack()
    if stack:
        record.spans[stack[-1]].syncs += 1
    else:
        record.syncs_outside += 1


@contextlib.contextmanager
def _counting_syncs(record: Record) -> Iterator[None]:
    """torch.cuda's sync debug mode at "warn" for the block; each of its
    warnings is counted against the innermost span open on the thread it
    reaches, and shown nowhere. The previous mode and warning handlers
    come back afterwards."""
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if SYNC_MESSAGE in str(message):
                _count_sync(record)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        previous = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def recording(syncs: bool = False) -> Iterator[Record]:
    """Turn spans and counters on for the block and yield their Record;
    with `syncs`, count the synchronising operations too (see
    _counting_syncs). One block at a time."""
    global _on, _record
    if _on:
        raise RuntimeError("profiling.recording() is already open")
    record = Record()
    with contextlib.ExitStack() as stack:
        if syncs:
            stack.enter_context(_counting_syncs(record))
        _record, _on = record, True
        try:
            yield record
        finally:
            _on, _record = False, None


@contextlib.contextmanager
def trace(out_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block's host and device activity into out_dir
    (a TensorBoard / Chrome trace), with the program's spans recorded, so
    each span shows over the kernels it launched:

        with profiling.trace("/tmp/humor_trace"):
            runner(observed)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                out_dir)) as prof:
        yield prof
