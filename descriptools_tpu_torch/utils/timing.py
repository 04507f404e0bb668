"""Timing and profiling helpers (torch).

Counterpart of ``descriptools_tpu/utils/timing.py``.  A CUDA launch returns
before the card finishes, so ``sync`` waits for the card
(``torch.cuda.synchronize``) and ``timeit`` times calls on the card (its
default) with CUDA events on the current stream; calls the caller asks to
time on the CPU are timed on the host clock, with a ``sync`` inside the
window, as JAX's ``timeit`` blocks on every result.
``trace()`` records a ``torch.profiler`` trace for TensorBoard or
chrome://tracing.

Spans and counters.  The entry points open a span at each stage
(``span(name)``) and count what the host already knows inside it
(``count(name, n)``: rounds, live cells, host reads).  Both do nothing
unless a ``recording()`` block is open: then each span keeps its name, its
host start and end (``time.perf_counter_ns``), its parent and its request
(the index of its top-level span, one a call of an entry point), and its
counters, in the ``Record`` the block yields, in memory; and, while a
``torch.profiler`` runs too, each span is also a ``record_function`` named
``"dt." + name``, so the trace ties every launch to its stage.  Neither
reads the device or synchronizes.  One thread records at a time: the
record is the process's.
"""

import contextlib
import os
import statistics
import time

import torch

from descriptools_tpu_torch.placement import check_device

TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "build", "torch_trace")


def sync(tree=None):
    """Wait for every queued CUDA launch (a no-op without CUDA); returns
    ``tree``."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def timeit(fn, *args, warmup=1, iters=3, device="cuda", **kwargs):
    """Median seconds of ``fn(*args, **kwargs)`` after ``warmup`` calls:
    CUDA events when ``device`` is a CUDA device (raises where there is no
    card), else the host clock up to a ``sync`` of any queued CUDA work."""
    on_cuda = check_device(device).type == "cuda"
    for _ in range(warmup):
        fn(*args, **kwargs)
    sync()
    times = []
    for _ in range(iters):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            sync()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


@contextlib.contextmanager
def trace(logdir=TRACE_DIR):
    """torch.profiler trace of the block, CPU and (where present) CUDA
    activity, written to ``logdir`` (under the repository's ``build/`` by
    default); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        sync()


class Span:
    """One recorded span: ``name``, host ``start`` and ``end`` in
    nanoseconds (``time.perf_counter_ns``), ``parent`` (the index of the
    span it opened inside, None at the top), ``request`` (the index of its
    top-level span) and ``counters`` ({name: total})."""

    __slots__ = ("name", "start", "end", "parent", "request", "counters")

    def __init__(self, name, parent, request, counters):
        self.name, self.parent, self.request, self.counters = name, parent, request, counters
        self.start = self.end = None


class Record:
    """The spans of one ``recording()`` block, in the order they opened: a
    span's index in ``spans`` is its sequence number."""

    def __init__(self):
        self.spans = []
        self._open = []  # indices of the open spans, innermost last


_record = None  # the open recording()'s Record; None: recording is off
_OFF = contextlib.nullcontext()


class _Recorded:
    """A span being recorded into ``record``; also a ``record_function``
    where a profiler runs."""

    __slots__ = ("record", "name", "counters", "span", "annotation")

    def __init__(self, record, name, counters):
        self.record, self.name, self.counters = record, name, counters
        self.annotation = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function("dt." + self.name)
            self.annotation.__enter__()
        rec = self.record
        parent = rec._open[-1] if rec._open else None
        index = len(rec.spans)
        self.span = Span(self.name, parent, index if parent is None else rec.spans[parent].request, self.counters)
        rec.spans.append(self.span)
        rec._open.append(index)
        self.span.start = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end = time.perf_counter_ns()
        self.record._open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name, **counters):
    """A context manager around one stage: recorded as ``name`` with the
    initial ``counters`` while a ``recording()`` block is open, else one
    shared ``contextlib.nullcontext()``."""
    if _record is None:
        return _OFF
    return _Recorded(_record, name, counters)


def count(name, n=1):
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    while recording is off or no span is open).  ``n`` is a value the host
    holds already, never one read from the device for the count."""
    if _record is None or not _record._open:
        return
    counters = _record.spans[_record._open[-1]].counters
    counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters for the block; yields its ``Record``.
    The recording open before the block, if any, resumes after it."""
    global _record
    outer, _record = _record, Record()
    try:
        yield _record
    finally:
        _record = outer
