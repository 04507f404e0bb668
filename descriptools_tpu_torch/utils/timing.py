"""Timing and profiling helpers (torch).

Counterpart of ``descriptools_tpu/utils/timing.py``.  A CUDA launch returns
before the card finishes, so ``sync`` waits for the card
(``torch.cuda.synchronize``) and ``timeit`` times CUDA calls with CUDA
events on the current stream; CPU calls are timed on the host clock.
``trace()`` records a ``torch.profiler`` trace for TensorBoard or
chrome://tracing.
"""

import contextlib
import os
import statistics
import time

import torch

TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "build", "torch_trace")


def sync(tree=None):
    """Wait for every queued CUDA launch (a no-op without CUDA); returns
    ``tree``."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def timeit(fn, *args, warmup=1, iters=3, device="cpu", **kwargs):
    """Median seconds of ``fn(*args, **kwargs)`` after ``warmup`` calls:
    CUDA events when ``device`` is a CUDA device, else the host clock."""
    on_cuda = torch.device(device).type == "cuda"
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


def grid_points_per_second(cells, seconds):
    return cells / seconds
