"""The job kinds a traffic mix can name (``"job"``), one file a kind:
``jobs/<kind>.py``, found by name (``found.module``).  A kind is what one
request of the closed loop asks of the program, as a caller would write
it, and the plain reference of the same request:

- ``run(program, x, traffic, probe)``: the program (``Program``) on one
  pool input; returns its outputs, tensors on the device and, where it
  calibrates, Python numbers.  It imports the program inside the call.
- ``reference(x, pipeline, traffic, dtype, classify_dtype)``: the same
  outputs from ``benchmark/reference/`` alone, in ``dtype`` (float32 as
  the configurations state; the control's lower one), and the reference's
  walk statistics.  Every output it returns is compared (``check.py``).

The probe wraps each entry call in a span and, in the traced run's
unprofiled stretch, times the stages; in the timed window it does nothing.
"""

import contextlib
import time

import torch


class Program:
    """The system under test, imported, with its settings from the
    configuration and the mix (``cfg``)."""

    def __init__(self, pipeline):
        from descriptools_tpu_torch import pipeline as pl

        self.cfg = pl.PipelineConfig(**pipeline)


class Probe:
    """No spans, no stage timings: the timed window's probe."""

    def span(self, name):
        return contextlib.nullcontext()

    def host(self, name):
        return contextlib.nullcontext()

    def device(self, name):
        return contextlib.nullcontext()

    def sync(self):
        pass

    def note(self, name, **tensors):
        pass


class RecordingProbe(Probe):
    """Spans for the profiler (``record_function``) and stage timings:
    ``host(name)`` the host clock over a call, ``device(name)`` CUDA events
    around it, ``sync()`` a synchronize before a stage timed on the host."""

    def __init__(self, device, spans=True):
        self.on_cuda = torch.device(device).type == "cuda"
        self.spans = spans
        self.host_s = {}
        self.events = {}
        self.operands = {}

    def span(self, name):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    @contextlib.contextmanager
    def host(self, name):
        t0 = time.perf_counter()
        yield
        self.host_s.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def device(self, name):
        if not self.on_cuda:
            yield
            return
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        stop.record()
        self.events.setdefault(name, []).append((start, stop))

    def sync(self):
        if self.on_cuda:
            torch.cuda.synchronize()

    def note(self, name, **tensors):
        """Record the dtypes of a call's operands (the kernels' bytes
        depend on them)."""
        self.operands[name] = {k: str(t.dtype) for k, t in tensors.items()}

    def device_ms(self, name):
        """Milliseconds of each timed call (after a synchronize)."""
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]

