"""The per-layer readings, one function a quantity: ``metrics/<metric>.py``
names the one its metric reads.

Each takes the traced run's context (``harness.Run._traced``: ``spec``, ``trace``,
``jobs``, ``probe``, ``mean_job_s``, ``cells``, ``peaks``, ``pool``) and
returns a number, or None where it finds nothing to read."""

import statistics

from benchmark.kernels import own_names, roofline_percent


def suite_enqueue_ms(ctx):
    """Host milliseconds from the call of ``descriptor_suite`` to its
    return, before any synchronize, a job: the benchmark's host clock over
    the unprofiled stretch (the profiler lengthens host calls)."""
    times = ctx.probe.host_s.get("suite.enqueue")
    return 1e3 * statistics.mean(times) if times else None


def suite_launches(ctx):
    """Device activities (kernels, memsets, copies) launched under the
    benchmark's span around ``descriptor_suite``, a job (profiler)."""
    n = ctx.trace.count("suite")
    return n / ctx.jobs if n else None


def stencil_roofline(ctx):
    """K2's share of its roofline in %: ``kernels/stencil.py``'s bytes at
    the card's peak bandwidth over its device time by name, a job."""
    return roofline_percent(ctx, "stencil")


def downslope_roofline(ctx):
    """K3's share of its roofline in % (``kernels/downslope.py``)."""
    return roofline_percent(ctx, "downslope")


def flow_walk_roofline(ctx):
    """K4's share of its roofline in % (``kernels/flow_walk.py``)."""
    return roofline_percent(ctx, "flow_walk")


def torch_ops_device_ms(ctx):
    """Device milliseconds a job of the activities launched under the
    benchmark's span around ``descriptor_suite`` that are not the port's
    own kernels (``kernels/``): PyTorch's kernels for the glue
    (``flow.walk_inputs``, ``flow_from_state``, ``hand_and_river_fac``,
    GFI, casts), memsets and copies (profiler)."""
    s = ctx.trace.device_s(span="suite", exclude=own_names(ctx.spec.root))
    return 1e3 * s / ctx.jobs if s else None


def terrain_device_ms(ctx):
    """Milliseconds of ``derive_terrain`` a job, from CUDA events recorded
    before and after the call (unprofiled stretch)."""
    ms = ctx.probe.device_ms("terrain")
    return statistics.mean(ms) if ms else None


def classify_ms(ctx):
    """Host milliseconds of ``sharded_classify_flood`` a job, after a
    synchronize that ends the suite: its device passes and its host search
    (unprofiled stretch)."""
    times = ctx.probe.host_s.get("classify")
    return 1e3 * statistics.mean(times) if times else None


def device_idle_share(ctx):
    """Share of a job in which the card runs nothing: 1 - (device-busy
    seconds a job under the profiler) / (the mean job of the unprofiled
    stretch of the same run).  The busy time is the union of the device
    activities' intervals; the profiler lengthens the host's part of a job,
    not the device's, so the unprofiled job is the denominator."""
    busy = ctx.trace.busy_s() / ctx.jobs
    return 1.0 - busy / ctx.mean_job_s if busy else None
