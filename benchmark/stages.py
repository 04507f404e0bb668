"""The program's own spans and counters (``descriptools_tpu_torch.utils
.timing``) in a traced run, and the per-stage readings made from them.

After the harness's two stretches (``harness.Run._traced``, recording
off), the first per-stage reader runs two more stretches of as many jobs
(``trace_jobs``), both inside ``timing.recording()`` (and three short
ones that time recording's cost, off, on and off): one under
torch.profiler, in whose trace every device activity is tied to the
innermost program span (``dt.<name>``) open at its launch, its stage; and
one unprofiled, with the harness's unprofiled probe, whose record gives
the stages' host times and counters and whose mean job, against the
harness's unprofiled stretch, is the cost of recording.  The readings are
made once a run and kept on the context (``ctx.stages``); a program that
records no spans gives none, and every reader returns None.

Stage names nest by their dots: a stage's device time and counters include
those of the stages inside it (``suite.flow`` and ``suite.flow.<x>``).
"""

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
import types

import torch

from benchmark import jobs, trace

PREFIX = "dt."
BETWEEN = "between calls"


def within(stage, name):
    """True where ``stage`` is ``name`` or a stage inside it."""
    return stage is not None and (stage == name or stage.startswith(name + "."))


class StageTrace(trace.Trace):
    """A ``trace.Trace`` whose device activities also carry ``stage``: the
    innermost program span open at their launch, or None.  Every reading
    of ``trace.Trace`` reads the benchmark's spans (``bench.``) alone, as
    it does without the program's."""

    def __init__(self, events):
        super().__init__(events)
        stages, launches = [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat == "user_annotation" and name.startswith(PREFIX):
                ts = e["ts"] * 1e-6
                stages.append((ts, ts + e.get("dur", 0) * 1e-6, name[len(PREFIX):]))
            elif cat in trace.HOST_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e["ts"] * 1e-6
        # An outer span before the spans it holds, where they start together.
        self.stages = sorted(stages, key=lambda s: (s[0], -s[1]))
        self._starts = [s[0] for s in self.stages]
        for d in self.device:
            d["stage"] = self.stage_at(launches.get(d["launch"]))

    def stage_at(self, t):
        """The innermost program span open at host time ``t``, or None:
        of the spans that start by ``t``, the last one that has not ended."""
        if t is None:
            return None
        for i in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            lo, hi, name = self.stages[i]
            if hi >= t:
                return name
        return None

    def stage_s(self, stage):
        """Seconds of device activity of ``stage`` and the stages inside it."""
        return sum(d["end"] - d["start"] for d in self.device if within(d["stage"], stage))

    def idle_by_stage(self):
        """{innermost program span open at the gap's middle, or "between
        calls": idle seconds} over every gap between device activities in
        the window."""
        lo, hi = self.window
        out = {}
        for iv in self.busy_intervals().values():
            edges = [lo] + [t for s, e in iv for t in (s, e)] + [hi]
            for s, e in zip(edges[::2], edges[1::2]):
                if e > s:
                    name = self.stage_at((s + e) / 2) or BETWEEN
                    out[name] = out.get(name, 0.0) + e - s
        return out

    def uncovered(self):
        """{benchmark span: its device activities with no program stage
        inside the program's span of that name}, for every benchmark span
        named as a top-level program span: launches no stage accounts for."""
        roots = {name for _, _, name in self.stages if "." not in name}
        out = {}
        for d in self.device:
            if d["span"] in roots and not (d["stage"] or "").startswith(d["span"] + "."):
                out[d["span"]] = out.get(d["span"], 0) + 1
        return out


def profile(run, device):
    """Run ``run()`` under torch.profiler inside the window span, as
    ``trace.profile`` does; returns its StageTrace."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return StageTrace(events)


def readings(ctx):
    """The stretches' readings (``trace``, ``record``, ``jobs``), made on
    the first call and kept on ``ctx``; None where the program records no
    spans."""
    if not hasattr(ctx, "stages"):
        ctx.stages = _measure(ctx)
    return ctx.stages


def _measure(ctx):
    from descriptools_tpu_torch.utils import timing

    if not hasattr(timing, "recording"):
        return None
    device = next(iter(ctx.pool[0].values())).device
    program = jobs.Program(ctx.spec.pipeline)
    run = ctx.spec.kind.run
    failed = []

    def stretch(probe):
        lat = []
        for i in range(ctx.jobs):
            t = time.perf_counter()
            try:
                run(program, ctx.pool[i % len(ctx.pool)], ctx.spec.traffic, probe)
            except RuntimeError as err:  # counted and shown, as the harness's loop does
                failed.append(str(err))
                continue
            if device.type == "cuda":
                torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        return lat

    def unprofiled():  # the harness's unprofiled stretch's probe
        return stretch(jobs.RecordingProbe(device, spans=False))

    held = {}
    with timing.recording():
        tr = profile(lambda: held.update(lat=stretch(jobs.RecordingProbe(device))), device)
    with timing.recording() as record:
        lat = unprofiled()
    # Recording's cost beside the same process's state: off, on, off after it.
    pairs = [unprofiled()]
    with timing.recording():
        pairs.append(unprofiled())
    pairs.append(unprofiled())
    s = types.SimpleNamespace(trace=tr, record=record, jobs=ctx.jobs)
    _say(ctx, s, lat, held["lat"], pairs, failed)
    return s


def _say(ctx, s, lat, profiled, pairs, failed):
    """The stderr line: recording's cost (the recording stretch's mean job
    against the harness's unprofiled stretch's, and three more stretches
    in turn, off, on, off), idle time by stage and the longest gaps under
    the profiler, launches no stage accounts for, the longest operations
    split by stage, and each stage's device time, activities, host time
    and counters a job."""
    n = s.jobs
    host, counters = {}, {}
    for x in s.record.spans:
        host[x.name] = host.get(x.name, 0.0) + 1e-6 * (x.end - x.start) / n
        for k, v in x.counters.items():
            c = counters.setdefault(x.name, {})
            c[k] = c.get(k, 0) + v / n
    device = {}
    for d in s.trace.device:
        st = device.setdefault(str(d["stage"]), dict(device_ms=0.0, activities=0.0, top_ms={}))
        ms = 1e3 * (d["end"] - d["start"]) / n
        st["device_ms"] += ms
        st["activities"] += 1 / n
        st["top_ms"][d["name"][:200]] = st["top_ms"].get(d["name"][:200], 0.0) + ms
    for st in device.values():  # the stage's longest operations, by the first 200 characters of their names
        st["top_ms"] = sorted(st["top_ms"].items(), key=lambda kv: -kv[1])[:3]
    longest = {}  # the operations that took most device time, each split by stage
    for name, _ in s.trace.breakdown(top=3)["device_ops"]:
        split = {}
        for d in s.trace.device:
            if d["name"] == name:
                split[str(d["stage"])] = split.get(str(d["stage"]), 0.0) + 1e3 * (d["end"] - d["start"]) / n
        longest[name[:200]] = split
    lo = s.trace.window[0]
    gaps = []
    for iv in s.trace.busy_intervals().values():
        gaps += [(b - a, a) for (_, a), (b, _) in zip(iv, iv[1:])]
    mean = statistics.mean(lat) if lat else None
    line = dict(
        recording=dict(jobs=n, failed=len(failed), recorded_job_s=mean, unrecorded_job_s=ctx.mean_job_s,
                       cost_s=None if mean is None else mean - ctx.mean_job_s,
                       profiled_job_s=statistics.mean(profiled) if profiled else None,
                       off_on_off_job_s=[statistics.mean(x) if x else None for x in pairs]),
        idle_ms_by_stage={k: 1e3 * v / n for k, v in sorted(s.trace.idle_by_stage().items())},
        longest_gaps=[(s.trace.stage_at(a + g / 2) or BETWEEN, 1e3 * g, a - lo) for g, a in sorted(gaps)[-5:]],
        longest_ops_by_stage=longest,
        uncovered=s.trace.uncovered(),
        device_by_stage=device,
        host_ms_by_span=host,
        counters_by_span=counters,
    )
    print(json.dumps(dict(stages=line)), file=sys.stderr, flush=True)


def device_ms(ctx, stage):
    """Device milliseconds a job of ``stage`` and the stages inside it
    (profiled stretch, recording on)."""
    s = readings(ctx)
    seconds = s.trace.stage_s(stage) if s else 0.0
    return 1e3 * seconds / s.jobs if seconds else None


def _named(s, name):
    return [x for x in s.record.spans if x.name == name] if s else []


def host_ms(ctx, name):
    """Host milliseconds a job inside the spans named ``name``, from their
    start to their end (recording stretch)."""
    s = readings(ctx)
    spans = _named(s, name)
    return 1e-6 * sum(x.end - x.start for x in spans) / s.jobs if spans else None


def self_ms(ctx, name):
    """Host milliseconds a job of the spans named ``name`` less the time of
    the spans opened inside them: their self time (recording stretch)."""
    s = readings(ctx)
    own = {i for i, x in enumerate(s.record.spans) if x.name == name} if s else set()
    if not own:
        return None
    spans = s.record.spans
    inner = sum(x.end - x.start for x in spans if x.parent in own)
    return 1e-6 * (sum(spans[i].end - spans[i].start for i in own) - inner) / s.jobs


def share_ms(ctx, name, root, key, own=False):
    """Host milliseconds a job of the spans named ``name`` (their self time
    where ``own``): their share of the spans named ``root`` in the
    recording stretch, times the harness's host time ``key`` of the same
    call, read in its unprofiled stretch before any profiler ran.  After a
    profiled stretch the process's host calls can run 10-30 % slower on a
    basin job, recording or not, so the recording stretch's own
    milliseconds may read high; its shares hold."""
    part = (self_ms if own else host_ms)(ctx, name)
    whole = host_ms(ctx, root)
    times = ctx.probe.host_s.get(key) if whole else None
    if part is None or not times:
        return None
    return part / whole * 1e3 * statistics.mean(times)


def counter(ctx, name, key):
    """Counter ``key`` a job, summed over the spans named ``name`` and the
    spans inside them (recording stretch); None where none counted it."""
    s = readings(ctx)
    values = [x.counters[key] for x in (s.record.spans if s else ()) if within(x.name, name) and key in x.counters]
    return sum(values) / s.jobs if values else None


def suite_flow_device_ms(ctx):
    return device_ms(ctx, "suite.flow")


def suite_hand_device_ms(ctx):
    return device_ms(ctx, "suite.hand")


def suite_gfi_device_ms(ctx):
    return device_ms(ctx, "suite.gfi")


def suite_flow_enqueue_ms(ctx):
    return share_ms(ctx, "suite.flow", "suite", "suite.enqueue")


def suite_hand_enqueue_ms(ctx):
    return share_ms(ctx, "suite.hand", "suite", "suite.enqueue")


def suite_gfi_enqueue_ms(ctx):
    return share_ms(ctx, "suite.gfi", "suite", "suite.enqueue")


def terrain_d8_device_ms(ctx):
    return device_ms(ctx, "terrain.d8")


def terrain_accumulation_device_ms(ctx):
    return device_ms(ctx, "terrain.accumulation")


def terrain_accumulation_host_reads(ctx):
    return counter(ctx, "terrain.accumulation", "host_reads")


def classify_device_ms(ctx):
    return device_ms(ctx, "classify")


def classify_search_ms(ctx):
    return share_ms(ctx, "classify.search", "classify", "classify", own=True)


def classify_host_reads(ctx):
    return counter(ctx, "classify", "host_reads")
