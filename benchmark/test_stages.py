"""The per-stage readings (``stages.py``): device activities tied to the
program's innermost span, the benchmark's own readings unchanged beside
the program's spans, the readers, a traced run on the CPU, and on the card
the host reads the program's counters count."""

import json
import time
import traceback
import types
import warnings
from pathlib import Path

import pytest
import torch

from benchmark import found, harness, inputs, jobs, stages, trace
from benchmark.conftest import ROOT
from descriptools_tpu_torch.utils import timing

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {  # metric: what it reads
    "suite.flow.device_ms": "device", "suite.hand.device_ms": "device", "suite.gfi.device_ms": "device",
    "suite.flow.enqueue_ms": "host", "suite.hand.enqueue_ms": "host", "suite.gfi.enqueue_ms": "host",
    "terrain.d8.device_ms": "device", "terrain.accumulation.device_ms": "device",
    "terrain.accumulation.host_reads": "counter", "classify.device_ms": "device",
    "classify.search_ms": "host", "classify.host_reads": "counter",
}


def _x(cat, name, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)


def _launch(ts, corr, kernel_ts, kernel_dur, name="k"):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr),
            _x("kernel", name, kernel_ts, kernel_dur, correlation=corr, device=0)]


# A window (0-1000 us) holding a suite call (10-410) and a terrain call
# (500-700), each in a benchmark span and the program's spans; launches
# inside a child stage, inside a top-level stage alone, and outside both.
PROGRAM = [
    _x("user_annotation", "dt.suite", 11, 398),
    _x("user_annotation", "dt.suite.inputs", 11, 5),
    _x("user_annotation", "dt.suite.flow", 20, 100),
    _x("user_annotation", "dt.suite.hand", 130, 100),
    _x("user_annotation", "dt.terrain", 501, 198),
    _x("user_annotation", "dt.terrain.d8", 502, 50),
]
EVENTS = [
    _x("user_annotation", "bench.window", 0, 1000),
    _x("user_annotation", "bench.suite", 10, 400),
    _x("user_annotation", "bench.terrain", 500, 200),
    *PROGRAM,
    *_launch(12, 1, 14, 6, "cast"),
    *_launch(25, 2, 30, 50, "walk"),
    *_launch(40, 3, 80, 20, "walk"),
    *_launch(125, 4, 126, 4, "stray"),
    *_launch(140, 5, 150, 40, "gather"),
    *_launch(510, 6, 520, 30, "d8"),
    *_launch(600, 7, 610, 10, "mask"),
    *_launch(800, 8, 805, 5, "outside"),
]
STAGE_OF = {1: "suite.inputs", 2: "suite.flow", 3: "suite.flow", 4: "suite", 5: "suite.hand", 6: "terrain.d8",
            7: "terrain", 8: None}


def test_activity_takes_innermost_stage():
    tr = stages.StageTrace(EVENTS)
    assert {d["launch"]: d["stage"] for d in tr.device} == STAGE_OF
    assert tr.uncovered() == {"suite": 1, "terrain": 1}
    assert tr.stage_s("suite") == pytest.approx(120e-6)
    assert tr.stage_s("suite.flow") == pytest.approx(70e-6)
    assert tr.stage_s("terrain") == pytest.approx(40e-6)
    assert tr.stage_s("classify") == 0.0


def test_idle_by_stage():
    idle = stages.StageTrace(EVENTS).idle_by_stage()
    assert sum(idle.values()) == pytest.approx(1e-3 - 165e-6)
    assert idle == {stages.BETWEEN: pytest.approx((14 + 185 + 190) * 1e-6), "suite.flow": pytest.approx(36e-6),
                    "suite.hand": pytest.approx(20e-6), "suite": pytest.approx(330e-6),
                    "terrain": pytest.approx(60e-6)}


def test_bench_readings_unchanged_by_program_spans():
    """Every reading of ``trace.Trace`` reads the same with and without the
    program's spans in the trace."""
    bare = trace.Trace([e for e in EVENTS if not e["name"].startswith("dt.")])
    tr = stages.StageTrace(EVENTS)
    for t in (5e-6, 12e-6, 25e-6, 125e-6, 510e-6, 800e-6, None):
        assert tr.span_at(t) == bare.span_at(t)
    assert tr.spans == bare.spans and tr.window == bare.window
    for span in ("suite", "terrain", None):
        assert tr.count(span) == bare.count(span)
        assert tr.device_s(span=span) == bare.device_s(span=span)
        assert tr.device_s(span=span, names=("walk",)) == bare.device_s(span=span, names=("walk",))
    assert tr.breakdown() == bare.breakdown()
    assert tr.busy_s() == bare.busy_s() and tr.idle_gaps() == bare.idle_gaps()


def _span(name, parent, start_ms, end_ms, **counters):
    s = timing.Span(name, parent, 0, counters)
    s.start, s.end = int(start_ms * 1e6), int(end_ms * 1e6)
    return s


def _ctx(jobs=2):
    """A traced run's context whose per-stage readings are made: two jobs'
    worth of spans in the trace (``EVENTS``) and in the record."""
    rec = timing.Record()
    rec.spans += [
        _span("suite", None, 0, 10), _span("suite.flow", 0, 1, 3), _span("suite.hand", 0, 3, 4),
        _span("suite.gfi", 0, 4, 6),
        _span("terrain", None, 10, 20), _span("terrain.d8", 4, 10, 12),
        _span("terrain.accumulation", 4, 12, 20, host_reads=7, rounds=3),
        _span("classify", None, 20, 30), _span("classify.stats", 7, 20, 21, host_reads=1),
        _span("classify.search", 7, 21, 29, host_reads=3), _span("classify.search.pass", 9, 22, 24),
    ]
    probe = types.SimpleNamespace(host_s={"suite.enqueue": [3e-3, 5e-3], "classify": [8e-3]})
    return types.SimpleNamespace(stages=types.SimpleNamespace(trace=stages.StageTrace(EVENTS), record=rec,
                                                              jobs=jobs), probe=probe)


def _reader(name):
    return found.module("metrics", name).read


def test_new_metrics_are_entries_with_readers():
    names = {m["name"] for m in BENCH["per_layer"]}
    for name in NEW:
        cells = [n for n in names if n == name or n.rsplit(".", 1)[0] == name]
        assert cells, name
        assert _reader(name) is not None


def test_readers_read_their_spans():
    ctx = _ctx()
    want = {
        "suite.flow.device_ms": 70e-3 / 2, "suite.hand.device_ms": 40e-3 / 2, "suite.gfi.device_ms": None,
        # shares of the suite's 5 ms a job in the record, times the unprofiled 4 ms
        "suite.flow.enqueue_ms": 0.8, "suite.hand.enqueue_ms": 0.4, "suite.gfi.enqueue_ms": 0.8,
        "terrain.d8.device_ms": 30e-3 / 2, "terrain.accumulation.device_ms": None,
        "terrain.accumulation.host_reads": 3.5, "classify.device_ms": None,
        "classify.search_ms": 3.0 / 5.0 * 8.0, "classify.host_reads": 2.0,
    }
    for name, value in want.items():
        got = _reader(name)(ctx)
        assert got == (None if value is None else pytest.approx(value)), name


def test_readers_none_without_the_program_spans(monkeypatch):
    ctx = _ctx()
    ctx.stages.record.spans.clear()
    ctx.stages.trace = stages.StageTrace([e for e in EVENTS if not e["name"].startswith("dt.")])
    assert all(_reader(name)(ctx) is None for name in NEW)
    monkeypatch.delattr(timing, "recording")  # a program that records no spans
    ctx = types.SimpleNamespace()
    assert stages.readings(ctx) is None and ctx.stages is None
    assert all(_reader(name)(ctx) is None for name in NEW)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reads_the_new_metrics(tiny, capsys, workload):
    """A traced run on the CPU reports every new metric of its cell that the
    host reads; the device's are read on the card alone.  Its stderr line
    gives the stages, and no launch falls outside a stage."""
    r = harness.Run(harness.Spec(tiny, workload), 2**31 + 5, 0.3, True, device="cpu").execute()
    assert r["correct"] is True
    mine = [m["name"] for m in BENCH["per_layer"] if workload in m["workloads"]
            and (m["name"] in NEW or m["name"].rsplit(".", 1)[0] in NEW)]
    assert mine
    for name in mine:
        kind = NEW.get(name) or NEW[name.rsplit(".", 1)[0]]
        assert (name in r["metrics"]) == (kind != "device"), name
    line = [json.loads(x) for x in capsys.readouterr().err.splitlines() if x.startswith('{"stages"')]
    assert len(line) == 1 and line[0]["stages"]["uncovered"] == {}
    assert line[0]["stages"]["recording"]["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_sync_warnings_are_the_counted_reads(card, workload):
    """One job of the cell at its size under ``set_sync_debug_mode("warn")``,
    after a first one: as many synchronizing calls with recording on as
    off, and inside ``terrain`` and ``classify`` as many as their
    ``host_reads`` and ``host_writes``."""
    spec = harness.Spec(ROOT, workload)
    x = inputs.make_input(spec.traffic, spec.rows, spec.cols, 2**31 + 77, card)
    program = jobs.Program(spec.pipeline)

    def job():
        spec.kind.run(program, x, spec.traffic, jobs.Probe())

    def syncs():
        """[(host time, the call's last line in this repository)] of each
        synchronizing call of one job."""
        seen = []

        def hook(message, *args, **kwargs):
            if "synchroniz" in str(message):
                here = [f for f in traceback.extract_stack() if str(ROOT) in f.filename and "test_" not in f.filename]
                seen.append((time.perf_counter_ns(), f"{Path(here[-1].filename).name}:{here[-1].lineno}"
                             if here else "?"))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                job()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return seen

    job()
    torch.cuda.synchronize()
    first = syncs()
    off = syncs()
    with timing.recording() as rec:
        on = syncs()

    def inner(t):  # the innermost span open at t
        open_ = [s for s in rec.spans if s.start <= t <= s.end]
        return max(open_, key=lambda s: s.start).name if open_ else None

    by, sites, counted = {}, {}, {}
    for t, site in on:
        by[inner(t)] = by.get(inner(t), 0) + 1
        sites[site] = sites.get(site, 0) + 1
    for s in rec.spans:
        for k in ("host_reads", "host_writes"):
            counted.setdefault(s.name, {})[k] = counted.get(s.name, {}).get(k, 0) + s.counters.get(k, 0)
    print(json.dumps(dict(sync_warnings=dict(workload=workload, first=[x for _, x in first], off=len(off),
                                             on=len(on), by_span=by, sites=sites, counted=counted))))
    assert len(on) == len(off)
    for root in ("terrain", "classify"):
        assert sum(n for k, n in by.items() if stages.within(k, root)) == sum(
            sum(c.values()) for k, c in counted.items() if stages.within(k, root)), root
