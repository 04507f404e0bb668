"""The port's spans and counters (``utils.timing.span``, ``count``,
``recording``) in ``descriptor_suite``, ``derive_terrain`` and the
one-device ``sharded_classify_flood``: how they nest, what they count, that
they change no output, and that nothing is recorded while recording is off."""

import contextlib
import json

import numpy as np
import pytest
import torch

from descriptools_tpu_torch import pipeline
from descriptools_tpu_torch.d8 import doubling_rounds
from descriptools_tpu_torch.ops import terrain
from descriptools_tpu_torch.parallel import classify
from descriptools_tpu_torch.utils import timing
from descriptools_tpu_torch.utils.synthetic import synthetic_basin

CFG = pipeline.PipelineConfig()
TREES = {
    "suite": ["suite.inputs", "suite.stencil", "suite.downslope", "suite.flow", "suite.hand", "suite.gfi"],
    "terrain": ["terrain.d8", "terrain.accumulation"],
    "classify": ["classify.stats", "classify.search", "classify.map"],
}
NESTED = {"classify.count": "classify.search"}  # a stage's spans opened inside another stage's


@pytest.fixture(scope="module")
def basin():
    dem, fdr, river, fac = synthetic_basin(40, 56, seed=3)
    return [torch.as_tensor(a) for a in (dem.astype(np.int32), fdr, fac.astype(np.int32), river)]


@pytest.fixture(scope="module")
def calls(basin):
    """One call of each entry point, on the basin: (name, call)."""
    hand = pipeline.descriptor_suite(*basin, CFG)["hand"]
    flood = ((hand != -100) & (hand <= 6)).to(torch.uint8)
    frac = torch.as_tensor(np.random.default_rng(4).uniform(0.0, 0.9, tuple(hand.shape)), dtype=torch.float32)
    float_hand = torch.where(hand == -100, -100.0, hand + frac)
    return {
        "suite": lambda: pipeline.descriptor_suite(*basin, CFG),
        "terrain": lambda: terrain.derive_terrain(basin[0]),
        "classify": lambda: classify.sharded_classify_flood(hand, flood, device="cpu"),
        "classify_float": lambda: classify.sharded_classify_flood(float_hand, flood, device="cpu"),
    }


@pytest.mark.parametrize("entry", list(TREES))
def test_spans_nest_with_one_request_per_call(calls, entry):
    with timing.recording() as rec:
        calls[entry]()
        calls[entry]()
    roots = [i for i, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[r].name for r in roots] == [entry] * 2
    for root, end in zip(roots, roots[1:] + [len(rec.spans)]):
        spans = rec.spans[root:end]
        stages = [s for s in spans[1:] if s.name not in NESTED]
        assert [s.name for s in stages] == TREES[entry] and all(s.parent == root for s in stages)
        for s in spans[1:]:
            if s.name in NESTED:
                outer = rec.spans[s.parent]
                assert outer.name == NESTED[s.name] and outer.start <= s.start <= s.end <= outer.end
        assert {s.request for s in spans} == {root}
        assert all(spans[0].start <= s.start <= s.end <= spans[0].end for s in spans)
        assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    assert not rec._open


def test_recording_nests_and_restores():
    with timing.recording() as outer:
        with timing.span("a"):
            with timing.recording() as inner:
                with timing.span("b", k=1):
                    timing.count("k", 2)
            timing.count("k")
    assert [(s.name, s.counters) for s in outer.spans] == [("a", {"k": 1})]
    assert [(s.name, s.counters) for s in inner.spans] == [("b", {"k": 3})]


def test_recording_off_records_nothing(calls):
    assert timing.span("a") is timing.span("b", k=1)
    assert isinstance(timing.span("a"), contextlib.nullcontext)
    with timing.span("a"):
        timing.count("k")
    calls["terrain"]()
    with timing.recording() as rec:
        timing.count("k")  # no span open: dropped
    assert rec.spans == []


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_profiler_sees_spans_only_while_recording(calls, on):
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.recording() if on else contextlib.nullcontext():
            calls["terrain"]()
    names = {e.name for e in prof.events() if e.name.startswith("dt.")}
    assert names == ({"dt.terrain", "dt.terrain.d8", "dt.terrain.accumulation"} if on else set())


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    else:
        assert a == b


@pytest.mark.parametrize("entry", list(TREES))
def test_outputs_bitwise_with_recording_on_and_off(calls, entry):
    off = calls[entry]()
    with timing.recording():
        on = calls[entry]()
    _same(on, off)


@pytest.mark.parametrize("max_path", [None, 4])
def test_accumulation_counters(basin, max_path):
    """``rounds`` is ``stats["rounds"]``, ``live_cells`` the sum of
    ``stats["live"]``, and ``host_reads`` 1 + 1 a round: the live list's
    length once to start, then once a round.  D8 fills its divisors on
    the device: no ``host_writes``."""
    stats = {}
    with timing.recording() as rec:
        terrain.derive_terrain(basin[0], max_path=max_path, stats=stats)
    by = {s.name: s.counters for s in rec.spans}
    assert by["terrain"] == {} and by["terrain.d8"] == {}
    assert by["terrain.accumulation"] == dict(
        host_reads=1 + stats["rounds"], rounds=stats["rounds"], live_cells=sum(stats["live"]))
    assert stats["rounds"] == 2 if max_path == 4 else stats["rounds"] > 2  # truncated at log2(4) rounds


def test_flow_rounds_counted(calls):
    """On the CPU the flow stage runs the plain engine: its rounds are
    counted, and ``fused`` is absent."""
    with timing.recording() as rec:
        calls["suite"]()
    by = {s.name: s.counters for s in rec.spans}
    assert by["suite.flow"] == {"rounds": doubling_rounds(CFG.flow_max_steps)}
    assert "fused" not in by["suite.flow"]
    assert all(c == {} for name, c in by.items() if name != "suite.flow")


@pytest.mark.cuda
def test_flow_stage_is_one_entry_on_the_card(basin, tmp_path):
    """On the card ``suite.flow`` counts ``fused`` 1 and the jump walk's R,
    and launches at most 2 + R + 1 device activities (a memset, phase 1,
    R rounds, the finish): no torch op runs in the stage."""
    from torch.profiler import ProfilerActivity

    from descriptools_tpu_torch.ops.cuda import walk

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = [t.to("cuda") for t in basin]
    pipeline.descriptor_suite(*inputs, CFG)  # builds and loads the kernels
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with timing.recording() as rec:
            pipeline.descriptor_suite(*inputs, CFG)
        torch.cuda.synchronize()
    rounds = walk.flow_walk.rounds
    assert {s.name: s.counters for s in rec.spans}["suite.flow"] == {"rounds": rounds, "fused": 1}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    stage = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == "dt.suite.flow")
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
                and stage["ts"] <= e["ts"] <= stage["ts"] + stage["dur"]}
    device = [e["name"] for e in events if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
              and e.get("args", {}).get("correlation") in launched]
    assert 0 < len(device) <= 2 + rounds + 1, device
    assert sum("jump_start_kernel" in name for name in device) == 1, device
    assert sum("flow_finish_kernel" in name for name in device) == 1, device


@pytest.mark.parametrize("hand", ["integer", "float"])
def test_classify_counts_its_host_reads_and_writes(calls, monkeypatch, hand):
    """The classifier's ``host_reads`` are its ``.cpu()`` reads: the
    statistics' one, then one a counting pass, each in a ``classify.count``
    span (a pass a search stage with a cutoff not counted yet: three on
    this basin's integer HAND, whose later stages' integer cutoffs repeat
    earlier ones, five on its float HAND; the final threshold's is counted
    already).  It makes no ``host_writes``: its 0-dim tensors of host
    values (the second minimum's fill, the class map's cut) are filled on
    the device, and a counting pass takes its cutoffs as kernel
    parameters."""
    reads, writes = [], []
    real_cpu, real_tensor, real_as = torch.Tensor.cpu, torch.tensor, torch.as_tensor
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(1) or real_cpu(self, *a, **k))
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: writes.append(1) or real_tensor(*a, **k))
    monkeypatch.setattr(torch, "as_tensor", lambda x, *a, **k: (  # a list of cuts, not the flood map
        writes.append(1) if isinstance(x, list) else None) or real_as(x, *a, **k))
    with timing.recording() as rec:
        calls["classify" if hand == "integer" else "classify_float"]()
    by = {}
    for s in rec.spans:
        r, w = by.get(s.name, (0, 0))
        by[s.name] = (r + s.counters.get("host_reads", 0), w + s.counters.get("host_writes", 0))
    want = {"classify": (0, 0), "classify.stats": (1, 0), "classify.map": (0, 0)}
    want.update({"classify.search": (0, 0), "classify.count": (3 if hand == "integer" else 5, 0)})
    assert by == want
    assert sum(r for r, _ in by.values()) == len(reads)
    assert sum(w for _, w in by.values()) == len(writes)
