"""The port's provenance stamp and timing helpers (torch, no JAX)."""

import os
import time

import pytest
import torch

from descriptools_tpu_torch.utils import provenance, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stamp_fields():
    s = provenance.stamp(REPO)
    assert s["rev"] and isinstance(s["rev"], str)
    assert isinstance(s["engine_sources_dirty"], bool)
    assert s["torch_version"] == torch.__version__
    assert s["cuda_version"] == torch.version.cuda
    assert s["time_utc"].endswith("Z")


def test_engine_paths_name_the_port_and_exist():
    for path in provenance.ENGINE_PATHS:
        assert path.startswith("descriptools_tpu_torch/"), path
        assert os.path.exists(os.path.join(REPO, path)), path
    assert "descriptools_tpu_torch/csrc" in provenance.ENGINE_PATHS
    assert provenance.engine_sources_changed_since(REPO, None) is None
    assert provenance.engine_sources_changed_since(REPO, "0" * 40) is None
    assert provenance.engine_sources_changed_since(REPO, provenance.git_rev(REPO)) in (True, False)


def test_timeit_and_sync_on_cpu():
    calls = []

    def work(x, scale=1.0):
        calls.append(x)
        time.sleep(0.01 * scale)
        return torch.ones(3) * x

    t = timing.timeit(work, 2, warmup=2, iters=3, device="cpu", scale=1.0)
    assert len(calls) == 5 and 0.005 < t < 1.0
    tree = {"a": torch.zeros(2)}
    assert timing.sync(tree) is tree
    assert timing.grid_points_per_second(100, 0.5) == 200


def test_timeit_syncs_inside_the_host_clock_window(monkeypatch):
    """On the host clock each timed call ends in a ``sync`` before the clock
    stops, so queued CUDA work is timed, not only its launch."""
    events = []
    monkeypatch.setattr(timing, "sync", lambda tree=None: events.append("sync") or tree)
    real_clock = time.perf_counter
    monkeypatch.setattr(timing.time, "perf_counter", lambda: events.append("clock") or real_clock())
    timing.timeit(lambda: events.append("call"), warmup=1, iters=3, device="cpu")
    timed = events[events.index("clock"):]
    assert timed == ["clock", "call", "sync", "clock"] * 3


def test_timeit_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        timing.timeit(lambda: None, device="cuda", warmup=0, iters=1)


def test_trace_writes_a_profile(tmp_path):
    with timing.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(tmp_path.iterdir())
    assert prof.key_averages()
