"""The port's measuring entry points on the CPU: ``bench_torch.py`` (the
counterpart of ``bench.py``) and ``bench_configs_torch.py`` (the
counterpart of ``scripts/bench_configs.py``).

- ``bench_torch``'s line holds every key of ``bench.py``'s line (read from
  its source with ``ast``, never imported); ``value`` is cells over the
  sustained seconds, rounded as ``bench.py`` rounds it;
- the CPU leg is cached per git revision and metric under the root's
  ``build/``: read back for the same revision and metric, measured anew
  for another, or where the file is unreadable;
- the check of the timed suite against ``engine="torch"`` raises on a
  corrupted raster, bitwise or transcendental;
- the default input (``windowed_basin(2178, 1534, seed=0)``) hashes to
  the North star's parity reference;
- each config of ``bench_configs_torch`` gives the JAX script's result keys
  (read from its source) at small sizes;
- the default line keeps the keys it had before the modes below; under
  ``--engine torch_blocked`` it holds the same keys, the fold's walk tiers
  and a suite held to that engine, its CPU leg the count engine's as for
  every engine; ``--engine cuda`` and ``cuda_blocked`` raise on the CPU;
- ``--tiled 96 --tile 48`` and ``--checkpointed 96`` read
  ``windowed_basin(96, 96, seed=0)`` from memmaps under the root, written
  once, their last run bitwise the in-core suite (the mode checks it);
- the synchronising-call check: 0 under the count engine, the fold's one
  under ``cuda_blocked``, any other count raises;
- without git the revision is the hash of the port's sources.
(``--long-drainage`` is held to JAX in ``tests/test_torch_long_drainage.py``,
beside the JAX run it needs.)

Every run is on the CPU (``device="cpu"``), at 64x64 but for the hashes.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

import bench_configs_torch as bc
import bench_torch as bt
from descriptools_tpu_torch import pipeline
from descriptools_tpu_torch.utils import parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "64"]
METRIC = "full_descriptor_suite_synthetic_64"


def _bench_py_keys():
    """The keys of the dict ``bench.py``'s ``main`` prints with ``json.dumps``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py prints no dict")


def _bench_configs_keys():
    """{result key: the keys of its dict} of ``scripts/bench_configs.py``."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "bench_configs.py")).read())
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}

    def dict_keys(call):
        if call.func.id == "dict":
            return {k.arg for k in call.keywords}
        ret = next(n for n in ast.walk(funcs[call.func.id]) if isinstance(n, ast.Return))
        return dict_keys(ret.value)

    out = {}
    for node in ast.walk(funcs["main"]):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.value, ast.Call) and isinstance(node.value.func, ast.Name)):
            out[node.targets[0].slice.value] = dict_keys(node.value)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU suites beside other test processes: torch's thread pool
    waits far longer on its threads than it computes, so one thread (the
    values do not change; only the CPU leg's seconds, which no test pins)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rev(monkeypatch):
    """The revision ``bench_torch`` reads, set by the test (the checkout
    need not be a git repository)."""
    state = {"rev": "rev-a"}
    monkeypatch.setattr(bt, "_rev", lambda: state["rev"])
    return state


def _measure(root, argv=SMALL, **kw):
    return bt.measure(argv, device="cpu", iters=1, batch=2, root=str(root), **kw)


def test_jax_keys_are_bench_py_keys():
    assert list(bt.JAX_KEYS) == _bench_py_keys()


def test_line_holds_bench_py_keys_and_value_is_cells_over_sustained_seconds(tmp_path, rev):
    line = _measure(tmp_path)
    assert set(_bench_py_keys()) <= set(line)
    assert json.loads(json.dumps(line)) == line  # one JSON object
    assert line["metric"] == METRIC and line["unit"] == "grid-points/s/chip"
    assert line["cells"] == 64 * 64 and line["grid"] == [64, 64]
    assert line["value"] == round(line["cells"] / line["sustained_s"], 1)
    assert line["steady_state_ms"] == round(line["sustained_s"] * 1e3, 1)
    assert line["latency_ms_incl_sync_rtt"] == round(line["latency_s"] * 1e3, 1)
    assert line["vs_baseline"] == round(line["baseline"]["seconds"] / line["sustained_s"], 3)
    assert line["n_timing_batches"] == 1 and line["rev"] == "rev-a"
    # On the CPU the engine is the plain one and no kernel launches.
    assert line["engine"] == "torch" and line["walk_tiers"]["flow"] == "doubling_walk"
    assert line["suites_run"] == (bt.WARMUP + 1) * (1 + 2) + 1
    assert set(line["kernels"]) >= set(bt.IN_CORE) and not any(line["kernels"].values())
    assert line["correct"] is True and line["max_abs_err"] == 0.0
    assert line["device"] == "cpu" and line["baseline"]["threads"] == torch.get_num_threads() == 1


def test_cpu_leg_is_cached_by_revision_and_metric(tmp_path, rev):
    path = tmp_path / "build" / f"bench_cpu_{METRIC}.json"
    first = _measure(tmp_path)["baseline"]
    assert not first["cached"] and path.is_file()
    assert json.loads(path.read_text()) == dict(rev="rev-a", t_cpu=first["seconds"], threads=first["threads"],
                                                cpu_model=first["cpu_model"])
    again = _measure(tmp_path)["baseline"]
    assert again["cached"] and again["seconds"] == first["seconds"]
    # Another metric has its own file.
    other = _measure(tmp_path, ["--synthetic", "48"])["baseline"]
    assert not other["cached"] and (tmp_path / "build" / "bench_cpu_full_descriptor_suite_synthetic_48.json").is_file()
    # Another revision measures anew and rewrites the file.
    rev["rev"] = "rev-b"
    newer = _measure(tmp_path)["baseline"]
    assert not newer["cached"] and json.loads(path.read_text())["rev"] == "rev-b"
    # An unreadable file, or one without the fields, is measured anew.
    for text in ("{not json", json.dumps({"rev": "rev-b"})):
        path.write_text(text)
        assert not _measure(tmp_path)["baseline"]["cached"]
        assert json.loads(path.read_text())["rev"] == "rev-b"


def test_without_a_revision_the_cache_is_not_read(tmp_path, rev):
    rev["rev"] = None
    assert not _measure(tmp_path)["baseline"]["cached"]
    assert not _measure(tmp_path)["baseline"]["cached"]


@pytest.fixture(scope="module")
def small_suite():
    a = bt._inputs(bt.parser().parse_args(["--synthetic", "32"]))[0]
    inputs = pipeline.inputs_to_torch(a["dem"], a["fdr"], a["fac"], a["river"], "cpu")
    return pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))


@pytest.mark.parametrize("name, delta", [("hand", 1), ("indices", 1), ("fdist", 1e-3), ("twi", 1e-2)])
def test_check_suite_raises_on_a_corrupted_raster(small_suite, name, delta):
    assert bt.check_suite(small_suite, small_suite) == 0.0
    out = dict(small_suite)
    bad = out[name].clone()
    valid = (torch.isfinite(bad) & (bad != -100)).nonzero()[0]
    bad[tuple(valid)] += delta
    out[name] = bad
    with pytest.raises(AssertionError, match=f"{name}: 1 cells differ"):
        bt.check_suite(out, small_suite)


def test_default_inputs_hash_to_the_parity_reference():
    arrays, metric = bt._inputs(bt.parser().parse_args([]))
    assert metric == "full_descriptor_suite_windowed_basin_2178x1534"
    rows, cols = bt.DEFAULT_SHAPE
    assert arrays["dem"].shape == (rows, cols) and arrays["dem"].dtype == np.int32
    ref = parity.load(bt.REFERENCE)
    dtypes = parity.hash_dtypes(ref)
    for k in parity.INPUTS:
        assert parity.sha256(arrays[k], dtypes[k]) == str(ref[f"{rows}x{cols}.sha256.{k}"]), k


def test_measure_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.measure(SMALL)


def test_configs_are_the_jax_scripts():
    assert {c.__name__ for c in bc.CONFIGS} == {k for k in _bench_configs_keys() if k.startswith("config")}


@pytest.mark.parametrize("config", bc.CONFIGS, ids=lambda c: c.__name__)
def test_config_gives_the_jax_scripts_keys(config):
    small = dict(rows=64, cols=48) if config is bc.config4_calibration_basin else dict(size=64)
    got = config(device="cpu", iters=1, **small)
    assert _bench_configs_keys()[config.__name__] <= set(got)
    assert got["seconds"] > 0 and got["grid_points_per_s"] == got["cells"] / got["seconds"]
    if config is bc.config2_stencil_slope_twi_4096:
        assert got["bound_s"] == 64 * 64 * 24 / 3.35e12 and got["bound_by"] == "bytes"
    if config is bc.config4_calibration_basin:
        assert got["cells"] == 64 * 48 and 0 <= got["threshold"] <= 1


# The default line's keys before the long-drainage and out-of-core modes.
DEFAULT_KEYS = {*bt.JAX_KEYS, "grid", "cells", "sustained_s", "latency_s", "device", "torch_version", "cuda_version",
                "kernels", "suites_run", "correct", "checked_against", "max_abs_err", "baseline"}


@pytest.mark.parametrize("engine", [None, "torch_blocked"])
def test_engine_flag_keeps_the_line_and_holds_the_suite_to_its_order(tmp_path, rev, engine):
    line = _measure(tmp_path, SMALL + (["--engine", engine] if engine else []))
    assert set(line) == DEFAULT_KEYS
    assert line["engine"] == (engine or "torch") and line["walk_tiers"] == bt.STAGES[line["engine"]]
    assert line["baseline"]["engine"] == "torch" and line["correct"] is True
    assert "synchronising CUDA calls" in line["methodology"]
    if engine:
        assert line["walk_tiers"]["flow"] == "fold_walk" and line["metric"] == METRIC


@pytest.mark.parametrize("engine", ["cuda", "cuda_blocked"])
def test_a_cuda_engine_on_the_cpu_raises(tmp_path, rev, engine):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _measure(tmp_path, SMALL + ["--engine", engine])


@pytest.mark.parametrize("argv", [["--tile", "48"], ["--tiled", "96", "--engine", "cuda"],
                                  ["--checkpointed", "96", "--tile", "48"]])
def test_flags_that_do_not_go_together_are_refused(argv):
    with pytest.raises(SystemExit):
        bt._parse(argv)


@pytest.mark.parametrize("argv, metric", [
    (["--tiled", "96", "--tile", "48"], "tiled_descriptor_suite_windowed_basin_96_tile_48"),
    (["--checkpointed", "96"], "checkpointed_descriptor_suite_windowed_basin_96"),
])
def test_out_of_core_modes_read_memmaps_and_hold_to_the_in_core_suite(tmp_path, rev, argv, metric):
    first = _measure(tmp_path, argv)
    assert {*bt.JAX_KEYS, "correct", "max_abs_err", "prep_s", "cached", "kernels"} <= set(first)
    assert first["metric"] == metric and first["correct"] is True and first["max_abs_err"] == 0.0
    assert first["cells"] == 96 * 96 and first["value"] == round(first["cells"] / np.median(first["run_s"]), 1)
    assert first["runs"] == bt.WARMUP + 1 and len(first["run_s"]) == 1 and not first["cached"]
    assert (tmp_path / bt.INPUT_CACHE / "dem.npy").is_file()
    if argv[0] == "--tiled":
        assert first["tiles"] == 4 and first["walk_tiers"] == bt.STAGES["torch"]
    else:
        assert set(first["stages_s"]) == {"stencil", "walks", "flow", "pointwise"}
        assert not [p for p in (tmp_path / "build").iterdir() if p.name.startswith("bench_ckpt_")]
    again = _measure(tmp_path, argv)
    assert again["cached"] and again["baseline"]["cached"]


def test_sync_check_counts_the_folds_one_read():
    events = [("cudaLaunchKernel", 1, 2), ("cudaMemcpyAsync", 3, 4), ("cudaStreamSynchronize", 5, 6),
              ("cudaMemsetAsync", 7, 8), ("cudaDeviceSynchronize", 12, 13)]  # the last: the profiler's, at its stop
    assert bt.sync_calls(events, (0, 10)) == 1 and bt.sync_calls(events, (0, 4.5)) == 0
    assert bt.sync_calls(events, (0, 20)) == 2
    assert bt.check_syncs("cuda", 0) == 0 and bt.check_syncs("cuda_blocked", 1) == bt.FOLD_SYNCS == 1
    assert bt.check_syncs("torch", 7) is None and bt.check_syncs("torch_blocked", 0) is None
    for engine, counted in (("cuda", 1), ("cuda_blocked", 0), ("cuda_blocked", 2)):
        with pytest.raises(AssertionError, match="synchronising CUDA calls"):
            bt.check_syncs(engine, counted)
    # On the CPU there is no CUDA call to count.
    assert bt.count_syncs(lambda: 5, torch.device("cpu")) == (5, 0)


def test_without_git_the_revision_is_the_sources_hash(monkeypatch):
    monkeypatch.setattr(bt.provenance, "git_rev", lambda root: None)
    rev = bt._rev()
    assert rev == bt.source_rev(bt.ROOT) and rev.startswith("src-") and len(rev) == 20


def test_spread_summary_and_busy_share_arithmetic():
    import bench_spread_torch as bs

    s = bs.summary([5.0, 1.0, 3.0, 2.0, 4.0])
    assert (s["n"], s["median"], s["q1"], s["q3"], s["min"], s["max"]) == (5, 3.0, 2.0, 4.0, 1.0, 5.0)
    assert s["spread_over_median"] == 4.0 / 3.0 and s["iqr_over_median"] == 2.0 / 3.0
    # Overlapping intervals count once; what lies outside the window not at all.
    assert bs._clipped_union_us([(0, 4), (2, 6), (8, 20), (-5, 1)], (1, 10)) == 5 + 2
    assert bs._clipped_union_us([], (0, 1)) == 0.0
