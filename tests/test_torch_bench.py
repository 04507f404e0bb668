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
  (read from its source) at small sizes.

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
    assert line["device"] == "cpu" and line["baseline"]["threads"] == torch.get_num_threads()


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
