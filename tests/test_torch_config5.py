"""``config5_torch.py`` (BASELINE config 5, out of core on one card) on the
CPU at n = 300 in 128x128 tiles, ``device="cpu"``:

- ``prepare_inputs`` writes memmaps bitwise equal to those of the JAX
  script's ``scripts/config5_1e9.prepare_inputs`` (in one process and in
  two, in windows of 4096 and of 128), and ``meta.json`` the same;
- ``tiled_suite`` on the disk loaders with ``out_dir`` and no input cache
  is bitwise the port's in-core suite on indices, HAND, downslope, slope
  and fdist (HAND in the dem's int16);
- the sample checks and the streaming invariants pass (0 violations over
  every cell);
- the streaming classifier's threshold, Correctness, Fit and class map are
  ``pipeline.classify_flood``'s;
- the disk check raises and says how much is lacking; an out-of-range dem
  raises;
- ``main``'s flags are the JAX script's, with its defaults (read from its
  source): the four link knobs on, ``--engine auto``, the invariants run;
  the run with the knobs on (the default) equals the run with all four off
  (and ``skip_verify``, which leaves out the invariants; the test runs
  them on its outputs) on indices, HAND, downslope, slope and fdist
  bitwise and on the five transcendental rasters within rtol 2e-5, atol
  1e-4; its JSON carries the knobs, ``download_bytes_per_cell`` (18
  against 38) and the measured download bytes of each pass, pass C's 20 B
  a cell apart.
"""

import ast

import importlib.util
import json
import os
import shutil
from collections import namedtuple

import numpy as np
import pytest
import torch

import config5_torch as c5
from descriptools_tpu_torch import pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TILE, SEED = 300, 128, 5
PROBE = 1 << 20


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "config5_1e9", os.path.join(ROOT, "scripts", "config5_1e9.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_inputs")
    _jax_script().prepare_inputs(N, SEED, str(d))
    return d


Run = namedtuple("Run", "result out loaders dir")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("config5")
    result, out, loaders = c5.run(N, TILE, SEED, str(d / "out"), str(d / "inputs"), "cpu",
                                  disk_probe_bytes=PROBE)
    return Run(result, out, loaders, d)


@pytest.mark.parametrize("workers,gen_tile", [(1, 4096), (2, 128)])
def test_prepare_inputs_bitwise_the_jax_scripts(jax_inputs, tmp_path, workers, gen_tile):
    seconds, cached = c5.prepare_inputs(N, SEED, str(tmp_path), gen_tile=gen_tile, workers=workers)
    assert not cached and seconds > 0
    for k, dt in c5.INPUT_SPEC:
        got = np.load(tmp_path / f"{k}.npy")
        want = np.load(jax_inputs / f"{k}.npy")
        assert got.dtype == want.dtype == dt, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert json.loads((tmp_path / "meta.json").read_text()) == json.loads((jax_inputs / "meta.json").read_text())
    assert c5.prepare_inputs(N, SEED, str(tmp_path)) == (0.0, True)


def test_tiled_run_bitwise_the_in_core_suite(run):
    ld = run.loaders
    d = {k: np.asarray(ld[k](0, N, 0, N)) for k in ("dem", "fdr", "fac", "river")}
    want = pipeline.descriptor_suite(*pipeline.inputs_to_torch(d["dem"], d["fdr"], d["fac"], d["river"], "cpu"),
                                     pipeline.PipelineConfig())
    out = run.out
    for k in ("indices", "hand", "downslope", "slope", "fdist"):
        assert isinstance(out[k], np.memmap), k
        np.testing.assert_array_equal(np.asarray(out[k]), want[k].numpy(), err_msg=k)
    assert out["hand"].dtype == np.int16 and out["indices"].dtype == np.int32
    r = run.result
    assert r["engine"] == "torch" and r["grid"] == [N, N]
    assert r["launches"] == {}  # the plain engine launches no kernel
    assert set(r["pass_s"]) == {"A", "B", "C"} and set(r["link"]["passes"]) == {"A", "B", "C"}
    # No input cache: the inputs are read from their memmaps, never copied.
    assert not [p for p in os.listdir(run.dir / "out") if p.startswith("_incache_")]
    assert r["disk"]["suite_write_bytes"] == N * N * c5.OUTPUT_BYTES_PER_CELL
    assert r["bound_by"] in ("link", "disk") and r["floor_s"] > 0


def test_sample_checks_and_invariants_pass(run):
    checks = run.result["checks"]
    assert run.result["ok"] and checks["ok"], checks.get("failures")
    assert len(checks["windows"]) == 16
    assert all(w["downslope_cells_compared"] > 0 for w in checks["windows"])
    assert sum(w.get("fdist_cells_compared", 0) for w in checks["windows"]) > 0
    inv = checks["invariants"]
    assert inv["ok"] and inv["invariant_violations"] == 0 and inv["cells_checked"] == N * N


def test_classifier_is_classify_flood(run):
    got = run.result["checks"]["classification"]
    flood = np.asarray(run.loaders["flood"](0, N, 0, N))
    th, corr, fit, class_map = pipeline.classify_flood(torch.from_numpy(np.asarray(run.out["hand"])), flood)
    assert (got["threshold"], got["correctness"], got["fit"]) == (th, corr, fit)
    np.testing.assert_array_equal(np.load(run.dir / "out" / "class_map.npy"), class_map)


def test_disk_check_says_what_is_lacking(tmp_path, monkeypatch):
    free = shutil.disk_usage(tmp_path).free
    monkeypatch.setattr(c5.shutil, "disk_usage", lambda p: shutil._ntuple_diskusage(free, 0, 1000))
    with pytest.raises(RuntimeError, match=r"needs .* GB .* it lacks"):
        c5.check_disk(N, str(tmp_path / "in"), str(tmp_path / "out"), False, PROBE)
    monkeypatch.undo()
    need = c5.check_disk(N, str(tmp_path / "in"), str(tmp_path / "out"), False, PROBE)
    assert list(need.values())[0][0] == N * N * 48 + PROBE


KNOBS = ("host_slope_rad", "upload_in_prefetch", "host_pointwise", "host_slope")


@pytest.fixture(scope="module")
def run_knobs_off(run):
    """The same run with the four knobs off and ``skip_verify``, on the
    first run's inputs, drawing two sample windows (the float64 oracle is
    most of a run's time here; the sixteen windows are the default run's,
    which this one's outputs are held to)."""
    d = run.dir / "knobs_off"
    sample_checks = c5.sample_checks
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c5, "sample_checks", lambda *a, **k: sample_checks(*a, n_windows=2, **k))
        result, out, loaders = c5.run(N, TILE, SEED, str(d / "out"), str(run.dir / "inputs"), "cpu",
                                      disk_probe_bytes=PROBE, skip_verify=True, **dict.fromkeys(KNOBS, False))
    return result, out, loaders


def _jax_flags():
    """{flag: default} of the JAX script's ``main`` (store_true flags: False)."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", "config5_1e9.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            store_true = "action" in kw and ast.literal_eval(kw["action"]) == "store_true"
            default = kw.get("default")
            flags[node.args[0].value] = False if store_true else (
                ast.literal_eval(default) if isinstance(default, ast.Constant) else "computed")
    return flags


def test_main_takes_the_jax_scripts_flags_with_its_defaults():
    jax_flags = _jax_flags()
    assert {"--engine", "--no-upload-in-prefetch", "--no-host-slope-rad", "--no-host-pointwise",
            "--no-host-slope", "--skip-verify"} <= set(jax_flags)
    args = c5.parser().parse_args([])
    for flag, default in jax_flags.items():
        got = getattr(args, flag[2:].replace("-", "_"))
        if default != "computed":  # --out-dir, --input-cache: paths under the repository
            assert got == default, flag
    assert c5.run_options(args) == dict(engine="auto", skip_verify=False, **dict.fromkeys(KNOBS, True))
    off = c5.parser().parse_args(["--no-upload-in-prefetch", "--no-host-slope-rad", "--no-host-pointwise",
                                  "--no-host-slope", "--skip-verify", "--engine", "torch"])
    assert c5.run_options(off) == dict(engine="torch", skip_verify=True, **dict.fromkeys(KNOBS, False))


def test_knobs_on_by_default_equal_the_knob_off_run(run, run_knobs_off):
    off, out_off, _ = run_knobs_off
    for k in ("indices", "hand", "downslope", "slope", "fdist"):
        np.testing.assert_array_equal(np.asarray(run.out[k]), np.asarray(out_off[k]), err_msg=k)
    for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        np.testing.assert_allclose(np.asarray(run.out[k]), np.asarray(out_off[k]), rtol=2e-5, atol=1e-4,
                                   err_msg=k)
    on = run.result
    assert on["ok"] and off["ok"], (on["checks"].get("failures"), off["checks"].get("failures"))
    assert {k: on[k] for k in KNOBS} == dict.fromkeys(KNOBS, True)
    assert {k: off[k] for k in KNOBS} == dict.fromkeys(KNOBS, False)
    assert (on["download_bytes_per_cell"], off["download_bytes_per_cell"]) == (18, 38)
    # The link's own count: pass C's downloads less 20 B a cell, A and B as they were.
    assert off["d2h_bytes_by_pass"]["C"] - on["d2h_bytes_by_pass"]["C"] == 20 * N * N
    for p in ("A", "B"):
        assert on["d2h_bytes_by_pass"][p] == off["d2h_bytes_by_pass"][p]
    assert set(on["host_waits_s"]) == {"suite_prefetch_wait_s", "suite_device_get_s", "suite_write_wait_s"}


def test_skip_verify_leaves_out_the_invariants(run, run_knobs_off):
    assert "invariants" not in run_knobs_off[0]["checks"]
    assert run.result["checks"]["invariants"]["cells_checked"] == N * N


def test_knob_off_run_passes_the_invariants(run_knobs_off):
    """The streaming invariants over every cell of the knob-off run (all
    rasters downloaded), which ``skip_verify`` left out of its result."""
    off, out_off, loaders = run_knobs_off
    assert off["ok"] and len(off["checks"]["windows"]) == 2, off["checks"].get("failures")
    inv = c5.verify.streaming_flow_invariants(loaders, out_off, (N, N), pipeline.PipelineConfig().px,
                                              pipeline.PipelineConfig().flow_max_steps, tile_rows=TILE,
                                              tile_cols=TILE)
    assert inv["ok"] and inv["invariant_violations"] == 0 and inv["cells_checked"] == N * N


def test_dem_outside_int16_raises(tmp_path):
    arrays = {k: np.zeros((8, 8), dt) for k, dt in c5.INPUT_SPEC}
    arrays["dem"] = np.full((8, 8), 40000, np.int32)
    with pytest.raises(ValueError, match="outside int16"):
        c5.prepare_inputs(8, 0, str(tmp_path), arrays=arrays)
