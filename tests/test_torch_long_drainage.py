"""PyTorch port vs the JAX package on long drainage: terrain-derived
rivers whose walks run tens to hundreds of steps, on the CPU.

The input is the long-drainage set's (``make_north_star_reference.py``) at
512x384: ``synthetic_dem(512, 384, seed=0, smooth=255, amp=20000)``, fdr
and fac from ``derive_terrain``, river ``fac > 500``, the flood map the
lowest 20 % of the valid cells, ``elevation_difference=2000``.  The JAX
side is the reference script's own ``long_drainage_run`` (the xla suite,
``classify_flood``, the right fold of its frontier sweeps, the walks'
steps); the port makes its inputs with ``utils.parity.long_drainage_inputs``.
Tolerances:

- the inputs (dem, fdr, fac, river, flood), indices, HAND, downslope, the
  class map, threshold, Correctness and Fit: bitwise;
- slope within rtol 1e-6 (JAX's jitted slope multiplies by a reciprocal);
  slope_rad, TWI, mod-TWI, GFI and ln(hl/H) within rtol 2e-5, atol 1e-4;
- fdist: the count engine (``engine="torch"``) within
  ``parity.count_bound``, atol + (rtol + steps 2^-24) |w| with fdist's
  rtol 1e-6 and atol 1e-4, of JAX's xla fdist, whose residue is summed by
  doubling; the fold engine (``"torch_blocked"``) bitwise JAX's right fold
  and within the same bound of the xla fdist;
- ``tiled_suite`` in 128x128 tiles and ``sharded_suite`` on mesh (2, 2)
  (a world of one over gloo): bitwise the in-core port on indices, HAND,
  downslope, slope and fdist, each with at least one downslope retry
  (walks of up to 79 steps leave the 64-cell halo).

The walk statistics are pinned, so that a generator change cannot shorten
the walks silently; the committed set's floors are read from the file, and
JAX's current fdr and fac at 2178x1534 are held to its hashes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_north_star_reference as ms
from descriptools_tpu.ops.terrain import derive_terrain as j_derive_terrain
from descriptools_tpu.utils.synthetic import synthetic_dem as j_synthetic_dem
from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite
from descriptools_tpu_torch.utils import parity

REFERENCE = os.path.join(os.path.dirname(__file__), "data", "long_drainage_reference.npz")
ROWS, COLS = 512, 384
PARAMS = (255, 20000.0, 500, 2000.0, ms.FLOOD_QUANTILE)  # smooth, amp, T, ED, flood quantile
# The walks at 512x384 (the JAX side's count; the port's must agree).
WALKS = dict(valid=177120, landed=177036, flow_steps_sum=7340815, flow_steps_max=217, flow_over_64=41630,
             downslope_steps_sum=6316644, downslope_steps_max=79)
EXACT = ("indices", "hand", "downslope", "slope", "fdist")
TAG = f"{ROWS}x{COLS}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU walks here are hundreds of small torch ops a call;
    beside other test processes on the same cores, torch's thread pool
    spends far longer waiting on its threads than computing.  One thread
    (the ops are elementwise, so the values do not change) keeps the module
    fast under the parallel runner."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run():
    return ms.long_drainage_run(ROWS, COLS, *PARAMS[:4])


@pytest.fixture(scope="module")
def ref(jax_run):
    """The long-drainage set's entries for this size, built in memory."""
    import jax

    return {**ms.meta(jax, ""), **ms.long_drainage_summary(ROWS, COLS, PARAMS, jax_run)}


@pytest.fixture(scope="module")
def port_inputs():
    params = {"meta.seed": np.array(ms.SEED), f"{TAG}.params": np.array(PARAMS, np.float64)}
    return parity.long_drainage_inputs(params, ROWS, COLS, "cpu")


@pytest.fixture(scope="module")
def cfg():
    return pipeline.PipelineConfig(elevation_difference=PARAMS[3])


@pytest.fixture(scope="module")
def port_runs(port_inputs, cfg):
    tensors = port_inputs[1]
    return {
        engine: {k: v.numpy() for k, v in pipeline.descriptor_suite(
            *tensors, pipeline.PipelineConfig(elevation_difference=cfg.elevation_difference, engine=engine)).items()}
        for engine in ("torch", "torch_blocked")
    }


def test_inputs_and_terrain_bitwise_jax(port_inputs, port_runs, jax_run):
    """(The port's suites run first, before any JAX program in this module.)"""
    arrays, (dem, fdr, fac, river) = port_inputs
    for k in parity.INPUTS:
        want = jax_run["inputs"][k]
        assert arrays[k].dtype == want.dtype and np.array_equal(arrays[k], want), k
    assert fac.dtype == torch.int32 and river.dtype == torch.int8


def test_walks_are_long_and_pinned(jax_run, port_inputs, cfg):
    """The JAX side's walk statistics, the port's plain engines' and the
    pinned values agree; a quarter of the landed cells walk past 64 steps
    and some downslope walks past the 64-cell halo."""
    _, (dem, fdr, _, river) = port_inputs
    assert jax_run["walks"] == WALKS
    assert parity.walk_stats(dem, fdr, river, cfg.elevation_difference) == WALKS
    assert WALKS["flow_over_64"] / WALKS["landed"] > 0.2 and WALKS["downslope_steps_max"] > 64


@pytest.mark.parametrize("engine", ["torch", "torch_blocked"])
def test_suite_holds_to_jax_in_full(jax_run, port_runs, engine):
    """Every cell: integers and downslope bitwise, slope and the
    transcendentals within their tolerances, fdist in the engine's order."""
    got, want = port_runs[engine], jax_run["out"]
    for k in ("indices", "hand", "downslope"):
        assert np.array_equal(got[k], want[k]), k
    for k, tol in parity.TOLERANCES.items():
        if k != "fdist":
            np.testing.assert_allclose(got[k], want[k], equal_nan=True, err_msg=k, **tol)
    g, w, steps = got["fdist"], want["fdist"], jax_run["steps"]
    assert np.array_equal(np.isfinite(g), np.isfinite(w)) and np.array_equal(g == -100, w == -100)
    fin = np.isfinite(w) & (w != -100)
    diff = np.abs(g[fin].astype(np.float64) - w[fin])
    assert (diff <= parity.count_bound(w[fin], steps[fin])).all()
    if engine == "torch_blocked":
        assert np.array_equal(g, jax_run["fdist_fold"])
    # The departure is real on these walks: the fold and the doubling
    # residue part beyond fdist's tolerance on some cells.
    tol = parity.TOLERANCES["fdist"]
    assert (diff > tol["atol"] + tol["rtol"] * np.abs(w[fin])).any() == (engine == "torch_blocked")


@pytest.mark.parametrize("engine,order", [("torch", "count"), ("torch_blocked", "fold")])
def test_parity_check_in_the_engines_order(ref, jax_run, port_inputs, port_runs, engine, order):
    """``utils.parity.check`` on the set's entries for this size, as
    ``chip_smoke.py`` runs it on the card; the classifier identical."""
    out = port_runs[engine]
    classified = pipeline.classify_flood(torch.from_numpy(out["hand"]), port_inputs[0]["flood"])
    want = jax_run["classified"]
    assert classified[:3] == tuple(want[:3]) and np.array_equal(classified[3], want[3])
    report = parity.check(ref, ROWS, COLS, port_inputs[0], out, classified, fdist_order=order)
    assert report["fdist"]["bound_used"] <= 1.0 and report["fdist"]["sum_bound_used"] <= 1.0
    with pytest.raises(AssertionError, match="right fold" if order == "fold" else "beyond count_bound"):
        wrong = dict(out, fdist=np.where(out["fdist"] > 1000, out["fdist"] * np.float32(1 + 1e-4), out["fdist"]))
        parity.check(ref, ROWS, COLS, port_inputs[0], wrong, classified, fdist_order=order)


def test_bench_long_drainage_line_holds_to_jax(ref, tmp_path, monkeypatch):
    """``bench_torch.py --long-drainage`` on this size's set, built in
    memory, on the CPU under the count engine (the fold engine's plain
    suites take seconds each here; the card runs both): its suite held to
    JAX in the count order, its walk statistics the set's.  The CPU leg is
    read from a cache written here."""
    import json

    import bench_torch as bt

    monkeypatch.setattr(bt, "_rev", lambda: "rev-a")
    metric = f"full_descriptor_suite_long_drainage_{TAG}"
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / f"bench_cpu_{metric}.json").write_text(
        json.dumps(dict(rev="rev-a", t_cpu=1.0, threads=1, cpu_model="cached")))
    line = bt.measure(["--long-drainage", TAG, "--engine", "torch"], device="cpu", iters=1, batch=1,
                      root=str(tmp_path), reference=ref)
    assert line["metric"] == metric and line["engine"] == "torch" and line["baseline"]["cached"]
    assert line["correct"] is True and "long_drainage_reference" in line["checked_against"]
    assert line["fdist"]["order"] == "count" and line["fdist"]["bound_used"] <= 1.0
    assert line["walks"]["flow_steps_max"] == WALKS["flow_steps_max"]
    assert line["walks"]["downslope_steps_mean"] == WALKS["downslope_steps_sum"] / WALKS["valid"]
    assert line["prep_s"] > 0 and line["walks"]["landed"] == WALKS["landed"]
    assert not any(line["kernels"].values())


@pytest.fixture(scope="module")
def world():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


@pytest.mark.parametrize("path", ["tiled", "sharded"])
def test_tiled_and_sharded_bitwise_in_core_with_a_retry(port_inputs, port_runs, cfg, world, path):
    arrays = port_inputs[0]
    stats = {}
    if path == "tiled":
        loaders = {k: tiled._array_loader(arrays[k]) for k in ("dem", "fdr", "river", "fac")}
        out = tiled.tiled_suite(loaders, (ROWS, COLS), cfg, "cpu", tile_rows=128, tile_cols=128, stats=stats)
    else:
        out = sharded_suite(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], cfg,
                            make_mesh((2, 2), device="cpu"), stats=stats)
        out = {k: v.numpy() for k, v in out.items()}
    for k in EXACT:
        assert np.array_equal(np.asarray(out[k]), port_runs["torch"][k], equal_nan=True), k
    assert stats["downslope_retries"] >= 1, stats.get("downslope_retry_halos", stats.get("downslope_attempts"))


@pytest.fixture(scope="module")
def committed():
    return parity.load(REFERENCE)


def test_committed_set_meets_the_floors(committed):
    assert parity.sizes(committed) == [(2178, 1534), (4096, 4096)]
    assert tuple(committed["meta.walks"].tolist()) == parity.WALKS == ms.WALKS
    assert tuple(committed["meta.params"].tolist()) == parity.PARAMS == ms.PARAMS
    for rows, cols in parity.sizes(committed):
        stats = ms.floor_terms(parity.walks(committed, rows, cols))
        assert all(stats[k] >= floor for k, floor in ms.FLOORS.items()), (rows, cols, stats)
        p = parity.params(committed, rows, cols)
        assert p["smooth"] < min(rows, cols)
        assert (p["smooth"], p["amp"], p["river_fac"], p["elevation_difference"]) == ms.LONG_DRAINAGE[(rows, cols)]


def test_jax_terrain_still_matches_the_committed_hashes(committed):
    """JAX's current dem, fdr and fac at 2178x1534 against the set."""
    rows, cols = 2178, 1534
    p = parity.params(committed, rows, cols)
    dem = j_synthetic_dem(rows, cols, seed=0, smooth=int(p["smooth"]), amp=p["amp"]).astype(np.int32)
    fdr, fac = (np.asarray(a) for a in j_derive_terrain(jnp.asarray(dem)))
    dtypes = parity.hash_dtypes(committed)
    for k, a in (("dem", dem), ("fdr", fdr), ("fac", fac)):
        assert parity.sha256(a, dtypes[k]) == str(committed[f"{rows}x{cols}.sha256.{k}"]), k
