"""PyTorch port vs the JAX package: ``tiled_suite``'s four link knobs
(``host_slope_rad``, ``upload_in_prefetch``, ``host_pointwise``,
``host_slope``) on the CPU, each alone and all four together.

On CPU tensors the tile kernels run their plain versions.  Tolerances:
- against the port's knob-off run: indices, HAND, downslope, fdist and
  slope bitwise (the host slope is the same IEEE divisions); every raster
  bitwise under ``upload_in_prefetch`` (no arithmetic moves); the five
  transcendental rasters a knob recomputes on the host within rtol 2e-5,
  atol 1e-4 (numpy's and torch's CPU arctan/tan/log/pow against the
  tile's own);
- against the JAX ``tiled_suite`` with the same knob: indices, HAND and
  downslope bitwise; slope bitwise under ``host_slope`` (both the host's
  IEEE stencil), else within rtol 1e-6, atol 1e-6 (the jitted XLA slope
  divides by a reciprocal); fdist within rtol 1e-4, atol 1e-2 (the JAX ring
  sums f32 distances a block, the port forms fdist from step counts); the
  transcendental rasters within rtol 2e-5, atol 1e-4 (the tolerances of
  tests/test_torch_tiled.py);
- pass C's downloads fall by exactly 4, 12 and 4 B a cell of the grid
  (JAX's accounting, ``scripts/config5_1e9.py:378-386``);
- pass C runs the stencil once a tile, and not at all when every raster of
  it is recomputed on the host;
- ``_host_slope_from_padded`` bitwise the JAX package's on NaN, +-inf,
  -100, tied and 1xN blocks.
"""

import threading

import numpy as np
import pytest
import torch

from descriptools_tpu import tiled as jtiled
from descriptools_tpu.pipeline import PipelineConfig as JConfig
from descriptools_tpu.utils.synthetic import synthetic_basin, windowed_basin
from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.utils.synthetic import adversarial_dem

SHAPE, TILE = (75, 83), (32, 28)
CFG = pipeline.PipelineConfig()
JCFG = JConfig(engine="xla")
KNOBS = ("host_slope_rad", "upload_in_prefetch", "host_pointwise", "host_slope")
CASES = KNOBS + ("all",)
# Bytes a cell each knob takes off pass C's downloads.
DROPPED = dict(host_slope_rad=4, upload_in_prefetch=0, host_pointwise=12, host_slope=4, all=20)
TRANSCENDENTAL = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
TRANSC = dict(rtol=2e-5, atol=1e-4)


def knobs_of(case):
    return dict.fromkeys(KNOBS, True) if case == "all" else {case: True}


def _loaders():
    dem, fdr, river, fac = synthetic_basin(*SHAPE, seed=52)
    arrays = dict(dem=dem.astype(np.int32), fdr=fdr, river=river, fac=fac.astype(np.int32))
    return {k: tiled._array_loader(a) for k, a in arrays.items()}


def _port(loaders, shape=SHAPE, tile=TILE, **kw):
    """The port's run, its stats, and how many tiles ran the stencil (its
    plain version, on the CPU)."""
    stats, calls = {}, []
    plain = tiled._st.stencil_padded_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiled._st, "stencil_padded_plain", counted)
        out = tiled.tiled_suite(loaders, shape, CFG, "cpu", tile_rows=tile[0], tile_cols=tile[1],
                                stats=stats, **kw)
    return out, stats, len(calls)


@pytest.fixture(scope="module")
def runs():
    """The knob-off port run, and per case the port's and JAX's runs with
    the same knobs, each made once."""
    loaders = _loaders()
    cache = {"off": _port(loaders)}

    def get(case):
        if case not in cache:
            port = _port(loaders, **knobs_of(case))
            jax = jtiled.tiled_suite(loaders, SHAPE, JCFG, tile_rows=TILE[0], tile_cols=TILE[1],
                                     **knobs_of(case))
            cache[case] = port, {k: np.asarray(v) for k, v in jax.items()}
        return cache[case]

    return cache["off"], get


def _assert_vs_jax(case, got, want):
    for key in got:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        if key in TRANSCENDENTAL:
            np.testing.assert_allclose(g, w, err_msg=key, **TRANSC)
        elif key == "slope" and not knobs_of(case).get("host_slope"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)
        elif key == "fdist":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-2, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_vs_knob_off(case, got, off):
    assert set(got) == set(off)
    for key in got:
        if key in TRANSCENDENTAL and case != "upload_in_prefetch":
            np.testing.assert_allclose(got[key], off[key], err_msg=key, **TRANSC)
        else:
            np.testing.assert_array_equal(got[key], off[key], err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_knob_vs_jax_tiled_suite_with_the_same_knob(runs, case):
    _, get = runs
    (port, _, _), jax = get(case)
    _assert_vs_jax(case, port, jax)


@pytest.mark.parametrize("case", CASES)
def test_knob_vs_the_ports_knob_off_run(runs, case):
    (off, _, _), get = runs
    (port, _, _), _ = get(case)
    _assert_vs_knob_off(case, port, off)


@pytest.mark.parametrize("case", CASES)
def test_knob_drops_its_bytes_from_pass_c_downloads(runs, case):
    (_, off_stats, _), get = runs
    (_, stats, _), _ = get(case)
    cells = SHAPE[0] * SHAPE[1]
    c, c_off = stats["link"]["C"], off_stats["link"]["C"]
    assert c_off["d2h_bytes"] - c["d2h_bytes"] == DROPPED[case] * cells
    assert c["h2d_bytes"] == c_off["h2d_bytes"]
    for p in ("A", "B"):
        assert stats["link"][p]["h2d_bytes"] == off_stats["link"][p]["h2d_bytes"]
        assert stats["link"][p]["d2h_bytes"] == off_stats["link"][p]["d2h_bytes"]
    assert {k: stats[k] for k in KNOBS} == {k: k in knobs_of(case) for k in KNOBS}
    assert stats["engine"] == "torch" and stats["downslope_retries"] == 0


@pytest.mark.parametrize("case", CASES)
def test_stencil_runs_for_what_stays_on_the_device(runs, case):
    """Once a tile while a raster of the stencil is downloaded; not at all
    with host_slope, host_slope_rad and host_pointwise on, as XLA drops the
    unused stencil from the JAX package's jitted tile."""
    (_, _, off_calls), get = runs
    (_, _, calls), _ = get(case)
    assert off_calls == 3 * 3
    assert calls == (0 if case == "all" else off_calls)


@pytest.mark.parametrize("upload_in_prefetch", [False, True])
def test_upload_in_prefetch_moves_the_tile_uploads_to_the_prefetch_thread(monkeypatch, upload_in_prefetch):
    """Passes A and C upload on the prefetch thread with the knob, on the
    main thread without it; pass B's ring upload stays on the main thread."""
    threads = []
    up = tiled._Link.up

    def counted(self, arr):
        threads.append((self.pass_, threading.current_thread() is threading.main_thread()))
        return up(self, arr)

    monkeypatch.setattr(tiled._Link, "up", counted)
    _port(_loaders(), upload_in_prefetch=upload_in_prefetch)
    tiles = 3 * 3
    on_main = {p: [m for q, m in threads if q == p] for p in "ABC"}
    assert len(on_main["A"]) == 2 * tiles and len(on_main["C"]) == 4 * tiles
    for p in "AC":
        assert all(m != upload_in_prefetch for m in on_main[p]), p
    assert all(on_main["B"])


def test_engine_argument_overrides_the_config():
    loaders = windowed_basin(40, 40, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_suite(loaders, (40, 40), CFG, "cpu", engine="cuda")
    with pytest.raises(ValueError, match="through the ring"):
        tiled.tiled_suite(loaders, (40, 40), CFG, "cpu", engine="torch_blocked")
    stats = {}
    tiled.tiled_suite(loaders, (40, 40), pipeline.PipelineConfig(engine="cuda"), "cpu",
                      tile_rows=20, tile_cols=20, engine="torch", stats=stats)
    assert stats["engine"] == "torch"


def test_all_knobs_from_windowed_loaders_memmap(tmp_path):
    """The config 5 form in miniature: windowed loaders, no input cache,
    memmap outputs, every knob on, against the port's knob-off run (JAX's
    run with every knob on is held to the port's above)."""
    shape = (96, 112)
    loaders = windowed_basin(*shape, seed=7)
    got, stats, calls = _port(loaders, shape, (48, 32), out_dir=str(tmp_path), cache_inputs=False,
                              **knobs_of("all"))
    assert isinstance(got["slope"], np.memmap) and isinstance(got["twi"], np.memmap)
    off, off_stats, _ = _port(loaders, shape, (48, 32), cache_inputs=False)
    _assert_vs_knob_off("all", got, off)
    assert off_stats["link"]["C"]["d2h_bytes"] - stats["link"]["C"]["d2h_bytes"] == 20 * shape[0] * shape[1]
    assert calls == 0


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", [(3, 3), (3, 11), (11, 3), (19, 26), (42, 57)])
@pytest.mark.parametrize("px", [12.5, 30.0])
@pytest.mark.parametrize("seed", [0, 4])
def test_host_slope_from_padded_bitwise_vs_jax(shape, px, seed):
    """Padded blocks whose cells and rings hold NaN, +-inf, +-0.0, -100 and
    ties; (3, 3), (3, 11) and (11, 3) pad a 1x1, 1x9 and 9x1 interior."""
    padded = adversarial_dem(np.random.default_rng(seed), shape, special=0.25)
    got = tiled._host_slope_from_padded(padded, px)
    assert got.dtype == np.float32 and got.shape == (shape[0] - 2, shape[1] - 2)
    np.testing.assert_array_equal(_bits(got), _bits(jtiled._host_slope_from_padded(padded, px)))
    ties = np.random.default_rng(seed).integers(-101, -98, size=shape).astype(np.float32)
    np.testing.assert_array_equal(_bits(tiled._host_slope_from_padded(ties, px)),
                                  _bits(jtiled._host_slope_from_padded(ties, px)))


def test_host_slope_from_padded_is_the_ports_slope_of_the_block():
    padded = adversarial_dem(np.random.default_rng(2), (30, 41), special=0.1)
    from descriptools_tpu_torch.ops.slope import slope_from_padded

    np.testing.assert_array_equal(_bits(tiled._host_slope_from_padded(padded, 12.5)),
                                  _bits(slope_from_padded(torch.from_numpy(padded), 12.5).numpy()))
