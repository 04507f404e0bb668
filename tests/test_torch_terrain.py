"""Terrain from a DEM: the port's ``d8.d8_flow_direction``,
``ops.terrain.flow_accumulation`` (both forms) and ``derive_terrain``
against the JAX package's, bitwise, and flow accumulation against a
brute-force path count; ``ops.cuda.terrain.d8_successor`` on the CPU (its
plain version) against D8 and a decode of its codes, and the accumulation
given that successor against the accumulation that decodes fdr;
``flow_accumulation_plain`` against ``flow_accumulation`` and JAX on
``utils.synthetic.accumulation_cases`` and a float DEM, and the argument
checks of ``ops.cuda.terrain.accumulation``."""

import numpy as np
import pytest
import torch

from descriptools_tpu import d8 as jd8
from descriptools_tpu.ops import terrain as jterrain
from descriptools_tpu_torch import d8 as td8
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops import terrain as tterrain
from descriptools_tpu_torch.ops.cuda import terrain as cterrain
from descriptools_tpu_torch.utils import timing
from descriptools_tpu_torch.utils.synthetic import (
    accumulation_cases,
    d8_division_pin,
    d8_from_dem,
    d8_ties,
    synthetic_dem,
)


def brute_force_fac(fdr):
    """Count, per cell, walkers from every other cell whose path visits it
    (a copy of the counter in tests/test_terrain.py)."""
    from descriptools_tpu_torch.oracle.core import _D8_LUT

    rows, cols = fdr.shape
    fac = np.zeros((rows, cols), np.int64)
    for i in range(rows):
        for j in range(cols):
            y, x = i, j
            for _ in range(rows * cols):
                step = _D8_LUT.get(int(fdr[y, x]))
                if step is None:
                    break
                dy, dx, _ = step
                ny, nx = y + dy, x + dx
                if not (0 <= ny < rows and 0 <= nx < cols):
                    break
                y, x = ny, nx
                fac[y, x] += 1
    return fac


def _d8_both(dem):
    want = np.asarray(jd8.d8_flow_direction(dem))
    got = td8.d8_flow_direction(torch.from_numpy(np.asarray(dem))).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


def _fac_both(fdr, max_path=None):
    want = np.asarray(jterrain.flow_accumulation(fdr, max_path=max_path))
    stats = {}
    got = tterrain.flow_accumulation(torch.from_numpy(fdr), max_path=max_path, stats=stats).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return want, stats["rounds"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_d8_flow_direction_bitwise_on_synthetic_dem(seed):
    dem = synthetic_dem(45, 61, seed=seed)
    got = _d8_both(dem)
    np.testing.assert_array_equal(got, d8_from_dem(dem))
    assert (got[dem == NODATA] == 0).all() and (got != 0).any()


def test_d8_flow_direction_ties_and_nodata():
    """Exact ties (a float DEM on a 0.25 grid, flats and cones), NoData
    cells scattered and on the border, int32 and float64 DEMs."""
    rng = np.random.default_rng(7)
    dem = np.round(rng.uniform(0, 3, size=(37, 41)) * 4) / 4
    dem[rng.random(dem.shape) < 0.1] = NODATA
    dem[0, :] = NODATA
    dem[:, -1] = NODATA
    for d in (dem, dem.astype(np.float32), np.round(dem).astype(np.int32)):
        _d8_both(d)
    yy, xx = np.mgrid[0:21, 0:21]
    cone = (np.abs(yy - 10) + np.abs(xx - 10)).astype(np.float32)  # every direction tied at the rim
    _d8_both(cone)
    _d8_both(-cone)
    _d8_both(np.zeros((9, 11), np.float32))  # flat: all code 0
    rng = np.random.default_rng(8)  # gradients over sqrt(2) on many values
    _d8_both(rng.normal(size=(64, 64)).astype(np.float32) * 1e3)


@pytest.mark.parametrize("seed", [17, 5])
def test_flow_accumulation_matches_jax_and_brute_force(seed):
    dem = synthetic_dem(40, 52, seed=seed)
    fdr = d8_from_dem(dem)
    fac, rounds = _fac_both(fdr)
    np.testing.assert_array_equal(fac, brute_force_fac(fdr))
    assert rounds >= 1


def test_flow_accumulation_truncated_on_a_long_line():
    """One 300-step path east along a row, a shorter one beside it:
    max_path caps the doubling rounds, and the truncated counts are JAX's."""
    fdr = np.ones((2, 301), np.uint8)
    fdr[:, -1] = 0
    fdr[1, :150] = 4  # south: off the grid, each cell its own terminal
    full, r_full = _fac_both(fdr)
    np.testing.assert_array_equal(full, brute_force_fac(fdr))
    assert r_full == 9  # 2^9 >= 300 steps
    for max_path in (2, 16, 100, 256):
        trunc, r = _fac_both(fdr, max_path=max_path)
        assert r == td8.doubling_rounds(max_path)
        assert (trunc <= full).all() and (trunc != full).any()


def test_flow_accumulation_live_list_shrinks():
    fdr = d8_from_dem(synthetic_dem(60, 60, seed=4))
    for accumulate in (tterrain.flow_accumulation, tterrain.flow_accumulation_plain):
        stats = {}
        accumulate(torch.from_numpy(fdr), stats=stats)
        live = stats["live"]
        assert len(live) == stats["rounds"] and all(a > b for a, b in zip(live, live[1:]))


@pytest.mark.parametrize("dtype", [np.int32, np.float64, np.int16, np.float32])
def test_derive_terrain_matches_jax_and_masks(dtype):
    dem = synthetic_dem(32, 40, seed=3).astype(dtype)
    fdr_w, fac_w = (np.asarray(a) for a in jterrain.derive_terrain(dem))
    fdr, fac = (t.numpy() for t in tterrain.derive_terrain(torch.from_numpy(dem)))
    for g, w in ((fdr, fdr_w), (fac, fac_w)):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (fac[dem == NODATA] == NODATA).all()
    assert (fdr[dem == NODATA] == 0).all()
    assert (fac[dem != NODATA] == 0).any()  # ridges


def _sink_successor(fdr):
    """Each cell's flat D8 target, ``rows * cols`` where its code is not a
    D8 code or leaves the grid: a decode in numpy, cell by cell."""
    from descriptools_tpu_torch.oracle.core import _D8_LUT

    rows, cols = fdr.shape
    out = np.full((rows, cols), rows * cols, np.int64)
    for i in range(rows):
        for j in range(cols):
            step = _D8_LUT.get(int(fdr[i, j]))
            if step is not None and 0 <= i + step[0] < rows and 0 <= j + step[1] < cols:
                out[i, j] = (i + step[0]) * cols + j + step[1]
    return out


def _tie_dems():
    """Seeded DEMs with exact ties (a 0.25 grid, the tie blocks, the
    division pin), NoData scattered and on the border."""
    rng = np.random.default_rng(11)
    grid = np.round(rng.uniform(0, 3, size=(37, 41)) * 4) / 4
    ties = d8_ties(29, 31).astype(np.float64)
    pin = np.pad(d8_division_pin(), 2, constant_values=20).astype(np.float64)
    out = []
    for dem in (grid, ties, pin, synthetic_dem(33, 47, seed=9).astype(np.float64)):
        dem = dem.copy()
        dem[rng.random(dem.shape) < 0.08] = NODATA
        dem[:, 0] = NODATA
        out.append(dem)
    return out


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32, np.float64])
def test_d8_successor_plain_is_d8_and_its_sink_successor(dtype):
    """On a CPU tensor ``d8_successor`` is its plain version: fdr bitwise
    the port's and JAX's ``d8_flow_direction`` and succ each code's target
    in the sink form, int32, on int16, int32, float32 and float64 DEMs with
    ties and NoData; no launch is counted."""
    launches = cterrain.d8_successor.launches
    for dem in _tie_dems():
        if np.issubdtype(dtype, np.integer):
            dem = np.where(dem == NODATA, NODATA, np.round(dem * 4))
        dem = dem.astype(dtype)
        fdr, succ = cterrain.d8_successor(torch.from_numpy(dem))
        assert fdr.dtype == succ.dtype == torch.int32
        np.testing.assert_array_equal(fdr.numpy(), _d8_both(dem))
        np.testing.assert_array_equal(succ.numpy(), _sink_successor(fdr.numpy()))
        assert torch.equal(fdr, cterrain.d8_successor_plain(torch.from_numpy(dem))[0])
    assert cterrain.d8_successor.launches == launches
    pin = cterrain.d8_successor(torch.from_numpy(d8_division_pin()))
    assert int(pin[0][1, 1]) == 2 and int(pin[1][1, 1]) == 8  # SE by an IEEE division


def _fac_given_succ(fdr, max_path=None):
    """flow_accumulation(fdr, succ=...) against flow_accumulation(fdr):
    counts, rounds and live lists equal; the given succ is jumped in place."""
    rows, cols = fdr.shape
    f = torch.from_numpy(fdr)
    succ = torch.from_numpy(_sink_successor(fdr).astype(np.int32))
    given = succ.clone()
    stats_w, stats_g = {}, {}
    want = tterrain.flow_accumulation(f, max_path=max_path, stats=stats_w)
    got = tterrain.flow_accumulation(f, max_path=max_path, stats=stats_g, succ=given)
    assert torch.equal(got, want) and stats_g == stats_w
    assert not torch.equal(given, succ) or stats_w["rounds"] == 0
    return got


@pytest.mark.parametrize("seed", [17, 5, 3])
def test_flow_accumulation_given_succ_on_seeded_dems(seed):
    dem = synthetic_dem(40, 52, seed=seed)
    dem[np.random.default_rng(seed).random(dem.shape) < 0.05] = NODATA  # NoData: code 0, the sink
    fdr = d8_from_dem(dem).astype(np.int32)
    fac = _fac_given_succ(fdr).numpy()
    np.testing.assert_array_equal(fac, brute_force_fac(fdr))
    fdr_t, succ = cterrain.d8_successor(torch.from_numpy(dem))
    got = tterrain.flow_accumulation(fdr_t, succ=succ)
    assert torch.equal(got, tterrain.flow_accumulation(fdr_t))


@pytest.mark.parametrize("max_path", [None, 2, 16, 100, 256])
def test_flow_accumulation_given_succ_truncated_on_a_long_line(max_path):
    """The 300-step line of ``test_flow_accumulation_truncated_on_a_long_line``
    with the successor given: the same truncated counts under every cap."""
    fdr = np.ones((2, 301), np.int32)
    fdr[:, -1] = 0
    fdr[1, :150] = 4  # south: off the grid, each cell its own terminal
    _fac_given_succ(fdr, max_path)


def test_d8_fused_counter_reads_zero_on_the_cpu():
    """``terrain.d8`` counts ``fused`` only for a launch of the kernel: on
    the CPU the span has no such counter, and no launch is counted."""
    dem = torch.from_numpy(synthetic_dem(32, 40, seed=3))
    launches = cterrain.d8_successor.launches
    with timing.recording() as rec:
        tterrain.derive_terrain(dem)
    counters = {s.name: s.counters for s in rec.spans}["terrain.d8"]
    assert counters.get("fused", 0) == 0 and cterrain.d8_successor.launches == launches


def test_d8_successor_refuses_what_int32_cannot_index():
    """A DEM that is not 2-D, or of 2^31 cells or more (the sink, rows *
    cols, and every flat index are int32), is refused on any device."""
    with pytest.raises(ValueError, match="2-D"):
        cterrain.d8_successor(torch.zeros(12))
    with pytest.raises(ValueError, match="int32"):
        cterrain.d8_successor(torch.zeros(1, 1).expand(1 << 16, 1 << 15))


def _float_dem_fdr():
    """D8 of a small float32 DEM of the LiDAR cell's generator (its hills
    and valleys scaled to the grid), unrounded metres."""
    from benchmark.generators import float_dem

    dem = float_dem.make(96, 128, 2147507200, "cpu", hills=31, valleys=9)["dem"]
    assert dem.dtype == torch.float32 and bool((dem != torch.round(dem)).any())
    return cterrain.d8_successor(dem)[0].numpy()


@pytest.mark.parametrize("case", [*accumulation_cases(), "float_dem"])
def test_flow_accumulation_plain_is_flow_accumulation_on_the_cpu(case):
    """On CPU tensors ``flow_accumulation`` is ``flow_accumulation_plain``:
    counts, stats and the successor jumped in place equal, and the counts
    JAX's, on the accumulation's edge cases (truncation, cycles whose
    lap-multiplied counts wrap int32, no live cell, 1 x N and N x 1) and a
    float DEM's D8."""
    fdr, max_path = (_float_dem_fdr(), None) if case == "float_dem" else accumulation_cases()[case]
    succ = torch.from_numpy(_sink_successor(fdr).astype(np.int32))
    got_succ, want_succ = succ.clone(), succ.clone()
    stats_g, stats_w = {}, {}
    f = torch.from_numpy(fdr)
    got = tterrain.flow_accumulation(f, max_path=max_path, stats=stats_g, succ=got_succ)
    want = tterrain.flow_accumulation_plain(f, max_path=max_path, stats=stats_w, succ=want_succ)
    assert torch.equal(got, want) and stats_g == stats_w and torch.equal(got_succ, want_succ)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jterrain.flow_accumulation(fdr, max_path=max_path)))
    assert stats_g["rounds"] == len(stats_g["live"]) <= td8.doubling_rounds(max_path or fdr.size)


def test_accumulation_fused_counter_reads_zero_on_the_cpu():
    """``terrain.accumulation`` counts ``fused`` only for a launch of the C
    entry: on the CPU the span has no such counter, no launch is counted,
    and the host reads the live list's length once to start and once a
    round."""
    dem = torch.from_numpy(synthetic_dem(32, 40, seed=3))
    launches = cterrain.accumulation.launches
    stats = {}
    with timing.recording() as rec:
        tterrain.derive_terrain(dem, stats=stats)
    counters = {s.name: s.counters for s in rec.spans}["terrain.accumulation"]
    assert counters.get("fused", 0) == 0 and cterrain.accumulation.launches == launches
    assert counters["host_reads"] == 1 + stats["rounds"] and counters["rounds"] == stats["rounds"] >= 1
    assert counters["live_cells"] == sum(stats["live"])


def test_accumulation_refuses_what_the_entry_cannot_take():
    """The accumulation's successor must be int32 and contiguous, of fewer
    than 2^31 cells (the sink and every flat index are int32), on any
    device: anything else is refused before a round."""
    succ = torch.full((6, 7), 42, dtype=torch.int32)
    for accumulate in (cterrain.accumulation, cterrain.accumulation_plain):
        with pytest.raises(ValueError, match="int32"):
            accumulate(succ.long(), 3)
        with pytest.raises(ValueError, match="contiguous"):
            accumulate(succ.t(), 3)
        with pytest.raises(ValueError, match="overflow"):
            accumulate(torch.zeros(1, dtype=torch.int32).expand(1 << 31), 31)
    with pytest.raises(ValueError, match="int32"):
        tterrain.flow_accumulation(torch.zeros(6, 7, dtype=torch.int32), succ=succ.to(torch.int16))
    fac, live = cterrain.accumulation(succ, 3)  # every cell a sink: no round
    assert live == [] and torch.equal(fac, torch.zeros(42, dtype=torch.int32))
