"""Terrain from a DEM: the port's ``d8.d8_flow_direction``,
``ops.terrain.flow_accumulation`` (both forms) and ``derive_terrain``
against the JAX package's, bitwise, and flow accumulation against a
brute-force path count."""

import numpy as np
import pytest
import torch

from descriptools_tpu import d8 as jd8
from descriptools_tpu.ops import terrain as jterrain
from descriptools_tpu_torch import d8 as td8
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops import terrain as tterrain
from descriptools_tpu_torch.utils.synthetic import d8_from_dem, synthetic_dem


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
        assert r == tterrain._levels(max_path)
        assert (trunc <= full).all() and (trunc != full).any()


def test_flow_accumulation_live_list_shrinks():
    fdr = d8_from_dem(synthetic_dem(60, 60, seed=4))
    stats = {}
    tterrain.flow_accumulation(torch.from_numpy(fdr), stats=stats)
    live = stats["live"]
    assert len(live) == stats["rounds"] and all(a > b for a, b in zip(live, live[1:]))


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
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
