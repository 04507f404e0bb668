"""PyTorch port vs the JAX package: D8 machinery and the numpy copies.

Inputs come from numpy with fixed seeds; every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import descriptools_tpu.constants as jconst
from descriptools_tpu import d8 as jd8
from descriptools_tpu.evaluation import coarse_to_fine_search as j_search
from descriptools_tpu.oracle import evaluation as jeval
from descriptools_tpu.utils import synthetic as jsyn
import descriptools_tpu_torch.constants as tconst
from descriptools_tpu_torch import d8 as td8
from descriptools_tpu_torch import evaluation as tevaluation
from descriptools_tpu_torch.oracle import evaluation as teval
from descriptools_tpu_torch.utils import synthetic as tsyn


def _fdr_fixture(rows, cols, seed):
    """Every D8 code plus 0 and invalid codes, at random."""
    rng = np.random.default_rng(seed)
    codes = np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 3, 255], np.uint8)
    return codes[rng.integers(0, codes.size, size=(rows, cols))]


@pytest.mark.parametrize("shape,seed", [((17, 23), 0), ((40, 9), 1)])
def test_decode_and_successor_bitwise(shape, seed):
    fdr = _fdr_fixture(*shape, seed)
    want = [np.asarray(x) for x in jd8.decode(fdr)]
    got = [x.numpy() for x in td8.decode(torch.from_numpy(fdr))]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    want = [np.asarray(x) for x in jd8.successor(fdr, *shape)]
    got = [x.numpy() for x in td8.successor(torch.from_numpy(fdr), *shape)]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_pull8_bitwise():
    rows, cols = 31, 45
    fdr = _fdr_fixture(rows, cols, 2)
    rng = np.random.default_rng(3)
    f = rng.normal(size=(rows, cols)).astype(np.float32)
    i = rng.integers(-1000, 1000, size=(rows, cols)).astype(np.int32)
    b = rng.random((rows, cols)) < 0.5
    want = jd8.pull8(fdr, [f, i, b], [0.0, -7, False])
    got = td8.pull8(
        torch.from_numpy(fdr),
        [torch.from_numpy(f), torch.from_numpy(i), torch.from_numpy(b)],
        [0.0, -7, False],
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_constants_copy_equal():
    for name in ("NODATA", "REPAIR", "EPS", "SQRT2", "DOWNSLOPE_MAX_STEPS", "FLOW_MAX_STEPS"):
        assert getattr(tconst, name) == getattr(jconst, name)
    for name in ("D8_CODES", "D8_DY", "D8_DX", "D8_STEP"):
        w, g = getattr(jconst, name), getattr(tconst, name)
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,seed", [((70, 110), 13), ((33, 57), 2)])
def test_synthetic_basin_copy_bitwise(shape, seed):
    for w, g in zip(jsyn.synthetic_basin(*shape, seed=seed), tsyn.synthetic_basin(*shape, seed=seed)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "shape,seed,window",
    [((96, 128), 0, (0, 96, 0, 128)), ((130, 257), 1, (7, 101, 33, 250))],
)
def test_windowed_basin_copy_bitwise(shape, seed, window):
    want = jsyn.windowed_basin(*shape, seed=seed)
    got = tsyn.windowed_basin(*shape, seed=seed)
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = want[k](*window), got[k](*window)
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def _scaled_desc_and_flood(seed):
    rng = np.random.default_rng(seed)
    hand = rng.integers(0, 60, size=(48, 64)).astype(np.float64)
    hand[:3, :] = jconst.NODATA
    desc = jeval.min_max_scale_oracle(hand, 0, 59)
    flood = (hand < 20).astype(np.int32)
    flood[:3, :] = jconst.NODATA
    return hand, desc, flood


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_oracle_copy_identical(seed):
    hand, desc, flood = _scaled_desc_and_flood(seed)
    np.testing.assert_array_equal(
        teval.min_max_scale_oracle(hand, 0, 59), jeval.min_max_scale_oracle(hand, 0, 59)
    )
    for under in ("under", "over"):
        th_w = jeval.calibration_oracle(desc, flood, under)
        th_g = teval.calibration_oracle(desc, flood, under)
        assert th_g == th_w
        bw = jeval.binary_map_oracle(desc, th_w, under)
        bg = teval.binary_map_oracle(desc, th_g, under)
        np.testing.assert_array_equal(bg, bw)
        cw, fw, rw = jeval.confusion_oracle(bw, flood)
        cg, fg, rg = teval.confusion_oracle(bg, flood)
        assert (cg, fg) == (cw, fw)
        np.testing.assert_array_equal(rg, rw)


def test_coarse_to_fine_search_matches_oracle():
    """The shared search loop, fed float64 oracle Fits, selects the
    oracle's threshold (and the JAX search loop's)."""
    _, desc, flood = _scaled_desc_and_flood(2)

    def fits_at(values, scale):
        return np.array([
            teval.confusion_oracle(teval.binary_map_oracle(desc, v / scale, "under"), flood)[1]
            for v in values
        ])

    th = tevaluation.coarse_to_fine_search(fits_at)
    assert th == teval.calibration_oracle(desc, flood, "under")
    assert th == j_search(fits_at)
    assert tevaluation.calibration(desc, flood) == th
