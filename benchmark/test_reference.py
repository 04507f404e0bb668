"""The plain reference against descriptools' semantics as the repository's
NumPy oracles state them (per-cell loops in float64), on the benchmark's
own generators at small sizes."""

import numpy as np
import pytest
import torch

from benchmark import found, inputs, generators
from benchmark.reference import classify, suite, terrain
from descriptools_tpu_torch import oracle

PIPELINE = dict(px=12.5, elevation_difference=5.0, n_topo=0.1, n_gfi=0.4, b_gfi=0.1,
                downslope_max_steps=5000, flow_max_steps=20000)
MIXES = {
    "derived": dict(dem=dict(generator="synthetic_dem", smooth=9, amp=400), terrain="derive",
                    river=dict(fac_above=12)),
    "basin": dict(dem=dict(generator="windowed_basin", smooth=7, amp=80.0, river_level=0.4)),
}


@pytest.fixture(params=sorted(MIXES))
def grid(request):
    return inputs.make_input(MIXES[request.param], 36, 52, 2**31 + 5, "cpu")


def _walk_count(fdr):
    """Upstream cells by walking every cell's path (numpy)."""
    rows, cols = fdr.shape
    succ = terrain.successor(torch.as_tensor(fdr)).numpy()
    fac = np.zeros(rows * cols, np.int64)
    for c in range(rows * cols):
        s = succ[c]
        while s != rows * cols:
            fac[s] += 1
            s = succ[s]
    return fac.reshape(rows, cols)


def test_d8_and_accumulation(grid):
    dem = grid["dem"]
    fdr, fac = terrain.derive(dem)
    from descriptools_tpu_torch.utils.synthetic import d8_from_dem

    np.testing.assert_array_equal(fdr.numpy(), d8_from_dem(dem.numpy()).astype(np.int32))
    want = np.where(dem.numpy() == -100, -100, _walk_count(fdr.numpy()))
    np.testing.assert_array_equal(fac.numpy(), want)


def test_suite_matches_the_oracles(grid):
    x = grid
    dem, fdr, fac, river = (x[k].numpy() for k in ("dem", "fdr", "fac", "river"))
    out, steps = suite.suite(x["dem"], x["fdr"], x["fac"], x["river"], PIPELINE)
    px, n_topo, n_gfi, b_gfi = 12.5, 0.1, 0.4, 0.1
    sl = oracle.slope_oracle(dem, px)
    rad = np.where(dem == -100, -100.0, np.arctan(sl / 100))
    fdist, idx = oracle.flow_distance_index_oracle(fdr, river, px)
    hand = oracle.hand_oracle(dem, idx)
    rfac = oracle.river_accumulation_oracle(fac, idx)
    want = dict(
        slope=sl, slope_rad=rad,
        twi=oracle.topographic_index_oracle(fac, rad, px),
        mod_twi=oracle.modified_topographic_index_oracle(fac, rad, px, n_topo),
        downslope=oracle.downslope_oracle(dem, fdr, px, 5.0),
        fdist=fdist, gfi=oracle.gfi_oracle(hand, rfac, n_gfi, b_gfi, px),
        ln_hl_h=oracle.ln_hl_h_oracle(hand, fac, n_gfi, b_gfi, px),
    )
    np.testing.assert_array_equal(out["indices"].numpy(), idx)
    np.testing.assert_array_equal(out["hand"].numpy(), hand)
    for k, w in want.items():
        np.testing.assert_allclose(out[k].numpy(), w, rtol=2e-5, atol=2e-4, err_msg=k)
    assert int(steps["flow_steps"].max()) > 0


def test_classifier_matches_the_oracle(grid):
    x = grid
    out, _ = suite.suite(x["dem"], x["fdr"], x["fac"], x["river"], PIPELINE)
    flood = inputs.flood_map(x["dem"], 0.3)
    th, correctness, fit, class_map = classify.classify_flood(out["hand"], flood)
    hand = out["hand"].numpy()
    elements = np.unique(hand)
    desc = oracle.min_max_scale_oracle(hand, elements[1], elements[-1])
    want_th = oracle.calibration_oracle(desc, flood.numpy(), "under")
    c, f, cmap = oracle.confusion_oracle(oracle.binary_map_oracle(desc, want_th, "under"), flood.numpy())
    assert (th, correctness, fit) == (want_th, c, f)
    np.testing.assert_array_equal(class_map.numpy(), cmap)


def test_flood_map_is_numpy_quantile():
    dem = found.module("generators", "synthetic_dem").make(30, 40, 9, "cpu")["dem"]
    d = dem.numpy()
    q = np.quantile(d[d != -100], 0.2)
    want = np.where(d != -100, (d <= q).astype(np.int32), -100)
    np.testing.assert_array_equal(inputs.flood_map(dem, 0.2).numpy(), want)


def test_box_sum_is_numpy_convolve():
    a = np.random.default_rng(0).normal(size=(37, 29))
    for k in (1, 7, 15):
        want = a.copy()
        for ax in (0, 1):
            want = np.apply_along_axis(lambda m: np.convolve(m, np.ones(k), mode="same"), ax, want)
        got = generators.box_sum(generators.box_sum(torch.from_numpy(a), k, 0), k, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_same_seed_same_inputs():
    mix = dict(MIXES["basin"], pool=2)
    a = inputs.make_pool(mix, 20, 24, 2**33 + 1, "cpu")
    b = inputs.make_pool(mix, 20, 24, 2**33 + 1, "cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["dem"], a[1]["dem"])
