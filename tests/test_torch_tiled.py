"""PyTorch port vs the JAX package: the out-of-core tiled path.

On CPU tensors the tiled functions run the kernels' plain versions.
Tolerances:
- indices, HAND, downslope: bitwise against the JAX tiled suite;
- against the port's in-core suite: indices, HAND, downslope, slope and
  fdist bitwise (the same torch ops on the same values; fdist from the same
  integer step counts), the transcendental rasters within rtol 2e-5,
  atol 1e-4 (torch's CPU log/pow/tan round the last ulp differently in
  vectorised and remainder lanes, so a tile's cells can differ by 1 ulp);
- slope, slope_rad, TWI, mod-TWI, GFI, ln(hl/H) against the JAX tiled suite
  within rtol 1e-6, atol 1e-6, and fdist within rtol 1e-4, atol 1e-2 (the
  tolerances of tests/test_tiled_suite.py: JAX sums f32 steps serially);
- ``tiled_flow_hand`` against the JAX one through the VMEM absorbing kernel
  (interpret mode): indices, HAND, river-fac bitwise, fdist within rtol
  1e-5, atol 1e-2, and bitwise the port's in-core fdist;
- ``tiled_classify_flood`` and ``_integer_cutoff``: identical.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu import tiled as jtiled
from descriptools_tpu.ops import slope as jslope
from descriptools_tpu.parallel.classify import _integer_cutoff as j_integer_cutoff
from descriptools_tpu.pipeline import PipelineConfig as JConfig
from descriptools_tpu.pipeline import descriptor_suite as j_suite
from descriptools_tpu.utils.synthetic import synthetic_basin, windowed_basin
from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.slope import slope as t_slope
from descriptools_tpu_torch.ops.slope import slope_from_padded
from descriptools_tpu_torch.parallel.classify import _integer_cutoff

PX = 12.5
CFG = pipeline.PipelineConfig()
JCFG = JConfig(engine="xla")
RASTERS = ("slope", "slope_rad", "twi", "mod_twi", "downslope", "fdist", "indices", "hand", "gfi", "ln_hl_h")
EXACT = ("indices", "hand", "downslope")
TRANSCENDENTAL = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")


def array_loaders(**arrays):
    return {k: tiled._array_loader(a) for k, a in arrays.items()}


def _basin_75x83():
    dem, fdr, river, fac = synthetic_basin(75, 83, seed=52)
    return dem.astype(np.int32), fdr, river, fac.astype(np.int32)


def _port_incore(dem, fdr, river, fac, cfg=CFG):
    out = pipeline.descriptor_suite(*pipeline.inputs_to_torch(dem, fdr, fac, river, "cpu"), cfg)
    return {k: v.numpy() for k, v in out.items()}


def _assert_vs_jax(key, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if key in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key == "fdist":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def suites_75x83():
    dem, fdr, river, fac = _basin_75x83()
    loaders = array_loaders(dem=dem, fdr=fdr, river=river, fac=fac)
    stats = {}
    port = tiled.tiled_suite(loaders, (75, 83), CFG, "cpu", tile_rows=32, tile_cols=28, stats=stats)
    jax = jtiled.tiled_suite(loaders, (75, 83), JCFG, tile_rows=32, tile_cols=28)
    return port, {k: np.asarray(v) for k, v in jax.items()}, _port_incore(dem, fdr, river, fac), stats


@pytest.mark.parametrize("key", RASTERS)
def test_tiled_suite_vs_jax_tiled_suite(suites_75x83, key):
    port, jax, _, _ = suites_75x83
    assert port[key].dtype == jax[key].dtype
    _assert_vs_jax(key, port[key], jax[key])


@pytest.mark.parametrize("key", RASTERS)
def test_tiled_suite_vs_port_incore_suite(suites_75x83, key):
    port, _, incore, _ = suites_75x83
    if key in TRANSCENDENTAL:
        np.testing.assert_allclose(port[key], incore[key], rtol=2e-5, atol=1e-4, err_msg=key)
    else:
        np.testing.assert_array_equal(port[key], incore[key], err_msg=key)


def test_tiled_suite_stats_and_link_counts(suites_75x83):
    *_, stats = suites_75x83
    assert stats["tiles"] == 9 and stats["engine"] == "torch"
    assert stats["flow_walk_tier"] == stats["downslope_engine"] == "torch"
    assert stats["downslope_retries"] == 0 and stats["downslope_halo0"] == 64
    assert set(stats["pass_s"]) == set(stats["link"]) == {"A", "B", "C"}
    # Pass A moves fdr + river up (2 B/cell) and six int32 ring fields down.
    tile_cells, ring_len = 32 * 28, 2 * (32 + 28)
    assert stats["link"]["A"]["h2d_bytes"] == 9 * 2 * tile_cells
    assert stats["link"]["A"]["d2h_bytes"] == 9 * 6 * 4 * ring_len


def test_tiled_suite_from_windowed_loaders_memmap(tmp_path):
    """Windowed loaders, memmap outputs on disk, against the JAX in-core
    suite; the input-cache files are removed, the outputs remain."""
    rows, cols = 96, 112
    loaders = windowed_basin(rows, cols, seed=7)
    got = tiled.tiled_suite(loaders, (rows, cols), CFG, "cpu", tile_rows=48, tile_cols=32,
                            out_dir=str(tmp_path))
    assert isinstance(got["hand"], np.memmap)
    full = {k: loaders[k](0, rows, 0, cols) for k in ("dem", "fdr", "river", "fac")}
    want = j_suite(full["dem"], full["fdr"], full["fac"], full["river"], JCFG)
    for key in RASTERS:
        _assert_vs_jax(key, got[key], want[key])
    assert [p.name for p in tmp_path.iterdir() if p.name.startswith("_")] == []


def test_tiled_suite_reads_each_loader_once_per_tile():
    """Every loader is called once per tile (plus the 1-cell dem dtype and
    fac0 probes); without an input cache the ring pass reads no dem/fac."""
    rows, cols = 96, 112
    base = windowed_basin(rows, cols, seed=7)

    def counted(calls):
        def wrap(k):
            def f(ys, ye, xs, xe):
                calls[k].append((ye - ys) * (xe - xs))
                return base[k](ys, ye, xs, xe)
            return f
        return {k: wrap(k) for k in calls}

    n_tiles = 2 * 4
    calls = {k: [] for k in ("dem", "fdr", "river", "fac")}
    got = tiled.tiled_suite(counted(calls), (rows, cols), CFG, "cpu", tile_rows=48, tile_cols=32)
    for k in ("fdr", "river"):
        assert len(calls[k]) == n_tiles, (k, len(calls[k]))
    for k in ("dem", "fac"):
        windows = [c for c in calls[k] if c > 1]
        assert len(windows) == n_tiles and len(calls[k]) - len(windows) == 1, k
    calls2 = {k: [] for k in calls}
    got2 = tiled.tiled_suite(counted(calls2), (rows, cols), CFG, "cpu", tile_rows=48, tile_cols=32,
                             cache_inputs=False)
    for k in ("dem", "fac"):
        assert len([c for c in calls2[k] if c > 1]) <= 2 * n_tiles + 2, k
    assert len([c for c in calls2["fdr"] if c > 1]) == 2 * n_tiles
    for key in RASTERS:
        np.testing.assert_array_equal(got2[key], got[key], err_msg=key)


def test_tiled_suite_int32_guard_raises_past_2pow31():
    loaders = windowed_basin(46342, 46342, seed=0)
    with pytest.raises(ValueError, match="overflows int32"):
        tiled.tiled_suite(loaders, (46342, 46342), CFG, "cpu")
    with pytest.raises(ValueError, match="overflows int32"):
        tiled.tiled_flow_hand(np.zeros((1, 1)), None, None, None, PX, "cpu",
                              tile_rows=46342, tile_cols=46342)


def test_tiled_suite_engine_cuda_refuses_cpu():
    loaders = windowed_basin(40, 40, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.tiled_suite(loaders, (40, 40), pipeline.PipelineConfig(engine="cuda"), "cpu")


def test_tiled_suite_downslope_trunc_retry_bitwise():
    """A gentle 1-unit drop every 20 columns: the 5 m threshold needs ~100
    steps, far past the starting halo of 4, so the retry must widen the
    halo until the downslope is bitwise the in-core one."""
    rows, cols = 48, 256
    dem = (1000 - np.arange(cols) // 20).astype(np.int32) * np.ones((rows, 1), np.int32)
    fdr = np.full((rows, cols), 1, np.uint8)
    river = np.zeros((rows, cols), np.int8)
    river[:, -2] = 1
    fac = np.full((rows, cols), 10, np.int32)
    stats = {}
    got = tiled.tiled_suite(array_loaders(dem=dem, fdr=fdr, river=river, fac=fac), (rows, cols), CFG,
                            "cpu", tile_rows=32, tile_cols=32, downslope_halo=4, stats=stats)
    assert stats["downslope_retries"] > 0
    want = j_suite(dem, fdr, fac, river, JCFG)
    for key in ("downslope", "indices", "hand"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


@pytest.fixture(scope="module")
def flow_hand_75x83():
    dem, fdr, river, fac = _basin_75x83()
    port = tiled.tiled_flow_hand(dem, fdr, river, fac, PX, "cpu", tile_rows=32, tile_cols=28)
    jax = jtiled.tiled_flow_hand(dem, fdr, river, fac, PX, tile_rows=32, tile_cols=28,
                                 engine="pallas", interpret=True)
    return port, [np.asarray(x) for x in jax], _port_incore(dem, fdr, river, fac)


@pytest.mark.parametrize("i,key", list(enumerate(("fdist", "indices", "hand", "river_fac"))))
def test_tiled_flow_hand_vs_jax_absorbing_kernel(flow_hand_75x83, i, key):
    port, jax, _ = flow_hand_75x83
    assert port[i].dtype == jax[i].dtype
    if key == "fdist":
        np.testing.assert_allclose(port[i], jax[i], rtol=1e-5, atol=1e-2)
    else:
        np.testing.assert_array_equal(port[i], jax[i])


def test_tiled_flow_hand_fdist_bitwise_vs_port_incore(flow_hand_75x83):
    port, _, incore = flow_hand_75x83
    np.testing.assert_array_equal(port[0], incore["fdist"])
    np.testing.assert_array_equal(port[1], incore["indices"])
    np.testing.assert_array_equal(port[2], incore["hand"])


@pytest.mark.parametrize("halo", [1, 0])
def test_tile_map_slope_bitwise_vs_incore(halo):
    dem = synthetic_basin(70, 90, seed=51)[0].astype(np.float32)
    if halo:
        got = tiled.tile_map(lambda t: slope_from_padded(t.to(torch.float32), PX),
                             [dem], [NODATA], 32, 48, "cpu", halo=1)
    else:
        got = tiled.tile_map(lambda t: t * 2, [dem], [NODATA], 32, 48, "cpu")
        np.testing.assert_array_equal(got, dem * 2)
        return
    np.testing.assert_array_equal(got, t_slope(torch.from_numpy(dem), PX).numpy())
    np.testing.assert_array_equal(got, np.asarray(jslope(dem, PX)))


@pytest.fixture(scope="module")
def hand_96x112():
    rows, cols = 96, 112
    loaders = windowed_basin(rows, cols, seed=7)
    full = {k: loaders[k](0, rows, 0, cols) for k in ("dem", "fdr", "river", "fac")}
    return _port_incore(full["dem"], full["fdr"], full["river"], full["fac"])["hand"], loaders


@pytest.mark.parametrize("under", ["under", "over"])
def test_tiled_classify_flood_identical_to_jax_and_incore(hand_96x112, under):
    hand, loaders = hand_96x112
    shape = hand.shape
    got = tiled.tiled_classify_flood(hand, loaders["flood"], shape, under=under, tile_rows=40, tile_cols=36)
    want = jtiled.tiled_classify_flood(hand, loaders["flood"], shape, under=under, tile_rows=40, tile_cols=36)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    if under == "under":
        th, c, f, cmap = pipeline.classify_flood(hand, loaders["flood"](0, shape[0], 0, shape[1]))
        assert got[:3] == (th, c, f)
        np.testing.assert_array_equal(got[3], cmap)


@pytest.mark.parametrize("bad", [-5.0, 2.5, 1e9])
def test_tiled_classify_flood_rejects_invalid_hand_values(bad):
    rng = np.random.default_rng(3)
    hand = rng.integers(0, 40, size=(64, 64)).astype(np.float32)
    flood = (hand < 5).astype(np.int8)
    hand[10, 10] = bad
    with pytest.raises(ValueError, match="non-negative-integer"):
        tiled.tiled_classify_flood(hand, tiled._array_loader(flood), (64, 64), tile_rows=32, tile_cols=32)


def test_integer_cutoff_identical_to_jax():
    rng = np.random.default_rng(11)
    for _ in range(300):
        mn = float(rng.integers(-5, 50))
        mx = mn + float(rng.integers(1, 5000))
        th = float(rng.choice([rng.random(), rng.integers(0, 10001) / 10000, -0.1, 1.2]))
        for under in ("under", "over"):
            assert _integer_cutoff(th, mn, mx, under) == j_integer_cutoff(th, mn, mx, under)
