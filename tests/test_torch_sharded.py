"""PyTorch port vs the JAX package: the suite over a mesh of blocks.

The port's mesh runs in this process as a world of one over gloo (set up
and torn down by a fixture), its eight blocks on the CPU, where the kernel
wrappers run their plain versions; the JAX side runs on the conftest's
eight virtual CPU devices.  Meshes (2, 4), (4, 2) and (1, 8), as
``tests/test_sharded.py``.  Tolerances:
- indices, HAND, river_fac, downslope, class map and threshold: bitwise
  (against JAX, and against the port's in-core suite);
- slope and fdist: bitwise against the port's in-core suite; slope within
  rtol 1e-6 of JAX (its jitted slope multiplies by a reciprocal), fdist
  within rtol 1e-5, atol 1e-4 of JAX's sharded fdist (which sums f32 step
  lengths through the ring in another order);
- the rest (slope_rad, TWI, mod-TWI, GFI, ln(hl/H)): rtol 2e-5, atol 1e-4.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu import parallel as jpar
from descriptools_tpu.ops import downslope as j_downslope
from descriptools_tpu.parallel.classify import sharded_classify_flood as j_classify
from descriptools_tpu.pipeline import PipelineConfig as JConfig
from descriptools_tpu_torch import oracle, pipeline
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.flow import hand_and_river_fac
from descriptools_tpu_torch.parallel import (
    classify as tclassify,
    halo_exchange,
    make_mesh,
    multihost,
    sharded_downslope,
    sharded_flow_hand,
    sharded_slope,
    sharded_suite,
    sharded_suite_staged,
)
from descriptools_tpu_torch.parallel.mesh import Mesh, pad_to_mesh
from descriptools_tpu_torch.parallel.sharded import _staged
from descriptools_tpu_torch.utils.synthetic import synthetic_basin

PX = 12.5
CFG = pipeline.PipelineConfig()
MESHES = [(2, 4), (4, 2), (1, 8)]
EXACT = ("indices", "hand", "river_fac", "downslope", "slope", "fdist")
CLOSE = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def world():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


@pytest.fixture(scope="module")
def basin():
    dem, fdr, river, fac = synthetic_basin(72, 100, seed=21)
    return dem.astype(np.int32), fdr, river, fac.astype(np.int32)


def _incore(dem, fdr, river, fac, cfg=CFG):
    out = pipeline.descriptor_suite(*pipeline.inputs_to_torch(dem, fdr, fac, river, "cpu"), cfg)
    _, out["river_fac"] = hand_and_river_fac(torch.as_tensor(dem), torch.as_tensor(fac), out["indices"])
    return {k: v.numpy() for k, v in out.items()}


def _gentle_east_basin(rows, cols):
    """tests/test_sharded.py's fixture: walks of 50-200 cells east with a
    large elevation threshold, far past any halo."""
    prof = np.round((cols - np.arange(cols, dtype=np.float64)) ** 2 / 50.0)
    dem = 500.0 + prof * np.ones((rows, 1))
    return dem, np.full((rows, cols), 1, np.uint8)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_slope(basin, shape):
    dem = basin[0]
    got = sharded_slope(dem, PX, make_mesh(shape, device="cpu")).numpy()
    np.testing.assert_array_equal(got, _incore(*basin)["slope"])
    want = np.asarray(jpar.sharded_slope(dem, PX, jpar.make_mesh(shape)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _assert_flow(got, want_jax, incore):
    names = ("fdist", "indices", "hand", "river_fac")
    for name, g, w in zip(names, got, want_jax):
        g, w = g.numpy(), np.asarray(w)
        if name == "fdist":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, incore[name], err_msg=name)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_flow(basin, shape):
    dem, fdr, river, fac = basin
    got = sharded_flow_hand(dem, fdr, river, fac, PX, make_mesh(shape, device="cpu"))
    want = jpar.sharded_flow_hand(dem, fdr, river, fac, PX, jpar.make_mesh(shape))
    _assert_flow(got, want, _incore(*basin))


def test_sharded_flow_uneven_pad():
    """45x53 divides by no mesh: padding, and indices renumbered from the
    padded columns."""
    dem, fdr, river, fac = synthetic_basin(45, 53, seed=5)
    dem, fac = dem.astype(np.int32), fac.astype(np.int32)
    got = sharded_flow_hand(dem, fdr, river, fac, PX, make_mesh((2, 4), device="cpu"))
    want = jpar.sharded_flow_hand(dem, fdr, river, fac, PX, jpar.make_mesh((2, 4)))
    _assert_flow(got, want, _incore(dem, fdr, river, fac))
    _, want_i = oracle.flow_distance_index_oracle(fdr, river, PX)
    np.testing.assert_array_equal(got[1].numpy(), want_i)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_downslope(basin, shape):
    dem, fdr, _, _ = basin
    stats = {}
    got = sharded_downslope(dem, fdr, PX, 5.0, make_mesh(shape, device="cpu"), halo=16, stats=stats)
    want = np.asarray(j_downslope(dem.astype(np.float32), fdr, PX, 5.0))
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["downslope_attempts"] == [dict(halo=16, engine="torch")]
    assert stats["downslope_retries"] == 0


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_downslope_exact_past_halo(shape):
    """Walks of 100+ cells from a halo of 8: the retry widens the halo past
    one block (32 columns on (1, 8)) and lands bitwise on the single-device
    result."""
    dem, fdr = _gentle_east_basin(48, 256)
    stats = {}
    got = sharded_downslope(dem, fdr, PX, 100.0, make_mesh(shape, device="cpu"), halo=8, stats=stats)
    want = np.asarray(j_downslope(dem.astype(np.float32), fdr, PX, 100.0))
    np.testing.assert_array_equal(got.numpy(), want)
    halos = [a["halo"] for a in stats["downslope_attempts"]]
    assert stats["downslope_retries"] == len(halos) - 1 > 0
    assert halos[0] == 8 and all(b == 2 * a for a, b in zip(halos, halos[1:]))
    if shape == (1, 8):
        assert halos[-1] > 256 // 8  # past one block: a multi-block exchange


def test_sharded_downslope_exact_false_diverges():
    dem, fdr = _gentle_east_basin(48, 256)
    mesh = make_mesh((1, 8), device="cpu")
    heur = sharded_downslope(dem, fdr, PX, 100.0, mesh, halo=8, exact=False).numpy()
    want = np.asarray(j_downslope(dem.astype(np.float32), fdr, PX, 100.0))
    assert not np.allclose(heur, want)


def test_staged_on_wrong_mesh_rejected(basin):
    dem = basin[0]
    staged = _staged(dem, make_mesh((2, 4), device="cpu"), NODATA, np.float32)
    with pytest.raises(ValueError, match="mesh"):
        sharded_slope(staged, PX, make_mesh((4, 2), device="cpu"), shape=dem.shape)
    with pytest.raises(ValueError, match="shape"):
        sharded_slope(staged, PX, make_mesh((2, 4), device="cpu"))


@pytest.fixture(scope="module")
def suites(basin):
    dem, fdr, river, fac = basin
    stats = {}
    port = sharded_suite(dem, fdr, fac, river, CFG, make_mesh((2, 4), device="cpu"), stats=stats)
    jax = jpar.sharded_suite(dem, fdr, fac, river, JConfig(engine="xla"), jpar.make_mesh((2, 4)))
    return ({k: v.numpy() for k, v in port.items()}, {k: np.asarray(v) for k, v in jax.items()},
            _incore(*basin), stats)


@pytest.mark.parametrize("key", ["slope", "slope_rad", "twi", "mod_twi", "downslope", "fdist",
                                 "indices", "hand", "river_fac", "gfi", "ln_hl_h"])
def test_sharded_suite(suites, key):
    port, jax, incore, _ = suites
    got = port[key]
    if key in EXACT:
        np.testing.assert_array_equal(got, incore[key], err_msg=key)
    else:
        np.testing.assert_allclose(got, incore[key], **CLOSE, err_msg=key)
    if key in ("indices", "hand", "river_fac", "downslope"):
        np.testing.assert_array_equal(got, jax[key], err_msg=key)
    elif key == "slope":
        np.testing.assert_allclose(got, jax[key], rtol=1e-6, atol=0)
    elif key == "fdist":
        np.testing.assert_allclose(got, jax[key], rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(got, jax[key], **CLOSE, err_msg=key)


def test_sharded_suite_counts_its_traffic(suites):
    stats = suites[3]
    # One rank: every strip is a device copy, every collective still runs.
    assert stats["halo_bytes"] > 0 and stats["comm_calls"] > 0
    assert stats["downslope_retries"] == 0


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("blocks", [0, 1, 2.5])
def test_halo_exchange_matches_pad_and_slice(basin, shape, blocks):
    """Each extended block is the slice of the grid padded by ``width``
    with ``fill``: widths 1, one block height and 2.5 block heights."""
    mesh = make_mesh(shape, device="cpu")
    dem = pad_to_mesh(basin[0].astype(np.float32), mesh, NODATA)
    fdr = pad_to_mesh(basin[1], mesh, 0)
    h, w = dem.shape[0] // shape[0], dem.shape[1] // shape[1]
    width = max(1, int(blocks * h))
    for arr, fill in ((dem, NODATA), (fdr, 0)):
        staged = _staged(arr, mesh, fill)
        ext = halo_exchange(staged, width, fill)
        model = np.pad(arr, width, constant_values=fill)
        for b in mesh.blocks:
            iy, ix = mesh.coords(b)
            want = model[iy * h : (iy + 1) * h + 2 * width, ix * w : (ix + 1) * w + 2 * width]
            np.testing.assert_array_equal(ext[b].numpy(), want)


def _hand_flood(seed, cut, rows=72, cols=100):
    dem, fdr, river, _ = synthetic_basin(rows, cols, seed=seed)
    _, idx = oracle.flow_distance_index_oracle(fdr, river, PX)
    hand = oracle.hand_oracle(dem.astype(np.int32), idx)
    return hand, ((hand != NODATA) & (hand <= cut)).astype(np.uint8)


@pytest.mark.parametrize("under", ["under", "over"])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_classifier_matches_jax_and_host(shape, under):
    hand, flood = _hand_flood(21, 8)
    if under == "over":
        flood = ((hand != NODATA) & (hand >= 12)).astype(np.uint8)
    want = pipeline.classify_flood(hand, flood, under=under)
    got = tclassify.sharded_classify_flood(hand, flood, make_mesh(shape, device="cpu"), under=under)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    if shape == (2, 4):
        jax = j_classify(hand, flood, jpar.make_mesh((2, 4)), under=under)
        assert tuple(jax[:3]) == got[:3]
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(jax[3]))


def test_mesh_classifier_counting_fallback_and_padding(monkeypatch):
    """The counting fallback (forced by a tiny NBINS_MAX) on 45x53, which
    divides by no mesh: the padding is masked out of the statistics, and
    the class map stays per block with ``crop=False``."""
    hand, flood = _hand_flood(5, 5, 45, 53)
    hand = np.where(hand == NODATA, 3, hand)  # no NoData: the min is a real value
    want = pipeline.classify_flood(hand, flood)
    mesh = make_mesh((2, 4), device="cpu")
    calls = []
    real = tclassify._block_counts
    monkeypatch.setattr(tclassify, "NBINS_MAX", 4)
    monkeypatch.setattr(tclassify, "_block_counts", lambda *a: calls.append(1) or real(*a))
    got = tclassify.sharded_classify_flood(hand, flood, mesh, crop=False)
    assert calls and got[:3] == want[:3]
    cmap = got[3].gather().numpy()[:45, :53]
    np.testing.assert_array_equal(cmap, want[3])


def test_mesh_classifier_refuses_a_non_mesh():
    hand, flood = _hand_flood(2, 5, 24, 30)
    with pytest.raises(TypeError, match="Mesh"):
        tclassify.sharded_classify_flood(hand, flood, mesh=(2, 4))


def test_sharded_suite_staged_with_flood(basin):
    dem, fdr, river, fac = basin
    incore = _incore(*basin)
    flood = ((incore["hand"] != NODATA) & (incore["hand"] <= 5)).astype(np.uint8)
    arrays = dict(dem=dem, fdr=fdr, river=river, fac=fac, flood=flood)
    loaders = {k: (lambda ys, ye, xs, xe, a=v: a[ys:ye, xs:xe]) for k, v in arrays.items()}
    out = sharded_suite_staged(make_mesh((4, 2), device="cpu"), dem.shape, loaders, CFG, downslope_halo=8)
    for key in ("indices", "hand", "downslope", "slope", "fdist"):
        np.testing.assert_array_equal(out[key].numpy(), incore[key], err_msg=key)
    want = pipeline.classify_flood(incore["hand"], flood)
    assert (out["threshold"], out["correctness"], out["fit"]) == want[:3]
    np.testing.assert_array_equal(out["class_map"].numpy(), want[3])


def test_mesh_layout_and_staging():
    """make_mesh's default shape and divisibility rule; stage_padded loads a
    rank's blocks only, padded with ``fill``."""
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.world, mesh.blocks, mesh.comm_device) == ((1, 1), 1, (0,), torch.device("cpu"))
    assert multihost.global_mesh(device="cpu") == mesh
    with pytest.raises(ValueError, match="blocks"):
        make_mesh((0, 3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((2, 4))
    # Rank 1 of 2 on a (2, 4) layout owns blocks 4-7: the bottom row.
    other = Mesh((2, 4), 2, 1, torch.device("cpu"), "gloo")
    seen = []

    def loader(ys, ye, xs, xe):
        seen.append((ys, ye, xs, xe))
        return np.ones((ye - ys, xe - xs), np.int32)

    staged = multihost.stage_padded(other, (45, 53), NODATA, loader, np.int32)
    assert sorted(staged.blocks) == [4, 5, 6, 7] and staged.shape == (46, 56)
    assert all(ys == 23 and ye == 45 for ys, ye, _, _ in seen)
    np.testing.assert_array_equal(staged.blocks[7][-1].numpy(), np.full(14, NODATA))
    with pytest.raises(ValueError, match="divide"):
        multihost.stage_global(other, (45, 53), np.int32, loader)


def test_parallel_exports_the_jax_names():
    import descriptools_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(callable(getattr(tpar, name)) for name in jpar.__all__)
    assert tpar.multihost.initialize and tpar.ckpt.stage_hook
