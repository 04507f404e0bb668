"""The port's one-device exact classifier (``parallel.classify
.sharded_classify_flood``) against the JAX package's sharded classifier on
a mesh of the CPU devices and against the host float64 ``classify_flood``.

Threshold, Correctness and Fit identical; class map identical.  HAND comes
from the float64 oracle on synthetic basins (integer DEM), the flood map
from HAND and a seed.

Float HAND (a float DEM's) takes the float path: a float32 cutoff a
threshold (``_float_cutoffs``) and one counting pass a search stage
(``ops.cuda.classify.cutoff_count``, its plain version here).  The JAX
package's sharded classifier takes integer HAND only, so float HAND is
held to the JAX package's host ``pipeline.classify_flood`` (float64 on
the host, as the reference) and to the port's own, on seeded rasters of
64² to 256² with NoData and the ``hand[0, 0]`` probe quirk, under both
rules, and on values placed at the thresholds and their float32
neighbours.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu.parallel import make_mesh
from descriptools_tpu.parallel.classify import sharded_classify_flood as j_sharded
from descriptools_tpu.pipeline import classify_flood as j_classify_flood
from descriptools_tpu_torch import oracle, pipeline
from descriptools_tpu_torch.ops.cuda import classify as cclassify
from descriptools_tpu_torch.parallel import classify as tclassify
from descriptools_tpu_torch.utils import timing
from descriptools_tpu_torch.utils.synthetic import synthetic_basin

PX = 12.5


def _hand_flood(rows, cols, seed, cut, noise=None):
    dem, fdr, river, _ = synthetic_basin(rows, cols, seed=seed)
    _, idx = oracle.flow_distance_index_oracle(fdr, river, PX)
    hand = oracle.hand_oracle(dem.astype(np.int32), idx)
    flood = (hand != -100) & (hand <= cut)
    if noise is not None:
        rng = np.random.default_rng(noise)
        flood &= rng.random(hand.shape) < 0.9
    return hand, flood.astype(np.uint8)


def _port(hand, flood, **kw):
    th, c, f, cm = tclassify.sharded_classify_flood(hand, flood, device="cpu", **kw)
    assert cm.dtype == torch.uint8 and cm.device.type == "cpu"
    return th, c, f, cm.numpy()


def _assert_all_agree(hand, flood, under="under"):
    want = pipeline.classify_flood(hand, flood, under=under)
    got = _port(hand, flood, under=under)
    jax_out = j_sharded(hand, flood, make_mesh((2, 4)), under=under)
    assert got[:3] == want[:3]
    assert tuple(jax_out[:3]) == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3], np.asarray(jax_out[3]))
    return got


@pytest.mark.parametrize("seed,cut,noise", [(21, 8, 0), (5, 5, None), (33, 12, 3)])
def test_one_device_classify_matches_jax_and_host(seed, cut, noise):
    hand, flood = _hand_flood(72, 100, seed=seed, cut=cut, noise=noise)
    th, c, f, _ = _assert_all_agree(hand, flood)
    assert 0.0 < f <= 1.0 and 0.0 <= th <= 1.0


def test_one_device_classify_over():
    hand, _ = _hand_flood(72, 100, seed=21, cut=8)
    flood = ((hand != -100) & (hand >= 12)).astype(np.uint8)
    _assert_all_agree(hand, flood, under="over")


def test_one_device_classify_no_nodata():
    """With no NoData the minimum is a real value and np.unique(hand)[1] is
    the second distinct real value."""
    hand, flood = _hand_flood(45, 53, seed=5, cut=5)
    hand = np.where(hand == -100, 3, hand)
    assert (hand != -100).all()
    _assert_all_agree(hand, flood)


def test_one_device_classify_tensors_and_staged_shape():
    """Tensors stay on their device; a NoData-padded staged raster with
    ``shape`` and ``crop`` gives the unpadded result."""
    hand, flood = _hand_flood(45, 53, seed=5, cut=5)
    want = pipeline.classify_flood(hand, flood)
    hp = np.pad(hand, ((0, 3), (0, 5)), constant_values=-100)
    fp = np.pad(flood.astype(np.int32), ((0, 3), (0, 5)), constant_values=-100)
    got = tclassify.sharded_classify_flood(torch.from_numpy(hp), torch.from_numpy(fp), shape=hand.shape)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    full = tclassify.sharded_classify_flood(torch.from_numpy(hp), torch.from_numpy(fp), shape=hand.shape,
                                            crop=False)
    assert full[3].shape == hp.shape and not full[3][45:].any() and not full[3][:, 53:].any()


@pytest.mark.parametrize("under", ["under", "over"])
def test_integer_hand_counts_one_pass_a_stage(monkeypatch, under):
    """Integer HAND counts each search stage on the device: the host
    float64 path's threshold, Fit and class map."""
    hand, flood = _hand_flood(72, 100, seed=21, cut=8, noise=0)
    if under == "over":
        flood = ((hand != -100) & (hand >= 12)).astype(np.uint8)
    want = pipeline.classify_flood(hand, flood, under=under)
    calls = []
    real = tclassify._block_cut_counts
    monkeypatch.setattr(tclassify, "_block_cut_counts", lambda *a: calls.append(1) or real(*a))
    got = _port(hand, flood, under=under)
    # A pass a search stage that has a cutoff not counted yet: here the
    # integer cutoffs of two later stages all repeat earlier ones, and the
    # final threshold's cutoff is its last stage's.
    assert len(calls) == 3
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("under", ["under", "over"])
def test_integer_hand_of_a_wide_value_range(under):
    """Integer HAND up to about 5,000,000 (wider than 2^22 values, and
    exact in float32): integer cutoffs through the counting passes, the
    host float64 paths' threshold, Correctness, Fit and class map."""
    hand, flood = _hand_flood(72, 100, seed=21, cut=8, noise=0)
    spread = np.random.default_rng(6).integers(0, 100_000, hand.shape)
    wide = np.where(hand == -100, -100, hand * 100_000 + spread).astype(np.int32)
    assert wide.max() - wide[wide != -100].min() > 1 << 22 and wide.max() < 1 << 24
    if under == "over":
        flood = ((hand != -100) & (hand >= 12)).astype(np.uint8)
    _assert_host(wide, flood, under)


def test_non_integer_hand_and_degenerate_range_raise():
    """Non-integer HAND now calibrates (the float path: one counting pass a
    stage) as the host float64 path does; a degenerate range still raises."""
    hand, flood = _hand_flood(72, 100, seed=21, cut=8)
    frac = hand.astype(np.float32)
    frac[3, 3] = 7.5
    _assert_host(frac, flood, "under")
    flat = np.where(hand == -100, -100, 4).astype(np.float32)
    with pytest.raises(ValueError, match="degenerate"):
        _port(flat, flood)


def test_mesh_and_missing_card_refused():
    hand, flood = _hand_flood(24, 30, seed=2, cut=5)
    with pytest.raises(TypeError, match="Mesh"):
        tclassify.sharded_classify_flood(hand, flood, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tclassify.sharded_classify_flood(hand, flood)


def _float_hand_flood(size, seed, probe):
    """Float32 HAND of ``size``² (a gamma-like spread of metres, a NoData
    block) and a flood map that follows it with noise (1, 0, and NoData
    where HAND is).  ``probe``: the corner is data and some cells share its
    value (the quirk), else the corner is NoData."""
    rng = np.random.default_rng(seed)
    hand = (rng.gamma(1.5, 4.0, (size, size)) * rng.random((size, size)) ** 0.3).astype(np.float32)
    hand[: size // 5, size // 3 : size // 2] = -100
    hand[rng.random(hand.shape) < 0.02] = 0.0
    if probe:
        hand[0, 0] = hand[size // 2, size // 2]
        hand[rng.random(hand.shape) < 0.01] = hand[0, 0]
    else:
        hand[0, 0] = -100
    noisy = hand + rng.normal(0.0, 2.0, hand.shape).astype(np.float32)
    flood = np.where(noisy <= np.quantile(hand[hand != -100], 0.3), 1, 0).astype(np.int32)
    flood[hand == -100] = -100
    return hand, flood


def _assert_host(hand, flood, under):
    """The port's classifier identical to the JAX package's host float64
    path and to the port's own."""
    want = j_classify_flood(hand, flood, under=under)
    host = pipeline.classify_flood(hand, flood, under=under)
    got = _port(hand, flood, under=under)
    for other in (host, got):
        assert other[:3] == want[:3]
        np.testing.assert_array_equal(other[3], want[3])
    return got


@pytest.mark.parametrize("under", ["under", "over"])
@pytest.mark.parametrize("size,seed,probe", [(64, 1, True), (128, 2, False), (256, 3, True)])
def test_float_hand_matches_host(size, seed, probe, under):
    hand, flood = _float_hand_flood(size, seed, probe)
    assert (hand != np.round(hand)).any()
    if under == "over":
        flood = np.where(hand == -100, -100, (hand >= np.quantile(hand, 0.6)).astype(np.int32))
    th, c, f, _ = _assert_host(hand, flood, under)
    assert 0.0 < f <= 1.0


@pytest.mark.parametrize("under", ["under", "over"])
def test_float_hand_at_the_thresholds(under):
    """mn 0 and mx 1: HAND at k/10000 (each search threshold's own value,
    rounded to float32) and at its float32 neighbours, so that the oracle's
    float64 predicate flips between neighbours at every threshold."""
    k = np.arange(0, 10001, dtype=np.float64) / 10000
    at = k.astype(np.float32)
    vals = np.concatenate([at, np.nextafter(at, np.float32(-1)), np.nextafter(at, np.float32(2))])
    vals = np.clip(vals, np.float32(0), np.float32(1))
    rng = np.random.default_rng(7)
    size = 180
    hand = rng.choice(vals, (size, size)).astype(np.float32)
    hand[:10, :10] = -100
    hand[50, 50], hand[51, 51] = 0.0, 1.0
    lo = rng.random(hand.shape) < 0.8
    flood = np.where(lo, (hand <= 0.3141).astype(np.int32), (rng.random(hand.shape) < 0.5).astype(np.int32))
    if under == "over":
        flood = np.where(lo, (hand >= 0.6180).astype(np.int32), flood)
    flood[hand == -100] = -100
    _assert_host(hand, flood, under)


@pytest.mark.parametrize("under", ["under", "over"])
def test_float_cutoffs_are_the_flip(under):
    """Each cutoff is where the float64 predicate flips: it holds at the
    cutoff and fails at its float32 neighbour past it (under: above; over:
    below), for thresholds inside and far outside [0, 1]."""
    mn, mx = np.float64(np.float32(0.37)), np.float64(np.float32(812.5))
    ths = np.array([v / 10000 for v in range(-20, 10200, 37)] + [-5.0, 5.0])
    cuts = tclassify._float_cutoffs(ths, mn, mx, under)
    assert cuts.dtype == np.float32

    def holds(h, th):
        x = (np.float64(h) - mn) / (mx - mn)
        return x <= th if under == "under" else x >= th

    assert np.isfinite(cuts).all()  # every float32 range holds a flip of these thresholds
    for th, cut in zip(ths, cuts):
        past = np.nextafter(cut, np.float32(np.inf if under == "under" else -np.inf))
        assert holds(cut, th) and not holds(past, th), (th, cut)


@pytest.mark.parametrize("under", ["under", "over"])
def test_float_cutoffs_bisect_where_the_guess_misses(monkeypatch, under):
    """Thresholds whose flip is not near ``f32(mn + th (mx - mn))`` (a
    range whose sum cancels near 0) and thresholds whose predicate is empty
    or full go to the whole-range bisection; the rest take the guess's
    neighbourhood, with the same flip."""
    bisected = []
    whole = tclassify._bisect_cutoffs
    monkeypatch.setattr(tclassify, "_bisect_cutoffs", lambda ths, *a: bisected.append(len(ths)) or whole(ths, *a))
    mn, mx = np.float64(np.float32(-1000.0)), np.float64(np.float32(1000.0))
    ths = np.array([0.5, 0.25, 0.75, 0.5001, -1e300, 1e300])
    cuts = tclassify._float_cutoffs(ths, mn, mx, under)
    assert cuts.dtype == np.float32
    assert bisected == [3]  # 0.5 (cancels to 0) and the two infinite thresholds

    def holds(h, th):
        x = (np.float64(h) - mn) / (mx - mn)
        return x <= th if under == "under" else x >= th

    for th, cut in zip(ths[:4], cuts[:4]):
        past = np.nextafter(cut, np.float32(np.inf if under == "under" else -np.inf))
        assert holds(cut, th) and not holds(past, th), (th, cut)
    assert 0 < abs(cuts[0]) < 1e-10  # the flip sits where h + 1000 first rounds past 1000
    empty, full = (-np.inf, np.inf) if under == "under" else (np.inf, -np.inf)
    assert (cuts[4], cuts[5]) == ((empty, full) if under == "under" else (full, empty))


@pytest.mark.parametrize("under", ["under", "over"])
def test_cutoff_count_plain_counts_each_cut(under):
    """The plain counting pass against a direct count, cut by cut: valid
    cells hit, valid flooded ones among them, flooded cells; unsorted cuts
    with a repeat, infinities, NaN HAND, flood 2 flooded, the probe."""
    hand, flood = _float_hand_flood(96, 11, True)
    hand[5, 7] = np.nan
    flood[flood == 1] = np.where(np.random.default_rng(3).random(int((flood == 1).sum())) < 0.2, 2, 1)
    cuts = np.array([3.5, 0.0, np.inf, 3.5, 12.25, -np.inf, 1e-3], np.float32)
    h, f = torch.from_numpy(hand), torch.from_numpy(flood)
    got = cclassify.cutoff_count(h, f, h[0, 0], cuts, under).numpy()
    valid = (hand != -100) & (hand != hand[0, 0])
    fl = (flood == 1) | (flood == 2)
    k = len(cuts)
    for j, c in enumerate(cuts):
        hit = valid & ((hand <= c) if under == "under" else (hand >= c))
        assert got[j] == hit.sum() and got[k + j] == (hit & fl).sum(), (j, c)
    assert got[2 * k] == fl.sum()


def test_float_path_passes_reads_and_spans():
    """The float path: 5 counting passes (``classify.count``, ``passes`` 1
    and its cutoffs each) and 6 host reads (the statistics' and one a
    pass), the float32 bisections counted on ``classify.search``."""
    hand, flood = _float_hand_flood(64, 5, True)
    with timing.recording() as rec:
        _port(hand, flood)
    counts = [s for s in rec.spans if s.name == "classify.count"]
    assert [s.counters["passes"] for s in counts] == [1] * 5
    assert sum(s.counters["host_reads"] for s in counts) == 5
    assert sum(s.counters.get("host_reads", 0) for s in rec.spans) == 6
    assert [s.counters["cuts"] for s in counts][0] == 3 and max(s.counters["cuts"] for s in counts) <= 21
    search = [s for s in rec.spans if s.name == "classify.search"]
    assert search[0].counters["float_cutoffs"] == 3 + 5 + 11 + 21 + 21 + 1


def test_integer_path_reads_unchanged():
    """Integer HAND: a counting pass a search stage with a cutoff not
    counted yet (``classify.count``, ``passes`` 1; three on this basin,
    whose later stages' integer cutoffs repeat earlier ones) and 1 + passes
    host reads (the statistics' one and one a pass), no float32
    bisection."""
    hand, flood = _hand_flood(72, 100, seed=21, cut=8, noise=0)
    with timing.recording() as rec:
        _port(hand, flood)
    counts = [s for s in rec.spans if s.name == "classify.count"]
    assert [s.counters["passes"] for s in counts] == [1] * 3
    assert sum(s.counters["host_reads"] for s in counts) == 3
    assert sum(s.counters.get("host_reads", 0) for s in rec.spans) == 1 + 3
    assert "float_cutoffs" not in [s for s in rec.spans if s.name == "classify.search"][0].counters
