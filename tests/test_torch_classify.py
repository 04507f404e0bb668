"""The port's one-device exact classifier (``parallel.classify
.sharded_classify_flood``) against the JAX package's sharded classifier on
a mesh of the CPU devices and against the host float64 ``classify_flood``.

Threshold, Correctness and Fit identical; class map identical.  HAND comes
from the float64 oracle on synthetic basins (integer DEM), the flood map
from HAND and a seed.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu.parallel import make_mesh
from descriptools_tpu.parallel.classify import sharded_classify_flood as j_sharded
from descriptools_tpu_torch import oracle, pipeline
from descriptools_tpu_torch.parallel import classify as tclassify
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
def test_counting_fallback_matches_histogram(monkeypatch, under):
    """Above ``NBINS_MAX`` bins the search counts each stage on the device:
    the same threshold, Fit and class map."""
    hand, flood = _hand_flood(72, 100, seed=21, cut=8, noise=0)
    if under == "over":
        flood = ((hand != -100) & (hand >= 12)).astype(np.uint8)
    want = _port(hand, flood, under=under)
    calls = []
    real = tclassify._block_counts
    monkeypatch.setattr(tclassify, "NBINS_MAX", 1)
    monkeypatch.setattr(tclassify, "_block_counts", lambda *a: calls.append(1) or real(*a))
    got = _port(hand, flood, under=under)
    assert len(calls) == 6  # five search stages and the final count
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_histogram_path_is_one_pass(monkeypatch):
    hand, flood = _hand_flood(72, 100, seed=21, cut=8, noise=0)
    calls = []
    real = tclassify._block_histogram
    monkeypatch.setattr(tclassify, "_block_histogram", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tclassify, "_block_counts", None)
    _port(hand, flood)
    assert calls == [1]


def test_non_integer_hand_and_degenerate_range_raise():
    hand, flood = _hand_flood(72, 100, seed=21, cut=8)
    bad = hand.astype(np.float32)
    bad[3, 3] = 7.5
    with pytest.raises(ValueError, match="integer"):
        _port(bad, flood)
    flat = np.where(hand == -100, -100, 4).astype(np.float32)
    with pytest.raises(ValueError, match="degenerate"):
        _port(flat, flood)


def test_mesh_and_missing_card_refused():
    hand, flood = _hand_flood(24, 30, seed=2, cut=5)
    with pytest.raises(NotImplementedError, match="one device"):
        tclassify.sharded_classify_flood(hand, flood, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tclassify.sharded_classify_flood(hand, flood)
