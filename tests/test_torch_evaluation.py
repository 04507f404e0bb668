"""The port's ``evaluation`` (scaling, thresholding, confusion, Fit and
Correctness, ``batch_fit`` and ``calibration(backend="torch")``) against the
JAX package's, bitwise: float32 rasters, int32 maps and counts, float32 Fit
values, and the identical threshold as JAX's ``backend="jax"``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from descriptools_tpu import evaluation as jev
from descriptools_tpu_torch import evaluation as tev
from descriptools_tpu_torch.constants import NODATA


def _hand_flood(seed, shape=(50, 70), top=60):
    """Integer HAND with NoData rows, and a flood map correlated with it."""
    rng = np.random.default_rng(seed)
    hand = rng.integers(0, top, size=shape).astype(np.int32)
    hand[:3] = NODATA
    flood = ((hand <= top // 4) & (rng.random(shape) < 0.85)) | (rng.random(shape) < 0.05)
    flood = flood.astype(np.int8)
    flood[-2:] = NODATA
    return hand, flood


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mn,mx", [(0, 59), (np.int32(1), np.int32(59)), (0.3, 59.7), (np.float64(1e-3), 7)])
def test_min_max_scale(mn, mx):
    hand, _ = _hand_flood(0)
    _same(tev.min_max_scale(torch.from_numpy(hand), mn, mx), jev.min_max_scale(hand, mn, mx))
    f = hand.astype(np.float32) + np.float32(0.37)
    _same(tev.min_max_scale(torch.from_numpy(f), mn, mx), jev.min_max_scale(f, mn, mx))


@pytest.mark.parametrize("under", ["under", "over"])
def test_binary_map_confusion_and_counts(under):
    hand, flood = _hand_flood(1)
    desc = np.array(jev.min_max_scale(hand, 1, 59))
    for th in (0.0, 0.1, 0.3, 1 / 3, 0.55, 1.0):
        want = np.asarray(jev.binary_map(desc, th, under))
        got = tev.binary_map(torch.from_numpy(desc), th, under)
        _same(got, want)
        cw, fw, rw = jev.confusion(want, flood)
        cg, fg, rg = tev.confusion(got, torch.from_numpy(flood))
        _same(cg, cw)
        _same(fg, fw)
        _same(rg, rw)
    _same(tev._normalise_benchmark(torch.from_numpy(flood)), jev._normalise_benchmark(flood))
    count = np.array([5, 0, 0, 0], np.int32)  # 0/0: NaN in both
    _same(tev.correctness(torch.from_numpy(count)), jev.correctness(jnp.asarray(count)))
    _same(tev.fit(torch.from_numpy(count)), jev.fit(jnp.asarray(count)))


def test_binary_map_rounds_the_threshold_to_float32():
    """A threshold float32 cannot represent meets desc values lying between
    it and its float32 rounding: both packages compare in float32."""
    for t in (0.1, 0.3, 0.7, 1 / 3):
        r = np.float32(t)
        below, above = np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(1))
        desc = np.array([[5.0, r, below], [above, r, t]], np.float32)
        assert float(r) != t
        for under in ("under", "over"):
            _same(tev.binary_map(torch.from_numpy(desc), t, under), jev.binary_map(desc, t, under))
        got = tev.binary_map(torch.from_numpy(desc), t, "under" if float(r) > t else "over").numpy()
        assert got[0, 1] == 1  # the f32 value counts, though it lies past t in float64


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("under", ["under", "over"])
def test_batch_fit_bitwise(seed, under):
    hand, flood = _hand_flood(seed)
    desc = np.array(jev.min_max_scale(hand, 1, 59))
    ths = np.concatenate([np.linspace(-0.1, 1.1, 41), [0.1, 1 / 3, 2.0]]).astype(np.float32)
    want = np.asarray(jev.batch_fit(desc, flood, ths, under=under))
    got = tev.batch_fit(torch.from_numpy(desc), torch.from_numpy(flood), torch.from_numpy(ths), under=under)
    _same(got, want)


def test_batch_fit_nan_when_nothing_counts():
    desc = np.full((4, 5), 0.5, np.float32)
    desc[0, 0] = 9.0
    flood = np.zeros((4, 5), np.int8)
    ths = np.array([0.1, 0.9], np.float32)
    got = tev.batch_fit(torch.from_numpy(desc), torch.from_numpy(flood), ths).numpy()
    _same(got, jev.batch_fit(desc, flood, ths))
    assert np.isnan(got[0])


@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("under", ["under", "over"])
def test_calibration_torch_equals_jax_backend(seed, under):
    hand, flood = _hand_flood(seed, top=80)
    if under == "over":
        flood = np.where(flood == NODATA, NODATA, (hand >= 40) & (hand != NODATA)).astype(np.int8)
    desc = np.array(jev.min_max_scale(hand, 1, 79))
    want = jev.calibration(desc, flood, under, backend="jax")
    got = tev.calibration(torch.from_numpy(desc), torch.from_numpy(flood), under, backend="torch")
    assert got == want
    assert tev.calibration(desc, flood, under, backend="torch", device="cpu") == want
    assert tev.calibration(desc, flood, under) == jev.calibration(desc, flood, under)
    with pytest.raises(ValueError, match="backend"):
        tev.calibration(desc, flood, under, backend="jax")
