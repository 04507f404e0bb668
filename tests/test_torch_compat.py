"""The reference-compatible API over the port (``descriptools_tpu_torch
.compat``) against the JAX package's ``compat``: the reference example
script's flow (Example/example.py:18-147), stage by stage, through both.

Tolerances are those of tests/test_torch_pipeline.py: indices, HAND,
downslope and the class map bitwise; slope rtol 1e-6; fdist rtol 1e-6, atol
1e-4; TWI, mod-TWI, GFI and ln(hl/H) rtol 2e-5, atol 1e-4; the threshold,
Correctness and Fit identical.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu import compat as jcompat
from descriptools_tpu_torch import compat as tcompat
from descriptools_tpu_torch import evaluation
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.utils.synthetic import synthetic_basin

PX = 12.5
TRANSC = dict(rtol=2e-5, atol=1e-4)


def _script(compat, dem, fdr, river, fac, **dev):
    """The reference example, line for line (Example/example.py:59-147)."""
    sl = compat.sloper(dem, PX, **dev).astype("float32")
    out = dict(slope=sl)
    sl = np.arctan(sl / 100).astype("float32")
    sl = np.where(dem == -100, -100, sl)
    out["twi"], out["mod_twi"] = compat.topographic_index(fac, sl, PX, 0.1, **dev)
    out["downslope"] = compat.downsloper(dem, fdr, PX, 5, **dev)
    out["fdist"], out["indices"], out["hand"] = compat.flow_hand_index(dem, fdr, river, PX, **dev)
    out["gfi"] = compat.gfi_calculator(out["hand"], fac, out["indices"], 0.4, 0.1, PX, **dev)
    out["ln_hl_h"] = compat.ln_hl_H_calculator(out["hand"], fac, 0.4, 0.1, PX, **dev)
    out["river_fac"] = compat.river_accumulation(fac, out["indices"], **dev)
    out["hand_again"] = compat.hand_calculator(dem, out["indices"], **dev)
    hand = out["hand"]
    rng = np.random.default_rng(0)
    flood = ((hand != -100) & (hand <= 6) & (rng.uniform(size=hand.shape) < 0.9)).astype("int8")
    elements, _ = np.unique(hand, return_counts=True)
    mx, mn = elements[-1], elements[1]
    desc = compat.minMaxScale(hand, mn, mx, -100)
    th = compat.calibration(desc, flood, "under")
    binary = compat.binary_map(desc, th, "under")
    c, f, class_map = compat.avaliacao(binary, flood)
    out.update(desc=desc, binary=binary, class_map=class_map)
    return out, (th, c, f)


@pytest.mark.parametrize("shape,seed", [((60, 72), 41), ((47, 90), 3)])
def test_reference_script_flow_matches_jax(shape, seed):
    dem, fdr, river, fac = synthetic_basin(*shape, seed=seed)
    dem = dem.astype(np.int16)
    fac = fac.astype(np.int64)
    want, want_eval = _script(jcompat, dem, fdr, river, fac)
    got, got_eval = _script(tcompat, dem, fdr, river, fac, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    for k in ("indices", "hand", "hand_again", "downslope", "desc", "binary", "class_map"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=1e-6)
    np.testing.assert_allclose(got["fdist"], want["fdist"], rtol=1e-6, atol=1e-4)
    for k in ("twi", "mod_twi", "gfi", "ln_hl_h", "river_fac"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRANSC)
    assert got_eval == want_eval
    assert (got["indices"] != NODATA).any() and 0.0 < got_eval[2] <= 1.0


def test_divisor_matches_reference_formula():
    for args in ((2178, 1534, 2, 3), (100, 7, 0, 5), (9, 9, 8, 8)):
        for g, w in zip(tcompat.divisor(*args), jcompat.divisor(*args)):
            np.testing.assert_array_equal(g, w)
    br, bc = tcompat.divisor(2178, 1534, 2, 3)
    np.testing.assert_array_equal(br, [726, 1452])
    np.testing.assert_array_equal(bc, [383, 767, 1150])


def test_index_calculator():
    sub = np.array([[0, 3], [NODATA, 5]])
    out = tcompat.index_calculator(sub, 10, 20, 100)
    assert out[0, 0] == 1020 and out[0, 1] == 1121 and out[1, 0] == NODATA
    rng = np.random.default_rng(4)
    sub = np.where(rng.random((13, 17)) < 0.2, NODATA, rng.integers(0, 13 * 17, size=(13, 17)))
    np.testing.assert_array_equal(tcompat.index_calculator(sub, 40, 7, 300),
                                  jcompat.index_calculator(sub, 40, 7, 300))


def test_numpy_entry_points_refuse_cuda_without_a_card():
    """Asked for the card where there is none, every new numpy entry point
    raises; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

    dem, fdr, river, fac = synthetic_basin(12, 14, seed=1)
    idx = np.zeros(dem.shape, np.int32)
    calls = [
        lambda **d: tcompat.sloper(dem, PX, **d),
        lambda **d: tcompat.topographic_index(fac, dem.astype(np.float32), PX, 0.1, **d),
        lambda **d: tcompat.downsloper(dem, fdr, PX, 5, **d),
        lambda **d: tcompat.flow_hand_index(dem, fdr, river, PX, **d),
        lambda **d: tcompat.hand_calculator(dem, idx, **d),
        lambda **d: tcompat.river_accumulation(fac, idx, **d),
        lambda **d: tcompat.gfi_calculator(dem, fac, idx, 0.4, 0.1, PX, **d),
        lambda **d: tcompat.ln_hl_H_calculator(dem, fac, 0.4, 0.1, PX, **d),
        lambda **d: sharded_classify_flood(dem.astype(np.int32), river, **d),
        lambda **d: evaluation.calibration(dem.astype(np.float32), river, backend="torch", **d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
