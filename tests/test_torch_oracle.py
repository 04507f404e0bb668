"""The port's copy of the descriptor oracles (``oracle/core.py``) against
the JAX package's original: every function bitwise on the same numpy
inputs, and the package's exports."""

import numpy as np
import pytest

from descriptools_tpu import oracle as joracle
from descriptools_tpu_torch import oracle as toracle
from descriptools_tpu_torch.utils.synthetic import downslope_cases, synthetic_basin

PX = 12.5


def _same(got, want):
    for g, w in zip(got, want) if isinstance(want, tuple) else ((got, want),):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_exports_match():
    assert toracle.__all__ == joracle.__all__


@pytest.mark.parametrize("shape,seed", [((40, 56), 3), ((33, 21), 8)])
def test_core_oracles_bitwise(shape, seed):
    dem, fdr, river, fac = synthetic_basin(*shape, seed=seed)
    dem_i = dem.astype(np.int16)
    both = lambda name, *a: _same(getattr(toracle, name)(*a), getattr(joracle, name)(*a))
    sl = joracle.slope_oracle(dem, PX)
    both("slope_oracle", dem, PX)
    sl_rad = np.where(dem == -100, -100, np.arctan(sl / 100))
    both("topographic_index_oracle", fac, sl_rad, PX)
    both("modified_topographic_index_oracle", fac, sl_rad, PX, 0.1)
    for ed, steps in ((5.0, 5000), (50.0, 7)):
        both("downslope_oracle", dem, fdr, PX, ed, steps)
        both("downslope_oracle_trunc", dem, fdr, PX, ed, steps)
    for steps in (20000, 3):
        both("flow_distance_index_oracle", fdr, river, PX, steps)
    _, idx = joracle.flow_distance_index_oracle(fdr, river, PX)
    both("hand_oracle", dem_i, idx)
    hand = joracle.hand_oracle(dem_i, idx)
    both("river_accumulation_oracle", fac, idx)
    rfac = joracle.river_accumulation_oracle(fac, idx)
    both("gfi_oracle", hand, rfac, 0.4, 0.1, PX)
    both("ln_hl_h_oracle", hand, fac, 0.4, 0.1, PX)


@pytest.mark.parametrize("name", sorted(downslope_cases()))
def test_downslope_oracles_on_adversarial_cases(name):
    dem, fdr, ed, steps = downslope_cases()[name]
    for fn in ("downslope_oracle", "downslope_oracle_trunc"):
        _same(getattr(toracle, fn)(dem, fdr, PX, ed, steps), getattr(joracle, fn)(dem, fdr, PX, ed, steps))
