"""Topographic indexes (TWI and modified TWI) — pointwise torch maps.

Counterpart of ``descriptools_tpu/ops/topo.py`` (epsilon inside tan(), the
reference GPU variant).  NoData: fac <= -100 -> -100.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import EPS, NODATA


def _area(fac, px):
    fac = fac.to(torch.float32)
    return fac, torch.where(fac == 0, 1.0, fac) * float(np.float32(px * px))


def topographic_index(fac, slope_rad, px, nodata=NODATA):
    """TWI = ln(max(fac,1) * px^2 / tan(slope_rad + 0.01))."""
    fac, area = _area(fac, px)
    twi = torch.log(area / torch.tan(slope_rad.to(torch.float32) + float(np.float32(EPS))))
    return torch.where(fac <= nodata, float(nodata), twi)


def modified_topographic_index(fac, slope_rad, px, exponent, nodata=NODATA):
    """Modified TWI = ln((max(fac,1) * px^2)^n / tan(slope_rad + 0.01))."""
    fac, area = _area(fac, px)
    tan = torch.tan(slope_rad.to(torch.float32) + float(np.float32(EPS)))
    mtwi = torch.log(torch.pow(area, float(np.float32(exponent))) / tan)
    return torch.where(fac <= nodata, float(nodata), mtwi)
