"""Geomorphic flood index (GFI), ln(hl/H), and the river-accumulation gather.

Counterpart of ``descriptools_tpu/ops/gfi.py``: pointwise maps plus one
gather of fac at each cell's drainage point.  The reference's quirk of
falling back to ``fac.flat[0]`` for unresolved cells is kept; those cells
are masked to -100 downstream because idx == -100 implies hand == -100.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import EPS, NODATA


def river_accumulation(fac, indices, nodata=NODATA):
    """fac gathered at each cell's river index (float32)."""
    flat = fac.reshape(-1).to(torch.float32)
    idx = indices.reshape(-1)
    safe = torch.where(idx == nodata, 0, idx).long()
    out = torch.where(idx != nodata, flat[safe], flat[0])
    return out.reshape(fac.shape)


def _ln_ratio(area, hand, exponent, scale_factor, nodata):
    """ln(b * area^n / (hand + 0.01)), NoData where hand <= -100."""
    hand = hand.to(torch.float32)
    val = torch.log(
        float(np.float32(scale_factor))
        * torch.pow(area, float(np.float32(exponent)))
        / (hand + float(np.float32(EPS)))
    )
    return torch.where(hand <= nodata, float(nodata), val)


def gfi(hand, river_fac, exponent, scale_factor, px, nodata=NODATA):
    """GFI = ln(b * (fac_river * px^2)^n / (hand + 0.01))."""
    area = river_fac.to(torch.float32) * float(np.float32(px * px))
    return _ln_ratio(area, hand, exponent, scale_factor, nodata)


def ln_hl_h(hand, fac, exponent, scale_factor, px, nodata=NODATA):
    """ln(hl/H) = ln(b * (max(fac,1) * px^2)^n / (hand + 0.01))."""
    fac = fac.to(torch.float32)
    area = torch.where(fac == 0, 1.0, fac) * float(np.float32(px * px))
    return _ln_ratio(area, hand, exponent, scale_factor, nodata)


def gfi_calculator(hand, fac, indices, exponent, scale_factor, px, nodata=NODATA):
    """The reference's public GFI entry: the river-fac gather, then GFI."""
    return gfi(hand, river_accumulation(fac, indices, nodata), exponent, scale_factor, px, nodata)
