"""Slope descriptor — 8-neighbour max-downhill-gradient stencil (torch).

Counterpart of ``descriptools_tpu/ops/slope.py``: per cell
``max(0, max over valid neighbours of (z_c - z_n)/dist) * 100``, NoData ->
-100.  The divisor is ``f32(px * float(step))`` (a product in double, then
cast) and every division is tensor by tensor: PyTorch's CUDA ``div`` by a
Python scalar multiplies by the reciprocal instead, which is not bitwise.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import D8_DX, D8_DY, D8_STEP, NODATA
from descriptools_tpu_torch.d8 import pad1


def slope_divisors(px):
    """The 8 per-direction divisors, D8 order, as the JAX stencil forms them."""
    return [np.float32(px * float(step)) for step in D8_STEP]


def slope_from_padded(padded, px, nodata=NODATA):
    """Slope for the interior of a 1-ring-padded float32 DEM block."""
    rows = padded.shape[0] - 2
    cols = padded.shape[1] - 2
    dem = padded[1:-1, 1:-1]
    nd = float(nodata)
    best = torch.zeros((rows, cols), dtype=torch.float32, device=padded.device)
    for dy, dx, div in zip(D8_DY, D8_DX, slope_divisors(px)):
        nbr = padded[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
        grad = (dem - nbr) / torch.tensor(div, device=padded.device)
        best = torch.where((nbr != nd) & (grad > best), grad, best)
    return torch.where(dem == nd, nd, best * 100.0)


def slope(dem, px, nodata=NODATA):
    """Slope (%) of a whole DEM."""
    return slope_from_padded(pad1(dem.to(torch.float32), float(nodata)), px, nodata)
