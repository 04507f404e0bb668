"""``utils/synthetic.py``'s ``windowed_basin``, in torch on the device."""

import torch

from benchmark.generators import NODATA, blob, box_sum, grid_ramp, rng
from benchmark.reference import terrain


def make(rows, cols, seed, device, smooth=7, amp=80.0, river_level=0.40):
    """The window-consistent basin's rasters for one whole grid: DEM
    (uniform noise summed over a ``smooth`` x ``smooth`` box, scaled, a
    ramp, rounded; the NoData corner), steepest-descent fdr (uint8), the
    river below a fixed elevation (int8) and a uniform random fac
    (int32).  Returns {"dem", "fdr", "fac", "river"}."""
    g = rng(seed, device)
    noise = torch.rand(rows, cols, generator=g, dtype=torch.float64, device=device) - 0.5
    nb = box_sum(box_sum(noise, smooth, 0), smooth, 1)
    gy, gx, ramp = grid_ramp(rows, cols, device)
    dem = torch.round(400.0 + amp * 3.464 / (smooth * smooth) * nb + amp * ramp)
    nodata = blob(gy, gx, rows, cols)
    dem = torch.where(nodata, float(NODATA), dem).to(torch.int32)
    valid = ~nodata
    river = ((dem <= 400.0 + amp * river_level) & valid).to(torch.int8)
    u = torch.rand(rows, cols, generator=g, dtype=torch.float64, device=device)
    fac = torch.where(valid, (u * 200000).to(torch.int32), NODATA)
    return dict(dem=dem, fdr=terrain.d8(dem).to(torch.uint8), fac=fac, river=river)
