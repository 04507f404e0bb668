"""``utils/synthetic.py``'s ``synthetic_dem``, in torch on the device."""

import torch

from benchmark.generators import NODATA, blob, box_sum, grid_ramp, rng


def make(rows, cols, seed, device, smooth=7, amp=80.0):
    """int32 DEM: normal noise blurred by a ``smooth``-wide box (mean) on
    each axis, plus a ramp, times ``amp``, above 400, rounded; NoData in a
    corner.  Returns {"dem"}."""
    noise = torch.randn(rows, cols, generator=rng(seed, device), dtype=torch.float64, device=device)
    noise = box_sum(box_sum(noise, smooth, 0), smooth, 1) / (smooth * smooth)
    gy, gx, ramp = grid_ramp(rows, cols, device)
    dem = torch.round(400.0 + amp * (noise + ramp))
    dem = torch.where(blob(gy, gx, rows, cols), float(NODATA), dem)
    return dict(dem=dem.to(torch.int32))
