"""A float32 DEM in metres, unrounded, as a 1 m LiDAR tile gives it, in
torch on the device."""

import torch

from benchmark.generators import NODATA, blob, box_sum, grid_ramp, rng


def _smooth(rows, cols, width, g, device):
    """Normal noise box-blurred twice along each axis (a ``width``-wide
    window), divided by the blur's norm (unit standard deviation away from
    the edges): a surface whose slope is continuous."""
    a = torch.randn(rows, cols, generator=g, dtype=torch.float64, device=device)
    for _ in range(2):
        a = box_sum(box_sum(a, width, 0), width, 1)
    return a / (width * (2 * width * width + 1) / 3)  # the 2-D kernel's norm: a triangle's energy per axis


def make(rows, cols, seed, device, hills=701, valleys=141, relief=30.0, valley_share=0.25,
         ramp=60.0, rough=0.01, rough_width=3):
    """float32 DEM: hills (a smooth surface of ``hills`` cells' scale and
    ``relief`` metres' standard deviation) with valleys (``valleys`` cells'
    scale, ``valley_share`` of the relief), a ramp of ``ramp`` metres
    (falling 1.5 ``ramp`` from one corner to the other), centimetre
    roughness (normal, ``rough`` metres, averaged over a ``rough_width``
    square as a surface interpolated from a point cloud is) above 300 m;
    NoData in a corner.  Returns {"dem"}."""
    g = rng(seed, device)
    z = relief * (_smooth(rows, cols, hills, g, device) + valley_share * _smooth(rows, cols, valleys, g, device))
    gy, gx, r = grid_ramp(rows, cols, device)
    noise = torch.randn(rows, cols, generator=g, dtype=torch.float64, device=device)
    if rough_width > 1:
        noise = box_sum(box_sum(noise, rough_width, 0), rough_width, 1) / rough_width
    z += ramp * r + rough * noise
    dem = torch.where(blob(gy, gx, rows, cols), float(NODATA), 300.0 + z)
    return dict(dem=dem.to(torch.float32))
