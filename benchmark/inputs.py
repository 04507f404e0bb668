"""The general input generator: a traffic mix's parameters in, a pool of
input rasters on the device out, every one made from the seed.

A mix (``traffic/<mix>.json``) names its DEM generator and parameters
(``dem``), where fdr and fac come from (``terrain``: ``"derive"`` from
the DEM by the plain reference's D8 and accumulation, or
``"generator"`` from the generator itself), the river rule (``river``)
and, for a calibrating job, the flood map's rule (``flood``).  Pool input
``k`` is made from ``seed + k``.  The generator is the file of its name
under ``generators/``.
"""

import torch

from benchmark import found
from benchmark.reference import terrain

NODATA = terrain.NODATA


def flood_map(dem, quantile):
    """1 at the valid cells at or below the ``quantile`` of the valid
    elevations (numpy's linear interpolation), 0 at the other valid cells,
    NoData at NoData (int32)."""
    valid = dem != NODATA
    v = torch.sort(dem[valid].to(torch.float64)).values
    h = (v.numel() - 1) * quantile
    lo = int(h)
    q = v[lo] + (h - lo) * (v[min(lo + 1, v.numel() - 1)] - v[lo])
    return torch.where(valid, (dem <= q).to(torch.int32), NODATA)


def make_input(traffic, rows, cols, seed, device, root=found.ROOT):
    """One input of the mix as a dict of rasters on ``device``."""
    spec = dict(traffic["dem"])
    x = found.module("generators", spec.pop("generator"), root).make(rows, cols, seed, device, **spec)
    if traffic.get("terrain") == "derive":
        x["fdr"], x["fac"] = terrain.derive(x["dem"])
    if "river" in traffic and "fac" in x:
        x["river"] = ((x["fac"] > traffic["river"]["fac_above"]) & (x["dem"] != NODATA)).to(torch.int8)
    if "flood" in traffic:
        x["flood"] = flood_map(x["dem"], traffic["flood"]["quantile"])
    return x


def make_pool(traffic, rows, cols, seed, device, root=found.ROOT):
    """``traffic["pool"]`` inputs, input k from ``seed + k``."""
    return [make_input(traffic, rows, cols, seed + k, device, root) for k in range(traffic["pool"])]
