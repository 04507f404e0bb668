"""The comparison that decides ``correct``: the outputs of jobs the window
ran, against the plain reference run on the same inputs.

Every output the job kind's reference returns is compared, each against
the limit of its name in ``limits/<workload>.json``:

- a float raster: the worst cell's gap, ``|p - r| / max(|r|, m)`` with
  ``m`` the median of the reference's finite ``|r|``; a cell where one
  side is NaN or infinite and the other is not the same is a gap of
  ``MISMATCH``;
- an integer raster: the count of cells that differ;
- a number (the calibration's): ``|p - r|``.

The reference's type decides which.

Each number is the largest over the jobs compared.
"""

import torch

MISMATCH = 1e9


def float_gap(p, r):
    p = p.to(torch.float64)
    r = r.to(torch.float64)
    both = torch.isfinite(p) & torch.isfinite(r)
    special = ~both & ~((p == r) | (torch.isnan(p) & torch.isnan(r)))
    if bool(special.any()):
        return MISMATCH
    if not bool(both.any()):
        return 0.0
    mag = r[both].abs()
    floor = torch.clamp(torch.median(mag), min=torch.finfo(torch.float32).tiny)
    gap = (p[both] - r[both]).abs() / torch.maximum(mag, floor)
    return float(gap.max())


def compare(got, want):
    """{output: number} for every output of the reference ``want``."""
    numbers = {}
    for name, w in want.items():
        g = got.get(name)
        if g is None:
            numbers[name] = MISMATCH
        elif not isinstance(w, torch.Tensor):
            numbers[name] = abs(float(g) - float(w))
        elif not isinstance(g, torch.Tensor) or g.shape != w.shape:
            numbers[name] = MISMATCH
        elif w.is_floating_point():
            numbers[name] = float_gap(g.to(w.device), w)
        else:
            numbers[name] = int((g.to(w.device).to(torch.int64) != w.to(torch.int64)).sum())
    return numbers


def worst(per_job):
    """The largest of each number over the jobs compared."""
    out = {}
    for numbers in per_job:
        for k, v in numbers.items():
            out[k] = max(out.get(k, v), v)
    return out
