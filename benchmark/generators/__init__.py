"""The input generators, one file a generator (``generators/<name>.py``,
found by the name a mix's ``dem.generator`` gives), and the pieces they
share.  Each file has ``make(rows, cols, seed, device, **params)``, which
returns a dict of rasters on ``device`` made from ``seed`` with a
``torch.Generator`` there.

The generators are torch copies of the program's synthetic terrain
(``utils/synthetic.py``: ``synthetic_dem`` and ``windowed_basin``); they
need not be, and are not, bitwise the program's numpy ones.
"""

import torch

from benchmark.reference.terrain import NODATA  # noqa: F401


def rng(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def box_sum(a, width, dim):
    """Sum over a centred window of ``width`` (odd) along ``dim``, zero
    beyond the edges: numpy's ``convolve(..., mode="same")`` with ones."""
    half = width // 2
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim)] = pad[2 * (1 - dim) + 1] = half + 1
    c = torch.nn.functional.pad(a[None], pad)[0].cumsum(dim)
    n = a.shape[dim]
    return c.narrow(dim, width, n) - c.narrow(dim, 0, n)


def grid_ramp(rows, cols, device):
    gy = torch.arange(rows, dtype=torch.float64, device=device)
    gx = torch.arange(cols, dtype=torch.float64, device=device)
    return gy, gx, (1.0 - gy / (rows - 1))[:, None] + (0.5 * (1.0 - gx / (cols - 1)))[None, :]


def blob(gy, gx, rows, cols):
    """The NoData corner of both generators."""
    return (gy[:, None] + 1.3 * gx[None, :]) < 0.25 * (rows + cols)
