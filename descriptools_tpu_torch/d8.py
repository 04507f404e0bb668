"""Vectorised D8 flow-direction machinery (torch).

Counterpart of ``descriptools_tpu/d8.py``: the same select chains in the
same order, so every output is bitwise the JAX one.

Conventions: (row, col) tensors; ESRI codes 1=E 2=SE 4=S 8=SW 16=W 32=NW
64=N 128=NE; diagonal steps cost px*sqrt(2).
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import D8_CODES, D8_DX, D8_DY, D8_STEP


def decode(fdr):
    """Decode a D8 raster into (dy, dx, step_pixels, valid).

    Invalid codes (0 or anything not in the D8 set) give dy=dx=0, step=0,
    valid=False.
    """
    dev = fdr.device
    dy = torch.zeros(fdr.shape, dtype=torch.int32, device=dev)
    dx = torch.zeros(fdr.shape, dtype=torch.int32, device=dev)
    step = torch.zeros(fdr.shape, dtype=torch.float32, device=dev)
    valid = torch.zeros(fdr.shape, dtype=torch.bool, device=dev)
    for code, cdy, cdx, cs in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        hit = fdr == int(code)
        dy = torch.where(hit, int(cdy), dy)
        dx = torch.where(hit, int(cdx), dx)
        step = torch.where(hit, float(cs), step)
        valid = valid | hit
    return dy, dx, step, valid


def successor(fdr, rows, cols, row0=0, col0=0, grid_rows=None, grid_cols=None):
    """Per-cell D8 successor as flat local indices, plus step length & flags.

    Returns (succ, step_pixels, in_bounds, valid), all (rows, cols):
      - ``succ``: int32 flat index into the local (rows, cols) block of the
        D8 target; cells whose step is invalid or leaves the local block
        keep ``succ = self``;
      - ``step_pixels``: step length in pixels (0 where no step is taken:
        an invalid code, or a step off the *global* grid);
      - ``in_bounds``: True where the code decodes and its target lies
        inside the global grid;
      - ``valid``: True where the D8 code itself decodes.

    ``row0``/``col0`` (the block's origin in the global grid) and
    ``grid_rows``/``grid_cols`` (the global grid's shape, by default the
    block's) tell a global border exit apart from a step off the block that
    stays inside the global grid, as the JAX ``successor`` does.  With the
    defaults the block is the grid.
    """
    dev = fdr.device
    if grid_rows is None:
        grid_rows = rows
    if grid_cols is None:
        grid_cols = cols
    dy, dx, step, valid = decode(fdr)
    i = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(cols, dtype=torch.int32, device=dev)[None, :]
    ty = i + dy
    tx = j + dx
    gy = ty + int(row0)
    gx = tx + int(col0)
    in_global = (gy >= 0) & (gy < grid_rows) & (gx >= 0) & (gx < grid_cols)
    in_local = (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
    ok = valid & in_global & in_local
    succ = torch.where(ok, ty * cols + tx, i * cols + j).to(torch.int32)
    step = torch.where(valid & in_global, step, 0.0)
    return succ, step, valid & in_global, valid


def d8_flow_direction(dem, nodata=-100):
    """ESRI D8 flow-direction raster (int32) of a DEM, on the DEM's device.

    Steepest descent over the 8-neighbourhood; a gradient is the drop over
    the step length in pixels; ties go to the first direction in ESRI code
    order (E, SE, S, SW, W, NW, N, NE).  Pits, flats and NoData cells get
    code 0.  Each drop is divided by a 0-dim float32 tensor on the DEM's
    device, an IEEE division as in the JAX op: PyTorch's CUDA ``div`` by a
    Python scalar multiplies by the reciprocal, which can move a gradient
    by an ulp and change which neighbour wins a tie.
    """
    dem = dem.to(torch.float32)
    rows, cols = dem.shape
    pad = pad1(dem, float(np.float32(nodata)))
    best = torch.zeros(dem.shape, dtype=torch.float32, device=dem.device)
    code_out = torch.zeros(dem.shape, dtype=torch.int32, device=dem.device)
    for code, cdy, cdx, cs in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        nbr = pad[1 + cdy : 1 + cdy + rows, 1 + cdx : 1 + cdx + cols]
        grad = (dem - nbr) / torch.tensor(np.float32(cs), device=dem.device)
        ok = (nbr != nodata) & (grad > best)
        best = torch.where(ok, grad, best)
        code_out = torch.where(ok, int(code), code_out)
    return torch.where(dem == nodata, 0, code_out)


def pad1(arr, fill):
    """``arr`` with a 1-cell ring of ``fill`` around it (any dtype)."""
    rows, cols = arr.shape
    out = torch.full((rows + 2, cols + 2), fill, dtype=arr.dtype, device=arr.device)
    out[1:-1, 1:-1] = arr
    return out


def pull8(fdr, arrays, fills):
    """Per-cell pull of values from each cell's D8 successor, gather-free.

    ``pulled[c] = X[c + delta(fdr[c])]`` as eight shifted-tensor selects in
    D8_CODES order.  Cells with invalid/no direction keep their own value;
    ``fills`` is the value seen when the successor is off the grid.
    """
    rows, cols = fdr.shape
    outs = []
    for arr, fill in zip(arrays, fills):
        padded = pad1(arr, fill)
        acc = arr
        for code, dy, dx in zip(D8_CODES, D8_DY, D8_DX):
            nbr = padded[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
            acc = torch.where(fdr == int(code), nbr, acc)
        outs.append(acc)
    return outs
