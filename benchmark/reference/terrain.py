"""Plain terrain derivation: D8 flow direction and flow accumulation.

Steepest descent over the 8-neighbourhood in the order E, SE, S, SW, W,
NW, N, NE (ESRI codes 1, 2, ..., 128), a drop over the step length in
pixels, the first of equal drops winning; pits, flats and NoData cells get
code 0.  Every drop is a float32 IEEE division (a division by a 0-dim
tensor: PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal instead).

Flow accumulation counts, for each cell, the cells whose D8 path passes
through it.  With ``C_j[x]`` the cells at a path distance 0 .. 2^j - 1
above x (x itself included) and ``S_j`` the 2^j-th successor,
``C_{j+1}[c] = C_j[c] + sum over S_j(x) = c of C_j[x]``: the cells at a
distance 2^j .. 2^{j+1} - 1 above c are those at a distance below 2^j
above the one x that lies 2^j steps above c on their path.  Integer adds,
exact in any order.
"""

import math

import torch

NODATA = -100
CODES = (1, 2, 4, 8, 16, 32, 64, 128)
DY = (0, 1, 1, 1, 0, -1, -1, -1)
DX = (1, 1, 0, -1, -1, -1, 0, 1)
STEP = (1.0, math.sqrt(2.0)) * 4  # pixels, cardinal and diagonal in turn


def pad1(a, fill):
    """``a`` with a one-cell ring of ``fill``."""
    out = torch.full((a.shape[0] + 2, a.shape[1] + 2), fill, dtype=a.dtype, device=a.device)
    out[1:-1, 1:-1] = a
    return out


def neighbours(padded, rows, cols):
    """The eight shifted views of a one-ring-padded raster, in code order."""
    return [padded[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols] for dy, dx in zip(DY, DX)]


def d8(dem, dtype=torch.float32):
    """int32 D8 codes of an integer or float DEM, the drops in ``dtype``."""
    z = dem.to(dtype)
    rows, cols = z.shape
    nd = torch.tensor(NODATA, dtype=dtype, device=z.device)
    best = torch.zeros_like(z)
    code = torch.zeros(z.shape, dtype=torch.int32, device=z.device)
    for c, nbr, step in zip(CODES, neighbours(pad1(z, NODATA), rows, cols), STEP):
        grad = (z - nbr) / torch.tensor(step, dtype=dtype, device=z.device)
        ok = (nbr != nd) & (grad > best)
        best = torch.where(ok, grad, best)
        code = torch.where(ok, c, code)
    return torch.where(z == nd, 0, code)


def successor(fdr):
    """Flat int64 successor of each cell, ``n`` (a sink) where the code is
    not a D8 code or its step leaves the grid."""
    rows, cols = fdr.shape
    n = rows * cols
    dev = fdr.device
    i = torch.arange(rows, device=dev)[:, None]
    j = torch.arange(cols, device=dev)[None, :]
    succ = torch.full((rows, cols), n, dtype=torch.int64, device=dev)
    for c, dy, dx in zip(CODES, DY, DX):
        ty, tx = i + dy, j + dx
        ok = (fdr == c) & (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
        succ = torch.where(ok, ty * cols + tx, succ)
    return succ.reshape(-1)


def accumulation(fdr, dem):
    """int32 count of the cells upstream of each cell; NoData where the
    DEM is NoData."""
    n = fdr.numel()
    s = torch.cat([successor(fdr), torch.tensor([n], device=fdr.device)])
    c = torch.ones(n + 1, dtype=torch.int64, device=fdr.device)
    c[n] = 0
    live = torch.nonzero(s[:n] != n).reshape(-1)
    for _ in range(max(1, n - 1).bit_length()):  # paths of at most n - 1 steps
        if not live.numel():
            break
        nxt = c.clone()
        nxt.index_add_(0, s[live], c[live])
        nxt[n] = 0
        c = nxt
        s = s[s]
        live = live[s[live] != n]
    fac = (c[:n] - 1).to(torch.int32).reshape(fdr.shape)
    return torch.where(dem == NODATA, NODATA, fac)


def derive(dem, dtype=torch.float32):
    """(fdr int32, fac int32) of a DEM."""
    fdr = d8(dem, dtype)
    return fdr, accumulation(fdr, dem)
