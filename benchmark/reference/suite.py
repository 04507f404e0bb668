"""Plain descriptor suite: the rasters ``descriptor_suite`` returns, from
the benchmark's own inputs, by walking every cell's D8 path a step at a
time (descriptools' per-cell loops, run for all cells at once).

The spec is descriptools' (Example/example.py and the modules it calls):

- slope: ``max(0, max over the valid neighbours of (z - z_n) / dist) *
  100``, NoData -100; slope_rad ``atan(slope / 100)``;
- TWI ``ln(max(fac, 1) px^2 / tan(slope_rad + 0.01))``, modified TWI
  ``ln((max(fac, 1) px^2)^n_topo / tan(slope_rad + 0.01))``, NoData where
  fac is;
- downslope: walk until the elevation is at or below ``z - ed``, a
  terminal (no D8 code, a step off the grid or onto NoData) or
  ``max_steps`` steps; ``(z - z_stop) / dist``, 0 for a walk of no step;
- flow distance and river index: walk to the first river cell; a dead
  end, a step off the grid, a cell of code 0 or more than ``max_steps``
  steps give NoData; a river start gives 0 and its own index;
- HAND ``max(z - z_river, 0)``; GFI ``ln(b (fac_river px^2)^n / (HAND +
  0.01))``; ln(hl/H) ``ln(b (max(fac, 1) px^2)^n / (HAND + 0.01))``.

Path lengths are ``a c_card + b c_diag`` from the walk's cardinal and
diagonal step counts, ``c = f32(step) f32(px)``.  Every float is computed
in ``dtype``: float32, the precision the configurations state, or a lower
one for the control.
"""

import torch

from benchmark.reference.terrain import CODES, DX, DY, NODATA, STEP, neighbours, pad1

EPS = 0.01


def _scalar(x, dtype, device):
    return torch.tensor(x, dtype=dtype, device=device)


def step_tables(device):
    """Per code 0..255: (dy, dx, diagonal, is a D8 code)."""
    tdy = torch.zeros(256, dtype=torch.int64, device=device)
    tdx = torch.zeros(256, dtype=torch.int64, device=device)
    diag = torch.zeros(256, dtype=torch.bool, device=device)
    ok = torch.zeros(256, dtype=torch.bool, device=device)
    for k, (c, dy, dx) in enumerate(zip(CODES, DY, DX)):
        tdy[c], tdx[c], diag[c], ok[c] = dy, dx, k % 2 == 1, True
    return tdy, tdx, diag, ok


def _codes(fdr):
    f = fdr.reshape(-1).to(torch.int64)
    return torch.where((f >= 0) & (f < 256), f, 0)


def step_lengths(px, dtype, device):
    """(cardinal, diagonal) step in metres: f32(step) * f32(px), in dtype."""
    f32 = torch.float32
    c_card = _scalar(1.0, f32, device) * _scalar(px, f32, device)
    c_diag = _scalar(STEP[1], f32, device) * _scalar(px, f32, device)
    return c_card.to(dtype), c_diag.to(dtype)


def path_length(a, b, px, dtype):
    c_card, c_diag = step_lengths(px, dtype, a.device)
    return a.to(dtype) * c_card + b.to(dtype) * c_diag


def stencil(dem, fac, px, n_topo, dtype=torch.float32):
    """(slope, slope_rad, twi, mod_twi)."""
    z = dem.to(dtype)
    rows, cols = z.shape
    dev = z.device
    nd = _scalar(NODATA, dtype, dev)
    best = torch.zeros_like(z)
    for nbr, step in zip(neighbours(pad1(z, NODATA), rows, cols), STEP):
        grad = (z - nbr) / _scalar(px * step, torch.float32, dev).to(dtype)
        best = torch.where((nbr != nd) & (grad > best), grad, best)
    slope = torch.where(z == nd, nd, best * 100.0)
    slope_rad = torch.where(z == nd, nd, torch.atan(slope / _scalar(100.0, dtype, dev)))
    f = fac.to(dtype)
    area = torch.where(f == 0, _scalar(1.0, dtype, dev), f) * _scalar(px * px, torch.float32, dev).to(dtype)
    tan = torch.tan(slope_rad + _scalar(EPS, torch.float32, dev).to(dtype))
    twi = torch.where(f <= nd, nd, torch.log(area / tan))
    mod_twi = torch.where(f <= nd, nd, torch.log(torch.pow(area, _scalar(n_topo, torch.float32, dev).to(dtype)) / tan))
    return slope, slope_rad, twi, mod_twi


def downslope(dem, fdr, px, ed, max_steps, dtype=torch.float32):
    """(downslope raster, steps of each walk)."""
    rows, cols = dem.shape
    n = rows * cols
    dev = dem.device
    tdy, tdx, tdiag, tok = step_tables(dev)
    z = dem.to(dtype).reshape(-1)
    nd = _scalar(NODATA, dtype, dev)
    code = _codes(fdr)
    cell = torch.arange(n, device=dev)
    ty, tx = cell // cols + tdy[code], cell % cols + tdx[code]
    inside = tok[code] & (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
    succ = torch.where(inside, ty * cols + tx, cell)
    terminal = ~inside | (z[succ] == nd) | (z == nd)
    thresh = z - _scalar(ed, torch.float32, dev).to(dtype)
    pos = cell.clone()
    a = torch.zeros(n, dtype=torch.int32, device=dev)
    b = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.nonzero(z != nd).reshape(-1)
    for _ in range(max_steps):
        p = pos[active]
        go = (z[p] > thresh[active]) & ~terminal[p]
        active, p = active[go], p[go]
        if not active.numel():
            break
        d = tdiag[code[p]]
        a[active] += (~d).to(torch.int32)
        b[active] += d.to(torch.int32)
        pos[active] = succ[p]
    dist = path_length(a, b, px, dtype)
    walked = (a + b) > 0
    out = torch.where(walked, (z - z[pos]) / torch.where(walked, dist, 1), 0)
    out = torch.where(z == nd, nd, out)
    return out.reshape(rows, cols), (a + b).reshape(rows, cols)


def flow(fdr, river, px, max_steps, dtype=torch.float32):
    """(fdist, indices int32, steps of each landed walk)."""
    rows, cols = fdr.shape
    n = rows * cols
    dev = fdr.device
    tdy, tdx, tdiag, tok = step_tables(dev)
    code = _codes(fdr)
    is_river = river.reshape(-1) == 1
    idx = torch.full((n,), NODATA, dtype=torch.int64, device=dev)
    a = torch.zeros(n, dtype=torch.int32, device=dev)
    b = torch.zeros(n, dtype=torch.int32, device=dev)
    start = tok[code]
    cell = torch.arange(n, device=dev)
    idx[start & is_river] = cell[start & is_river]
    active = torch.nonzero(start & ~is_river).reshape(-1)
    pos = active.clone()
    for _ in range(max_steps):
        if not active.numel():
            break
        c = code[pos]
        y, x = pos // cols + tdy[c], pos % cols + tdx[c]
        go = tok[c] & (y >= 0) & (y < rows) & (x >= 0) & (x < cols)
        active, pos, c = active[go], (y * cols + x)[go], c[go]
        d = tdiag[c]
        a[active] += (~d).to(torch.int32)
        b[active] += d.to(torch.int32)
        alive = code[pos] != 0
        active, pos = active[alive], pos[alive]
        hit = is_river[pos]
        idx[active[hit]] = pos[hit]
        active, pos = active[~hit], pos[~hit]
    landed = idx != NODATA
    nd = _scalar(NODATA, dtype, dev)
    fdist = torch.where(landed, path_length(a, b, px, dtype), nd)
    steps = torch.where(landed, a + b, 0)
    return fdist.reshape(rows, cols), idx.to(torch.int32).reshape(rows, cols), steps.reshape(rows, cols)


def hand_and_river_fac(dem, fac, indices, dtype=torch.float32):
    """(HAND in dem's dtype, fac at each cell's river cell as dtype).  The
    river cell's elevation and fac are taken in ``dtype`` (exact in
    float32 below 2^24)."""
    flat = dem.reshape(-1)
    idx = indices.reshape(-1).to(torch.int64)
    ok = (flat != NODATA) & (idx != NODATA)
    safe = torch.where(idx == NODATA, 0, idx)
    at = flat.to(dtype)[safe].to(flat.dtype)
    hand = torch.where(ok, torch.clamp(flat - at, min=0), NODATA)
    f = fac.reshape(-1).to(dtype)
    river_fac = torch.where(idx != NODATA, f[safe], f[0])
    return hand.reshape(dem.shape), river_fac.reshape(dem.shape)


def _ln_ratio(area, hand, n_gfi, b_gfi, dtype):
    dev = area.device
    f32 = torch.float32
    h = hand.to(dtype)
    val = torch.log(_scalar(b_gfi, f32, dev).to(dtype) * torch.pow(area, _scalar(n_gfi, f32, dev).to(dtype))
                    / (h + _scalar(EPS, f32, dev).to(dtype)))
    return torch.where(h <= NODATA, _scalar(NODATA, dtype, dev), val)


def suite(dem, fdr, fac, river, cfg, dtype=torch.float32):
    """The suite's rasters as a dict, and the walks' step counts
    (``downslope_steps``, ``flow_steps``)."""
    dev = dem.device
    slope, slope_rad, twi, mod_twi = stencil(dem, fac, cfg["px"], cfg["n_topo"], dtype)
    down, down_steps = downslope(dem, fdr, cfg["px"], cfg["elevation_difference"],
                                 cfg["downslope_max_steps"], dtype)
    fdist, indices, flow_steps = flow(fdr, river, cfg["px"], cfg["flow_max_steps"], dtype)
    hand, river_fac = hand_and_river_fac(dem, fac, indices, dtype)
    px2 = _scalar(cfg["px"] * cfg["px"], torch.float32, dev).to(dtype)
    f = fac.to(dtype)
    local = torch.where(f == 0, _scalar(1.0, dtype, dev), f) * px2
    out = dict(
        slope=slope, slope_rad=slope_rad, twi=twi, mod_twi=mod_twi, downslope=down,
        fdist=fdist, indices=indices, hand=hand,
        gfi=_ln_ratio(river_fac * px2, hand, cfg["n_gfi"], cfg["b_gfi"], dtype),
        ln_hl_h=_ln_ratio(local, hand, cfg["n_gfi"], cfg["b_gfi"], dtype),
    )
    return out, dict(downslope_steps=down_steps, flow_steps=flow_steps)


def walk_stats(steps, dem, landed=None):
    """Mean and max steps of the walks over the valid (or landed) cells."""
    mask = (dem != NODATA) if landed is None else landed
    s = steps[mask].to(torch.float64)
    if not s.numel():
        return dict(mean=0.0, max=0)
    return dict(mean=float(s.mean()), max=int(s.max()))



def walk_summary(steps, dem, indices):
    """The walks' statistics of one input: flow steps over the landed
    cells, downslope steps over the valid ones."""
    return dict(flow_steps=walk_stats(steps["flow_steps"], dem, indices != NODATA),
                downslope_steps=walk_stats(steps["downslope_steps"], dem))
