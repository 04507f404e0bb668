"""Synthetic terrain generators for tests and benchmarks (NumPy, host-side).

Produces DEM / D8 / river rasters with the reference's conventions (-100
NoData, ESRI D8 codes, code 0 at pits & NoData) so every walk-termination
branch — river absorption, dead ends, border exits, NoData targets — is
exercised.  Steepest-descent D8 over a smooth field is strictly downhill, so
generated flow graphs are acyclic by construction; cycle handling is tested
separately with hand-crafted rasters.
"""

import numpy as np

from descriptools_tpu_torch.constants import D8_CODES, D8_DX, D8_DY, D8_STEP, NODATA


def synthetic_dem(rows, cols, seed=0, nodata_border=True, smooth=7, amp=80.0):
    """Smooth random DEM (float32-valued integers-ish) with a NoData region.

    A blurred noise field plus a broad ramp (so paths have somewhere to go).
    If ``nodata_border``, an irregular NoData region covers one corner, like
    the bundled basin's masked surroundings.
    """
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=(rows, cols))
    # Separable box blur (avoid the scipy dependency in the hot test path).
    k = smooth
    kernel = np.ones(k) / k
    for axis in (0, 1):
        noise = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), axis, noise
        )
    ramp = np.linspace(1.0, 0.0, rows)[:, None] + np.linspace(0.5, 0.0, cols)[None, :]
    dem = 400.0 + amp * (noise + ramp)
    dem = np.round(dem).astype(np.float64)
    if nodata_border:
        yy, xx = np.mgrid[0:rows, 0:cols]
        blob = (yy + 1.3 * xx) < 0.25 * (rows + cols)
        dem[blob] = NODATA
    return dem


def d8_from_dem(dem, nodata=NODATA):
    """ESRI D8 by steepest descent; ties -> first code in ESRI order;
    pits/flats and NoData -> 0.  Mirrors descriptools_tpu.d8.d8_flow_direction."""
    dem = np.asarray(dem, dtype=np.float64)
    rows, cols = dem.shape
    pad = np.full((rows + 2, cols + 2), nodata, dtype=np.float64)
    pad[1:-1, 1:-1] = dem
    best = np.zeros((rows, cols))
    code = np.zeros((rows, cols), dtype=np.int32)
    for c, dy, dx, s in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
        nbr = pad[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
        grad = (dem - nbr) / float(s)
        ok = (nbr != nodata) & (grad > best)
        best = np.where(ok, grad, best)
        code = np.where(ok, int(c), code)
    return np.where(dem == nodata, 0, code).astype(np.uint8)


def d8_ties(rows, cols):
    """float32 DEM of 3 x 3 blocks, cropped to rows x cols, that ties D8's
    drops in every ESRI position.  Each block's centre is 0; block p (in
    row-major order, mod 9) gives its neighbours at ESRI positions p to 7 a
    drop of exactly 1 (a cardinal neighbour at -1, a diagonal one at
    -float32(sqrt 2)) and those before p a drop of 0.5, so the first of the
    equal drops, position p, wins; block 8 is flat (code 0)."""
    s = np.float32(D8_STEP[1])
    out = np.zeros((rows + 2, cols + 2), np.float32)
    blocks = ((rows + 2) // 3, (cols + 2) // 3)
    for b in range(blocks[0] * blocks[1]):
        y, x = 3 * (b // blocks[1]) + 1, 3 * (b % blocks[1]) + 1
        p = b % 9
        for k, (dy, dx) in enumerate(zip(D8_DY, D8_DX)):
            if p < 8:
                unit = s if k % 2 else np.float32(1)
                out[y + dy, x + dx] = -unit if k >= p else np.float32(-0.5) * unit
    return out[:rows, :cols]


def d8_division_pin():
    """3 x 3 float32 DEM whose centre's SE drop fl(d / sqrt 2) equals its S
    drop q, where d * fl(1 / sqrt 2) rounds below q: an IEEE division picks
    SE (code 2), a multiplication by the reciprocal S (code 4).  The other
    neighbours lie above the centre."""
    d = np.float32(1.1156934)
    q = d / np.float32(D8_STEP[1])
    assert d * (np.float32(1) / np.float32(D8_STEP[1])) < q
    dem = np.full((3, 3), 10, np.float32)
    dem[1, 1] = 0
    dem[2, 2] = -d
    dem[2, 1] = -q
    return dem


def _hash01(gy, gx, cols, salt):
    """Deterministic per-cell uniform in [0, 1): splitmix64 finalizer of the
    global flat index.  Pure elementwise — any window of any shape yields
    bitwise the same value for the same (gy, gx), which is what makes the
    windowed generator below self-consistent across out-of-core tiles."""
    u64 = np.uint64
    i = gy.astype(np.uint64)[:, None] * u64(cols) + gx.astype(np.uint64)[None, :]
    with np.errstate(over="ignore"):
        z = i * u64(0x9E3779B97F4A7C15) + u64(salt) * u64(0xD1B54A32D192ED03)
        z = (z ^ (z >> u64(30))) * u64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> u64(27))) * u64(0x94D049BB133111EB)
        z = z ^ (z >> u64(31))
    return (z >> u64(11)).astype(np.float64) * (1.0 / (1 << 53))


def windowed_basin(rows, cols, seed=0, smooth=7, amp=80.0, river_level=0.40):
    """Window-consistent synthetic basin for out-of-core runs: returns
    loaders {'dem','fdr','river','fac'}, each ``f(ys, ye, xs, xe) -> array``.

    Every window is bitwise-identical to the corresponding slice of the
    virtual global raster regardless of how it is windowed (the 1e9-cell
    north-star inputs can't be materialised per process; SURVEY §7 step 6).
    Construction mirrors ``synthetic_basin`` — smooth blurred noise + ramp,
    NoData corner blob, steepest-descent D8, low-elevation river set — but
    every primitive is local: hash noise per cell, ``smooth``-wide window
    mean via a fixed-order shifted-slice sum (cumsum would round differently
    per window origin), analytic ramp, and a fixed absolute river elevation
    (a quantile would be a global reduction).
    """
    half = smooth // 2
    scale = amp * 3.464 / (smooth * smooth)  # blurred-uniform std ~ 0.14*amp
    rthresh = np.float64(400.0 + amp * river_level)

    def _noise_padded(ys, ye, xs, xe, pad):
        """Raw noise on the padded window, zero outside the global grid
        (np.convolve 'same' zero-pad semantics at grid borders)."""
        ys0, ye0, xs0, xe0 = ys - pad, ye + pad, xs - pad, xe + pad
        out = np.zeros((ye0 - ys0, xe0 - xs0), np.float64)
        cy0, cy1 = max(ys0, 0), min(ye0, rows)
        cx0, cx1 = max(xs0, 0), min(xe0, cols)
        if cy1 > cy0 and cx1 > cx0:
            out[cy0 - ys0 : cy1 - ys0, cx0 - xs0 : cx1 - xs0] = (
                _hash01(np.arange(cy0, cy1), np.arange(cx0, cx1), cols, seed)
                - 0.5
            )
        return out

    def _win_sum(a, axis):
        """Width-``smooth`` sliding sum, fixed accumulation order."""
        n = a.shape[axis] - 2 * half
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n)
        acc = a[tuple(sl)].copy()
        for k in range(1, smooth):
            sl[axis] = slice(k, k + n)
            acc += a[tuple(sl)]
        return acc

    def dem(ys, ye, xs, xe):
        nb = _win_sum(_win_sum(_noise_padded(ys, ye, xs, xe, half), 0), 1)
        gy = np.arange(ys, ye, dtype=np.int64)
        gx = np.arange(xs, xe, dtype=np.int64)
        ramp = (1.0 - gy / (rows - 1))[:, None] + (
            0.5 * (1.0 - gx / (cols - 1))
        )[None, :]
        d = np.round(400.0 + scale * nb + amp * ramp)
        blob = (gy[:, None] + 1.3 * gx[None, :]) < 0.25 * (rows + cols)
        d[blob] = NODATA
        return d.astype(np.int32)

    def _dem_halo1(ys, ye, xs, xe):
        """dem on the window plus a 1-cell rim, NODATA beyond the grid."""
        out = np.full((ye - ys + 2, xe - xs + 2), NODATA, np.int32)
        cy0, cy1 = max(ys - 1, 0), min(ye + 1, rows)
        cx0, cx1 = max(xs - 1, 0), min(xe + 1, cols)
        out[cy0 - ys + 1 : cy1 - ys + 1, cx0 - xs + 1 : cx1 - xs + 1] = dem(
            cy0, cy1, cx0, cx1
        )
        return out

    def fdr(ys, ye, xs, xe):
        pad = _dem_halo1(ys, ye, xs, xe).astype(np.float64)
        d = pad[1:-1, 1:-1]
        best = np.zeros(d.shape)
        code = np.zeros(d.shape, np.int32)
        h, w = d.shape
        for c, dy, dx, s in zip(D8_CODES, D8_DY, D8_DX, D8_STEP):
            nbr = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            grad = (d - nbr) / float(s)
            ok = (nbr != NODATA) & (grad > best)
            best = np.where(ok, grad, best)
            code = np.where(ok, int(c), code)
        return np.where(d == NODATA, 0, code).astype(np.uint8)

    def river(ys, ye, xs, xe):
        d = dem(ys, ye, xs, xe)
        return ((d <= rthresh) & (d != NODATA)).astype(np.int8)

    def fac(ys, ye, xs, xe):
        d = dem(ys, ye, xs, xe)
        u = _hash01(
            np.arange(ys, ye), np.arange(xs, xe), cols, seed + 0x5EED
        )
        return np.where(
            d != NODATA, (u * 200000).astype(np.int32), np.int32(NODATA)
        )

    def flood(ys, ye, xs, xe):
        """Synthetic benchmark flood map: the low-elevation belt just above
        the river level (so calibration has a real optimum), NoData where
        the DEM is NoData — the reference benchmark's value set {NODATA,0,1}
        (Example/example.py:106, evaluation.py:149-150)."""
        d = dem(ys, ye, xs, xe)
        wet = (d <= rthresh + 0.125 * amp).astype(np.int32)
        return np.where(d == NODATA, np.int32(NODATA), wet)

    return dict(dem=dem, fdr=fdr, river=river, fac=fac, flood=flood)


def synthetic_basin(rows, cols, seed=0, river_quantile=0.15):
    """(dem, fdr, river, fac) for a synthetic basin.

    River cells = valid cells below the given elevation quantile (flow paths
    descend, so most cells drain into the river set).  fac is a crude proxy
    (elevation rank) — sufficient for the pointwise descriptors' formulas.
    """
    dem = synthetic_dem(rows, cols, seed=seed)
    fdr = d8_from_dem(dem)
    valid = dem != NODATA
    thresh = np.quantile(dem[valid], river_quantile)
    river = ((dem <= thresh) & valid).astype(np.int8)
    rng = np.random.default_rng(seed + 1)
    fac = np.where(valid, rng.integers(0, 200000, size=dem.shape), NODATA)
    return dem, fdr, river, fac


ADVERSARIAL_VALUES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, NODATA, 1e-7, -1e-7], np.float32)


def adversarial_dem(rng, shape, special=0.1):
    """A float32 DEM on the edges of the slope stencil's arithmetic: normal
    values at a scale of 1e-3 to 1e3 by row, ties (every third row rounded
    to integers), NaN, +-inf, +-0.0, -100 (NoData) and +-1e-7 in a share
    ``special`` of the cells and, on grids of 3x3 or more, a valid cell in
    the corner whose whole ring is NoData.  ``rng``: a numpy Generator."""
    scale = 10.0 ** rng.integers(-3, 4, size=(shape[0], 1))
    dem = (rng.standard_normal(shape) * scale).astype(np.float32)
    dem[::3] = np.round(dem[::3])
    mask = rng.random(shape) < special
    dem[mask] = rng.choice(ADVERSARIAL_VALUES, int(mask.sum()))
    if min(shape) >= 3:
        dem[:3, :3] = NODATA
        dem[1, 1] = 1.0
    return dem


def downslope_cases(rows=40, cols=56, seed=0):
    """Named ``(dem float32, fdr, ed, max_steps)`` on the edges of the
    downslope walk, on a fractional surface falling to the south-east with
    its steepest-descent D8:

    - ``nodata``: NoData starts (with their codes, or 0) and NoData targets;
    - ``border_exits``: integer elevations, codes that leave the grid on
      every edge and corner;
    - ``invalid_codes``: codes 0, 3 and 255 among the valid ones;
    - ``fdr_int16``, ``fdr_int64``: NoData, border exits and invalid codes,
      with 257 and -1 too, in a wider dtype;
    - ``terminal_holds_still``: eastward walks into terminals (a dead end,
      and the east border) more than 2^20 - ed above them: the JAX engines'
      -2^20 terminal offset does not stop them, so they hold still to the
      cap there; the port stops them at the terminal, as descriptools does;
    - ``fractional_terminal_stops``: eastward walks on fractional elevations
      that all stop at the east border's exits, whose elevation the JAX
      engines' -2^20 terminal offset rounds to 1/16 and the port reads
      exactly.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols]
    dem = (300.0 - 0.37 * yy - 0.21 * xx + rng.random((rows, cols)) * 2.3).astype(np.float32)
    fdr = d8_from_dem(dem)
    nodata = dem.copy()
    nodata[rng.random(dem.shape) < 0.06] = NODATA
    nodata[5:8, 10:14] = NODATA
    nodata_fdr = fdr.copy()
    nodata_fdr[5:8, 10:14] = 0
    exits = fdr.copy()
    exits[0, :] = rng.choice([32, 64, 128], cols)
    exits[-1, :] = rng.choice([2, 4, 8], cols)
    exits[:, 0] = rng.choice([8, 16, 32], rows)
    exits[:, -1] = rng.choice([1, 2, 128], rows)
    invalid = fdr.copy()
    hit = rng.random(dem.shape) < 0.08
    invalid[hit] = rng.choice([0, 3, 255], int(hit.sum()))
    wide = np.where(rng.random(dem.shape) < 0.08, invalid, exits).astype(np.int64)
    hit = rng.random(dem.shape) < 0.06
    wide[hit] = rng.choice([257, -1], int(hit.sum()))
    east = np.ones((rows, cols), np.uint8)
    still = (1000.0 - 0.01 * xx).astype(np.float32)
    still[::2, 20] = 1.2e6
    still[:, -1] = 1.2e6
    east_still = east.copy()
    east_still[::2, 20] = 0
    frac = (300.0 - 0.21 * xx + rng.random((rows, cols)) * 2.3).astype(np.float32)
    return {
        "nodata": (nodata, nodata_fdr, 5.0, 200),
        "border_exits": (np.round(dem), exits, 5.0, 200),
        "invalid_codes": (dem, invalid, 5.0, 200),
        "fdr_int16": (nodata, wide.astype(np.int16), 5.0, 200),
        "fdr_int64": (nodata, wide, 5.0, 200),
        "terminal_holds_still": (still, east_still, 5.0, 30),
        "fractional_terminal_stops": (frac, east, 50.0, 5000),
    }


def accumulation_cases():
    """Named ``(fdr int32, max_path)`` on the edges of the flow
    accumulation's rounds:

    - ``synthetic_17``, ``synthetic_5``: seeded DEMs' D8, NoData included;
    - ``line_<cap>``: a 300-step path east along a row and a shorter one
      beside it, truncated at ``max_path`` 2, 16, 100 and 256 (and not);
    - ``two_cycle``, ``two_cycle_wraps``: cells draining into a pair that
      point at each other, so the pair never reaches the sink and every
      round runs; the second at ``max_path`` 2^40 (40 rounds), whose
      lap-multiplied counts wrap int32;
    - ``ring``, ``ring_capped``: a 12-cell loop fed from inside and outside,
      at the default cap and at ``max_path`` 5;
    - ``all_sink``: every code 0, so no round runs and every count is 0;
    - ``row``, ``column``: 1 x N east and N x 1 south lines.
    """
    cases = {}
    for seed in (17, 5):
        dem = synthetic_dem(40, 52, seed=seed)
        dem[np.random.default_rng(seed).random(dem.shape) < 0.05] = NODATA
        cases[f"synthetic_{seed}"] = (d8_from_dem(dem).astype(np.int32), None)
    line = np.ones((2, 301), np.int32)
    line[:, -1] = 0
    line[1, :150] = 4  # south: off the grid, each cell its own terminal
    for cap in (None, 2, 16, 100, 256):
        cases[f"line_{cap}"] = (line, cap)
    two = np.zeros((6, 8), np.int32)
    two[:2, :] = 4  # south into row 2
    two[2, :3] = 1  # east into the pair
    two[2, 3], two[2, 4] = 1, 16  # the pair: east, then west
    two[2, 5:] = 16  # west into the pair
    cases["two_cycle"] = (two, None)
    cases["two_cycle_wraps"] = (two, 1 << 40)
    ring = np.full((6, 6), 4, np.int32)  # south: the top row feeds the loop
    ring[1, 1:4] = 1  # the loop: east along row 1,
    ring[1:4, 4] = 4  # south down column 4,
    ring[4, 2:5] = 16  # west along row 4,
    ring[2:5, 1] = 64  # north up column 1
    ring[2:4, 2:4] = 64  # the inside drains north into it
    ring[5, :] = 64  # the bottom row drains north into it
    ring[1:5, 0] = 1  # the west column drains east into it
    ring[1:5, 5] = 16  # the east column drains west into it
    cases["ring"] = (ring, None)
    cases["ring_capped"] = (ring, 5)
    cases["all_sink"] = (np.zeros((5, 7), np.int32), None)
    row = np.ones((1, 257), np.int32)
    row[0, -1] = 0
    cases["row"] = (row, None)
    cases["column"] = (np.full((257, 1), 4, np.int32), None)  # the last step leaves the grid
    return cases
