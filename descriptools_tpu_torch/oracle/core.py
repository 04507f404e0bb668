"""NumPy oracles for the descriptor kernels (see package docstring)."""

import math

import numpy as np

from descriptools_tpu_torch.constants import (
    D8_CODES,
    D8_DX,
    D8_DY,
    D8_STEP,
    DOWNSLOPE_MAX_STEPS,
    EPS,
    FLOW_MAX_STEPS,
    NODATA,
    SQRT2,
)

# Map D8 code -> (dy, dx, step_in_pixels); invalid codes map to None.
_D8_LUT = {
    int(c): (int(dy), int(dx), float(s))
    for c, dy, dx, s in zip(D8_CODES, D8_DY, D8_DX, D8_STEP)
}


def slope_oracle(dem, px):
    """Max downhill gradient to the 8-neighbourhood, in percent.

    Spec: reference slope.py:8-49 (``slope_sequential_jit``).  Per cell:
    ``max(0, max over in-bounds non-NoData neighbours of (z_c - z_n)/dist)
    * 100``; NoData cells -> -100.  ``dist`` is ``px`` for cardinal, ``px *
    sqrt(2)`` for diagonal neighbours.
    """
    dem = np.asarray(dem, dtype=np.float64)
    rows, cols = dem.shape
    pad = np.full((rows + 2, cols + 2), NODATA, dtype=np.float64)
    pad[1:-1, 1:-1] = dem
    best = np.zeros_like(dem)
    for dy, dx, step in zip(D8_DY, D8_DX, D8_STEP):
        nbr = pad[1 + dy : 1 + dy + rows, 1 + dx : 1 + dx + cols]
        grad = (dem - nbr) / (px * float(step))
        valid = nbr != NODATA
        best = np.where(valid & (grad > best), grad, best)
    return np.where(dem == NODATA, float(NODATA), best * 100.0)


def topographic_index_oracle(fac, slope_rad, px):
    """TWI = ln(max(fac,1) * px^2 / tan(slope + 0.01)).

    Spec: reference topoindexes.py:233-261 (GPU variant; epsilon inside tan).
    NoData (fac <= -100) -> -100.  ``slope_rad`` must already be in radians
    (the caller converts percent via arctan(sl/100), Example/example.py:63).
    """
    fac = np.asarray(fac, dtype=np.float64)
    slope_rad = np.asarray(slope_rad, dtype=np.float64)
    area = np.where(fac == 0, 1.0, fac) * (px * px)
    with np.errstate(invalid="ignore", divide="ignore"):
        twi = np.log(area / np.tan(slope_rad + EPS))
    return np.where(fac <= NODATA, float(NODATA), twi)


def modified_topographic_index_oracle(fac, slope_rad, px, exponent):
    """Modified TWI = ln((max(fac,1)*px^2)^n / tan(slope + 0.01)).

    Spec: reference topoindexes.py:264-295.
    """
    fac = np.asarray(fac, dtype=np.float64)
    slope_rad = np.asarray(slope_rad, dtype=np.float64)
    area = np.where(fac == 0, 1.0, fac) * (px * px)
    with np.errstate(invalid="ignore", divide="ignore"):
        mtwi = np.log(np.power(area, exponent) / np.tan(slope_rad + EPS))
    return np.where(fac <= NODATA, float(NODATA), mtwi)


def downslope_oracle(dem, fdr, px, elevation_difference, max_steps=DOWNSLOPE_MAX_STEPS):
    """Downslope index: walk D8 until cumulative drop >= elevation_difference.

    Spec: reference downslope.py:160-314 (``downslope_sequential_jit``, which
    the public ``downsloper`` runs over the global matrix as the repair pass,
    downslope.py:373-374, making it the end-to-end semantics).

    The walk from cell c0 stops at the first position p_k satisfying any of:
      (a) z(p_k) <= z(c0) - elevation_difference     (threshold reached)
      (b) p_k is terminal: its D8 step is invalid    (border exit, NoData
          target, or dead-end fdr)
      (c) k == max_steps                             (cap, 5000)
    and the result is (z(c0) - z(p_k)) / dist_k in every case, with the
    degenerate dist_k == 0 giving 0.  NoData cells -> -100.

    Known divergence from the reference (documented): a *dead-end* start cell
    (valid dem, fdr not in the D8 set) yields NaN in the reference (0/0 after
    spinning to the cap) and 0 here; this cannot occur in real data where
    fdr==0 coincides with dem NoData.
    """
    dem = np.asarray(dem, dtype=np.float64)
    fdr = np.asarray(fdr)
    rows, cols = dem.shape
    out = np.zeros(dem.shape, dtype=np.float64)
    for i in range(rows):
        for j in range(cols):
            if dem[i, j] == NODATA:
                out[i, j] = NODATA
                continue
            y, x = i, j
            dist = 0.0
            for _ in range(max_steps):
                if dem[i, j] - dem[y, x] >= elevation_difference:
                    break
                step = _D8_LUT.get(int(fdr[y, x]))
                if step is None:
                    break  # dead-end fdr: terminal
                dy, dx, s = step
                ny, nx = y + dy, x + dx
                if not (0 <= ny < rows and 0 <= nx < cols):
                    break  # border exit: terminal
                if dem[ny, nx] == NODATA:
                    break  # NoData target: terminal
                y, x = ny, nx
                dist += px * s
            out[i, j] = 0.0 if dist == 0.0 else (dem[i, j] - dem[y, x]) / dist
    return out


def downslope_oracle_trunc(dem, fdr, px, elevation_difference,
                           max_steps=DOWNSLOPE_MAX_STEPS):
    """Vectorized twin of ``downslope_oracle`` returning ``(out, trunc)``.

    Identical per-cell semantics (same stop-condition order: threshold,
    dead-end fdr, border exit, NoData target; reference
    downslope.py:160-314), evaluated for all cells synchronously with
    active-set compaction so window-sized grids check in seconds.

    ``trunc[i, j]`` is True when the walk stopped by stepping off the ARRAY
    edge: on a full grid that is a genuine global-border terminal (result
    still exact — asserted bitwise vs downslope_oracle in tests), but on a
    windowed sub-grid the global walk would have continued, so windowed
    spot checks (scripts/config5_1e9.py) must skip trunc cells.
    """
    dem = np.asarray(dem, dtype=np.float64)
    fdr = np.asarray(fdr)
    rows, cols = dem.shape
    # Code -> (dy, dx, step) tables over the full uint8 range.
    tdy = np.zeros(256, np.int64)
    tdx = np.zeros(256, np.int64)
    ts = np.zeros(256, np.float64)
    tvalid = np.zeros(256, bool)
    for c, (dy, dx, s) in _D8_LUT.items():
        if 0 <= c < 256:
            tdy[c], tdx[c], ts[c], tvalid[c] = dy, dx, s, True
    code = np.where((fdr >= 0) & (fdr < 256), fdr, 0).astype(np.int64)

    valid = dem != NODATA
    n = rows * cols
    cy, cx = np.divmod(np.arange(n, dtype=np.int64), cols)
    dist = np.zeros(n, np.float64)
    z0 = dem.reshape(-1)
    trunc = np.zeros(n, bool)
    active = np.flatnonzero(valid.reshape(-1))

    for _ in range(max_steps):
        if active.size == 0:
            break
        y, x = cy[active], cx[active]
        zc = dem[y, x]
        go = z0[active] - zc < elevation_difference  # threshold not reached
        c = code[y, x]
        ok = go & tvalid[c]
        ny, nx = y + tdy[c], x + tdx[c]
        inside = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
        trunc[active[ok & ~inside]] = True
        move = ok & inside
        tgt_nd = np.zeros_like(move)
        tgt_nd[move] = dem[ny[move], nx[move]] == NODATA
        move &= ~tgt_nd
        mi = active[move]
        cy[mi] = ny[move]
        cx[mi] = nx[move]
        dist[mi] += px * ts[c[move]]
        active = mi

    zend = dem[cy, cx]
    out = np.where(dist == 0.0, 0.0, (z0 - zend) / np.where(dist == 0, 1, dist))
    out = np.where(valid.reshape(-1), out, float(NODATA))
    return out.reshape(rows, cols), trunc.reshape(rows, cols)


def flow_distance_index_oracle(fdr, river, px, max_steps=FLOW_MAX_STEPS):
    """Flow distance to nearest drainage + river-cell flat index.

    Spec: reference flowhand.py:565-846 (``flow_distance_index_gpu``) with
    zero divisions (out == [0,0,0,0]); this is the configuration that produced
    the committed golden output.  Per-cell walk along D8:

      - start cell with fdr <= 0 (or invalid)  -> (-100, -100)
      - start river cell                       -> (0, own flat index)
      - walk; arriving at a cell with fdr == 0 -> (-100, -100)
        else if it is river                    -> (dist, its flat index)
        else if its fdr points off-grid        -> (-100, -100)
      - paths longer than max_steps (20000), incl. cycles -> (-100, -100)

    Returns (fdist float64, indices int64).
    """
    fdr = np.asarray(fdr)
    river = np.asarray(river)
    rows, cols = fdr.shape
    fdist = np.zeros((rows, cols), dtype=np.float64)
    indices = np.zeros((rows, cols), dtype=np.int64)
    for i in range(rows):
        for j in range(cols):
            if int(fdr[i, j]) <= 0 or int(fdr[i, j]) not in _D8_LUT:
                fdist[i, j] = NODATA
                indices[i, j] = NODATA
                continue
            if river[i, j] == 1:
                fdist[i, j] = 0.0
                indices[i, j] = i * cols + j
                continue
            y, x = i, j
            dist = 0.0
            ok = False
            for step_count in range(1, max_steps + 1):
                step = _D8_LUT.get(int(fdr[y, x]))
                if step is None:
                    break  # dead-end (fdr==0 or invalid) -> nan
                dy, dx, s = step
                ny, nx = y + dy, x + dx
                if not (0 <= ny < rows and 0 <= nx < cols):
                    break  # border exit -> nan
                y, x = ny, nx
                dist += px * s
                if int(fdr[y, x]) == 0:
                    break  # arrived at dead-end -> nan (flowhand.py:826-828)
                if river[y, x] == 1:
                    ok = True
                    break
            if ok:
                fdist[i, j] = dist
                indices[i, j] = y * cols + x
            else:
                fdist[i, j] = NODATA
                indices[i, j] = NODATA
    return fdist, indices


def hand_oracle(dem, indices):
    """HAND = clip(dem - dem.flat[indices], 0) with NoData masking.

    Spec: reference flowhand.py:414-442 (``hand_calculator``).  Integer-exact
    when ``dem`` is integer.
    """
    dem = np.asarray(dem)
    indices = np.asarray(indices)
    flat = dem.reshape(-1)
    idx = indices.reshape(-1)
    safe = np.where(idx == NODATA, 0, idx)
    hand = flat - flat[safe]
    hand = np.where((flat != NODATA) & (idx != NODATA), hand, NODATA)
    hand = np.where((hand < 0) & (hand != NODATA), 0, hand)
    return hand.reshape(dem.shape)


def river_accumulation_oracle(fac, indices):
    """fac gathered at each cell's drainage point.

    Spec: reference gfi.py:118-147 — cells with idx == -100 fall back to
    ``fac.flat[0]`` (a quirk preserved for parity; in the bundled example
    fac.flat[0] is the NoData corner).
    """
    fac = np.asarray(fac)
    indices = np.asarray(indices)
    flat = fac.reshape(-1).astype(np.float64)
    idx = indices.reshape(-1)
    safe = np.where(idx == NODATA, 0, idx)
    out = np.where(idx != NODATA, flat[safe], flat[0])
    return out.reshape(fac.shape)


def gfi_oracle(hand, river_fac, exponent, scale_factor, px):
    """GFI = ln(b * (fac_river * px^2)^n / (hand + 0.01)).

    Spec: reference gfi.py:267-294 (GPU variant).  hand <= -100 -> -100.
    ``river_fac`` is the output of :func:`river_accumulation_oracle`.
    """
    hand = np.asarray(hand, dtype=np.float64)
    river_fac = np.asarray(river_fac, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        gfi = np.log(
            scale_factor * np.power(river_fac * (px * px), exponent) / (hand + EPS)
        )
    return np.where(hand <= NODATA, float(NODATA), gfi)


def ln_hl_h_oracle(hand, fac, exponent, scale_factor, px):
    """ln(hl/H) = ln(b * (max(fac,1) * px^2)^n / (hand + 0.01)).

    Spec: reference gfi.py:403-440 (GPU variant; local fac with the
    fac==0 -> 1 guard instead of the river-gathered fac).
    """
    hand = np.asarray(hand, dtype=np.float64)
    fac = np.asarray(fac, dtype=np.float64)
    area = np.where(fac == 0, 1.0, fac) * (px * px)
    with np.errstate(invalid="ignore", divide="ignore"):
        val = np.log(scale_factor * np.power(area, exponent) / (hand + EPS))
    return np.where(hand <= NODATA, float(NODATA), val)
