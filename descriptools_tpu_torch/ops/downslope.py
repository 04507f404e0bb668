"""Downslope index — the walk to the first cell ``ed`` metres below (torch).

Counterpart of ``descriptools_tpu/ops/downslope.py``.  Each cell walks its
D8 path until the elevation there is at or below ``z - ed``, a terminal
(border exit, NoData target, dead end) or ``max_steps``; the result is
``(z - z_stop) / dist_stop`` in every branch.

The plain engine is split into three parts, so that each can be held to
its JAX counterpart:

- :func:`walk_inputs` builds the walk's operands: ``fdr_eff`` (0 at
  terminals, so terminals hold still), ``z``, and ``zt0`` (z with terminals
  offset by -2^20, so one compare ``Zt <= z0 - ed`` catches both stops);
- :func:`jacobi_walk` returns the stop state ``(pk, Zt)``: ``pk`` the
  cardinal and diagonal step counts packed in one int32 (bits 0-15 /
  16-31), ``Zt`` the offset-encoded elevation at the stop (synchronous pull
  sweeps, as the JAX ``_downslope_jacobi``);
- :func:`downslope_from_state` forms the ratio once, post-pass.

The CUDA kernel (``ops.cuda.walk.downslope_walk``) does all three in one
launch from dem and fdr, bitwise this composition (:func:`_downslope_jacobi`).

On a block cut from a larger grid (a tile or shard with a halo),
:func:`trunc_cells` marks the terminals that only the block's edge made,
and the walk engines given ``trunc0`` also return a flag per cell: its walk
stopped at such a terminal, so its result is not yet exact.
:func:`downslope_window` composes them for a tile's halo window, the
plain version of ``ops.cuda.walk.downslope_walk_tracked``.

``method="descent"`` is the JAX package's cross-check engine: a binary
descent over doubling tables (:func:`build_downslope_tables`,
:func:`_downslope_descent`), plain torch ops with no kernel.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import D8_STEP, DOWNSLOPE_MAX_STEPS, NODATA
from descriptools_tpu_torch.d8 import decode, pull8, successor

_INC_DIAG = 1 << 16
# Terminal offset of the Zt encoding: exact for integer-valued elevations
# (f32 ulp just below 2^20 is 1/16), and it rounds fractional ones to 1/16
# exactly as the JAX engines do.
_OFF = float(1 << 20)
_HALF = float(1 << 19)
_NEG_INF = float(np.float32(-3e38))  # the descent tables' key of a terminal


def step_inc_consts():
    """Per-direction packed increments in D8_CODES order."""
    return [1 if float(s) == 1.0 else _INC_DIAG for s in D8_STEP]


def unpack_dist(pk, px):
    """f32 path distance from packed counts — the one shared reconstruction
    (f32(step) * f32(px) per step kind, as the JAX engines)."""
    a = torch.bitwise_and(pk, (1 << 16) - 1).to(torch.float32)
    b = torch.bitwise_right_shift(pk, 16).to(torch.float32)  # pk >= 0 always
    c_card = float(np.float32(D8_STEP[0]) * np.float32(px))
    c_diag = float(np.float32(D8_STEP[1]) * np.float32(px))
    return a * c_card + b * c_diag


def check_max_steps(max_steps):
    """The packed counts hold at most 2^16 - 1 steps of each kind."""
    if not 0 <= max_steps < 1 << 16:
        raise ValueError(f"max_steps must be in [0, 65536), got {max_steps}")


def trunc_cells(dem, fdr, row0, col0, grid_rows, grid_cols, nodata=NODATA):
    """Cells whose D8 step leaves the local block while staying inside the
    global grid (bool).  A walk that stops at such a cell was cut by the
    block's edge, unlike a stop at a genuine terminal (global border exit,
    NoData target, dead end).  ``row0``/``col0``: global coordinates of the
    block's origin."""
    rows, cols = dem.shape
    z = dem.to(torch.float32)
    dy, dx, _, valid = decode(fdr)
    i = torch.arange(rows, dtype=torch.int32, device=dem.device)[:, None]
    j = torch.arange(cols, dtype=torch.int32, device=dem.device)[None, :]
    ty = i + dy
    tx = j + dx
    gy = ty + int(row0)
    gx = tx + int(col0)
    in_local = (ty >= 0) & (ty < rows) & (tx >= 0) & (tx < cols)
    in_global = (gy >= 0) & (gy < grid_rows) & (gx >= 0) & (gx < grid_cols)
    return valid & in_global & ~in_local & (z != float(nodata))


def _terminal_and_step(dem, fdr, px, nodata=NODATA):
    """Per-cell elevation, terminal flag and step length (2-D)."""
    rows, cols = dem.shape
    z = dem.to(torch.float32)
    succ, step, in_bounds, valid = successor(fdr, rows, cols)
    target_nodata = z.reshape(-1)[succ.reshape(-1).long()].reshape(rows, cols) == nodata
    terminal = (~valid) | (~in_bounds) | target_nodata | (z == nodata)
    stepd = torch.where(terminal, 0.0, step * float(np.float32(px)))
    return z, terminal, stepd


def walk_inputs(dem, fdr, px):
    """(fdr_eff int32, z f32, zt0 f32) — the operands of every walk engine."""
    z, terminal, _ = _terminal_and_step(dem, fdr, px)
    fdr_eff = torch.where(terminal, 0, fdr.to(torch.int32))
    zt0 = torch.where(terminal, z - _OFF, z)
    return fdr_eff, z, zt0


def jacobi_walk(fdr_eff, z, zt0, elevation_difference, max_steps, trunc0=None):
    """Plain walk engine: the shared t-step lookahead, one pull sweep per
    step, each cell's stop state frozen at its first hit.

    Returns (pk int32, Zt f32) at each cell's stop (or at the horizon for
    cells that reach ``max_steps``).  With ``trunc0`` (bool, see
    :func:`trunc_cells`) it also pulls that raster along the walk and
    returns a third, bool raster: the walk stopped at a terminal
    (``Zt < -2^19``) that ``trunc0`` marks.  A start that is itself such a
    terminal carries its own flag; a walk that reaches the cap is exact
    and is not flagged."""
    check_max_steps(max_steps)
    track = trunc0 is not None
    incs = step_inc_consts()
    inc = torch.zeros(fdr_eff.shape, dtype=torch.int32, device=fdr_eff.device)
    for code, c in zip((1, 2, 4, 8, 16, 32, 64, 128), incs):
        inc = torch.where(fdr_eff == code, c, inc)
    thresh = z - float(np.float32(elevation_difference))
    pk = torch.zeros_like(inc)
    zt = zt0
    stopped = zt0 <= thresh  # stop at k=0 when the start itself is terminal
    res_pk, res_zt = pk, zt0
    if track:
        tt = trunc0.to(torch.bool)
        res_t = tt & (zt0 < -_HALF)
    t = 0
    unroll = 8  # steps between the host-side convergence checks
    while t < max_steps and not bool(stopped.all()):
        for _ in range(min(unroll, max_steps - t)):
            if track:
                p_pk, p_zt, tt = pull8(fdr_eff, [pk, zt, tt], [0, 0.0, False])
            else:
                p_pk, p_zt = pull8(fdr_eff, [pk, zt], [0, 0.0])
            pk = inc + p_pk
            zt = p_zt
            hit = (~stopped) & (zt <= thresh)
            res_pk = torch.where(hit, pk, res_pk)
            res_zt = torch.where(hit, zt, res_zt)
            if track:
                res_t = torch.where(hit, tt & (zt < -_HALF), res_t)
            stopped = stopped | hit
        t += unroll
    # Cap: unstopped cells take the state at the lookahead horizon.
    out = torch.where(stopped, res_pk, pk), torch.where(stopped, res_zt, zt)
    return (*out, res_t & stopped) if track else out


def downslope_from_state(z, pk, zt, px):
    """Post-pass: ``(z - z_stop) / dist(pk)``, 0 for zero-length walks,
    -100 on NoData."""
    z_at = torch.where(zt < -_HALF, zt + _OFF, zt)
    out = torch.where(pk == 0, 0.0, (z - z_at) / unpack_dist(pk, px))
    return torch.where(z == NODATA, float(NODATA), out)


def _downslope_jacobi(dem, fdr, px, elevation_difference, max_steps, trunc0=None):
    """Downslope through the plain engine (bitwise the JAX jacobi engine).
    With ``trunc0``: (downslope, truncation flags), as :func:`jacobi_walk`."""
    fdr_eff, z, zt0 = walk_inputs(dem, fdr, px)
    if trunc0 is None:
        pk, zt = jacobi_walk(fdr_eff, z, zt0, elevation_difference, max_steps)
        return downslope_from_state(z, pk, zt, px)
    pk, zt, tr = jacobi_walk(fdr_eff, z, zt0, elevation_difference, max_steps, trunc0)
    return downslope_from_state(z, pk, zt, px), tr


def downslope_window(dem_f, fdr, px, elevation_difference, max_steps, row0, col0,
                     grid_rows, grid_cols, halo):
    """(downslope f32, truncation flags bool) of the interior of a window
    that holds a tile and a ring of ``halo`` cells around it: every start of
    the window walks, and the interior's results are returned.  ``row0``,
    ``col0``: the window's origin in the global grid (``grid_rows`` x
    ``grid_cols``)."""
    rows, cols = dem_f.shape
    tr0 = trunc_cells(dem_f, fdr, row0, col0, grid_rows, grid_cols)
    dn, tr = _downslope_jacobi(dem_f, fdr, px, elevation_difference, max_steps, trunc0=tr0)
    interior = (slice(halo, rows - halo), slice(halo, cols - halo))
    return dn[interior], tr[interior]


def _num_levels(max_steps):
    j = 0
    while (1 << (j + 1)) <= max_steps:
        j += 1
    return j + 1  # levels 0..j cover jumps up to 2^j <= max_steps


def build_downslope_tables(dem, fdr, px, nodata=NODATA, max_steps=DOWNSLOPE_MAX_STEPS):
    """Doubling tables for the binary descent, stacked (levels, n) over the
    flat grid: ``succs`` (int32, the cell 2^j steps on, terminals holding
    still), ``dists`` (float32, the path length of those steps, ``d +
    d[s]`` level by level) and ``minkeys`` (float32, the least key among
    them, a terminal's key -3e38)."""
    rows, cols = dem.shape
    z = dem.to(torch.float32).reshape(-1)
    succ, step, in_bounds, valid = (t.reshape(-1) for t in successor(fdr, rows, cols))
    target_nodata = z[succ.long()] == nodata
    terminal = (~valid) | (~in_bounds) | target_nodata | (z == nodata)
    self_idx = torch.arange(rows * cols, dtype=torch.int32, device=dem.device)
    key = torch.where(terminal, _NEG_INF, z)
    succ0 = torch.where(terminal, self_idx, succ)
    dist0 = torch.where(terminal, 0.0, step * float(np.float32(px)))
    minkey0 = key[succ0.long()]
    succs, dists, minkeys = [succ0], [dist0], [minkey0]
    for _ in range(_num_levels(max_steps) - 1):
        s, d, m = succs[-1], dists[-1], minkeys[-1]
        sl = s.long()
        succs.append(s[sl])
        dists.append(d + d[sl])
        minkeys.append(torch.minimum(m, m[sl]))
    return torch.stack(succs), torch.stack(dists), torch.stack(minkeys)


def _downslope_descent(dem, fdr, px, elevation_difference, max_steps):
    """Downslope by binary descent over :func:`build_downslope_tables`: from
    the top level down, jump 2^j steps while no cell among them is at or
    below ``z - ed`` (nor a terminal) and the cap allows, then take the one
    step onto the stop."""
    rows, cols = dem.shape
    z = dem.to(torch.float32).reshape(-1)
    succs, dists, minkeys = build_downslope_tables(dem, fdr, px, max_steps=max_steps)
    cur = torch.arange(rows * cols, device=dem.device)
    dist = torch.zeros(rows * cols, dtype=torch.float32, device=dem.device)
    steps = torch.zeros(rows * cols, dtype=torch.int32, device=dem.device)
    thresh = z - float(np.float32(elevation_difference))
    for j in range(succs.shape[0] - 1, -1, -1):
        can = (minkeys[j][cur] > thresh) & (steps + (1 << j) <= max_steps)
        dist = torch.where(can, dist + dists[j][cur], dist)
        steps = torch.where(can, steps + (1 << j), steps)
        cur = torch.where(can, succs[j][cur].long(), cur)
    take = (steps < max_steps) & (minkeys[0][cur] <= thresh)
    dist = torch.where(take, dist + dists[0][cur], dist)
    cur = torch.where(take, succs[0][cur].long(), cur)
    out = torch.where(dist == 0.0, 0.0, (z - z[cur]) / dist)
    out = torch.where(z == NODATA, float(NODATA), out)
    return out.reshape(rows, cols)


METHODS = ("jacobi", "descent")


def downslope(dem, fdr, px, elevation_difference,
              max_steps=DOWNSLOPE_MAX_STEPS, method="jacobi", engine="torch"):
    """Downslope index of a whole grid (float32).

    ``method`` picks the algorithm, as in JAX: ``"jacobi"`` the lookahead
    walk, ``"descent"`` the binary descent over doubling tables (a
    cross-check engine).  ``engine`` picks kernel or plain version:
    ``"torch"`` runs the plain engine on any device; ``"cuda"`` the
    downslope kernel (``ops.cuda.walk.downslope_cuda``), which is the
    jacobi walk: ``"descent"`` with ``"cuda"`` raises ``ValueError``, no
    kernel exists for it.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if engine == "cuda":
        if method != "jacobi":
            raise ValueError(f"method={method!r} has no CUDA kernel; run it with engine='torch'")
        from descriptools_tpu_torch.ops.cuda.walk import downslope_cuda

        return downslope_cuda(dem, fdr, px, elevation_difference, max_steps)
    if method == "descent":
        return _downslope_descent(dem, fdr, px, elevation_difference, max_steps)
    return _downslope_jacobi(dem, fdr, px, elevation_difference, max_steps)
