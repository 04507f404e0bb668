"""Flow tracing to the drainage network, and HAND (torch).

Counterpart of ``descriptools_tpu/ops/flow.py``.  Every cell walks its D8
path to the nearest absorbing cell: a river cell (its flat index is the
answer) or a NaN absorber (dead end, border exit, fdr 0), within
``max_steps``.  The walk is split like the downslope one:

- :func:`walk_inputs` builds ``fdr_eff`` (0 at absorbing cells) and
  ``code0`` (the absorber's code at absorbing cells: its flat index for a
  river, ``-idx-1`` for a NaN absorber; ``UNRES`` elsewhere);
- a walk engine returns ``(code, a, b)``: the absorber's code and the
  cardinal and diagonal step counts, or ``(UNRES, 0, 0)`` where no absorber
  is reached within ``max_steps`` (cycles, over-long paths).
  :func:`doubling_walk` is the plain engine; ``ops.cuda.walk.flow_walk``
  runs the jump walk (a bounded serial walk per CUDA thread, then pointer
  jumping over the cells still walking);
- :func:`flow_from_state` forms fdist and indices post-pass, from the
  integer counts, as ``walk_vmem.flow_pallas_vmem`` does.

The fold engines (``engine="torch_blocked"`` / ``"cuda_blocked"``) are the
counterpart of the JAX blocked tier ``walk.py::flow_pallas``: frontier
sweeps in which a cell takes its successor's code and distance when the
successor resolves, so fdist is the right fold ``stepd[c0] + (stepd[c1] +
(... + 0))`` of the f32 step lengths along the path, not a product of
counts.  The two orders differ in the last ulps on long paths.
:func:`fold_walk` is the plain engine; ``ops.cuda.walk.flow_walk_blocked``
forms the same fold as an anchored fold (the jump walk's depths, then
each cell's first steps folded onto an already final anchor, band by
band); :func:`flow_from_fold` finishes either.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import D8_STEP, FLOW_MAX_STEPS, NODATA
from descriptools_tpu_torch.d8 import pull8, successor

UNRES = -(1 << 31)  # unresolved-walk code (INT32_MIN)
_I32_IDX_LIMIT = 1 << 31


def flow_states(fdr, river, rows, cols):
    """Per-cell absorbing classification (flat tensors).

    A river cell whose fdr is 0 is a NaN absorber, not a river
    (the reference's truth table, flowhand.py:599-846)."""
    fdr_f = fdr.reshape(-1)
    river_f = river.reshape(-1)
    succ, step, in_bounds, valid = (t.reshape(-1) for t in successor(fdr, rows, cols))
    is_zero = fdr_f == 0
    is_river = (~is_zero) & (river_f == 1)
    absorb_nan = is_zero | ((~is_river) & (valid & ~in_bounds)) | ((~is_river) & ~valid)
    absorbing = absorb_nan | is_river
    return succ, step, absorbing, absorb_nan, is_river


def walk_inputs(fdr, river):
    """(fdr_eff int32, code0 int32) — the operands of every flow walk engine."""
    rows, cols = fdr.shape
    n = rows * cols
    if n >= _I32_IDX_LIMIT:
        raise ValueError(f"{n} cells overflow flat int32 indices")
    _, _, absorbing, _, is_river = flow_states(fdr, river, rows, cols)
    absorbing = absorbing.reshape(rows, cols)
    is_river = is_river.reshape(rows, cols)
    self_idx = torch.arange(n, dtype=torch.int32, device=fdr.device).reshape(rows, cols)
    code0 = torch.where(
        absorbing, torch.where(is_river, self_idx, -self_idx - 1), UNRES
    ).to(torch.int32)
    fdr_eff = torch.where(absorbing, 0, fdr.to(torch.int32))
    return fdr_eff, code0


def doubling_walk(fdr_eff, code0, max_steps):
    """Plain walk engine: successor doubling with integer step counts.

    After R rounds (2^R >= max_steps) every walk of at most ``max_steps``
    steps sits on its absorber, with exact counts."""
    rows, cols = fdr_eff.shape
    succ, step, _, _ = successor(fdr_eff, rows, cols)
    succ = succ.reshape(-1).long()
    step = step.reshape(-1)
    absorbing = code0.reshape(-1) != UNRES
    nxt = torch.where(absorbing, torch.arange(rows * cols, device=succ.device), succ)
    a = ((step == 1.0) & ~absorbing).to(torch.int32)
    b = ((step > 1.0) & ~absorbing).to(torch.int32)
    rounds = 0
    while (1 << rounds) < max_steps:
        rounds += 1
    for _ in range(rounds):
        a = a + a[nxt]
        b = b + b[nxt]
        nxt = nxt[nxt]
    ok = absorbing[nxt] & (a + b <= max_steps)
    code = torch.where(ok, code0.reshape(-1)[nxt], UNRES)
    a = torch.where(ok, a, 0)
    b = torch.where(ok, b, 0)
    return tuple(t.reshape(rows, cols) for t in (code, a, b))


def step_consts(px):
    """(cardinal, diagonal) step length in metres, f32(step) * f32(px), as
    Python floats that are exact f32 values."""
    return (float(np.float32(D8_STEP[0]) * np.float32(px)),
            float(np.float32(D8_STEP[1]) * np.float32(px)))


def dist_from_counts(a, b, px):
    """f32 path length of ``a`` cardinal and ``b`` diagonal steps: the one
    expression every count engine, in core or tiled, forms fdist with."""
    c_card, c_diag = step_consts(px)
    return a.to(torch.float32) * c_card + b.to(torch.float32) * c_diag


def flow_from_state(code, a, b, px, max_steps):
    """(fdist f32, indices int32) from a walk engine's (code, a, b)."""
    landed = (code >= 0) & (a + b <= max_steps)
    fdist = torch.where(landed, dist_from_counts(a, b, px), float(NODATA))
    indices = torch.where(landed, code, NODATA)
    return fdist, indices


def fold_walk(fdr_eff, code0, c_card, c_diag, max_steps):
    """Plain fold engine: (code int32, dist f32) after frontier sweeps.

    Sweep ``s`` (from 0, gated by ``s < max_steps``) resolves every UNRES
    cell whose successor is resolved: it takes the successor's code and
    ``stepd + dist[succ]``, ``stepd`` being ``c_card`` or ``c_diag`` by step
    kind (0 at absorbers, which never resolve anew).  A cell at depth ``d`` resolves at sweep ``d - 1``; the walk stops
    after a sweep that resolves nothing, or after ``max_steps`` sweeps.
    Cells that never resolve keep (UNRES, 0)."""
    diag = (fdr_eff == 2) | (fdr_eff == 8) | (fdr_eff == 32) | (fdr_eff == 128)
    stepd = torch.where(diag, c_diag, c_card).to(torch.float32)
    stepd = torch.where(fdr_eff == 0, 0.0, stepd)
    code = code0.clone()
    dist = torch.zeros(code0.shape, dtype=torch.float32, device=code0.device)
    for _ in range(max_steps):
        p_code, p_dist = pull8(fdr_eff, [code, dist], [-1, 0.0])
        hit = (code == UNRES) & (p_code != UNRES)
        if not bool(hit.any()):
            break
        dist = torch.where(hit, stepd + p_dist, dist)
        code = torch.where(hit, p_code, code)
    return code, dist


def flow_from_fold(code, dist):
    """(fdist f32, indices int32) from a fold engine's (code, dist)."""
    landed = code >= 0
    fdist = torch.where(landed, dist, float(NODATA))
    indices = torch.where(landed, code, NODATA)
    return fdist, indices


def flow_distance_index(fdr, river, px, max_steps=FLOW_MAX_STEPS, engine="torch"):
    """Flow distance + river-cell flat index for a whole grid.

    Returns (fdist float32, indices int32).  ``engine="torch"`` runs the
    plain count engine on any device, ``"cuda"`` the jump-walk kernels
    (``ops.cuda.walk.flow_cuda``); ``"torch_blocked"`` the plain fold
    engine, ``"cuda_blocked"`` the fold kernel
    (``ops.cuda.walk.flow_blocked_cuda``).  Indices are the same for all
    four; fdist of the fold engines is bitwise the JAX blocked tier's.
    """
    if engine == "cuda":
        from descriptools_tpu_torch.ops.cuda.walk import flow_cuda

        return flow_cuda(fdr, river, px, max_steps)
    if engine == "cuda_blocked":
        from descriptools_tpu_torch.ops.cuda.walk import flow_blocked_cuda

        return flow_blocked_cuda(fdr, river, px, max_steps)
    fdr_eff, code0 = walk_inputs(fdr, river)
    if engine == "torch_blocked":
        return flow_from_fold(*fold_walk(fdr_eff, code0, *step_consts(px), max_steps))
    code, a, b = doubling_walk(fdr_eff, code0, max_steps)
    return flow_from_state(code, a, b, px, max_steps)


def hand_calculator(dem, indices, nodata=NODATA):
    """HAND = clip(dem - dem.flat[indices], 0); NoData masked.

    Integer-exact when dem is integer: pass dem as an int dtype."""
    flat = dem.reshape(-1)
    idx = indices.reshape(-1)
    safe = torch.where(idx == nodata, 0, idx).long()
    hand = flat - flat[safe]
    hand = torch.where((flat != nodata) & (idx != nodata), hand, nodata)
    hand = torch.where((hand < 0) & (hand != nodata), 0, hand)
    return hand.reshape(dem.shape)


def hand_and_river_fac(dem, fac, indices, nodata=NODATA):
    """HAND and river-gathered fac from ONE gather of a (dem, fac) payload.

    As in the JAX version, dem and fac ride the gather as float32 (exact
    below 2^24) and HAND keeps the dem's dtype; the ``fac.flat[0]``
    fallback quirk for unresolved cells is kept."""
    flat_d = dem.reshape(-1)
    flat_f = fac.reshape(-1)
    idx = indices.reshape(-1)
    safe = torch.where(idx == nodata, 0, idx).long()
    packed = torch.stack([flat_d.to(torch.float32), flat_f.to(torch.float32)], dim=-1)[safe]
    dem_at = packed[:, 0].to(dem.dtype)
    fac_at = packed[:, 1]
    hand = flat_d - dem_at
    hand = torch.where((flat_d != nodata) & (idx != nodata), hand, nodata)
    hand = torch.where((hand < 0) & (hand != nodata), 0, hand)
    river_fac = torch.where(idx != nodata, fac_at, flat_f[0].to(torch.float32))
    return hand.reshape(dem.shape), river_fac.reshape(dem.shape)


def flow_hand_index(dem, fdr, river, px, max_steps=FLOW_MAX_STEPS, engine="auto"):
    """Flow distance, river indices and HAND of a whole grid: the
    reference's public ``flow_hand_index`` on tensors.

    ``engine`` as ``pipeline.resolve_engine`` takes it: ``"auto"`` runs
    the jump-walk kernel on CUDA tensors and the plain engine elsewhere.
    Pass dem as an integer dtype for integer-exact HAND."""
    from descriptools_tpu_torch.pipeline import resolve_engine

    engine = resolve_engine(engine, fdr.device)
    fdist, indices = flow_distance_index(fdr, river, px, max_steps=max_steps, engine=engine)
    return fdist, indices, hand_calculator(dem, indices)
