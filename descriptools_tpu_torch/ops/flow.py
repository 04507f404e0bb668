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

``flow_distance_index(method=...)`` runs the JAX package's own engines in
plain torch ops (no kernel): ``"doubling"`` (:func:`_flow_doubling`,
whole-grid successor doubling of f32 distances) and ``"hybrid"``
(:func:`_flow_hybrid` over :func:`resolve_absorbing_walk`: frontier pull
sweeps, then compacted doubling over the cells still walking).
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


def _f2i(x):
    """The bits of a float32 tensor as int32 (exact: f32 payloads ride the
    int32 packs of :func:`resolve_absorbing_walk`)."""
    return x.view(torch.int32)


def _i2f(x):
    """The bits of an int32 tensor as float32 (inverse of :func:`_f2i`)."""
    return x.view(torch.float32)


def _doubling_rounds(max_steps):
    k = 0
    while (1 << k) < max_steps:
        k += 1
    return k


def _flow_doubling(fdr, river, px, max_steps):
    """Plain whole-grid successor doubling of f32 distances (the JAX
    package's cross-check engine): ``_doubling_rounds(max_steps)`` rounds of
    ``(s[s], d + d[s], st + st[s])``."""
    rows, cols = fdr.shape
    succ, step, absorbing, _, is_river = flow_states(fdr, river, rows, cols)
    n = rows * cols
    self_idx = torch.arange(n, dtype=torch.int32, device=fdr.device)
    s = torch.where(absorbing, self_idx, succ).long()
    d = torch.where(absorbing, 0.0, step * float(np.float32(px)))
    st = torch.where(absorbing, 0, 1).to(torch.int32)
    for _ in range(_doubling_rounds(max_steps)):
        s, d, st = s[s], d + d[s], st + st[s]
    landed = is_river[s] & (st <= max_steps)
    fdist = torch.where(landed, d, float(NODATA))
    indices = torch.where(landed, s.to(torch.int32), NODATA)
    return fdist.reshape(rows, cols), indices.reshape(rows, cols)


def resolve_absorbing_walk(fdr, absorbing, stepd, succ, max_steps, cap, tag0=None):
    """Every cell walks its D8 path to the nearest absorbing cell: the JAX
    package's hybrid resolver, in its argument and output order.

    ``fdr`` (rows, cols); ``absorbing`` flat bool (the walks' endpoints);
    ``stepd`` flat f32 step cost (0 at absorbing cells); ``succ`` flat int32
    D8 successor (self where invalid); ``tag0`` optional flat f32 payload
    of the absorbing cells, carried to every cell that resolves there.
    Returns flat (resolved bool, dist f32, steps f32, absorber int32, tag
    f32).

    Phase 1: frontier sweeps (``d8.pull8``), unrolled 4 times with one
    count a body, while more than ``cap`` cells are unresolved, a body
    resolved some and fewer than ``max_steps`` sweeps ran.  Phase 2:
    successor doubling over the residue, compacted by a stable sort on the
    unresolved flag to its first ``cap`` cells, the state packed into int32
    rows with the f32 payloads as raw bits (:func:`_f2i`); a slot whose walk
    reached a resolved cell holds still with zero weight, and its own
    resolution is added once at the end."""
    rows, cols = fdr.shape
    n = rows * cols
    dev = fdr.device
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    absorbing2d = absorbing.reshape(rows, cols)
    stepd2d = stepd.reshape(rows, cols).to(torch.float32)
    if tag0 is None:
        tag0 = torch.zeros(n, dtype=torch.float32, device=dev)
    # Pulls do not cross absorbing cells: they keep their own values.
    fdr_eff = torch.where(absorbing2d, 0, fdr.to(torch.int32))
    resolved = absorbing2d
    tag = tag0.reshape(rows, cols).to(torch.float32)
    dist = stepd2d * 0.0
    steps = stepd2d * 0.0
    absorber = torch.where(resolved, self_idx.reshape(rows, cols), 0)

    unroll = 4  # sweeps a body, one count each
    count = int(resolved.sum())
    newly, t = 1, 0
    while n - count > cap and newly > 0 and t < max_steps:
        for _ in range(unroll):
            p_res, p_tag, p_d, p_s, p_a = pull8(
                fdr_eff, [resolved, tag, dist, steps, absorber], [False, 0.0, 0.0, 0.0, 0]
            )
            hit = (~resolved) & p_res
            dist = torch.where(hit, stepd2d + p_d, dist)
            steps = torch.where(hit, 1.0 + p_s, steps)
            absorber = torch.where(hit, p_a, absorber)
            tag = torch.where(hit, p_tag, tag)
            resolved = resolved | hit
        count_new = int(resolved.sum())
        newly, count, t = count_new - count, count_new, t + unroll

    resolved_f, tag_f, dist_f, steps_f, absorber_f = (
        a.reshape(-1) for a in (resolved, tag, dist, steps, absorber)
    )
    unresolved = ~resolved_f
    if not bool(unresolved.any()):
        return resolved_f, dist_f, steps_f, absorber_f, tag_f

    # ---- Phase 2: compacted doubling over the unresolved residue ----
    keys = torch.where(unresolved, 0, 1).to(torch.int32)
    order = torch.sort(keys, stable=True).indices
    sub = order[:cap]
    rank = torch.cumsum(unresolved.to(torch.int32), 0, dtype=torch.int32) - 1  # global -> sub slot
    g_succ = succ.reshape(-1)[sub].long()
    g_un = unresolved[sub]
    full_pack = torch.stack(
        [resolved_f.to(torch.int32), _f2i(dist_f), _f2i(steps_f), absorber_f.to(torch.int32), _f2i(tag_f)],
        dim=-1,
    )
    at_sub = full_pack[sub]
    at_succ = full_pack[g_succ]
    succ_resolved = at_succ[:, 0] > 0
    sub_step = torch.where(g_un, stepd.reshape(-1).to(torch.float32)[sub], 0.0)
    k = torch.arange(sub.shape[0], dtype=torch.int32, device=dev)
    absorbed0 = (~g_un) | succ_resolved
    r_dist = torch.where(g_un, sub_step + _i2f(at_succ[:, 1]), _i2f(at_sub[:, 1]))
    r_steps = torch.where(g_un, 1.0 + _i2f(at_succ[:, 2]), _i2f(at_sub[:, 2]))
    r_abs = torch.where(g_un, at_succ[:, 3], at_sub[:, 3])
    r_tag = torch.where(g_un, _i2f(at_succ[:, 4]), _i2f(at_sub[:, 4]))
    s_succ = torch.where(absorbed0, k, torch.clamp(rank[g_succ], 0, cap - 1))
    e_dist = torch.where(absorbed0, 0.0, sub_step)
    e_steps = torch.where(absorbed0, 0.0, 1.0)
    pack = torch.stack([s_succ, _f2i(e_dist), _f2i(e_steps)], dim=-1)
    for _ in range(_doubling_rounds(max_steps)):
        nxt = pack[pack[:, 0].long()]  # one packed gather a round
        pack = torch.stack(
            [nxt[:, 0], _f2i(_i2f(pack[:, 1]) + _i2f(nxt[:, 1])), _f2i(_i2f(pack[:, 2]) + _i2f(nxt[:, 2]))],
            dim=-1,
        )
        # Every live chain has reached an absorbed slot (cycles never do).
        if bool((absorbed0[pack[:, 0].long()] | ~g_un).all()):
            break
    final_slot = pack[:, 0].long()
    write = g_un & absorbed0[final_slot]
    r_at_final = torch.stack([_f2i(r_dist), _f2i(r_steps), r_abs, _f2i(r_tag)], dim=-1)[final_slot]
    # Copies: resolved and tag may still be the caller's absorbing and tag0.
    resolved_f, dist_f, steps_f, absorber_f, tag_f = (
        a.clone() for a in (resolved_f, dist_f, steps_f, absorber_f, tag_f)
    )
    dist_f[sub] = torch.where(write, _i2f(pack[:, 1]) + _i2f(r_at_final[:, 0]), _i2f(at_sub[:, 1]))
    steps_f[sub] = torch.where(write, _i2f(pack[:, 2]) + _i2f(r_at_final[:, 1]), _i2f(at_sub[:, 2]))
    absorber_f[sub] = torch.where(write, r_at_final[:, 2], at_sub[:, 3]).to(absorber_f.dtype)
    resolved_f[sub] = resolved_f[sub] | write
    tag_f[sub] = torch.where(write, _i2f(r_at_final[:, 3]), _i2f(at_sub[:, 4]))
    return resolved_f, dist_f, steps_f, absorber_f, tag_f


def _flow_hybrid(fdr, river, px, max_steps, cap):
    """The JAX package's default flow engine: :func:`resolve_absorbing_walk`
    from the absorbing classification, river cells tagged 1."""
    rows, cols = fdr.shape
    succ, step, absorbing, _, is_river = flow_states(fdr, river, rows, cols)
    stepd = torch.where(absorbing, 0.0, step * float(np.float32(px)))
    resolved, dist, steps, absorber, tag = resolve_absorbing_walk(
        fdr, absorbing, stepd, succ, max_steps, cap, tag0=is_river.to(torch.float32),
    )
    landed = resolved & (tag > 0) & (steps <= max_steps)
    fdist = torch.where(landed, dist, float(NODATA))
    indices = torch.where(landed, absorber, NODATA).to(torch.int32)
    return fdist.reshape(rows, cols), indices.reshape(rows, cols)


METHODS = ("doubling", "hybrid")


def flow_distance_index(fdr, river, px, max_steps=FLOW_MAX_STEPS, method=None, engine="torch"):
    """Flow distance + river-cell flat index for a whole grid.

    Returns (fdist float32, indices int32).  ``method=None`` dispatches by
    ``engine``: ``"torch"`` runs the plain count engine on any device,
    ``"cuda"`` the jump-walk kernels (``ops.cuda.walk.flow_cuda``);
    ``"torch_blocked"`` the plain fold engine, ``"cuda_blocked"`` the fold
    kernel (``ops.cuda.walk.flow_blocked_cuda``).  Indices are the same for
    all four; fdist of the fold engines is bitwise the JAX blocked tier's.

    ``method`` picks one of the JAX package's engines instead, in plain
    torch ops on any device: ``"doubling"`` or ``"hybrid"`` (JAX's default);
    with any engine but ``"torch"`` it raises ``ValueError``, since no kernel
    exists for it.
    """
    if method is not None:
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS} or None, got {method!r}")
        if engine != "torch":
            raise ValueError(f"method={method!r} has no kernel; run it with engine='torch', not {engine!r}")
        rows, cols = fdr.shape
        n = rows * cols
        if n >= _I32_IDX_LIMIT:
            raise ValueError(f"{n} cells overflow flat int32 indices")
        if method == "doubling":
            return _flow_doubling(fdr, river, px, max_steps)
        return _flow_hybrid(fdr, river, px, max_steps, min(n, max(1024, n // 8)))
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
