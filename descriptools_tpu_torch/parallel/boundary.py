"""Boundary-graph reduction for D8 flow traced across block edges (torch).

Counterpart of ``descriptools_tpu/parallel/boundary.py``.  A grid cut into
blocks (tiles on one card, or shards) is traced in three phases:

  1. *Local phase* (per block): every cell walks to an absorbing cell of its
     block: a river cell, a NaN absorber (dead end, grid exit, fdr 0), or an
     EXIT cell whose step leaves the block.  Each cell's record is the
     absorber's role, the step counts, the exit target (global coordinates)
     and the river payloads (global flat index, elevation, fac).
  2. *Ring phase*: the perimeter cells of all blocks form a functional graph
     (a ring cell's walk absorbs, or exits into a perimeter cell of a
     neighbour block), solved by pointer jumping.
  3. *Combine* (per block): exit cells add their entry cell's solved record.

Departure from the JAX package: the records carry the cardinal (``a``) and
diagonal (``b``) step counts as int32 in place of an f32 distance, and
fdist is formed once, from the total counts, by ``ops.flow.dist_from_counts``
(the in-core expression), so the blocked fdist is bitwise the in-core one.
The ring phase doubles its accumulators ``ceil(log2 G) + 1`` times, so each
count is capped at ``max_steps + 1`` after every round, as the step count
is: a ring cycle cannot overflow them, and a path of at most ``max_steps``
steps keeps exact counts.

Status codes: 0=STEP (unresolved), 1=RIVER, 2=NAN, 3=EXIT.
"""

import numpy as np
import torch

from descriptools_tpu_torch.d8 import decode
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.flow import UNRES, dist_from_counts, doubling_walk

STEP, RIVER, NAN, EXIT = 0, 1, 2, 3


def _ceil_log2(n):
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def local_walk_operands(fdr, river, iy, ix, h, w, R, C):
    """The local walk's operands of block (iy, ix) and each cell's role.

    Returns (fdr_eff int32, code0 int32, role int32, dy, dx, step), all
    (h, w): ``fdr_eff`` is 0 at absorbing cells (RIVER, NAN and EXIT roles),
    ``code0`` the absorber's own local flat index there and UNRES
    elsewhere; dy, dx, step as ``d8.decode`` gives them."""
    dev = fdr.device
    dy, dx, step, valid = decode(fdr)
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    gy = iy * h + yy + dy
    gx = ix * w + xx + dx
    ty = yy + dy
    tx = xx + dx
    in_global = (gy >= 0) & (gy < R) & (gx >= 0) & (gx < C)
    in_local = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)

    is_zero = fdr == 0
    is_river = (~is_zero) & (river == 1)
    role = torch.where(
        is_river,
        RIVER,
        torch.where(
            is_zero | (~valid) | (valid & ~in_global),
            NAN,
            torch.where(~in_local, EXIT, STEP),
        ),
    ).to(torch.int32)
    absorbing = role != STEP
    self_idx = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w)
    fdr_eff = torch.where(absorbing, 0, fdr.to(torch.int32)).contiguous()
    code0 = torch.where(absorbing, self_idx, UNRES).to(torch.int32).contiguous()
    return fdr_eff, code0, role, dy, dx, step


def local_flow_summary(dem, fdr, river, fac, iy, ix, h, w, R, C,
                       max_steps=20000, engine="torch"):
    """Phase 1: resolve every cell of an (h, w) block locally.

    ``engine="cuda"`` runs the local walk in the absorbing-walk kernel
    (``ops.cuda.walk.absorbing_walk``), ``"torch"`` in successor doubling
    (``ops.flow.doubling_walk``); both give the same (code, a, b).  One
    payload gather at the absorber finishes the records.  Unlike the JAX
    function it takes no ``px``: distances are formed later, from the
    counts.

    Returns flat per-cell tensors: status, a, b (cardinal and diagonal step
    counts, the exit step included), tgy, tgx (exit target, global coords),
    ridx (river global flat index, int32), rz, rfac (payloads, f32).
    """
    fdr_eff, code0, role, dy, dx, step = local_walk_operands(fdr, river, iy, ix, h, w, R, C)
    if engine == "cuda":
        from descriptools_tpu_torch.ops.cuda.walk import absorbing_walk

        code, a, b = absorbing_walk(fdr_eff, code0, max_steps)
    else:
        code, a, b = doubling_walk(fdr_eff, code0, max_steps)
    z = dem.to(torch.float32)
    code, a, b = code.reshape(-1), a.reshape(-1), b.reshape(-1)
    resolved = code != UNRES
    final = torch.where(resolved, code, 0).long()

    # One packed payload gather at the absorbing cell: its exit step's kind
    # (exit cells), its D8 offsets (for the exit target), river payloads,
    # and the absorber's role (the walk's status).  Every field is exact in
    # f32 (small integers; dem and fac below 2^24).
    role_f = role.reshape(-1)
    exit_card = (role_f == EXIT) & (step.reshape(-1) == 1.0)
    exit_diag = (role_f == EXIT) & (step.reshape(-1) > 1.0)
    payload = torch.stack(
        [
            exit_card.to(torch.float32),
            exit_diag.to(torch.float32),
            dy.reshape(-1).to(torch.float32),
            dx.reshape(-1).to(torch.float32),
            z.reshape(-1),
            fac.reshape(-1).to(torch.float32),
            role_f.to(torch.float32),
        ],
        dim=-1,
    )[final]
    status = torch.where(resolved, payload[:, 6].to(torch.int32), NAN)
    is_exit = status == EXIT
    a = a + torch.where(is_exit, payload[:, 0].to(torch.int32), 0)
    b = b + torch.where(is_exit, payload[:, 1].to(torch.int32), 0)
    final = final.to(torch.int32)
    fy = final // w
    fx = final % w
    tgy = iy * h + fy + payload[:, 2].to(torch.int32)
    tgx = ix * w + fx + payload[:, 3].to(torch.int32)
    # Global flat river index in int32: exact for grids < 2^31 cells, which
    # callers assert (R * C < 2^31).
    ridx = (iy * h + fy) * C + (ix * w + fx)
    return dict(
        status=status, a=a, b=b, tgy=tgy, tgx=tgx,
        ridx=ridx, rz=payload[:, 4], rfac=payload[:, 5],
    )


def ring_indices(h, w):
    """Flat local indices of the block perimeter in canonical ring order:
    [top row | bottom row | left col | right col] (corners duplicated,
    records identical)."""
    top = np.arange(w)
    bottom = (h - 1) * w + np.arange(w)
    left = np.arange(h) * w
    right = np.arange(h) * w + (w - 1)
    return np.concatenate([top, bottom, left, right]).astype(np.int32)


def slot_of(gy, gx, h, w, nx, ring_len):
    """Global ring-table slot of a perimeter cell given its global coords.

    Mirrors ring_indices' canonical order, with row slots taking priority
    over column slots for corner cells.
    """
    sy = gy // h
    sx = gx // w
    ly = gy - sy * h
    lx = gx - sx * w
    slot_in = torch.where(
        ly == 0,
        lx,
        torch.where(ly == h - 1, w + lx, torch.where(lx == 0, 2 * w + ly, 2 * w + h + ly)),
    )
    return (sy * nx + sx) * ring_len + slot_in


def solve_ring(ring, h, w, nx, max_steps):
    """Phase 2: pointer-jump the gathered ring graph.

    ``ring`` holds flat tensors of length G = num_blocks * ring_len (keys of
    :func:`local_flow_summary`).  Returns solved per-entry fields (status,
    a, b, ridx, rz, rfac): the full downstream resolution of a walk
    *entering* at each ring cell.  Counts are capped at ``max_steps + 1``.
    """
    ring_len = 2 * (h + w)
    G = ring["status"].shape[0]
    is_exit = ring["status"] == EXIT
    self_idx = torch.arange(G, dtype=torch.int32, device=is_exit.device)
    tgt_slot = slot_of(ring["tgy"], ring["tgx"], h, w, nx, ring_len)
    tgt_slot = torch.clamp(tgt_slot, 0, G - 1)
    succ = torch.where(is_exit, tgt_slot, self_idx).long()
    cap = max_steps + 1
    acc_a = torch.where(is_exit, ring["a"], 0).to(torch.int32)
    acc_b = torch.where(is_exit, ring["b"], 0).to(torch.int32)
    for _ in range(_ceil_log2(max(G, 2)) + 1):
        acc_a = torch.clamp(acc_a + acc_a[succ], max=cap)
        acc_b = torch.clamp(acc_b + acc_b[succ], max=cap)
        succ = succ[succ]

    fb = succ
    stat = ring["status"][fb]
    return dict(
        status=torch.where(stat == EXIT, NAN, stat),
        a=torch.clamp(acc_a + ring["a"][fb], max=cap),
        b=torch.clamp(acc_b + ring["b"][fb], max=cap),
        ridx=ring["ridx"][fb],
        rz=ring["rz"][fb],
        rfac=ring["rfac"][fb],
    )


def combine(local, solved, h, w, nx, max_steps):
    """Phase 3: splice ring resolutions into each cell's local result.

    Returns flat tensors (landed, a, b, ridx, rz, rfac) for the block;
    fdist is ``ops.flow.dist_from_counts(a, b, px)`` where landed.
    """
    ring_len = 2 * (h + w)
    G = solved["status"].shape[0]
    is_exit = local["status"] == EXIT
    slot = slot_of(local["tgy"], local["tgx"], h, w, nx, ring_len)
    slot = torch.clamp(slot, 0, G - 1).long()

    status = torch.where(is_exit, solved["status"][slot], local["status"])
    a = local["a"] + torch.where(is_exit, solved["a"][slot], 0)
    b = local["b"] + torch.where(is_exit, solved["b"][slot], 0)
    ridx = torch.where(is_exit, solved["ridx"][slot], local["ridx"])
    rz = torch.where(is_exit, solved["rz"][slot], local["rz"])
    rfac = torch.where(is_exit, solved["rfac"][slot], local["rfac"])

    landed = (status == RIVER) & (a + b <= max_steps)
    return landed, a, b, ridx, rz, rfac


def flow_rasters(dem_t, landed, a, b, ridx, rz, rfac, fac0, px):
    """(fdist, indices, hand, river_fac) of a block from its combined records (``combine``).

    fdist is formed from the total step counts by the in-core expression,
    so it is bitwise the in-core fdist; HAND keeps the dem's dtype."""
    shape = dem_t.shape
    dem_flat = dem_t.reshape(-1)
    fdist = torch.where(landed, dist_from_counts(a, b, px), float(NODATA))
    indices = torch.where(landed, ridx, NODATA)
    hand = torch.where(
        (dem_flat != NODATA) & landed,
        torch.clamp(dem_flat - rz.to(dem_flat.dtype), min=0),
        NODATA,
    )
    river_fac = torch.where(landed, rfac, float(fac0))
    return tuple(t.reshape(shape) for t in (fdist, indices, hand, river_fac))
