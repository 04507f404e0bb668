"""The descriptor suite over a mesh of blocks (torch.distributed).

Counterpart of ``descriptools_tpu/parallel/sharded.py``, with its names and
arguments.  Each function takes numpy rasters of the *global* grid (padded
with NoData and cut into this rank's blocks) or ``ShardedRaster``s staged
by ``multihost.stage_padded``, runs every block of this rank on
``mesh.device``, and returns the cropped global raster on every rank
(``crop=True``: an all-gather, for small grids and checks) or the padded
``ShardedRaster`` (``crop=False``).

On a CUDA device the engine ``"auto"`` runs each block through the
hand-written kernels: the padded stencil (K1, ``stencil_padded``), the
absorbing walk (K5, ``absorbing_walk``, inside
``boundary.local_flow_summary``) and the tracked downslope walk (K6,
``downslope_walk_tracked``); ``"torch"`` runs their plain versions on any
device.  Integer outputs, downslope, slope and fdist are bitwise the port's
in-core suite for any mesh: fdist is formed once per block from integer
step counts carried through the ring, as on the tiled path.
"""

import numpy as np
import torch
import torch.distributed as dist

from descriptools_tpu_torch.constants import DOWNSLOPE_MAX_STEPS, FLOW_MAX_STEPS, NODATA
from descriptools_tpu_torch.ops.cuda import stencil as _st
from descriptools_tpu_torch.ops.cuda import walk as _walk
from descriptools_tpu_torch.ops.downslope import downslope_window
from descriptools_tpu_torch.ops.gfi import gfi as _gfi
from descriptools_tpu_torch.ops.gfi import ln_hl_h as _ln_hl_h
from descriptools_tpu_torch.parallel import boundary
from descriptools_tpu_torch.parallel.halo import halo_exchange
from descriptools_tpu_torch.parallel.mesh import (
    ShardedRaster,
    all_gather_blocks,
    all_reduce,
    crop_from_mesh,
    pad_to_mesh,
)
from descriptools_tpu_torch.pipeline import resolve_engine

_RING_KEYS = ("status", "a", "b", "tgy", "tgx", "ridx", "rz", "rfac")
_FLOAT_RING = ("rz", "rfac")  # carried as float32 bit views in the int32 record


def _check_mesh(raster, mesh):
    """A raster staged on another mesh raises: its block decomposition
    would silently disagree with the one ``mesh`` asks for."""
    if raster.mesh != mesh:
        raise ValueError(
            f"raster staged on mesh {raster.mesh} but the program targets mesh {mesh}; "
            "restage with multihost.stage_padded on the target mesh"
        )


def _staged(arr, mesh, fill, dtype=None):
    """A numpy raster padded and cut into this rank's blocks on
    ``mesh.device``; a ``ShardedRaster`` of this mesh passes through (cast
    to ``dtype``)."""
    if isinstance(arr, ShardedRaster):
        _check_mesh(arr, mesh)
        if dtype is None:
            return arr
        tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
        return arr.map(lambda t: t.to(tdt))
    a = np.asarray(arr)
    if dtype is not None:
        a = a.astype(dtype)
    a = pad_to_mesh(a, mesh, fill)
    ny, nx = mesh.shape
    R, C = a.shape
    h, w = R // ny, C // nx
    blocks = {}
    for b in mesh.blocks:
        iy, ix = mesh.coords(b)
        blk = np.ascontiguousarray(a[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w])
        blocks[b] = torch.from_numpy(blk).to(mesh.device)
    return ShardedRaster(mesh, (R, C), blocks)


def _resolve_shape(arr, mesh, shape):
    """Original (un-padded) raster shape.  Staged callers must pass it."""
    if shape is not None:
        return tuple(int(s) for s in shape)
    if isinstance(arr, ShardedRaster):
        _check_mesh(arr, mesh)
        raise ValueError("pass shape=(rows, cols) when inputs are staged")
    return np.asarray(arr).shape


def _fac0(fac, fac0):
    """``fac.flat[0]``, the reference's river_accumulation fallback
    (gfi.py:141-143); staged callers pass it."""
    if fac0 is not None:
        return float(fac0)
    if isinstance(fac, ShardedRaster):
        raise ValueError("pass fac0=fac[0, 0] when inputs are staged")
    return float(np.asarray(fac).reshape(-1)[0])


def _engine(engine, mesh):
    """``pipeline.resolve_engine`` for the mesh's device; the fold engines
    are refused: the sharded fdist is formed from step counts through the
    ring."""
    engine = resolve_engine(engine, mesh.device)
    if engine.endswith("_blocked"):
        raise ValueError(f"engine={engine!r}: the sharded path forms fdist from step counts "
                         "through the ring; use 'cuda', 'torch' or 'auto'")
    return engine


def _crop_indices(indices, shape, padded_cols):
    """Crop flat river indices computed in the padded grid, renumbering to
    the original column count (river cells never live in the padding)."""
    indices = crop_from_mesh(indices, shape)
    if padded_cols != shape[1]:
        indices = torch.where(
            indices == NODATA, NODATA,
            torch.div(indices, padded_cols, rounding_mode="floor") * shape[1] + indices % padded_cols,
        ).to(torch.int32)
    return indices


def _cropped(out, shape, stats=None):
    """{name: cropped global tensor} of a dict of ShardedRasters."""
    res = {}
    for k, v in out.items():
        full = v.gather(stats)
        res[k] = _crop_indices(full, shape, v.shape[1]) if k == "indices" else crop_from_mesh(full, shape)
    return res


def sharded_slope(dem, px, mesh, shape=None, crop=True, engine="auto", stats=None):
    """Slope: a 1-cell halo exchange, then per block the slope of the
    padded stencil (K1 on the card)."""
    shape = _resolve_shape(dem, mesh, shape)
    dem_s = _staged(dem, mesh, NODATA, np.float32)
    run = _st.stencil_padded if _engine(engine, mesh) == "cuda" else _st.stencil_padded_plain
    ext = halo_exchange(dem_s, 1, NODATA, stats)
    h, w = dem_s.block_shape
    fac = torch.zeros((h, w), dtype=torch.int32, device=mesh.device)  # slope reads no fac
    out = ShardedRaster(mesh, dem_s.shape, {b: run(ext[b], fac, px, 0.1)[0] for b in mesh.blocks})
    return _cropped({"slope": out}, shape, stats)["slope"] if crop else out


def _ring_record(loc, sel):
    """A block's ring records as one int32 (8, ring_len) tensor; rz and
    rfac ride as float32 bit views."""
    rows = [loc[k][sel].view(torch.int32) if k in _FLOAT_RING else loc[k][sel].to(torch.int32)
            for k in _RING_KEYS]
    return torch.stack(rows)


def sharded_flow_hand(dem, fdr, river, fac, px, mesh, max_steps=FLOW_MAX_STEPS, shape=None,
                      fac0=None, crop=True, engine="auto", stats=None):
    """Flow distance, river indices, HAND and river-fac through the
    boundary-graph reduction (``parallel.boundary``).

    Per block, the local walk (K5 on the card) resolves every cell to its
    block's absorbers; the ring records of all blocks are all-gathered in
    block-id order (one int32 tensor a block), the ring is solved on every
    rank, and each block splices the solution into its cells.  ``fac``
    rides along as the river payload, so GFI needs no global gather.  dem
    should be integer for bitwise HAND.  Staged callers pass ``shape`` and
    ``fac0`` (``fac.flat[0]``, the reference's river_accumulation
    fallback, gfi.py:141-143)."""
    engine = _engine(engine, mesh)
    shape = _resolve_shape(dem, mesh, shape)
    dem_s = _staged(dem, mesh, NODATA)
    fdr_s = _staged(fdr, mesh, 0)
    river_s = _staged(river, mesh, 0)
    fac_s = _staged(fac, mesh, NODATA)
    R, C = dem_s.shape
    if R * C >= 1 << 31:
        raise ValueError(f"padded grid {R}x{C} overflows int32 flat river indices")
    nx = mesh.shape[1]
    h, w = dem_s.block_shape
    fac0 = _fac0(fac, fac0)
    sel = torch.from_numpy(boundary.ring_indices(h, w)).long().to(mesh.device)

    locals_ = {}
    for blk in mesh.blocks:
        iy, ix = mesh.coords(blk)
        locals_[blk] = boundary.local_flow_summary(
            dem_s.blocks[blk], fdr_s.blocks[blk], river_s.blocks[blk], fac_s.blocks[blk],
            iy, ix, h, w, R, C, max_steps=max_steps, engine=engine,
        )
    records = all_gather_blocks(mesh, [_ring_record(locals_[b], sel) for b in mesh.blocks], stats)
    ring = torch.cat(records, dim=1)
    ring = {k: ring[i].view(torch.float32) if k in _FLOAT_RING else ring[i]
            for i, k in enumerate(_RING_KEYS)}
    solved = boundary.solve_ring(ring, h, w, nx, max_steps)

    outs = {k: {} for k in ("fdist", "indices", "hand", "river_fac")}
    for blk in mesh.blocks:
        landed, a, b, ridx, rz, rfac = boundary.combine(locals_[blk], solved, h, w, nx, max_steps)
        rasters = boundary.flow_rasters(dem_s.blocks[blk], landed, a, b, ridx, rz, rfac, fac0, px)
        for k, t in zip(outs, rasters):
            outs[k][blk] = t
    out = {k: ShardedRaster(mesh, (R, C), v) for k, v in outs.items()}
    if not crop:
        return tuple(out.values())
    return tuple(_cropped(out, shape, stats).values())


def sharded_downslope(dem, fdr, px, elevation_difference, mesh, halo=64,
                      max_steps=DOWNSLOPE_MAX_STEPS, exact=True, shape=None, crop=True,
                      engine="auto", stats=None):
    """Downslope index over the mesh, EXACT (bitwise the in-core suite).

    Each block walks on its halo-extended window (K6 on the card), which
    flags every cell whose walk stopped at the window's edge while still
    inside the global grid.  If any cell of any block is flagged (one
    all-reduce MAX, so every rank takes the same branch), the halo doubles
    (a multi-block exchange past one block) and the solve reruns; walks are
    bounded by ``max_steps`` and by the grid, so the loop ends.  The
    window's origin is in the PADDED grid, as in JAX.  ``exact=False``
    keeps the single fixed-halo pass.  ``stats["downslope_attempts"]``
    lists each attempt's halo and engine; ``stats["downslope_retries"]``
    counts the retries."""
    eng = _engine(engine, mesh)
    shape = _resolve_shape(dem, mesh, shape)
    dem_s = _staged(dem, mesh, NODATA, np.float32)
    fdr_s = _staged(fdr, mesh, 0)
    R, C = dem_s.shape
    h, w = dem_s.block_shape
    halo = int(min(halo, max(R, C), max_steps + 1))
    run = _walk.downslope_walk_tracked if eng == "cuda" else downslope_window
    attempts = stats.setdefault("downslope_attempts", []) if stats is not None else []
    while True:
        attempts.append(dict(halo=halo, engine=eng))
        dem_ext = halo_exchange(dem_s, halo, NODATA, stats)
        fdr_ext = halo_exchange(fdr_s, halo, 0, stats)
        out, flag = {}, torch.zeros((), dtype=torch.int32, device=mesh.device)
        for blk in mesh.blocks:
            iy, ix = mesh.coords(blk)
            out[blk], tr = run(dem_ext[blk], fdr_ext[blk], px, elevation_difference, max_steps,
                               iy * h - halo, ix * w - halo, R, C, halo)
            flag = torch.maximum(flag, tr.any().to(torch.int32))
        del dem_ext, fdr_ext
        if not exact or halo >= max(R, C):
            break
        if not bool(all_reduce(mesh, flag, dist.ReduceOp.MAX, stats)):
            break
        halo = min(2 * halo, max(R, C), max_steps + 1)
    if stats is not None:
        stats["downslope_retries"] = len(attempts) - 1
    res = ShardedRaster(mesh, (R, C), out)
    return _cropped({"downslope": res}, shape, stats)["downslope"] if crop else res


def sharded_suite(dem, fdr, fac, river, cfg, mesh, downslope_halo=64, shape=None, fac0=None,
                  crop=True, stage_hook=None, stats=None):
    """Full descriptor suite over the mesh (slope, slope_rad, TWI, mod-TWI,
    downslope, fdist, indices, HAND, river_fac, GFI, ln(hl/H)); mirrors
    ``pipeline.descriptor_suite``.

    ``stage_hook(name, compute)`` intercepts each stage ('flow',
    'downslope', 'pointwise'; ``compute()`` -> dict of padded
    ShardedRasters): ``parallel.ckpt.stage_hook`` uses it for shard-aware
    checkpoint and resume.  The pointwise stage is one 1-cell halo
    exchange, the padded stencil (K1 on the card: slope, slope_rad, TWI,
    mod-TWI) and the GFI and ln(hl/H) maps per block.  Stages compute on
    the padded grid; ``crop`` crops once at the end."""
    shape = _resolve_shape(dem, mesh, shape)
    engine = _engine(cfg.engine, mesh)
    dem_s = _staged(dem, mesh, NODATA)
    fdr_s = _staged(fdr, mesh, 0)
    river_s = _staged(river, mesh, 0)
    fac_s = _staged(fac, mesh, NODATA)
    fac0 = _fac0(fac, fac0)
    hook = stage_hook if stage_hook is not None else (lambda _n, f: f())

    out = dict(hook("flow", lambda: dict(zip(
        ("fdist", "indices", "hand", "river_fac"),
        sharded_flow_hand(dem_s, fdr_s, river_s, fac_s, cfg.px, mesh,
                          max_steps=cfg.flow_max_steps, shape=shape, fac0=fac0,
                          crop=False, engine=engine, stats=stats),
    ))))
    out.update(hook("downslope", lambda: {
        "downslope": sharded_downslope(
            dem_s, fdr_s, cfg.px, cfg.elevation_difference, mesh,
            halo=downslope_halo, max_steps=cfg.downslope_max_steps,
            shape=shape, crop=False, engine=engine, stats=stats,
        )
    }))

    def _pointwise():
        run = _st.stencil_padded if engine == "cuda" else _st.stencil_padded_plain
        ext = halo_exchange(dem_s.map(lambda t: t.to(torch.float32)), 1, NODATA, stats)
        res = {k: {} for k in (*_st.NAMES, "gfi", "ln_hl_h")}
        for blk in mesh.blocks:
            fac_b, hand_b = fac_s.blocks[blk], out["hand"].blocks[blk]
            for k, t in zip(_st.NAMES, run(ext[blk], fac_b, cfg.px, cfg.n_topo)):
                res[k][blk] = t
            res["gfi"][blk] = _gfi(hand_b, out["river_fac"].blocks[blk], cfg.n_gfi, cfg.b_gfi, cfg.px)
            res["ln_hl_h"][blk] = _ln_hl_h(hand_b, fac_b, cfg.n_gfi, cfg.b_gfi, cfg.px)
        return {k: ShardedRaster(mesh, dem_s.shape, v) for k, v in res.items()}

    out.update(hook("pointwise", _pointwise))
    return _cropped(out, shape, stats) if crop else out


def sharded_suite_staged(mesh, shape, loaders, cfg, downslope_halo=64, crop=True, dtypes=None,
                         under="under", ckpt_dir=None, stage_hook=None, stats=None):
    """Full suite with per-rank staging: NO process materialises a global
    raster (the 1e9-cell target).

    ``loaders`` maps {'dem', 'fdr', 'river', 'fac'} to
    ``block_loader(ys, ye, xs, xe) -> np.ndarray`` windowed readers; each
    rank loads only its own blocks, padded with the NoData conventions.
    With a ``'flood'`` loader the path runs on to the classified map
    (``parallel.classify.sharded_classify_flood``: the identical float64
    threshold to ``pipeline.classify_flood``), adding ``threshold``,
    ``correctness``, ``fit`` and ``class_map``.

    ``ckpt_dir`` enables shard-aware stage checkpoints: every rank saves
    only its blocks after each stage, and a restarted run (the same OR
    another number of ranks over the same block layout) resumes after the
    last complete stage, bitwise (``parallel.ckpt``).  ``stage_hook``
    observes each stage around the checkpointing one."""
    from descriptools_tpu_torch.parallel.multihost import stage_padded

    dtypes = dtypes or {}
    dem = stage_padded(mesh, shape, NODATA, loaders["dem"], dtypes.get("dem", np.int32))
    fdr = stage_padded(mesh, shape, 0, loaders["fdr"], dtypes.get("fdr", np.uint8))
    river = stage_padded(mesh, shape, 0, loaders["river"], dtypes.get("river", np.int8))
    fac = stage_padded(mesh, shape, NODATA, loaders["fac"], dtypes.get("fac", np.int32))
    # The reference's river_accumulation fac.flat[0] fallback (gfi.py:141):
    # the corner cell, read from the loader identically on every rank.
    fac0 = float(np.asarray(loaders["fac"](0, 1, 0, 1)).reshape(-1)[0])
    hook = stage_hook
    if ckpt_dir is not None:
        from dataclasses import asdict

        from descriptools_tpu_torch.parallel import ckpt as _ckpt

        manifest = dict(
            shape=[int(s) for s in shape],
            mesh=[int(s) for s in mesh.shape],
            downslope_halo=int(downslope_halo),
            # The stage set and each stage's rasters: a directory of another
            # layout fails the manifest check instead of resuming with a
            # missing raster.
            stage_layout="flow/downslope/pointwise+slope",
            **{k: (v if isinstance(v, (int, float, str)) else str(v)) for k, v in asdict(cfg).items()},
        )
        ck = _ckpt.stage_hook(ckpt_dir, mesh, manifest)
        if stage_hook is None:
            hook = ck
        else:
            def hook(name, compute, _ck=ck, _outer=stage_hook):
                return _outer(name, lambda: _ck(name, compute))
    has_flood = "flood" in loaders
    out = sharded_suite(dem, fdr, fac, river, cfg, mesh, downslope_halo=downslope_halo,
                        shape=shape, fac0=fac0, crop=False, stage_hook=hook, stats=stats)
    res = {}
    if has_flood:
        from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

        flood = stage_padded(mesh, shape, NODATA, loaders["flood"], dtypes.get("flood", np.int32))
        th, corr, fit_v, class_map = sharded_classify_flood(
            out["hand"], flood, mesh, under=under, shape=shape, crop=crop,
        )
        res = dict(threshold=th, correctness=corr, fit=fit_v, class_map=class_map)
    if crop:
        out = _cropped(out, shape, stats)
    out.update(res)
    return out
