"""Out-of-core tiled execution on one card (torch).

Counterpart of ``descriptools_tpu/tiled.py``.  Rasters live in host RAM (or
memory-mapped files), the card sees one tile at a time, and flow paths that
cross tile edges are stitched by the exact boundary-graph reduction of
``parallel.boundary``, so integer outputs are bitwise the in-core suite's.
Use it when a grid's in-core state (inputs, ten output rasters and the walk
operands, about 60 B/cell) exceeds the card.

Every function takes the ``device`` its tiles run on.  On a CUDA device the
engine ``"auto"`` runs each tile through the hand-written kernels (the
absorbing walk, the tracked downslope walk, the padded stencil); ``"torch"``
runs their plain torch versions on any device.  Device work is synchronous
per tile: host reads overlap it on one prefetch thread and output writes on
one writer thread.  ``tiled_suite`` takes the JAX package's four link knobs,
which move work off the host<->device link: three drop rasters from the
downloads and recompute them on the writer thread, one moves the uploads
onto the prefetch thread.
"""

import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

from descriptools_tpu_torch.constants import FLOW_MAX_STEPS, NODATA
from descriptools_tpu_torch.ops.downslope import downslope_window
from descriptools_tpu_torch.ops.cuda import stencil as _st
from descriptools_tpu_torch.ops.cuda import walk as _walk
from descriptools_tpu_torch.ops.gfi import gfi as _gfi
from descriptools_tpu_torch.ops.gfi import ln_hl_h as _ln_hl_h
from descriptools_tpu_torch.ops.slope import slope_from_padded
from descriptools_tpu_torch.ops.topo import modified_topographic_index, topographic_index
from descriptools_tpu_torch.parallel import boundary
from descriptools_tpu_torch.pipeline import resolve_engine


def _tile_grid(shape, tile_rows, tile_cols):
    ny = math.ceil(shape[0] / tile_rows)
    nx = math.ceil(shape[1] / tile_cols)
    return ny, nx, ny * tile_rows, nx * tile_cols


def _pad_to(arr, rows, cols, fill):
    r, c = arr.shape
    if r == rows and c == cols:
        return arr
    return np.pad(arr, ((0, rows - r), (0, cols - c)), constant_values=fill)


def load_window(loader, ys, ye, xs, xe, shape, fill, dtype, halo=0):
    """Window [ys:ye, xs:xe] plus ``halo`` rim from a windowed loader;
    positions beyond the global ``shape`` are ``fill`` (the padded-grid
    NoData convention every engine expects)."""
    rows, cols = shape
    out = np.full((ye - ys + 2 * halo, xe - xs + 2 * halo), fill, dtype)
    cy0, cy1 = max(ys - halo, 0), min(ye + halo, rows)
    cx0, cx1 = max(xs - halo, 0), min(xe + halo, cols)
    if cy1 > cy0 and cx1 > cx0:
        out[
            cy0 - (ys - halo) : cy1 - (ys - halo),
            cx0 - (xs - halo) : cx1 - (xs - halo),
        ] = loader(cy0, cy1, cx0, cx1)
    return out


def _alloc_out(out_dir, name, shape, dtype):
    if out_dir is None:
        return np.empty(shape, dtype)
    return np.lib.format.open_memmap(
        os.path.join(out_dir, name + ".npy"), mode="w+", dtype=dtype,
        shape=tuple(int(s) for s in shape),
    )


def _array_loader(a):
    return lambda ys, ye, xs, xe: a[ys:ye, xs:xe]


def _check_int32(R, C):
    if R * C >= 1 << 31:
        raise ValueError(f"padded grid {R}x{C} overflows int32 flat river indices")


def tile_map(fn, arrays, fills, tile_rows, tile_cols, device, halo=0, out_dtype=np.float32):
    """Apply a per-tile function over a large raster with optional halo.

    ``fn(*tiles) -> tile`` is called on tensors on ``device``; tiles are cut
    with ``halo`` cells of real neighbour data (``fills`` beyond the grid)
    and the interior of the result is stitched.  Covers stencil ops
    (halo=1) and bounded-walk ops (halo ~ max walk) out of core.
    """
    shape = arrays[0].shape
    ny, nx, R, C = _tile_grid(shape, tile_rows, tile_cols)
    loaders = [_array_loader(_pad_to(np.asarray(a), R, C, f)) for a, f in zip(arrays, fills)]
    out = np.empty(shape, out_dtype)
    for iy in range(ny):
        for ix in range(nx):
            ys, xs = iy * tile_rows, ix * tile_cols
            cut = [
                torch.from_numpy(load_window(
                    ld, ys, ys + tile_rows, xs, xs + tile_cols, (R, C), f,
                    np.asarray(a).dtype, halo=halo,
                )).to(device)
                for ld, a, f in zip(loaders, arrays, fills)
            ]
            res = fn(*cut).cpu().numpy()
            if halo and res.shape[0] == tile_rows + 2 * halo:
                res = res[halo:-halo, halo:-halo]
            ye_o = min(ys + tile_rows, shape[0])
            xe_o = min(xs + tile_cols, shape[1])
            out[ys:ye_o, xs:xe_o] = res[: ye_o - ys, : xe_o - xs]
    return out


def _global_indices(ix_t, C, cols):
    """Flat indices on the padded grid (width C) -> on the real grid."""
    if C == cols:
        return ix_t
    return np.where(ix_t == NODATA, NODATA, (ix_t // C) * cols + ix_t % C)


def _tile_engine(engine, device):
    """``pipeline.resolve_engine``, refusing the fold engines: the tiled
    fdist is formed from step counts carried through the ring."""
    engine = resolve_engine(engine, device)
    if engine.endswith("_blocked"):
        raise ValueError(
            f"engine={engine!r}: the tiled path forms fdist from step counts "
            "through the ring; use 'cuda', 'torch' or 'auto'"
        )
    return engine


def tiled_flow_hand(dem, fdr, river, fac, px, device, tile_rows=2048, tile_cols=2048,
                    max_steps=FLOW_MAX_STEPS, engine="auto"):
    """Flow distance / indices / HAND / river-fac, one tile on the card at a
    time, stitched exactly via the boundary-graph ring reduction.

    Inputs are numpy rasters; returns numpy (fdist, indices, hand,
    river_fac).  Indices and HAND are bitwise the in-core suite's, and so is
    fdist (formed from integer step counts).  ``engine`` is one of
    ``pipeline.ENGINES``: ``"auto"`` runs each tile's local walk in the
    absorbing-walk kernel on a CUDA device; the ``*_blocked`` engines are
    refused.
    """
    engine = _tile_engine(engine, device)
    shape = np.asarray(dem).shape
    ny, nx, R, C = _tile_grid(shape, tile_rows, tile_cols)
    _check_int32(R, C)
    h, w = tile_rows, tile_cols
    padded = [
        _pad_to(np.asarray(a), R, C, f)
        for a, f in ((dem, NODATA), (fdr, 0), (river, 0), (fac, NODATA))
    ]
    ring_sel = torch.from_numpy(boundary.ring_indices(h, w)).long().to(device)

    def tile(iy, ix, arrays):
        sl = np.s_[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w]
        return [torch.from_numpy(np.ascontiguousarray(a[sl])).to(device) for a in arrays]

    locals_, rings = {}, []
    for iy in range(ny):
        for ix in range(nx):
            loc = boundary.local_flow_summary(
                *tile(iy, ix, padded), iy, ix, h, w, R, C, max_steps=max_steps, engine=engine,
            )
            locals_[iy, ix] = {k: v.cpu() for k, v in loc.items()}
            rings.append({k: v[ring_sel].cpu() for k, v in loc.items()})
    ring = {k: torch.cat([r[k] for r in rings]).to(device) for k in rings[0]}
    solved = boundary.solve_ring(ring, h, w, nx, max_steps)

    fdist = np.empty(shape, np.float32)
    indices = np.empty(shape, np.int32)
    hand = np.empty(shape, padded[0].dtype)
    river_fac = np.empty(shape, np.float32)
    fac0 = np.float32(np.asarray(fac).reshape(-1)[0])
    for iy in range(ny):
        for ix in range(nx):
            loc = {k: v.to(device) for k, v in locals_[iy, ix].items()}
            landed, a, b, ridx, rz, rfac = boundary.combine(loc, solved, h, w, nx, max_steps)
            (dem_t,) = tile(iy, ix, padded[:1])
            rasters = boundary.flow_rasters(dem_t, landed, a, b, ridx, rz, rfac, fac0, px)
            ys, xs = iy * h, ix * w
            ye, xe = min(ys + h, shape[0]), min(xs + w, shape[1])
            for dst, src in zip((fdist, indices, hand, river_fac), rasters):
                dst[ys:ye, xs:xe] = src[: ye - ys, : xe - xs].cpu().numpy()
    return fdist, _global_indices(indices, C, shape[1]), hand, river_fac


# ---------------------------------------------------------------------------
# Loader-fed out-of-core suite (the 1e9-cell form): no full-grid host copy
# anywhere.  Inputs arrive through windowed loaders, outputs stream to RAM or
# disk memmaps, and the cross-tile flow stitching moves only per-tile RING
# records (2(h+w) entries per tile) instead of a per-cell spill.  Every
# loader is read once per tile (inputs are cached host-side for the later
# passes), and the local walk is recomputed on the card in pass C instead of
# downloading per-cell walk state.
# ---------------------------------------------------------------------------


class _Link:
    """Host<->device copies of one tiled run, counted per pass in
    ``stats["link"][pass]``: bytes and seconds each way.  A copy's seconds
    cover the transfer alone, on the clock of the thread that makes it: the
    thread's current stream is synchronised before a download starts, and
    an upload is synchronised on that stream before its clock stops.  Only
    the calling thread's stream is synchronised, never the whole device, so
    an upload on the prefetch thread's own stream waits for no kernel of
    the main thread's.  Both threads count under one lock."""

    def __init__(self, device, stats):
        self.device = torch.device(device)
        self.table = stats.setdefault("link", {}) if stats is not None else {}
        self.pass_ = None
        self._lock = threading.Lock()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _count(self, way, nbytes, seconds):
        with self._lock:
            row = self.table.setdefault(
                self.pass_, dict(h2d_bytes=0, h2d_s=0.0, d2h_bytes=0, d2h_s=0.0)
            )
            row[way + "_bytes"] += int(nbytes)
            row[way + "_s"] += seconds

    def up(self, arr):
        """numpy -> tensor on the device (on the calling thread's stream)."""
        t0 = time.perf_counter()
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self._sync()
        self._count("h2d", arr.nbytes, time.perf_counter() - t0)
        return t

    def down(self, t):
        """tensor on the device -> numpy."""
        self._sync()
        t0 = time.perf_counter()
        arr = t.cpu().numpy()
        self._count("d2h", arr.nbytes, time.perf_counter() - t0)
        return arr


def _host_slope_from_padded(padded, px):
    """Slope (numpy float32) of the interior of a 1-ring-padded numpy block,
    on the host: ``ops.slope.slope_from_padded`` on a CPU tensor (torch's
    intra-op threads).  The CPU's divisions are IEEE, so the result is
    bitwise the stencil kernel's slope (``csrc/stencil.cu``, ``__fdiv_rn``)
    and the JAX package's numpy ``_host_slope_from_padded``."""
    padded = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32))
    return slope_from_padded(padded, px).numpy()


def tiled_suite(loaders, shape, cfg, device, tile_rows=4096, tile_cols=4096,
                out_dir=None, downslope_halo=64, engine=None, progress=None,
                cache_inputs=True, stats=None, host_slope_rad=False,
                upload_in_prefetch=False, host_pointwise=False, host_slope=False):
    """Full descriptor suite, out of core, fed by windowed loaders.

    ``loaders``: {'dem','fdr','river','fac'} -> ``f(ys, ye, xs, xe) -> array``
    (windowed GeoTIFF/Zarr readers, or utils.synthetic.windowed_basin).  The
    dem loader should return an integer dtype for bitwise HAND parity.
    ``cfg`` is a ``pipeline.PipelineConfig``.  ``engine`` (``None``:
    ``cfg.engine``) resolves against ``device`` as in
    ``pipeline.descriptor_suite``, and the ``*_blocked`` engines are
    refused.

    Returns the same keys as ``pipeline.descriptor_suite``; values are numpy
    arrays, or memmaps under ``out_dir``.  Integer outputs, downslope, slope
    and fdist are bitwise the in-core suite's.

    Passes (each streams tile loads and stores, nothing global resident):
      A. ring pass: per tile, upload only fdr + river, run the local
         absorbing walk, download the perimeter ring records.  Every loader
         is read once here and cached (``cache_inputs``: RAM, or ``out_dir``
         memmaps, deleted at the end) for the later passes.
      B. ring solve on the card + host payload patch: river elevation / fac
         at the solved absorbers are point-gathered from the input cache.
      C. suite pass: per tile, re-run the local walk, splice the solved ring
         (``boundary.combine``) and compute every descriptor; downslope runs
         on the ``downslope_halo``-extended window with exact truncation
         retry (the halo doubles per tile until no interior walk is cut).

    The link knobs (the JAX package's, off by default).  Pass C's kernels
    run as they do without them, apart from the stencil when the three
    dropping knobs are all on (nothing of it is downloaded then, and it is
    not run); otherwise only what crosses the link changes:
      ``host_slope_rad`` drops slope_rad from the downloads (-4 B/cell); the
      writer thread recomputes it from the slope and the dem window with
      the JAX package's numpy expression.
      ``host_pointwise`` drops TWI, mod-TWI, GFI and ln(hl/H) and downloads
      river_fac instead (-12 B/cell); the writer thread recomputes the four
      with ``ops.topo`` and ``ops.gfi`` on CPU tensors, from the fac window,
      slope_rad (the host's with ``host_slope_rad``), HAND and river_fac.
      ``host_slope`` drops the slope (-4 B/cell); the writer thread
      recomputes it from the dem window (:func:`_host_slope_from_padded`,
      bitwise the kernel's).
      ``upload_in_prefetch`` makes the prefetch thread upload each tile's
      inputs, on a CUDA stream of its own, so that the upload of tile t+1
      may overlap tile t's kernels and downloads (from pageable host
      memory, as without it); the prefetch thread synchronises that stream
      before it hands the tensors on.  The results are bitwise those
      without it.
    A knob that fails raises; nothing falls back to the knob-off path.

    ``stats`` (a dict, filled in place): engine, the four knobs, tiles,
    flow_walk_tier, downslope_engine, downslope_halo0, downslope_retries,
    downslope_retry_halos, suite_prefetch_wait_s, suite_device_get_s,
    suite_write_wait_s, the writer thread's own seconds (writer_recompute_s
    for what the knobs dropped, writer_store_s for the output stores),
    ``pass_s`` (wall seconds of passes A, B, C) and ``link`` (host<->device
    bytes and seconds per pass, see :class:`_Link`).
    """
    engine = _tile_engine(cfg.engine if engine is None else engine, device)
    device = torch.device(device)
    rows, cols = shape
    h, w = tile_rows, tile_cols
    ny, nx, R, C = _tile_grid(shape, h, w)
    _check_int32(R, C)
    note = progress if progress is not None else (lambda *_: None)
    dem_dt = np.asarray(loaders["dem"](0, 1, 0, 1)).dtype
    max_steps = cfg.flow_max_steps
    fac0 = np.float32(np.asarray(loaders["fac"](0, 1, 0, 1)).reshape(-1)[0])
    halo0 = max(1, int(min(downslope_halo, max(R, C), cfg.downslope_max_steps + 1)))
    if stats is None:
        stats = {}
    stats.update(
        engine=engine,
        host_slope_rad=host_slope_rad,
        upload_in_prefetch=upload_in_prefetch,
        host_pointwise=host_pointwise,
        host_slope=host_slope,
        tiles=ny * nx,
        flow_walk_tier=engine,
        downslope_engine=engine,
        downslope_halo0=halo0,
        downslope_retries=0,
        downslope_retry_halos=[],
        pass_s={},
    )
    link = _Link(device, stats)

    def _acc(key, t0):
        stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)

    def tile_windows():
        for iy in range(ny):
            for ix in range(nx):
                yield iy, ix, iy * h, ix * w

    def _prefetched(thunks, wait_key=None):
        """One-ahead prefetch on a worker thread: host-side window reads
        overlap the previous tile's device work and copies.  ``wait_key``
        accumulates the main thread's blocked-on-prefetch seconds."""
        thunks = list(thunks)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(thunks[0]) if thunks else None
            for i in range(len(thunks)):
                t0 = time.perf_counter()
                res = fut.result()
                if wait_key:
                    _acc(wait_key, t0)
                fut = ex.submit(thunks[i + 1]) if i + 1 < len(thunks) else None
                yield res

    # upload_in_prefetch: the prefetch thread uploads on a stream of its own
    # (none on the CPU) and synchronises only that stream.
    up_stream = torch.cuda.Stream(device) if upload_in_prefetch and device.type == "cuda" else None

    def _prefetch_up(*arrays):
        """A tile's inputs as the prefetch thread hands them on: the numpy
        arrays, or with ``upload_in_prefetch`` tensors on the device, whose
        copies are complete (``_Link.up`` synchronises the copying stream)."""
        if not upload_in_prefetch:
            return arrays
        with torch.cuda.stream(up_stream):
            return tuple(link.up(a) for a in arrays)

    def _main_up(inputs):
        """:func:`_prefetch_up`'s output as tensors for the main thread:
        uploaded here, or kept from the caching allocator until the main
        stream is done with them (they were allocated on ``up_stream``)."""
        if not upload_in_prefetch:
            return tuple(link.up(a) for a in inputs)
        if up_stream is not None:
            for t in inputs:
                t.record_stream(torch.cuda.current_stream(device))
        return inputs

    # ---- Pass A: ring records + input cache -----------------------------
    t_pass = time.perf_counter()
    link.pass_ = "A"
    cache = {
        k: _alloc_out(out_dir, "_incache_" + k, shape, dt)
        for k, dt in (
            ("dem", dem_dt), ("fdr", np.uint8),
            ("river", np.int8), ("fac", np.int32),
        )
    } if cache_inputs else None

    ring_sel = torch.from_numpy(boundary.ring_indices(h, w)).long().to(device)
    ring_keys = ("status", "a", "b", "tgy", "tgx", "ridx")  # all int32
    # Payload placeholders: the local walk's roles never read dem/fac
    # (NoData cells carry fdr == 0); rz/rfac are re-derived in passes B, C.
    zero = torch.zeros((h, w), dtype=torch.float32, device=device)

    def _ring_inputs(iy, ix, ys, xs):
        # dem/fac are read here only to fill the input cache; without a
        # cache (loaders already are cheap memmaps) they are not read.
        keys = (
            (("dem", NODATA, dem_dt), ("fdr", 0, np.uint8),
             ("river", 0, np.int8), ("fac", NODATA, np.int32))
            if cache is not None
            else (("fdr", 0, np.uint8), ("river", 0, np.int8))
        )
        vals = {
            k: load_window(loaders[k], ys, ys + h, xs, xs + w, shape, f, dt)
            for k, f, dt in keys
        }
        if cache is not None:
            ye, xe = min(ys + h, rows), min(xs + w, cols)
            for k, v in vals.items():
                cache[k][ys:ye, xs:xe] = v[: ye - ys, : xe - xs]
        return iy, ix, _prefetch_up(vals["fdr"], vals["river"])

    rings = {}
    for iy, ix, walk_in in _prefetched(
        partial(_ring_inputs, *win) for win in tile_windows()
    ):
        fdr_t, river_t = _main_up(walk_in)
        loc = boundary.local_flow_summary(
            zero, fdr_t, river_t, zero, iy, ix, h, w, R, C,
            max_steps=max_steps, engine=engine,
        )
        rings[iy, ix] = link.down(torch.stack([loc[k][ring_sel] for k in ring_keys]))
        note("flow-rings", iy * nx + ix, ny * nx)
    stats["pass_s"]["A"] = time.perf_counter() - t_pass

    # ---- Pass B: solve the ring graph, patch the river payloads ---------
    t_pass = time.perf_counter()
    link.pass_ = "B"
    ring_host = np.concatenate([rings[iy, ix] for iy in range(ny) for ix in range(nx)], axis=1)
    del rings
    ring = dict(zip(ring_keys, link.up(ring_host)))
    G = ring_host.shape[1]
    zero_pay = torch.zeros(G, dtype=torch.float32, device=device)
    solved_dev = boundary.solve_ring(
        dict(ring, rz=zero_pay, rfac=zero_pay), h, w, nx, max_steps
    )
    del ring, ring_host, zero_pay
    status, ridx = link.down(torch.stack([solved_dev["status"], solved_dev["ridx"]]))

    # rz/rfac at the solved absorbers: point-gather dem/fac through the
    # input cache (or tile-grouped loader windows).  f32 casts of the same
    # integers the device combine would read -> bitwise-identical HAND.
    ridx = ridx.astype(np.int64)
    ry, rx = ridx // C, ridx % C
    ok = (status == boundary.RIVER) & (ry < rows) & (rx < cols)
    rz = np.zeros(G, np.float32)
    rfac = np.zeros(G, np.float32)
    if cache is not None:
        # Fancy-index the (possibly memmapped) caches directly: a point
        # gather touches only the needed pages, never the whole raster.
        rz[ok] = cache["dem"][ry[ok], rx[ok]].astype(np.float32)
        rfac[ok] = cache["fac"][ry[ok], rx[ok]].astype(np.float32)
    else:
        # One bounding-window loader read per tile that owns solved points.
        pts = np.flatnonzero(ok)
        tile_of = (ry[pts] // h) * nx + (rx[pts] // w)
        for t in np.unique(tile_of):
            sel = pts[tile_of == t]
            y0, y1 = int(ry[sel].min()), int(ry[sel].max()) + 1
            x0, x1 = int(rx[sel].min()), int(rx[sel].max()) + 1
            d = np.asarray(loaders["dem"](y0, y1, x0, x1))
            f = np.asarray(loaders["fac"](y0, y1, x0, x1))
            rz[sel] = d[ry[sel] - y0, rx[sel] - x0].astype(np.float32)
            rfac[sel] = f[ry[sel] - y0, rx[sel] - x0].astype(np.float32)
    solved_dev["rz"], solved_dev["rfac"] = link.up(rz), link.up(rfac)
    stats["pass_s"]["B"] = time.perf_counter() - t_pass

    # ---- Pass C: the full suite per tile --------------------------------
    t_pass = time.perf_counter()
    link.pass_ = "C"
    out = {
        k: _alloc_out(out_dir, k, shape, dt)
        for k, dt in (
            ("slope", np.float32), ("slope_rad", np.float32),
            ("twi", np.float32), ("mod_twi", np.float32),
            ("downslope", np.float32), ("fdist", np.float32),
            ("indices", np.int32), ("hand", dem_dt),
            ("gfi", np.float32), ("ln_hl_h", np.float32),
        )
    }
    cached = (
        {k: _array_loader(cache[k]) for k in cache}
        if cache is not None else loaders
    )
    run_stencil = _st.stencil_padded if engine == "cuda" else _st.stencil_padded_plain
    # Pass C runs the stencil for the rasters it keeps on the device.  With
    # host_slope, host_slope_rad and host_pointwise all on, the writer
    # thread recomputes all four, and the stencil is not run (XLA drops it
    # from the JAX package's jitted tile function as an unused value).
    device_stencil = not (host_slope and host_slope_rad and host_pointwise)
    run_down = _walk.downslope_walk_tracked if engine == "cuda" else downslope_window

    def _ext_inputs(ys, xs, halo):
        """dem and fdr of a tile with a ``halo`` rim (NoData / 0 beyond
        the grid)."""
        return (
            load_window(cached["dem"], ys, ys + h, xs, xs + w, shape, NODATA, dem_dt, halo=halo),
            load_window(cached["fdr"], ys, ys + h, xs, xs + w, shape, 0, np.uint8, halo=halo),
        )

    def _suite_inputs(iy, ix, ys, xs):
        dem_ext, fdr_ext = _ext_inputs(ys, xs, halo0)
        river_t = load_window(cached["river"], ys, ys + h, xs, xs + w, shape, 0, np.int8)
        fac_t = load_window(cached["fac"], ys, ys + h, xs, xs + w, shape, NODATA, np.int32)
        return iy, ix, ys, xs, _prefetch_up(dem_ext, fdr_ext, river_t, fac_t)

    def _downslope_ext(dem_f_ext, fdr_ext, y0, x0, halo):
        """Downslope of the interior of a halo-extended window, and whether
        any interior walk was cut by the window's edge (0-dim bool)."""
        dn, tr = run_down(dem_f_ext, fdr_ext, cfg.px, cfg.elevation_difference,
                          cfg.downslope_max_steps, y0, x0, R, C, halo)
        return dn, tr.any()

    def _suite_tile(iy, ix, ys, xs, suite_in):
        """The descriptors of one tile that cross the link, as tensors on
        the device: all ten without a knob; what a knob drops is left out
        (``host_pointwise`` adds river_fac)."""
        halo = halo0
        dem_ext, fdr_ext, river_t, fac_t = _main_up(suite_in)
        dem_t = dem_ext[halo:-halo, halo:-halo]
        loc = boundary.local_flow_summary(
            dem_t, fdr_ext[halo:-halo, halo:-halo], river_t, fac_t, iy, ix,
            h, w, R, C, max_steps=max_steps, engine=engine,
        )
        landed, a, b, ridx_l, rz_l, rfac_l = boundary.combine(loc, solved_dev, h, w, nx, max_steps)
        fdist, indices, hand, river_fac = boundary.flow_rasters(
            dem_t, landed, a, b, ridx_l, rz_l, rfac_l, fac0, cfg.px
        )
        dem_f_ext = dem_ext.to(torch.float32)
        if device_stencil:
            padded = dem_f_ext[halo - 1 : halo + h + 1, halo - 1 : halo + w + 1].contiguous()
            sl, sl_rad, twi, mtwi = run_stencil(padded, fac_t, cfg.px, cfg.n_topo)
        dn, trunc_any = _downslope_ext(dem_f_ext, fdr_ext, ys - halo, xs - halo, halo)
        res = dict(fdist=fdist, indices=indices, hand=hand, downslope=dn)
        if not host_slope:
            res["slope"] = sl
        if not host_slope_rad:
            res["slope_rad"] = sl_rad
        if host_pointwise:
            res["river_fac"] = river_fac
        else:
            res.update(
                twi=twi, mod_twi=mtwi,
                gfi=_gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, cfg.px),
                ln_hl_h=_ln_hl_h(hand, fac_t, cfg.n_gfi, cfg.b_gfi, cfg.px),
            )
        return res, trunc_any

    def _host_rasters(ys, ye, xs, xe, host):
        """What the knobs dropped from the downloads, recomputed on the
        writer thread into ``host``, in the JAX package's order: slope from
        the dem window with a 1-cell halo, slope_rad from the slope, then
        the four pointwise rasters from fac, slope_rad, HAND and river_fac."""
        dem_t = None
        if host_slope:
            dem_p = load_window(cached["dem"], ys, ye, xs, xe, shape, NODATA, dem_dt,
                                halo=1).astype(np.float32)
            host["slope"] = _host_slope_from_padded(dem_p, cfg.px)
            dem_t = dem_p[1:-1, 1:-1]
        if host_slope_rad:
            if dem_t is None:
                dem_t = load_window(cached["dem"], ys, ye, xs, xe, shape, NODATA, dem_dt)
            host["slope_rad"] = np.where(
                dem_t == NODATA, np.float32(NODATA),
                np.arctan(host["slope"] / np.float32(100.0), dtype=np.float32),
            )
        if host_pointwise:
            fac_t = torch.from_numpy(load_window(cached["fac"], ys, ye, xs, xe, shape, NODATA, np.int32))
            sl_rad = torch.from_numpy(host["slope_rad"])
            hand = torch.from_numpy(host["hand"])
            river_fac = torch.from_numpy(host.pop("river_fac"))
            host.update(
                twi=topographic_index(fac_t, sl_rad, cfg.px).numpy(),
                mod_twi=modified_topographic_index(fac_t, sl_rad, cfg.px, cfg.n_topo).numpy(),
                gfi=_gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, cfg.px).numpy(),
                ln_hl_h=_ln_hl_h(hand, fac_t, cfg.n_gfi, cfg.b_gfi, cfg.px).numpy(),
            )

    writer = ThreadPoolExecutor(1)
    pending_writes = []

    def _finish_tile(iy, ix, ys, xs, res, trunc_any):
        ye, xe = min(ys + h, rows), min(xs + w, cols)
        t0 = time.perf_counter()
        host = {k: link.down(v[: ye - ys, : xe - xs]) for k, v in res.items()}
        trunc = bool(link.down(trunc_any))
        _acc("suite_device_get_s", t0)
        halo = halo0
        while trunc and halo < max(R, C):
            # Rare truncation retry: rerun THIS tile's downslope with a
            # doubled halo until no interior walk is cut (exactness).
            halo = min(2 * halo, max(R, C), cfg.downslope_max_steps + 1)
            stats["downslope_retries"] += 1
            stats["downslope_retry_halos"].append(dict(tile=[iy, ix], halo=halo, engine=engine))
            dem_ext, fdr_ext = _ext_inputs(ys, xs, halo)
            dn, tr = _downslope_ext(
                link.up(dem_ext).to(torch.float32), link.up(fdr_ext), ys - halo, xs - halo, halo
            )
            host["downslope"] = link.down(dn[: ye - ys, : xe - xs])
            trunc = bool(link.down(tr))

        def write():
            host["indices"] = _global_indices(host["indices"], C, cols)
            t0 = time.perf_counter()
            _host_rasters(ys, ye, xs, xe, host)
            _acc("writer_recompute_s", t0)
            t0 = time.perf_counter()
            for k in out:
                out[k][ys:ye, xs:xe] = host[k]
            _acc("writer_store_s", t0)
            note("suite", iy * nx + ix, ny * nx)

        t0 = time.perf_counter()
        while len(pending_writes) > 1:
            pending_writes.pop(0).result()
        _acc("suite_write_wait_s", t0)
        pending_writes.append(writer.submit(write))

    try:
        for item in _prefetched(
            (partial(_suite_inputs, *win) for win in tile_windows()),
            wait_key="suite_prefetch_wait_s",
        ):
            _finish_tile(*item[:4], *_suite_tile(*item))
        for f in pending_writes:
            f.result()
    finally:
        writer.shutdown(wait=True)
    stats["pass_s"]["C"] = time.perf_counter() - t_pass

    if cache is not None:
        for k in cache:
            arr = cache[k]
            if isinstance(arr, np.memmap):
                path = arr.filename
                del arr
                os.remove(path)
        cache = None
    return out


def tiled_classify_flood(hand, flood_loader, shape, under="under",
                         out_dir=None, tile_rows=4096, tile_cols=4096,
                         progress=None):
    """Streaming flood-map calibration + classification over an out-of-core
    HAND raster (host numpy): the tiled twin of ``pipeline.classify_flood``,
    selecting the IDENTICAL float64 threshold (reference evaluation.py:12-87)
    while touching one tile at a time.

    ``hand``: (rows, cols) array or np.memmap, integer-valued (integer DEM
    input); ``flood_loader(ys, ye, xs, xe)`` windows the benchmark map.

    HAND from an integer DEM is integer-valued, so one streaming pass
    suffices for the whole calibration: a joint histogram over (integer
    HAND value x flooded-bit) plus the total flooded count yields every
    integer cutoff's exact TP/FP/FN by prefix sums, and the coarse-to-fine
    search becomes host arithmetic over the histogram.  The float64 scaled
    predicate reduces to an exact integer cutoff
    (``parallel.classify._integer_cutoff``), so the selected threshold is
    IDENTICAL to the reference float64 path.  Pass 2 writes the class map.
    Returns (threshold, correctness, fit, class_map uint8 [memmap if
    out_dir]).
    """
    from descriptools_tpu_torch.evaluation import coarse_to_fine_search
    from descriptools_tpu_torch.parallel.classify import _integer_cutoff

    rows, cols = shape
    h, w = tile_rows, tile_cols
    ny, nx, _R, _C = _tile_grid(shape, h, w)
    note = progress if progress is not None else (lambda *_: None)

    def tiles():
        for iy in range(ny):
            for ix in range(nx):
                ys, xs = iy * h, ix * w
                yield ys, min(ys + h, rows), xs, min(xs + w, cols)

    h00 = float(np.asarray(hand[0:1, 0:1], np.float64)[0, 0])
    probe_live = h00 != NODATA

    # Pass 1 (the only full scan of the search): value range + NoData
    # min/max conventions (np.unique(hand)[1]/[-1], pipeline.classify_flood)
    # AND the joint histogram, accumulated with np.bincount over the
    # non-negative integer HAND values.  Anything else means corruption or
    # a float DEM, and both must fail with THIS error before np.bincount
    # (which would raise a cryptic negative-element error, or allocate
    # O(max-value) memory for a huge corrupt value).
    _MAX_HAND = 1 << 22

    m1 = np.inf
    m2 = np.inf
    mx = -np.inf
    n_fl_total = 0
    hist_valid = np.zeros(0, np.int64)
    hist_tp = np.zeros(0, np.int64)

    def _acc(hist, vals_int):
        c = np.bincount(vals_int, minlength=len(hist)).astype(np.int64)
        if len(c) > len(hist):
            return c + np.pad(hist, (0, len(c) - len(hist)))
        hist[: len(c)] += c
        return hist

    for t, (ys, ye, xs, xe) in enumerate(tiles()):
        a = np.asarray(hand[ys:ye, xs:xe], np.float64)
        b = np.asarray(flood_loader(ys, ye, xs, xe))
        t1 = float(a.min())
        rest = a[a != t1]
        t2 = float(rest.min()) if rest.size else np.inf
        lo, hi = sorted((t1, m1))
        m1 = lo
        m2 = min(m2 if m2 != lo else np.inf, hi if hi != lo else np.inf, t2)
        mx = max(mx, float(a.max()))
        live = a[a != NODATA]
        if live.size and (
            (live % 1 != 0).any() or float(live.min()) < 0
            or float(live.max()) > _MAX_HAND
        ):
            raise ValueError(
                "HAND is not non-negative-integer-valued (or exceeds "
                f"{_MAX_HAND}); exact streaming calibration requires an "
                "integer DEM — use pipeline.classify_flood"
            )
        valid = (a != NODATA) & ~(probe_live & (a == h00))
        flooded = b == 1  # bench 1 -> 2 (flooded), NODATA -> 0
        n_fl_total += int(flooded.sum())
        hist_valid = _acc(hist_valid, a[valid].astype(np.int64))
        hist_tp = _acc(hist_tp, a[valid & flooded].astype(np.int64))
        note("classify-hist", t, ny * nx)
    mn = m2  # elements[1]: smallest value distinct from the global min
    if not np.isfinite(mn) or mx <= mn:
        raise ValueError(f"degenerate HAND value range [{mn}, {mx}]")

    # Prefix sums over the sorted value set: TP/FP/FN for EVERY cutoff.
    vals_i = np.flatnonzero(hist_valid)
    vals = vals_i.astype(np.float64)
    if len(hist_tp) < len(hist_valid):
        hist_tp = np.pad(hist_tp, (0, len(hist_valid) - len(hist_tp)))
    cum_valid = np.cumsum(hist_valid[vals_i], dtype=np.int64)
    cum_tp = np.cumsum(hist_tp[vals_i], dtype=np.int64)

    def counts_at(cuts):
        acc = np.empty((len(cuts), 3), np.int64)  # tp, fp, fn
        for k, cut in enumerate(cuts):
            if under == "under":
                i = int(np.searchsorted(vals, cut, side="right"))
                tp = int(cum_tp[i - 1]) if i else 0
                pred = int(cum_valid[i - 1]) if i else 0
            else:
                i = int(np.searchsorted(vals, cut, side="left"))
                tp = int(cum_tp[-1]) - (int(cum_tp[i - 1]) if i else 0)
                pred = int(cum_valid[-1]) - (int(cum_valid[i - 1]) if i else 0)
            acc[k] = (tp, pred - tp, n_fl_total - tp)
        return acc

    def fits_at(values, scale):
        cuts = [_integer_cutoff(v / scale, mn, mx, under) for v in values]
        c = counts_at(cuts).astype(np.float64)
        return c[:, 0] / (c[:, 0] + c[:, 2] + c[:, 1])

    th = coarse_to_fine_search(fits_at)
    cut = _integer_cutoff(th, mn, mx, under)
    tp, fp, fn = counts_at([cut])[0].astype(np.float64)
    correctness = tp / (fn + tp)
    fit = tp / (tp + fn + fp)

    class_map = _alloc_out(out_dir, "class_map", shape, np.uint8)
    for t, (ys, ye, xs, xe) in enumerate(tiles()):
        a = np.asarray(hand[ys:ye, xs:xe])
        b = np.asarray(flood_loader(ys, ye, xs, xe)).astype(np.int32)
        valid = (a != NODATA) & ~(probe_live & (a == h00))
        hit = a <= cut if under == "under" else a >= cut
        pred = (valid & hit).astype(np.uint8)
        bnorm = np.where(b == 1, 2, np.where(b == NODATA, 0, b))
        class_map[ys:ye, xs:xe] = pred + bnorm.astype(np.uint8)
        note("classify", t, ny * nx)
    return th, float(correctness), float(fit), class_map
