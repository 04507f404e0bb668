#!/usr/bin/env python3
"""BASELINE config 5 on one NVIDIA card: the whole descriptor suite on a
2^30-cell grid (32768 x 32768), out of core, with the PyTorch port
(``descriptools_tpu_torch``).  The counterpart of ``scripts/config5_1e9.py``;
it imports torch, numpy and the port only.

    nohup python3 config5_torch.py --n 32768 --tile 8192 > config5.log 2>&1 &

The first run generates the inputs (about 9 B a cell); later runs with the
same ``--n`` and ``--seed`` reuse them.  The run needs about 48 B a cell of
free disk (52 GB at 32768^2, inputs included) plus the 4 GiB disk probe,
checks it before it writes, and raises saying how much is lacking.  ``.config5_*``
directories are git-ignored.

Steps:

0. prep: ``windowed_basin(n, n, seed)`` written once to ``.npy`` memmaps in
   ``--input-cache`` (dem int16, fdr uint8, river int8, fac int32, flood
   int8), keyed on (n, seed) by ``meta.json``, generated window by window in
   up to 8 processes; its seconds are reported apart from the run;
1. ``tiled.tiled_suite`` over windowed memmap readers (no input cache: the
   inputs already are memmaps), outputs streamed to memmaps in
   ``--out-dir``: passes A and C run the absorbing walk, pass C the padded
   stencil and the tracked downslope walk, one launch of each a tile (the
   result's ``launches``: the kernels' launch counters over the run);
2. sample checks: sixteen 256x256 windows against the float64 oracle
   (slope and TWI abs 1e-3, downslope abs 1e-3 on untruncated cells, fdist
   rel 2e-4, indices exact in global flat coordinates, HAND =
   max(dem - dem[idx], 0) exact);
3. ``verify.streaming_flow_invariants`` over every cell (0 violations);
4. ``tiled.tiled_classify_flood`` over the HAND memmap, and the class map's
   benchmark bit on three windows;
5. accounting: the bytes each pass moved over the host link at the link's
   measured rate, the bytes read from and written to disk at the disk's
   measured rates (a timed write of 4 GiB with fsync in ``--out-dir``, then
   its read after its pages are dropped), the run's
   floor (the larger) and the bound the wall sits at.

It prints one JSON line (also written to ``--out-json``) and exits 1 when a
check fails.  It writes no other record.
"""

import argparse
import json
import multiprocessing
import os
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from descriptools_tpu_torch import oracle, pipeline, tiled, verify  # noqa: E402
from descriptools_tpu_torch.constants import NODATA  # noqa: E402
from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters  # noqa: E402
from descriptools_tpu_torch.utils.synthetic import windowed_basin  # noqa: E402

INPUT_SPEC = (
    ("dem", np.int16), ("fdr", np.uint8), ("river", np.int8),
    ("fac", np.int32), ("flood", np.int8),
)
# tiled_suite's outputs with an int16 dem: eight float32 rasters, indices
# int32, HAND int16; then the class map.
OUTPUT_BYTES_PER_CELL = 8 * 4 + 4 + 2
CLASS_MAP_BYTES_PER_CELL = 1
OUTPUT_FILES = ("slope", "slope_rad", "twi", "mod_twi", "downslope", "fdist",
                "indices", "hand", "gfi", "ln_hl_h", "class_map")
PROBE_FILE = "_disk_probe.bin"
GIB = 1 << 30


def card_line():
    """The card's name and power limit as nvidia-smi gives them (None
    where it is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Disk
# ---------------------------------------------------------------------------


def _existing(path):
    """``path`` or its nearest existing parent."""
    path = os.path.abspath(path)
    while not os.path.exists(path):
        path = os.path.dirname(path)
    return path


def _file_bytes(d, names):
    return sum(os.path.getsize(p) for p in (os.path.join(d, n) for n in names) if os.path.isfile(p))


def check_disk(n, input_cache, out_dir, inputs_cached, probe_bytes):
    """Raise unless each file system holds what the run writes there:
    9 B a cell of inputs (unless cached), 38 B a cell of outputs, 1 B a
    cell of class map and the disk probe.  Files the run would overwrite
    count as free.  Returns {mount: (need, free)} in bytes."""
    cells = n * n
    need = {}
    if not inputs_cached:
        in_bytes = cells * sum(np.dtype(dt).itemsize for _, dt in INPUT_SPEC)
        in_bytes -= _file_bytes(input_cache, [k + ".npy" for k, _ in INPUT_SPEC])
        need[_existing(input_cache)] = in_bytes
    out_bytes = cells * (OUTPUT_BYTES_PER_CELL + CLASS_MAP_BYTES_PER_CELL) + probe_bytes
    out_bytes -= _file_bytes(out_dir, [k + ".npy" for k in OUTPUT_FILES] + [PROBE_FILE])
    need[_existing(out_dir)] = need.get(_existing(out_dir), 0) + out_bytes
    by_dev = {}
    for path, b in need.items():
        key = os.stat(path).st_dev
        p, total = by_dev.get(key, (path, 0))
        by_dev[key] = (p, total + b)
    report = {}
    for path, b in by_dev.values():
        free = shutil.disk_usage(path).free
        report[path] = (int(b), int(free))
        if b > free:
            raise RuntimeError(
                f"config 5 at {n}x{n} needs {b / 1e9:.2f} GB on the file system of {path}, which has "
                f"{free / 1e9:.2f} GB free: it lacks {(b - free) / 1e9:.2f} GB"
            )
    return report


def disk_rates(directory, nbytes, chunk=64 << 20):
    """The disk's write rate (``nbytes`` written in ``chunk``s, then fsync)
    and read rate (the same file read back after its pages are dropped from
    the page cache), in bytes/s; the file is removed.  ``pages_dropped``
    says whether the drop was asked for (posix_fadvise)."""
    path = os.path.join(directory, PROBE_FILE)
    chunk = min(chunk, nbytes)
    block = np.random.default_rng(0).integers(0, 256, chunk, dtype=np.uint8).tobytes()
    nchunks = max(1, -(-nbytes // chunk))
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            t0 = time.perf_counter()
            for _ in range(nchunks):
                os.write(fd, block)
            os.fsync(fd)
            write_s = time.perf_counter() - t0
        finally:
            os.close(fd)
        dropped = hasattr(os, "posix_fadvise")
        fd = os.open(path, os.O_RDONLY)
        try:
            if dropped:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            buf = bytearray(chunk)
            t0 = time.perf_counter()
            got = 0
            while True:
                k = os.readv(fd, [buf])
                if not k:
                    break
                got += k
            read_s = time.perf_counter() - t0
        finally:
            os.close(fd)
    finally:
        if os.path.exists(path):
            os.remove(path)
    written = nchunks * chunk
    return dict(bytes=written, write_s=write_s, write_Bps=written / write_s,
                read_s=read_s, read_Bps=got / read_s, pages_dropped=dropped)


def _drop_pages(paths):
    """Write back and drop the page-cache pages of ``paths``, so that the
    next read comes from the disk (where posix_fadvise is honoured)."""
    if not hasattr(os, "posix_fadvise"):
        return False
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return True


def _ram_bytes():
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _input_path(cache_dir, k):
    return os.path.join(cache_dir, k + ".npy")


def _write_window(cache_dir, n, seed, ys, ye, xs, xe, arrays=None):
    """One window of every input into the memmaps of ``cache_dir``: from
    ``arrays`` where given, else from ``windowed_basin(n, n, seed)``."""
    gen = windowed_basin(n, n, seed=seed) if arrays is None else None
    for k, dt in INPUT_SPEC:
        mm = np.load(_input_path(cache_dir, k), mmap_mode="r+")
        v = gen[k](ys, ye, xs, xe) if arrays is None else np.asarray(arrays[k][ys:ye, xs:xe])
        if k == "dem" and (v.min() < np.iinfo(np.int16).min or v.max() > np.iinfo(np.int16).max):
            raise ValueError(f"dem window ({ys}, {xs}) holds values outside int16: "
                             f"[{v.min()}, {v.max()}]")
        mm[ys:ye, xs:xe] = v.astype(dt)
        mm.flush()
        del mm


def inputs_cached(cache_dir, n, seed):
    """Whether ``cache_dir`` holds the finished inputs of (n, seed)."""
    meta_path = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as fh:
        meta = json.load(fh)
    return meta.get("n") == n and meta.get("seed") == seed and bool(meta.get("done"))


def prepare_inputs(n, seed, cache_dir, gen_tile=4096, arrays=None, workers=1, progress=None):
    """Write ``windowed_basin(n, n, seed)`` once to ``.npy`` memmaps in
    ``cache_dir`` in ``INPUT_SPEC``'s dtypes (the JAX script's), and reuse
    them while ``meta.json`` names the same (n, seed).  ``arrays``: the
    whole rasters, written instead of generated (they must be the same
    ``windowed_basin`` grid).  Windows of ``gen_tile`` are generated in
    ``workers`` processes; every window of the generator is bitwise the same
    slice of its grid, so the files do not depend on either.  Returns
    (seconds, cached)."""
    if inputs_cached(cache_dir, n, seed):
        return 0.0, True
    meta_path = os.path.join(cache_dir, "meta.json")
    if os.path.exists(meta_path):
        os.remove(meta_path)
    os.makedirs(cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    for k, dt in INPUT_SPEC:
        np.lib.format.open_memmap(_input_path(cache_dir, k), mode="w+", dtype=dt, shape=(n, n)).flush()
    wins = [(ys, min(ys + gen_tile, n), xs, min(xs + gen_tile, n))
            for ys in range(0, n, gen_tile) for xs in range(0, n, gen_tile)]
    note = progress if progress is not None else (lambda *_: None)
    if arrays is not None or workers <= 1:
        for t, win in enumerate(wins):
            _write_window(cache_dir, n, seed, *win, arrays=arrays)
            note("prep", t, len(wins))
    else:
        # Fresh processes: this one may hold threads (BLAS, torch) that a
        # fork would copy mid-state.
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = [ex.submit(_write_window, cache_dir, n, seed, *win) for win in wins]
            for t, f in enumerate(futs):
                f.result()
                note("prep", t, len(wins))
    with open(meta_path, "w") as fh:
        json.dump({"n": n, "seed": seed, "done": True}, fh)
    return time.perf_counter() - t0, False


def ensure_inputs(n, seed, cache_dir, workers=1, progress=None):
    """Inputs of at least n x n for ``seed`` in ``cache_dir``: the files
    already there when they hold a grid of ``seed`` at least that large
    (a smaller grid reads their top-left window), else
    ``prepare_inputs(n, seed, ...)`` in at most ``workers`` processes.  Returns (seconds, side of the grid
    in the files)."""
    meta_path = os.path.join(cache_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        if meta.get("done") and meta.get("seed") == seed and meta.get("n", 0) >= n:
            return 0.0, meta["n"]
    windows = -(-n // 4096) ** 2  # prepare_inputs' windows
    seconds, _ = prepare_inputs(n, seed, cache_dir, workers=min(workers, windows), progress=progress)
    return seconds, n


def max_fac(cache_dir, rows, cols, chunk=4096):
    """The largest fac of the top-left rows x cols window of the inputs.
    The flow stage carries fac through float32 (``hand_and_river_fac``, the
    ring's payload), exact below 2^24."""
    fac = np.load(_input_path(cache_dir, "fac"), mmap_mode="r")
    return max(int(fac[ys : min(ys + chunk, rows), :cols].max()) for ys in range(0, rows, chunk))


def disk_loaders(cache_dir, counter=None):
    """Windowed readers of the memmaps: ``f(ys, ye, xs, xe)`` -> a view.
    ``counter`` (a dict) adds up the bytes each input's windows hold."""
    def reader(k, a):
        def read(ys, ye, xs, xe):
            v = a[ys:ye, xs:xe]
            if counter is not None:
                counter[k] = counter.get(k, 0) + v.nbytes
            return v
        return read

    return {k: reader(k, np.load(_input_path(cache_dir, k), mmap_mode="r")) for k, _ in INPUT_SPEC}


def draw_window(loaders, shape, rng, win=256):
    """(ys, xs) of a random win x win window, mostly data: up to 30 draws,
    until more than half its dem is not NoData."""
    rows, cols = shape
    for _ in range(30):  # the NoData corner blob covers whole windows
        ys = int(rng.integers(0, rows - win))
        xs = int(rng.integers(0, cols - win))
        if (loaders["dem"](ys, ys + win, xs, xs + win) != NODATA).mean() > 0.5:
            break
    return ys, xs


def sample_checks(loaders, shape, out, cfg, rng, n_windows=16, win=256, windows=None):
    """Oracle and invariant checks on ``n_windows`` random windows, with
    the JAX script's limits.  ``windows``: their (ys, xs), drawn beforehand
    by ``draw_window``; by default each is drawn from ``rng`` in turn."""
    rows, cols = shape
    checks = dict(windows=[], ok=True)

    def fail(msg):
        checks["ok"] = False
        checks.setdefault("failures", []).append(msg)

    for wi in range(n_windows if windows is None else len(windows)):
        ys, xs = draw_window(loaders, shape, rng, win) if windows is None else windows[wi]
        ye, xe = ys + win, xs + win
        dem = loaders["dem"](ys, ye, xs, xe)
        fac = loaders["fac"](ys, ye, xs, xe)
        river = loaders["river"](ys, ye, xs, xe)
        rec = dict(ys=ys, xs=xs)

        # Pointwise oracles (slope needs a 1-cell halo window).
        dem_h = tiled.load_window(loaders["dem"], ys, ye, xs, xe, shape, NODATA, dem.dtype, halo=1)
        sl_o = oracle.slope_oracle(dem_h.astype(np.float64), cfg.px)[1:-1, 1:-1]
        sl = np.asarray(out["slope"][ys:ye, xs:xe], np.float64)
        rec["slope_max_abs_err"] = float(np.max(np.abs(sl - sl_o)))
        if rec["slope_max_abs_err"] > 1e-3:
            fail(f"slope window {wi}")

        twi_o = oracle.topographic_index_oracle(fac, np.asarray(out["slope_rad"][ys:ye, xs:xe]), cfg.px)
        twi = np.asarray(out["twi"][ys:ye, xs:xe], np.float64)
        v = (twi != NODATA) & (twi_o != NODATA)
        rec["twi_max_abs_err"] = float(np.max(np.abs(twi[v] - twi_o[v]))) if v.any() else 0.0
        if rec["twi_max_abs_err"] > 1e-3:
            fail(f"twi window {wi}")

        # Flow invariants through the loaders (global properties).
        idx = np.asarray(out["indices"][ys:ye, xs:xe])
        hand = np.asarray(out["hand"][ys:ye, xs:xe])
        fdist = np.asarray(out["fdist"][ys:ye, xs:xe])
        landed = idx != NODATA
        n_landed = int(landed.sum())
        rec["landed_cells"] = n_landed
        if n_landed:
            ridx = idx[landed].astype(np.int64)
            hand_l = hand[landed]
            dem_l = dem[landed]
            if n_landed > 1500:  # bound the point-query count per window
                pick = rng.choice(n_landed, 1500, replace=False)
                ridx, hand_l, dem_l = ridx[pick], hand_l[pick], dem_l[pick]
            ry, rx = ridx // cols, ridx % cols
            riv_ok = np.ones(len(ridx), bool)
            dem_at = np.empty(len(ridx), dem.dtype)
            for k in range(len(ridx)):
                riv_ok[k] = loaders["river"](ry[k], ry[k] + 1, rx[k], rx[k] + 1)[0, 0] == 1
                dem_at[k] = loaders["dem"](ry[k], ry[k] + 1, rx[k], rx[k] + 1)[0, 0]
            if not riv_ok.all():
                fail(f"window {wi}: {int((~riv_ok).sum())} indices not river")
            want_hand = np.maximum(dem_l - dem_at, 0)
            if not np.array_equal(want_hand, hand_l):
                fail(f"window {wi}: hand != dem - dem[ridx]")
            if (hand_l < 0).any():
                fail(f"window {wi}: negative hand")
        own = (river == 1) & (loaders["fdr"](ys, ye, xs, xe) != 0)
        if own.any():
            yy = np.arange(ys, ye, dtype=np.int64)[:, None]
            xx = np.arange(xs, xe, dtype=np.int64)[None, :]
            own_idx = (yy * cols + xx)[own]
            if not np.array_equal(idx[own].astype(np.int64), own_idx):
                fail(f"window {wi}: river cells lack self index")
            if not (fdist[own] == 0).all():
                fail(f"window {wi}: river cells fdist != 0")

        # Downslope oracle on a halo-extended window: compare the cells
        # whose oracle walk completes inside the window (untruncated).
        halo = 192
        dem_w = tiled.load_window(loaders["dem"], ys, ye, xs, xe, shape, NODATA, dem.dtype,
                                  halo=halo).astype(np.float64)
        fdr_w = tiled.load_window(loaders["fdr"], ys, ye, xs, xe, shape, 0, np.uint8, halo=halo)
        dn_o, trunc = oracle.downslope_oracle_trunc(
            dem_w, fdr_w, cfg.px, cfg.elevation_difference, max_steps=cfg.downslope_max_steps,
        )
        dn_o = dn_o[halo:-halo, halo:-halo]
        ok_cells = ~trunc[halo:-halo, halo:-halo]
        dn = np.asarray(out["downslope"][ys:ye, xs:xe], np.float64)
        rec["downslope_cells_compared"] = int(ok_cells.sum())
        rec["downslope_max_abs_err"] = (
            float(np.max(np.abs(dn[ok_cells] - dn_o[ok_cells]))) if ok_cells.any() else 0.0
        )
        if rec["downslope_max_abs_err"] > 1e-3:
            fail(f"downslope window {wi}")

        # fdist and indices against the float64 flow oracle on the same
        # window: a cell whose window walk lands on a river never left the
        # window, so its global walk is the same path; indices must match
        # in global flat coordinates (a wrap of the int32 index shows
        # here) and fdist up to float32 summation order.
        riv_w = tiled.load_window(loaders["river"], ys, ye, xs, xe, shape, 0, np.int8, halo=halo)
        fd_o, idx_o = oracle.flow_distance_index_oracle(fdr_w, riv_w, cfg.px, max_steps=cfg.flow_max_steps)
        fd_o = fd_o[halo:-halo, halo:-halo]
        idx_o = idx_o[halo:-halo, halo:-halo]
        wcols = win + 2 * halo
        inwin = idx_o != NODATA
        rec["fdist_cells_compared"] = int(inwin.sum())
        if inwin.any():
            gy = (ys - halo) + idx_o[inwin].astype(np.int64) // wcols
            gx = (xs - halo) + idx_o[inwin].astype(np.int64) % wcols
            if not np.array_equal(idx[inwin].astype(np.int64), gy * cols + gx):
                fail(f"window {wi}: indices != window-oracle indices")
            fde = np.abs(np.asarray(fdist, np.float64)[inwin] - fd_o[inwin])
            rec["fdist_max_rel_err"] = float(np.max(fde / np.maximum(np.abs(fd_o[inwin]), 1.0)))
            if rec["fdist_max_rel_err"] > 2e-4:
                fail(f"window {wi}: fdist vs oracle")
        checks["windows"].append(rec)
    return checks


def classify(out, loaders, shape, tile, out_dir, rng, checks, progress=None):
    """``tiled_classify_flood`` over the HAND memmap; the class map's
    benchmark bit (code >= 2 where the benchmark floods) checked on three
    windows; the results go into ``checks``."""
    t0 = time.perf_counter()
    th, corr, fit, class_map = tiled.tiled_classify_flood(
        out["hand"], loaders["flood"], shape, out_dir=out_dir, tile_rows=tile, tile_cols=tile,
        progress=progress,
    )
    seconds = time.perf_counter() - t0
    for _ in range(3):
        ys = int(rng.integers(0, shape[0] - 256))
        xs = int(rng.integers(0, shape[1] - 256))
        cm = np.asarray(class_map[ys : ys + 256, xs : xs + 256])
        fl = loaders["flood"](ys, ys + 256, xs, xs + 256)
        if not ((cm >= 2) == (fl == 1)).all():
            checks["ok"] = False
            checks.setdefault("failures", []).append(f"class_map benchmark bit wrong at ({ys},{xs})")
    checks["classification"] = dict(threshold=float(th), correctness=float(corr), fit=float(fit),
                                    seconds=seconds)


def link_accounting(link):
    """Per pass: GB and GB/s each way (``stats["link"]``); the link's rate
    each way is the best pass's, and its floor the bytes at those rates."""
    passes, best = {}, {}
    for p, row in link.items():
        rec = {}
        for way in ("h2d", "d2h"):
            b, s = row[way + "_bytes"], row[way + "_s"]
            rec[way + "_GB"] = b / 1e9
            rec[way + "_s"] = s
            rec[way + "_GBps"] = b / s / 1e9 if s else None
            if s and b >= 1 << 20:  # a pass of smaller copies times their latency
                best[way] = max(best.get(way, 0.0), b / s)
        passes[p] = rec
    total = {way: sum(r[way + "_bytes"] for r in link.values()) for way in ("h2d", "d2h")}
    seconds = sum(total[way] / best[way] for way in total if way in best)
    return dict(passes=passes, h2d_bytes=total["h2d"], d2h_bytes=total["d2h"],
                h2d_GBps=best.get("h2d", 0.0) / 1e9, d2h_GBps=best.get("d2h", 0.0) / 1e9,
                floor_s=seconds)


def run(n, tile, seed, out_dir, input_cache, device, arrays=None, prep_workers=1,
        disk_probe_bytes=4 * GIB, progress=None):
    """Config 5 end to end at n x n in ``tile``-sided tiles on ``device``
    (the kernels on a CUDA device, their plain versions on the CPU).
    Returns (result, out, loaders): the result dict (printed as JSON by
    ``main``), the output memmaps and the disk loaders."""
    device = pipeline.check_device(device)
    shape, cells = (n, n), n * n
    os.makedirs(out_dir, exist_ok=True)
    disk_need = check_disk(n, input_cache, out_dir, inputs_cached(input_cache, n, seed), disk_probe_bytes)
    prep_s, prep_cached = prepare_inputs(n, seed, input_cache, arrays=arrays, workers=prep_workers,
                                         progress=progress)
    dropped = _drop_pages([_input_path(input_cache, k) for k, _ in INPUT_SPEC])

    read = {}
    loaders = disk_loaders(input_cache, read)
    cfg = pipeline.PipelineConfig()
    stats = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counters()
    t0 = time.perf_counter()
    out = tiled.tiled_suite(loaders, shape, cfg, device, tile_rows=tile, tile_cols=tile, out_dir=out_dir,
                            cache_inputs=False, stats=stats, progress=progress)
    for a in out.values():
        a.flush()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counters().items() if v}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    suite_read = dict(read)

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    checks = sample_checks(loaders, shape, out, cfg, rng)
    checks["sample_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inv = verify.streaming_flow_invariants(loaders, out, shape, cfg.px, cfg.flow_max_steps,
                                           tile_rows=tile, tile_cols=tile, progress=progress)
    inv["seconds"] = time.perf_counter() - t0
    checks["invariants"] = inv
    if not inv["ok"] or inv["cells_checked"] != cells:
        checks["ok"] = False
        checks.setdefault("failures", []).append(
            f"{inv['invariant_violations']} streaming invariant violations over {inv['cells_checked']} cells"
        )
    classify(out, loaders, shape, tile, out_dir, rng, checks, progress=progress)

    rates = disk_rates(out_dir, disk_probe_bytes)
    link = link_accounting(stats["link"])
    out_bytes = sum(a.nbytes for a in out.values())
    read_bytes = sum(suite_read.values())
    disk_s = read_bytes / rates["read_Bps"] + out_bytes / rates["write_Bps"]
    floors = dict(link=link["floor_s"], disk=disk_s)
    bound_by = max(floors, key=floors.get)
    ram = _ram_bytes()
    in_bytes = cells * sum(np.dtype(dt).itemsize for _, dt in INPUT_SPEC)
    result = dict(
        config=5,
        grid=[n, n],
        cells=cells,
        tile=tile,
        engine=stats["engine"],
        device=str(device),
        card=card_line() if device.type == "cuda" else None,
        input_prep_seconds=prep_s,
        input_prep_cached=prep_cached,
        prep_workers=prep_workers,
        wall_s=wall,
        grid_points_per_s=cells / wall,
        pass_s=stats["pass_s"],
        host_waits_s={k: stats.get(k, 0.0)
                      for k in ("suite_prefetch_wait_s", "suite_device_get_s", "suite_write_wait_s")},
        launches=launches,
        downslope_retries=stats["downslope_retries"],
        downslope_retry_halos=stats["downslope_retry_halos"],
        peak_device_bytes=peak,
        # ru_maxrss (KiB on Linux) counts the memmaps' resident file pages.
        peak_host_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        link=link,
        disk=dict(
            need_and_free_bytes=disk_need,
            probe=rates,
            suite_read_bytes=read_bytes,
            suite_read_bytes_by_input=suite_read,
            suite_write_bytes=out_bytes,
            floor_s=disk_s,
            input_pages_dropped_before_run=dropped,
            ram_bytes=ram,
            input_bytes=in_bytes,
            # Pass A reads every fdr and river page; passes B and C read
            # those inputs again, from RAM where they still fit beside the
            # outputs the run writes.
            page_cache_could_serve_rereads=bool(ram and in_bytes + out_bytes < ram),
        ),
        floor_s=floors[bound_by],
        bound_by=bound_by,
        wall_over_floor=wall / floors[bound_by] if floors[bound_by] else None,
        checks=checks,
        ok=bool(checks["ok"]),
    )
    return result, out, loaders


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tile", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, ".config5_out"))
    ap.add_argument("--input-cache", default=os.path.join(ROOT, ".config5_inputs"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-json", help="also write the result line to this file")
    args = ap.parse_args(argv)

    def note(phase, t, total):
        print(f"[{time.strftime('%H:%M:%S')}] {phase} {t + 1}/{total}", flush=True)

    result, _, _ = run(args.n, args.tile, args.seed, args.out_dir, args.input_cache, args.device,
                       prep_workers=min(8, os.cpu_count() or 1), progress=note)
    line = json.dumps(result)
    print(line)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(line + "\n")
    print("CONFIG5", "OK" if result["ok"] else "FAIL")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
