#!/usr/bin/env python3
"""The staged sharded suite at scale across cards (torch.distributed, one
NCCL rank a card), and BASELINE config 5 domain-decomposed.  The
counterpart of ``scripts/staged_scale.py``; it imports torch, numpy, the
port (``descriptools_tpu_torch``), ``config5_torch``, ``ranks_torch`` and
``weak_scaling_torch`` only.

    python3 staged_scale_torch.py --n 8192 --mesh 2 4 --cards 4
    python3 staged_scale_torch.py --config5 --n 32768 --mesh 4 4 --cards 4 --input-cache .config5_inputs

Ranks: ``--ranks`` processes (``--cards`` by default) share ``--cards``
cards in turn; each rank has a card of its own over NCCL, else they talk
over gloo.  On ``--device cpu`` they are gloo processes on the host.
``--n ROWS [COLS]`` is the grid.

Default mode: ``windowed_basin(rows, cols, seed=21)`` through
``sharded_suite_staged`` with a flood loader, checkpoints (``--ckpt-dir``;
by default a temporary directory, removed at the end) and a stage hook.
Each rank holds its blocks against the in-core suite on its card over the
identically padded grid (indices, HAND, river_fac, downslope, slope and
fdist bitwise; slope_rad, TWI, mod-TWI, GFI and ln(hl/H) within rtol 2e-5,
atol 1e-4), the threshold, Fit and Correctness against the one-card
classifier (identical) and its class map (bitwise).  Then it runs again on
the checkpoints: no stage may be saved again, the threshold and every
raster must be the first run's.

``--config5``: ``config5_torch.prepare_inputs(n, seed=5)`` memmaps, made in
at most ``weak_scaling_torch.PREP_WORKERS`` processes (or files
already in ``--input-cache`` of the seed and at least that grid), read
through ``config5_torch.disk_loaders``; no checkpoint (the stages would
write 44 B a cell, 47 GB at 2^30 cells).  Each rank writes its blocks of
fdist, indices (renumbered to the grid's columns) and HAND, and the class
map, into shared ``.npy`` memmaps in ``--work-dir``, and the part of each
of sixteen 256^2 sample windows (drawn in the parent from one seeded rng)
that its blocks hold of slope, slope_rad, TWI and downslope into one
(16, 256, 256) memmap a raster.  After the group ends, ``config5_checks``:
``verify.streaming_flow_invariants`` over every cell (0 violations),
``config5_torch.sample_checks`` on the windows (its own limits), and
``tiled.tiled_classify_flood`` over the HAND memmap and the flood loader on
one device, whose threshold, Fit and Correctness must be the mesh
classifier's and its class map the ranks'.

Both modes report the first run's staging seconds, wall and stage ms, then
``--iters`` warm runs of ``sharded_suite`` on blocks staged again, each
after a barrier (``weak_scaling_torch.timed_runs``: median on each rank;
then the maximum over the ranks), grid
points/s, the halo and group bytes against
``weak_scaling_torch.collective_volume_bytes``, peak GiB a rank, K1/K5/K6
launches a rank and the downslope retries, the checks' seconds and the
card's name and power limit.  One JSON line (``--out-json`` writes it to a
file as well), then ``STAGED OK`` or ``STAGED FAIL``; exit 1 when a check
fails.  Raises when fewer CUDA devices are present than ``--cards`` asks
for: nothing falls back to the CPU unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import config5_torch as c5  # noqa: E402
import ranks_torch as ranks  # noqa: E402
import weak_scaling_torch as ws  # noqa: E402
from descriptools_tpu_torch import pipeline, tiled, verify  # noqa: E402
from descriptools_tpu_torch.constants import NODATA  # noqa: E402

DEFAULT_SEED, CONFIG5_SEED = 21, 5
SAMPLE_SEED, N_WINDOWS, WINDOW = 11, 16, 256
CLOSE = dict(rtol=2e-5, atol=1e-4)  # the transcendental rasters (atanf, tanf, logf, powf)
BITWISE = ("indices", "hand", "river_fac", "downslope", "slope", "fdist")
# config 5's outputs held whole on disk, and those held only at the sample windows.
WHOLE = (("fdist", np.float32), ("indices", np.int32), ("hand", np.int32), ("class_map", np.uint8))
WINDOWED = ("slope", "slope_rad", "twi", "downslope")
STAGE_BYTES_PER_CELL = 44  # the stages' rasters: flow 16, downslope 4, pointwise 24
RANK_TIMEOUT_S = 3000


def padded_shape(shape, mesh):
    return tuple(-(-s // m) * m for s, m in zip(shape, mesh))


def sample_windows(loaders, shape, win):
    """The sample windows' (ys, xs) and the rng after drawing them
    (``config5_torch.sample_checks`` goes on with it)."""
    rng = np.random.default_rng(SAMPLE_SEED)
    return [c5.draw_window(loaders, shape, rng, win) for _ in range(N_WINDOWS)], rng


class WindowStack:
    """A raster held only at the sample windows: ``[ys:ye, xs:xe]`` of a
    window gives that window's (win, win) slice of the stack."""

    def __init__(self, stack, windows):
        self.stack = stack
        self.at = {tuple(w): i for i, w in enumerate(windows)}

    def __getitem__(self, key):
        ys, xs = key
        return self.stack[self.at[(ys.start, xs.start)]]


def _same(a, b):
    """Bitwise, NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------


def check_in_core(out, loaders, shape, mesh, cfg, dev):
    """Failures of this rank's blocks of ``out`` (crop=False) against the
    in-core suite and the one-card classifier on ``dev`` over the padded
    grid."""
    from descriptools_tpu_torch.ops.flow import hand_and_river_fac
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.parallel.mesh import pad_to_mesh

    fills = dict(dem=NODATA, fdr=0, river=0, fac=NODATA, flood=NODATA)
    dtypes = dict(dem=np.int32, fdr=np.uint8, river=np.int8, fac=np.int32, flood=np.int32)
    rows, cols = shape
    padded = {k: pad_to_mesh(np.asarray(loaders[k](0, rows, 0, cols), dtypes[k]), mesh, fills[k]) for k in fills}
    dem, fdr, fac, river = pipeline.inputs_to_torch(padded["dem"], padded["fdr"], padded["fac"], padded["river"], dev)
    want = pipeline.descriptor_suite(dem, fdr, fac, river, cfg)
    want["river_fac"] = hand_and_river_fac(dem, fac, want["indices"])[1]
    failures = []
    for key, ref in want.items():
        for b, t in out[key].blocks.items():
            ys, ye, xs, xe = out[key].window(b)
            w = ref[ys:ye, xs:xe]
            ok = _same(t, w) if key in BITWISE else torch.allclose(t, w, equal_nan=True, **CLOSE)
            if not ok:
                failures.append(f"{key} block {b}")
    flood = torch.as_tensor(padded["flood"], device=dev)
    th, corr, fit, cmap = sharded_classify_flood(want["hand"], flood, shape=shape, crop=False)
    if (out["threshold"], out["correctness"], out["fit"]) != (th, corr, fit):
        failures.append(f"classification {(out['threshold'], out['correctness'], out['fit'])} vs one card "
                        f"{(th, corr, fit)}")
    for b, t in out["class_map"].blocks.items():
        ys, ye, xs, xe = out["class_map"].window(b)
        if not torch.equal(t, cmap[ys:ye, xs:xe]):
            failures.append(f"class_map block {b}")
    return failures


def resume(mesh, shape, loaders, cfg, ckpt_dir, first):
    """The suite again on the checkpoints of the first run: (seconds,
    stages saved again, failures against the first run ``first``)."""
    from descriptools_tpu_torch.parallel import ckpt, sharded_suite_staged

    saves = []
    orig = ckpt.save_stage_sharded
    ckpt.save_stage_sharded = lambda path, arrays: saves.append(os.path.basename(path)) or orig(path, arrays)
    try:
        t0 = time.perf_counter()
        again = sharded_suite_staged(mesh, shape, loaders, cfg, crop=False, ckpt_dir=ckpt_dir)
        ranks.sync(mesh.device)
        seconds = time.perf_counter() - t0
    finally:
        ckpt.save_stage_sharded = orig
    failures = [f"resume: {k} block {b}" for k, v in first.items() if hasattr(v, "blocks")
                for b, t in v.blocks.items() if not _same(again[k].blocks[b], t)]
    if again["threshold"] != first["threshold"]:
        failures.append(f"resume: threshold {again['threshold']} vs {first['threshold']}")
    return seconds, saves, failures


def write_config5(out, mesh, shape, work_dir, windows, win):
    """This rank's blocks of the whole-raster outputs, and its part of each
    sample window, into the memmaps of ``work_dir``.  The pages reach the
    other processes through the page cache; nothing is flushed."""
    rows, cols = shape
    padded_cols = out["indices"].shape[1]
    for name, _ in WHOLE:
        mm = np.load(os.path.join(work_dir, name + ".npy"), mmap_mode="r+")
        for b, t in out[name].blocks.items():
            ys, ye, xs, xe = out[name].window(b)
            ye, xe = min(ye, rows), min(xe, cols)
            if ye <= ys or xe <= xs:
                continue
            t = t[: ye - ys, : xe - xs]
            if name == "indices" and padded_cols != cols:  # flat indices of the padded grid -> of the grid
                t = torch.where(t == NODATA, NODATA,
                                torch.div(t, padded_cols, rounding_mode="floor") * cols + t % padded_cols)
            mm[ys:ye, xs:xe] = t.cpu().numpy()
        del mm
    for name in WINDOWED:
        mm = np.load(os.path.join(work_dir, name + "_windows.npy"), mmap_mode="r+")
        for i, (wy, wx) in enumerate(windows):
            for b, t in out[name].blocks.items():
                ys, ye, xs, xe = out[name].window(b)
                y0, y1, x0, x1 = max(ys, wy), min(ye, wy + win), max(xs, wx), min(xe, wx + win)
                if y0 < y1 and x0 < x1:
                    mm[i, y0 - wy : y1 - wy, x0 - wx : x1 - wx] = t[y0 - ys : y1 - ys, x0 - xs : x1 - xs].cpu().numpy()
        del mm


def worker(spec):
    """One rank: the first run (staged from the loaders), its checks, the
    warm runs; prints the rank's result."""
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite_staged
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    rank, world, iters = spec["rank"], spec["ranks"], spec["iters"]
    dev = ranks.rank_device(spec["device"], rank, spec["cards"])
    multihost.initialize(f"tcp://localhost:{spec['port']}", world_size=world, rank=rank,
                         backend=spec["backend"], device=str(dev))
    try:
        mesh = make_mesh(tuple(spec["mesh"]), device=dev)
        shape = tuple(spec["grid"])
        config5 = spec["config5"]
        loaders = c5.disk_loaders(spec["input_cache"]) if config5 else windowed_basin(*shape, seed=spec["seed"])
        cfg = pipeline.PipelineConfig()
        res = dict(rank=rank, device=str(dev), blocks=list(mesh.blocks), failures=[])

        stats = {}
        hook, read = ranks.stage_timer(dev)
        reset_launch_counters()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ranks.barrier_start(mesh)
        t0 = time.perf_counter()
        out = sharded_suite_staged(mesh, shape, loaders, cfg, crop=False, ckpt_dir=spec["ckpt_dir"],
                                   stage_hook=hook, stats=stats)
        ranks.sync(dev)
        res["first_run_s"] = time.perf_counter() - t0
        res["first_stage_ms"], first_stage = read()
        res["staging_s"] = first_stage - t0
        res["launches"] = {k: v for k, v in launch_counters().items() if k in ws.KERNELS}
        res["downslope_halos"] = [a["halo"] for a in stats["downslope_attempts"]]
        res["classification"] = [out["threshold"], out["correctness"], out["fit"]]
        k = mesh.per_rank
        want = dict(stencil_padded=k, absorbing_walk=k, downslope_walk_tracked=k * len(res["downslope_halos"]))
        if dev.type == "cuda" and res["launches"] != want:
            res["failures"].append(f"launches {res['launches']}, expected {want}")

        t0 = time.perf_counter()
        if config5:
            write_config5(out, mesh, shape, spec["work_dir"], spec["windows"], spec["window"])
        else:
            res["failures"] += check_in_core(out, loaders, shape, mesh, cfg, dev)
            res["resume_s"], res["resume_saves"], fails = resume(mesh, shape, loaders, cfg, spec["ckpt_dir"], out)
            res["failures"] += fails
        res["rank_check_s"] = time.perf_counter() - t0
        del out

        # Warm runs of the suite on blocks staged again.
        staged = {k: multihost.stage_padded(mesh, shape, fill, loaders[k], dt) for k, fill, dt in ws.STAGED}
        fac0 = float(np.asarray(loaders["fac"](0, 1, 0, 1)).reshape(-1)[0])
        warm = ws.timed_runs(staged, cfg, mesh, shape, fac0, iters)
        res.update(warm_s=warm["seconds"], warm_stage_ms=warm["stage_ms"], collective=warm["collective"],
                   warm_downslope_halos=warm["downslope_halos"])
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        ranks.print_result(res)
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def make_work_files(work_dir, shape, win):
    """The shared memmaps the ranks write, created empty."""
    os.makedirs(work_dir, exist_ok=True)
    for name, dt in WHOLE:
        np.lib.format.open_memmap(os.path.join(work_dir, name + ".npy"), mode="w+", dtype=dt, shape=shape).flush()
    for name in WINDOWED:
        np.lib.format.open_memmap(os.path.join(work_dir, name + "_windows.npy"), mode="w+", dtype=np.float32,
                                  shape=(N_WINDOWS, win, win)).flush()


def config5_checks(input_cache, work_dir, shape, classification, tile, win, progress=None):
    """The checks of config 5 on the ranks' memmaps in ``work_dir``: the
    streaming invariants over every cell, the sample checks on the windows,
    and ``tiled_classify_flood`` (threshold, Correctness, Fit as
    ``classification`` gives them; class map bitwise the ranks').  Returns
    the checks, ``ok`` among them."""
    cfg = pipeline.PipelineConfig()
    loaders = c5.disk_loaders(input_cache)
    windows, rng = sample_windows(loaders, shape, win)
    out = {k: np.load(os.path.join(work_dir, k + ".npy"), mmap_mode="r") for k, _ in WHOLE}
    view = dict(out, **{k: WindowStack(np.load(os.path.join(work_dir, k + "_windows.npy"), mmap_mode="r"), windows)
                        for k in WINDOWED})
    t0 = time.perf_counter()
    checks = c5.sample_checks(loaders, shape, view, cfg, rng, win=win, windows=windows)
    checks["sample_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inv = verify.streaming_flow_invariants(loaders, out, shape, cfg.px, cfg.flow_max_steps, tile_rows=tile,
                                           tile_cols=tile, progress=progress)
    inv["seconds"] = time.perf_counter() - t0
    checks["invariants"] = inv
    cells = shape[0] * shape[1]
    if not inv["ok"] or inv["cells_checked"] != cells:
        checks["ok"] = False
        checks.setdefault("failures", []).append(
            f"{inv['invariant_violations']} streaming invariant violations over {inv['cells_checked']} cells")

    t0 = time.perf_counter()
    tiled_dir = os.path.join(work_dir, "tiled")
    os.makedirs(tiled_dir, exist_ok=True)
    th, corr, fit, cmap = tiled.tiled_classify_flood(out["hand"], loaders["flood"], shape, out_dir=tiled_dir,
                                                     tile_rows=tile, tile_cols=tile, progress=progress)
    same_map = all(np.array_equal(cmap[ys : ys + tile], out["class_map"][ys : ys + tile])
                   for ys in range(0, shape[0], tile))
    checks["classification"] = dict(tiled=[float(th), float(corr), float(fit)], mesh=list(classification),
                                    class_map_bitwise=same_map, seconds=time.perf_counter() - t0)
    if [th, corr, fit] != list(classification) or not same_map:
        checks["ok"] = False
        checks.setdefault("failures", []).append(
            f"classification: tiled {[th, corr, fit]} vs mesh {list(classification)}, class map "
            f"{'bitwise' if same_map else 'differs'}")
    return checks


def run_group(args, shape, backend, ckpt_dir, work_dir, windows, win):
    spec = dict(port=ranks.free_port(), ranks=args.ranks, cards=args.cards, device=args.device, backend=backend,
                mesh=args.mesh, grid=list(shape), config5=args.config5, seed=args.seed, input_cache=args.input_cache,
                ckpt_dir=ckpt_dir, work_dir=work_dir, windows=windows, window=win, iters=args.iters)
    return [r for _, r in ranks.run_ranks(
        lambda r: [os.path.abspath(__file__), "--worker", json.dumps(dict(spec, rank=r))],
        args.ranks, RANK_TIMEOUT_S, cwd=ROOT, env=ranks.child_env(ROOT))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[8192], help="ROWS [COLS] of the grid")
    ap.add_argument("--mesh", type=int, nargs=2, default=[2, 4])
    ap.add_argument("--cards", type=int, default=1, help="cards (processes on --device cpu)")
    ap.add_argument("--ranks", type=int, help="processes (default: one a card)")
    ap.add_argument("--config5", action="store_true", help="BASELINE config 5 over memmapped inputs")
    ap.add_argument("--iters", type=int, default=3, help="warm runs")
    ap.add_argument("--input-cache", default=os.path.join(ROOT, ".config5_inputs"))
    ap.add_argument("--work-dir", default=os.path.join(ROOT, ".staged_out"), help="--config5's output memmaps")
    ap.add_argument("--ckpt-dir", help="default mode's checkpoints (default: a temporary directory, removed)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-json", help="also write the result line to this file")
    args = ap.parse_args(argv)
    for key in ("input_cache", "work_dir", "ckpt_dir"):  # the ranks run from the repository's root
        if getattr(args, key):
            setattr(args, key, os.path.abspath(getattr(args, key)))
    if len(args.n) > 2:
        ap.error("--n takes ROWS [COLS]")
    shape = (args.n[0], args.n[-1])
    args.ranks = args.ranks or args.cards
    args.seed = CONFIG5_SEED if args.config5 else DEFAULT_SEED
    if args.mesh[0] * args.mesh[1] % args.ranks:
        ap.error(f"mesh {args.mesh} does not divide over {args.ranks} ranks")

    device = pipeline.check_device(args.device)
    backend = "gloo"
    if device.type == "cuda":
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"staged_scale_torch: --cards {args.cards} needs {args.cards} CUDA devices, "
                             f"found {torch.cuda.device_count()}")
        from descriptools_tpu_torch.ops.cuda import build

        build.build()  # once, before the ranks start
        backend = "nccl" if args.ranks <= args.cards else "gloo"
    card = c5.card_line() if device.type == "cuda" else None
    cells = shape[0] * shape[1]

    result = dict(script="staged_scale_torch.py", mode="config5" if args.config5 else "default", grid=list(shape),
                  cells=cells, mesh=args.mesh, padded_grid=list(padded_shape(shape, args.mesh)), ranks=args.ranks,
                  cards=args.cards, backend=backend, device=args.device, card=card, seed=args.seed)
    own_ckpt = None
    windows, win = [], min(WINDOW, min(shape) // 2)
    if args.config5:
        if shape[0] != shape[1]:
            ap.error("--config5 runs on a square grid")
        prep_s, side = c5.ensure_inputs(shape[0], args.seed, args.input_cache, workers=ws.PREP_WORKERS)
        fac_max = c5.max_fac(args.input_cache, *shape)
        print(f"inputs: {side}^2 (seed {args.seed}) in {args.input_cache}, prep {prep_s:.3f} s; max fac {fac_max}",
              flush=True)
        if fac_max >= ws.F32_EXACT:
            raise SystemExit(f"staged_scale_torch: max fac {fac_max} >= 2^24 is not exact in the flow stage's float32")
        result.update(input_prep_s=prep_s, input_prep_workers=ws.PREP_WORKERS, input_side=side, max_fac=fac_max,
                      checkpoint=(f"none: the stages would write {STAGE_BYTES_PER_CELL} B a cell, "
                                  f"{STAGE_BYTES_PER_CELL * cells / 1e9:.1f} GB"))
        need = cells * (sum(np.dtype(dt).itemsize for _, dt in WHOLE) + 1)  # and tiled_classify_flood's map
        free = shutil.disk_usage(c5._existing(args.work_dir)).free
        if need > free:
            raise SystemExit(f"staged_scale_torch: --config5 at {shape[0]}^2 writes {need / 1e9:.2f} GB to "
                             f"{args.work_dir}, which has {free / 1e9:.2f} GB free")
        windows, _ = sample_windows(c5.disk_loaders(args.input_cache), shape, win)
        make_work_files(args.work_dir, shape, win)
        ckpt_dir = None
    else:
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="staged_ckpt_")
        own_ckpt = None if args.ckpt_dir else ckpt_dir

    t0 = time.perf_counter()
    try:
        res = run_group(args, shape, backend, ckpt_dir, args.work_dir if args.config5 else None, windows, win)
        result["group_wall_s"] = time.perf_counter() - t0
        if ckpt_dir:
            files = sorted(os.listdir(ckpt_dir))
            result["checkpoint"] = dict(files=len(files),
                                        bytes=sum(os.path.getsize(os.path.join(ckpt_dir, f)) for f in files))
    finally:
        if own_ckpt:
            shutil.rmtree(own_ckpt, ignore_errors=True)

    block = [p // m for p, m in zip(padded_shape(shape, args.mesh), args.mesh)]
    halos = res[0]["warm_downslope_halos"]
    measured = {k: sum(r["collective"][k] for r in res) for k in ws.COUNTS}
    counted = ws.collective_volume_bytes(tuple(args.mesh), args.ranks, *block, halos)
    warm = max(r["warm_s"] for r in res)
    result.update(
        staging_s=max(r["staging_s"] for r in res),
        first_run_s=max(r["first_run_s"] for r in res),
        first_run_stage_ms={k: max(r["first_stage_ms"][k] for r in res) for k in ws.STAGES},
        warm_s=warm,
        warm_stage_ms={k: max(r["warm_stage_ms"][k] for r in res) for k in ws.STAGES},
        grid_points_per_s=cells / warm,
        collective_bytes=measured,
        collective_bytes_counted=counted,
        collective_bytes_match=measured == counted,
        downslope_retries=len(halos) - 1,
        launches_per_rank=[r["launches"] for r in res],
        peak_device_GiB_per_rank=[None if r["peak_device_bytes"] is None else r["peak_device_bytes"] / 2**30
                                  for r in res],
        rank_blocks=[r["blocks"] for r in res],
        rank_check_s=max(r["rank_check_s"] for r in res),
        classification=res[0]["classification"],
    )
    failures = [f"rank {r['rank']}: {f}" for r in res for f in r["failures"]]
    if not result["collective_bytes_match"]:
        failures.append(f"collective bytes {measured} != counted {counted}")
    if any(r["classification"] != res[0]["classification"] for r in res):
        failures.append(f"the ranks' classifications differ: {[r['classification'] for r in res]}")
    if args.config5:
        t0 = time.perf_counter()
        tile = min(ws.BLOCK, shape[0])
        checks = config5_checks(args.input_cache, args.work_dir, shape, res[0]["classification"], tile, win,
                                progress=lambda phase, t, n: print(f"[{time.strftime('%H:%M:%S')}] {phase} "
                                                                   f"{t + 1}/{n}", flush=True))
        result["check_s"] = time.perf_counter() - t0
        result["checks"] = checks
        failures += checks.get("failures", []) if not checks["ok"] else []
    else:
        result["resume"] = dict(seconds=max(r["resume_s"] for r in res),
                                stages_saved_again=sorted({s for r in res for s in r["resume_saves"]}))
        if result["resume"]["stages_saved_again"]:
            failures.append(f"resume recomputed {result['resume']['stages_saved_again']}")
    result["failures"] = failures
    result["ok"] = not failures
    line = json.dumps(result)
    print(line)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(line + "\n")
    print("STAGED", "OK" if result["ok"] else "FAIL")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(json.loads(sys.argv[2]))
    else:
        sys.exit(main())
