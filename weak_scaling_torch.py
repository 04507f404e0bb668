#!/usr/bin/env python3
"""Weak scaling of the port's sharded suite across cards (torch.distributed,
one NCCL rank a card).  The counterpart of ``scripts/weak_scaling.py``; it
imports torch, numpy, the port (``descriptools_tpu_torch``),
``config5_torch`` and ``ranks_torch`` only.

    python3 weak_scaling_torch.py --per-card 8192 16384 --cards 4

The work a card is fixed while the number of cards N grows 1 -> 2 -> 4
(powers of two up to ``--cards``).  Blocks are min(8192, per-card) cells a
side, s = per-card / block of them along each side of a rank's share, so
the mesh is (s, s), (s, 2s), (2s, 2s) and rank r owns the blocks
``[r s^2, (r + 1) s^2)`` (``parallel.mesh``): at ``--per-card 16384`` and
N = 4 the grid is 32768^2 = 2^30 cells on mesh (4, 4).  On
``--device cpu`` the ranks are gloo processes and ``--cards`` counts them.

Inputs: ``config5_torch.prepare_inputs(n, seed, --input-cache)`` once at
the largest grid, in at most ``PREP_WORKERS`` processes (``.npy``
memmaps, ``windowed_basin(n, n, seed)``), or files already there of the
same seed and at least that grid; each grid reads their top-left window,
and each rank stages only its own blocks (``multihost.stage_padded``).
The windows are not alike: ``windowed_basin``'s NoData blob lies in the
top-left corner of the largest grid, so a smaller grid holds less data a
cell.  Each row gives every rank's share of valid cells
(``valid_share_per_rank``): a rank with less data has less work.

Per (per-card, N), in a group of N rank processes:

- one warm-up run, then ``--iters`` runs of ``sharded_suite(...,
  crop=False, stage_hook=...)``, each after a barrier (``timed_runs``,
  which ``staged_scale_torch.py`` uses too): the run's seconds
  (host clock to the synchronised card) and each stage's (CUDA events; the
  host clock on the CPU); the median over the runs on each rank, then the
  maximum over the ranks, since a stage that holds a collective waits for
  the last rank;
- ``weak_scaling_efficiency`` t1 / tN, for the run and for each stage;
- ``collective_bytes``: the halo strips moved between blocks, the bytes
  handed to the group and its calls, summed over the ranks, which must
  equal ``collective_volume_bytes`` (the port's own count);
- the null baseline (``null_program``): 64 elementwise sweeps on the same
  blocks and no collective; ``vs_null_baseline`` reads each stage's
  efficiency against its efficiency;
- ``decomposition_overhead_vs_single_device``: tN over the in-core
  ``pipeline.descriptor_suite`` of the same grid on one card, where that
  grid fits one card (null beyond, with the reason);
- each rank's peak device memory, staging seconds, K1/K5/K6 launches a run
  and downslope retries; the card's name and power limit.

Left out of the JAX script: ``host_serialization_ceiling`` and
``fraction_of_ceiling``.  They bound eight virtual devices that share a
two-core host; a card runs its own program.

Prints one JSON line (``--out-json`` writes it to a file as well) and
writes nothing else.  Exits non-zero when a rank fails or the measured
collective bytes differ from the count; raises when fewer CUDA devices are
present than ``--cards`` asks for: nothing falls back to the CPU unless
``--device cpu`` is given.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import config5_torch as c5  # noqa: E402
from descriptools_tpu_torch import pipeline  # noqa: E402
from descriptools_tpu_torch.constants import NODATA  # noqa: E402
import ranks_torch as ranks  # noqa: E402
from descriptools_tpu_torch.parallel import sharded_suite  # noqa: E402

BLOCK = 8192  # a block's side: config 5's tile
NULL_SWEEPS = 64
STAGES = ("flow", "downslope", "pointwise")
TARGET = 0.8  # BASELINE.md: >= 80 % weak-scaling efficiency at N >= 2
RANK_TIMEOUT_S = 1800
PREP_WORKERS = 8  # the generator's processes for the inputs
COUNTS = ("halo_bytes", "comm_bytes", "comm_calls")
F32_EXACT = 1 << 24
# The staged inputs' dtypes: dem and fac int32 (integer HAND), fdr uint8,
# river int8; and their fills beyond the grid (``mesh.pad_to_mesh``).
STAGED = (("dem", NODATA, np.int32), ("fdr", 0, np.uint8), ("river", 0, np.int8), ("fac", NODATA, np.int32))
KERNELS = ("stencil_padded", "absorbing_walk", "downslope_walk_tracked")  # K1, K5, K6


def world_sizes(cards):
    """1, 2, 4, ... up to ``cards``."""
    out = [1]
    while out[-1] * 2 <= cards:
        out.append(out[-1] * 2)
    return out


def mesh_of(per_card, world):
    """(block side, mesh shape) that gives each of ``world`` ranks a
    per_card x per_card share: (s 2^floor(k/2), s 2^ceil(k/2)) blocks for
    world = 2^k, s = per_card / block."""
    block = min(BLOCK, per_card)
    if per_card % block:
        raise ValueError(f"--per-card {per_card} is not a multiple of the {block}-cell block")
    s = per_card // block
    k = world.bit_length() - 1
    if 1 << k != world:
        raise ValueError(f"world {world} is not a power of two")
    return block, (s << (k // 2), s << (k - k // 2))


def _axis_strips(n, size, width):
    """[(target, source, cells along the axis)] of a halo of ``width``
    along an axis of ``n`` blocks of ``size``: the cells of source block s
    inside target t's extended range [t size - width, (t + 1) size +
    width)."""
    out = []
    for t in range(n):
        lo, hi = t * size - width, (t + 1) * size + width
        for s in range(n):
            k = min(hi, (s + 1) * size) - max(lo, s * size)
            if s != t and k > 0:
                out.append((t, s, k))
    return out


def collective_volume_bytes(mesh_shape, world, h, w, downslope_halos, dem_bytes=4, fdr_bytes=1):
    """The port's collective volume of one ``sharded_suite`` run on a mesh
    of ``mesh_shape`` blocks of h x w over ``world`` ranks, summed over the
    ranks, as the suite's ``stats`` count it: {halo_bytes, comm_bytes,
    comm_calls}.

    - halo strips (``parallel.halo``): a row phase (strips w wide), then a
      column phase over the row-extended blocks (strips h + 2 d high), each
      piece straight from the block that holds it; a piece between blocks
      of two ranks is also handed to the group, one send each.  The
      downslope stage exchanges dem (float32) and fdr (uint8) once an
      attempt, at the attempt's halo d (``downslope_halos``, the run's
      ``stats["downslope_attempts"]``); the pointwise stage dem at d = 1;
    - one all-reduce of an int32 flag an attempt on each rank, where the
      halo is below the grid's larger side (else the loop ends first);
    - the flow stage's ring: one all-gather, each rank handing its blocks'
      records, an int32 (8, 2 (h + w)) tensor a block."""
    ny, nx = mesh_shape
    per_rank = ny * nx // world
    R, C = ny * h, nx * w
    vol = dict(halo_bytes=0, comm_bytes=0, comm_calls=0)

    def exchange(d, itemsize):
        for axis, n, size, across, lines in ((0, ny, h, w, nx), (1, nx, w, h + 2 * d, ny)):
            for t, s, k in _axis_strips(n, size, d):
                nbytes = k * across * itemsize
                for j in range(lines):
                    src, dst = (s * nx + j, t * nx + j) if axis == 0 else (j * nx + s, j * nx + t)
                    vol["halo_bytes"] += nbytes
                    if src // per_rank != dst // per_rank:
                        vol["comm_bytes"] += nbytes
                        vol["comm_calls"] += 1

    for d in downslope_halos:
        exchange(d, dem_bytes)
        exchange(d, fdr_bytes)
        if d < max(R, C):
            vol["comm_bytes"] += 4 * world
            vol["comm_calls"] += world
    exchange(1, dem_bytes)
    vol["comm_bytes"] += world * per_rank * 8 * 2 * (h + w) * 4
    vol["comm_calls"] += world
    return vol


def null_program(blocks, sweeps=NULL_SWEEPS):
    """The zero-collective baseline: ``sweeps`` elementwise sweeps
    ``v * 1.000001 + 0.5`` over a float32 copy of each block."""
    for t in blocks:
        v = t.to(torch.float32, copy=True)
        for _ in range(sweeps):
            v.mul_(1.000001).add_(0.5)


# ---------------------------------------------------------------------------
# A rank
# ---------------------------------------------------------------------------


def timed_runs(staged, cfg, mesh, shape, fac0, iters):
    """``iters`` runs of ``sharded_suite(..., crop=False)`` on this rank's
    ``staged`` blocks (dem, fdr, fac, river), each after a barrier.
    Returns dict(seconds: the median run, host clock to the synchronised
    device; stage_ms: each stage's median (CUDA events, the host clock on
    the CPU); collective: the halo bytes, bytes handed to the group and its
    calls of one run; downslope_halos: its attempts' halos).  Raises when
    two runs moved different bytes."""
    walls, stage_ms, counted = [], [], []
    for _ in range(iters):
        stats = {}
        hook, read = ranks.stage_timer(mesh.device)
        ranks.barrier_start(mesh)
        t0 = time.perf_counter()
        out = sharded_suite(staged["dem"], staged["fdr"], staged["fac"], staged["river"], cfg, mesh, shape=shape,
                            fac0=fac0, crop=False, stage_hook=hook, stats=stats)
        ranks.sync(mesh.device)
        walls.append(time.perf_counter() - t0)
        del out
        stage_ms.append(read()[0])
        counted.append(({k: stats.get(k, 0) for k in COUNTS}, [a["halo"] for a in stats["downslope_attempts"]]))
    if any(c != counted[0] for c in counted):
        raise AssertionError(f"rank {mesh.rank}: the runs moved different bytes: {counted}")
    return dict(seconds=statistics.median(walls),
                stage_ms={k: statistics.median(m[k] for m in stage_ms) for k in STAGES},
                collective=counted[0][0], downslope_halos=counted[0][1])


def valid_share(dem, shape):
    """The share of this rank's cells inside the grid ``shape`` whose dem
    (a ShardedRaster) is not NoData."""
    valid = cells = 0
    for b, t in dem.blocks.items():
        ys, ye, xs, xe = dem.window(b)
        inside = t[: max(0, min(ye, shape[0]) - ys), : max(0, min(xe, shape[1]) - xs)]
        valid += int((inside != NODATA).sum())
        cells += inside.numel()
    return valid / cells if cells else 0.0


def worker(spec):
    """One rank of a group: stage this rank's blocks from the memmaps, time
    the suite and the null baseline, print the rank's result."""
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.parallel import make_mesh, multihost

    rank, world, iters = spec["rank"], spec["world"], spec["iters"]
    dev = ranks.rank_device(spec["device"], rank, world)
    multihost.initialize(f"tcp://localhost:{spec['port']}", world_size=world, rank=rank, device=str(dev))
    try:
        mesh = make_mesh(tuple(spec["mesh"]), device=dev)
        shape = tuple(spec["grid"])
        loaders = c5.disk_loaders(spec["input_cache"])
        cfg = pipeline.PipelineConfig()
        t0 = time.perf_counter()
        staged = {k: multihost.stage_padded(mesh, shape, fill, loaders[k], dt) for k, fill, dt in STAGED}
        ranks.sync(dev)
        staging_s = time.perf_counter() - t0
        fac0 = float(loaders["fac"](0, 1, 0, 1)[0, 0])
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def null_once(dem_blocks):
            ranks.barrier_start(mesh)
            t0 = time.perf_counter()
            null_program(dem_blocks)
            ranks.sync(dev)
            return time.perf_counter() - t0

        timed_runs(staged, cfg, mesh, shape, fac0, 1)  # warm-up: the library's load, the group's first transfers
        reset_launch_counters()
        runs = timed_runs(staged, cfg, mesh, shape, fac0, iters)
        launches = {k: v // iters for k, v in launch_counters().items() if k in KERNELS}
        dem_blocks = [staged["dem"].blocks[b] for b in mesh.blocks]
        null_once(dem_blocks)
        null_s = [null_once(dem_blocks) for _ in range(iters)]
        ranks.print_result(dict(
            runs,
            rank=rank,
            device=str(dev),
            backend=mesh.backend,
            blocks=list(mesh.blocks),
            valid_share=valid_share(staged["dem"], shape),
            staging_s=staging_s,
            null_s=statistics.median(null_s),
            launches_per_run=launches,
            peak_device_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        ))
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


def run_group(per_card, world, args):
    """The row's ranks, started together; [(output, result)] by rank."""
    block, mesh = mesh_of(per_card, world)
    spec = dict(port=ranks.free_port(), world=world, device=args.device, mesh=mesh,
                grid=[mesh[0] * block, mesh[1] * block], input_cache=args.input_cache, iters=args.iters)
    return ranks.run_ranks(
        lambda r: [os.path.abspath(__file__), "--worker", json.dumps(dict(spec, rank=r))],
        world, RANK_TIMEOUT_S, cwd=ROOT, env=ranks.child_env(ROOT),
    )


def in_core_seconds(input_cache, shape, device, iters, fits):
    """(median seconds, peak bytes) of ``pipeline.descriptor_suite`` over
    the grid on one device (inputs on it, one warm-up), or (None, reason)
    when ``fits(cells)`` says it would not fit or the card runs out."""
    cells = shape[0] * shape[1]
    why = fits(cells)
    if why:
        return None, why
    loaders = c5.disk_loaders(input_cache)
    full = {k: np.array(loaders[k](0, shape[0], 0, shape[1])) for k in ("dem", "fdr", "fac", "river")}
    cfg = pipeline.PipelineConfig()
    try:
        inputs = pipeline.inputs_to_torch(full["dem"], full["fdr"], full["fac"], full["river"], device)
        del full
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for i in range(iters + 1):
            ranks.sync(device)
            t0 = time.perf_counter()
            out = pipeline.descriptor_suite(*inputs, cfg)
            ranks.sync(device)
            if i:
                times.append(time.perf_counter() - t0)
            del out
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        return statistics.median(times), peak
    except torch.cuda.OutOfMemoryError as e:
        return None, f"out of device memory: {str(e).splitlines()[0]}"
    finally:
        inputs = None
        if device.type == "cuda":
            torch.cuda.empty_cache()


def build_row(per_card, world, results, first):
    """The JSON row of one (per-card, N) from its ranks' results; ``first``
    is the N = 1 row of the same per-card size (None for N = 1 itself)."""
    block, mesh = mesh_of(per_card, world)
    rows, cols = mesh[0] * block, mesh[1] * block
    seconds = max(r["seconds"] for r in results)
    stage = {k: max(r["stage_ms"][k] for r in results) / 1e3 for k in STAGES}
    null_s = max(r["null_s"] for r in results)
    measured = {k: sum(r["collective"][k] for r in results) for k in COUNTS}
    halos = results[0]["downslope_halos"]
    counted = collective_volume_bytes(mesh, world, block, block, halos)
    t1 = seconds if first is None else first["seconds"]
    stage1 = stage if first is None else {k: v["seconds"] for k, v in first["phases"].items()}
    null1 = null_s if first is None else first["null_baseline_seconds"]
    eff_null = null1 / null_s
    total = sum(stage.values())
    return dict(
        mesh=f"{mesh[0]}x{mesh[1]}",
        devices=world,
        per_shard=per_card,
        block=block,
        blocks_per_rank=mesh[0] * mesh[1] // world,
        grid=[rows, cols],
        cells=rows * cols,
        seconds=seconds,
        grid_points_per_s=rows * cols / seconds,
        weak_scaling_efficiency=t1 / seconds,
        null_baseline_seconds=null_s,
        null_baseline_efficiency=eff_null,
        phases={
            k: dict(seconds=v, fraction=v / total, weak_scaling_efficiency=stage1[k] / v,
                    vs_null_baseline=stage1[k] / v / eff_null)
            for k, v in stage.items()
        },
        collective_bytes=measured,
        collective_bytes_counted=counted,
        collective_bytes_match=measured == counted,
        downslope_halos=halos,
        valid_share_per_rank=[r["valid_share"] for r in results],
        launches_per_run_per_rank=[r["launches_per_run"] for r in results],
        staging_s_per_rank=[r["staging_s"] for r in results],
        peak_device_GiB_per_rank=[None if r["peak_device_bytes"] is None else r["peak_device_bytes"] / 2**30
                                  for r in results],
        rank_devices=[r["device"] for r in results],
        backend=results[0]["backend"],
    )


def derive_conclusion(rows):
    """For each per-card size, the verdict at its largest N: whether
    BASELINE's >= 80 % holds, and the stage that loses the most time
    against N = 1, with its share of the loss and of the run."""
    verdicts = []
    for per_card in sorted({r["per_shard"] for r in rows}):
        mine = [r for r in rows if r["per_shard"] == per_card]
        one, big = mine[0], max(mine, key=lambda r: r["devices"])
        if big["devices"] < 2:
            verdicts.append(dict(per_card=per_card, devices=1, holds=None,
                                 text=f"per-card {per_card}^2: one card only; no efficiency at N >= 2"))
            continue
        loss = {k: v["seconds"] - one["phases"][k]["seconds"] for k, v in big["phases"].items()}
        worst = max(loss, key=loss.get)
        total_loss = big["seconds"] - one["seconds"]
        holds = big["weak_scaling_efficiency"] >= TARGET
        text = (f"per-card {per_card}^2 at N = {big['devices']} ({big['mesh']}, {big['cells']} cells): "
                f"efficiency {big['weak_scaling_efficiency']:.4f} "
                f"({'holds' if holds else 'misses'} BASELINE's >= {TARGET:.0%})")
        if total_loss > 0:
            text += (f"; the {worst} stage loses the most, {loss[worst] * 1e3:.3f} ms "
                     f"({loss[worst] / total_loss:.0%} of the {total_loss * 1e3:.3f} ms lost), and is "
                     f"{big['phases'][worst]['fraction']:.0%} of the stages' time at N = {big['devices']}")
        text += (f"; valid cells a rank {max(one['valid_share_per_rank']):.3f} at N = 1 against up to "
                 f"{max(big['valid_share_per_rank']):.3f} at N = {big['devices']} (the windows are not alike)")
        verdicts.append(dict(per_card=per_card, devices=big["devices"], efficiency=big["weak_scaling_efficiency"],
                             holds=holds, losing_stage=worst if total_loss > 0 else None,
                             losing_share=loss[worst] / total_loss if total_loss > 0 else None, text=text))
    return verdicts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-card", type=int, nargs="+", default=[8192, 16384],
                    help="rows = cols of each card's share (one set of rows each)")
    ap.add_argument("--cards", type=int, default=1, help="the largest N (cards; processes on --device cpu)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--input-cache", default=os.path.join(ROOT, ".config5_inputs"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-json", help="also write the summary line to this file")
    args = ap.parse_args(argv)
    args.input_cache = os.path.abspath(args.input_cache)  # the ranks run from the repository's root

    device = pipeline.check_device(args.device)
    if device.type == "cuda":
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"weak_scaling_torch: --cards {args.cards} needs {args.cards} CUDA devices, "
                             f"found {torch.cuda.device_count()}")
        from descriptools_tpu_torch.ops.cuda import build

        build.build()  # once, before the ranks start: each would build it otherwise
        device = torch.device("cuda", 0)
    worlds = world_sizes(args.cards)
    side = max(max(mesh_of(p, n)[1]) * mesh_of(p, n)[0] for p in args.per_card for n in worlds)
    prep_s, cache_side = c5.ensure_inputs(side, args.seed, args.input_cache, workers=PREP_WORKERS)
    fac_max = c5.max_fac(args.input_cache, side, side)
    if fac_max >= F32_EXACT:
        raise SystemExit(f"weak_scaling_torch: max fac {fac_max} >= 2^24 is not exact in the flow stage's float32")
    card = c5.card_line() if device.type == "cuda" else None
    print(f"inputs: {cache_side}^2 (seed {args.seed}) in {args.input_cache}, prep {prep_s:.3f} s; max fac {fac_max}; "
          f"card {card}", flush=True)

    rows, failures = [], []
    for per_card in args.per_card:
        first = None
        for world in worlds:
            t0 = time.perf_counter()
            res = [r for _, r in run_group(per_card, world, args)]
            row = build_row(per_card, world, res, first)
            row["group_wall_s"] = time.perf_counter() - t0
            first = first or row
            rows.append(row)
            if not row["collective_bytes_match"]:
                failures.append(f"{row['mesh']} per-card {per_card}: measured {row['collective_bytes']} != counted "
                                f"{row['collective_bytes_counted']}")
            ph = "  ".join(f"{k} {v['seconds'] * 1e3:.3f} ms (e {v['weak_scaling_efficiency']:.3f})"
                           for k, v in row["phases"].items())
            print(f"per-card {per_card}^2 N={world} mesh {row['mesh']} grid {row['grid'][0]}x{row['grid'][1]}: "
                  f"{row['seconds'] * 1e3:.3f} ms, {row['grid_points_per_s'] / 1e6:.2f} M grid-points/s, eff "
                  f"{row['weak_scaling_efficiency']:.4f}, null eff {row['null_baseline_efficiency']:.4f}; {ph}; "
                  f"bytes {row['collective_bytes']} (counted: "
                  f"{'equal' if row['collective_bytes_match'] else row['collective_bytes_counted']}); peak GiB "
                  f"{row['peak_device_GiB_per_rank']}; valid cells a rank {row['valid_share_per_rank']}", flush=True)

    # The same grids in core on one device, smallest first; a grid is left
    # out where the peak bytes a cell of the largest one run so far say it
    # would not fit the card.
    per_cell = []
    total = torch.cuda.get_device_properties(device).total_memory if device.type == "cuda" else None

    def fits(cells):
        if total and per_cell and max(per_cell) * cells > total:
            return (f"does not fit one card: {max(per_cell) * cells / 2**30:.1f} GiB predicted at "
                    f"{max(per_cell):.1f} B a cell, {total / 2**30:.1f} GiB on the card")
        return None

    single = {}
    for grid in sorted({tuple(r["grid"]) for r in rows}, key=lambda g: g[0] * g[1]):
        seconds, peak = in_core_seconds(args.input_cache, grid, device, args.iters, fits)
        single[grid] = (seconds, peak)
        if isinstance(peak, int):
            per_cell.append(peak / (grid[0] * grid[1]))
    for r in rows:
        seconds, peak = single[tuple(r["grid"])]
        r["single_device_seconds"] = seconds
        r["decomposition_overhead_vs_single_device"] = None if seconds is None else r["seconds"] / seconds
        if seconds is None:
            r["single_device_note"] = peak
        else:
            r["single_device_peak_GiB"] = None if peak is None else peak / 2**30

    summary = dict(
        script="weak_scaling_torch.py",
        device=args.device,
        card=card,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        cards=args.cards,
        iters=args.iters,
        metric="median over runs on each rank, then the maximum over the ranks",
        clock=("stages: CUDA events; seconds: host clock around the run, ended by a synchronise"
               if device.type == "cuda" else "host clock (CPU ranks): not a device measurement"),
        inputs=dict(seed=args.seed, side=cache_side, prep_s=prep_s, prep_workers=PREP_WORKERS, max_fac=fac_max),
        note=("one process a card, one rank each; the work a card is fixed, the grid grows with the cards. "
              "host_serialization_ceiling and fraction_of_ceiling of the JAX script are left out: they bound "
              "virtual devices that share a host's cores, and a card runs its own program"),
        weak_scaling=rows,
        conclusion=derive_conclusion(rows),
        failures=failures,
        ok=not failures,
    )
    line = json.dumps(summary)
    print(line)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(line + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(json.loads(sys.argv[2]))
    else:
        sys.exit(main())
