#!/usr/bin/env python3
"""Drive the PyTorch port (descriptools_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --cards 4  # the staged scale script over NCCL, a rank a card, and weak scaling
    python3 chip_smoke.py --link-probes  # the host link's copy/kernel overlap probes alone
    python3 chip_smoke.py --long-drainage  # the long-drainage parity phase alone
    python3 chip_smoke.py --float-dem  # the float-DEM phase alone
    python3 chip_smoke.py --d8  # terrain's D8 kernel phase alone

Phases, each printing its own lines:

0. device and toolchain: the card (name and power limit from nvidia-smi),
   torch and CUDA versions, nvcc, the build of ``csrc/*.cu`` with each
   stencil kernel's registers, stack and spills, the stencils' own SASS
   instructions a cell (``cuobjdump -sass`` of the built library), the
   least operations a cell their function needs (``stencil_floor``) and
   the card's issue rate, which give their bound;
1. every CUDA kernel against its plain PyTorch version on the card, at the
   basin's shape (2178x1534, synthetic) and on adversarial fixtures (for
   the stencils: NaN, +-inf, +-0.0, -100 and tied elevations at 1x1, 3x5,
   17x33 and 2178x1534, padded blocks of those and of 4096x4096, fac int32
   and float32; long northward walks, with and without ascending bumps;
   for the downslope kernel ``utils.synthetic.downslope_cases`` (NoData
   starts and targets, border exits, invalid codes, fdr int16, int32 and
   int64 with 257 and -1, a terminal that holds its walks still,
   fractional terminal stops) and the basin with fdr int32; a lateral
   channel; a 40000-step serpentine, under and over the cap; 2-cell
   cycles; NaN absorbers; northward flow into a river row every 101
   rows; rows that reach the jump walk's cap at B * 2^5 - 1, + 0 and + 1
   steps; for the fold walk, rows that reach its cap at W * 5 - 1, + 0 and
   + 1 steps, the edges of its bands); one flow walk under
   ``torch.cuda.set_sync_debug_mode("error")``; the tiled path's kernels
   on tile operands (basin windows and tiles, a lateral channel cut into
   tiles, a flat eastward walk, a ramp and adversarial windows cut by a
   window edge, the tracked downslope at halos 0 and 8);
2. the in-core path: ``descriptor_suite`` on CUDA tensors (the kernels
   run), then ``classify_flood``, held against the ``engine="torch"`` run
   on the same card, with every kernel's launch count checked; the
   one-card exact classifier (``parallel.classify.sharded_classify_flood``)
   identical to the host ``classify_flood``, and
   ``calibration(backend="torch")`` identical to its own CPU run, timed;
2b. the North star's parity: the suite through K2, K3 and K4 (launch
   counters read) and the one-card classifier at 2178x1534 (phase 2's run)
   and 4096x4096, held to the JAX package's results in
   ``tests/data/north_star_reference.npz`` (``utils.parity.check``: sha256
   of the inputs, indices, HAND, downslope and class map; threshold, Fit
   and Correctness identical; each float raster within its tolerance at
   the sampled cells, its -100/NaN/inf counts exact, its sums within the
   bound the tolerance implies), with the largest error of each raster and
   the suite's time at 4096x4096;
2c. long drainage (``phase_long_drainage``): terrain-derived rivers whose
   walks run hundreds of steps (``synthetic_dem`` with a wide blur and a
   steep ramp, fdr and fac from ``derive_terrain`` on the card, river
   ``fac > T``), held to the JAX package's results in
   ``tests/data/long_drainage_reference.npz`` at 2178x1534 and 4096x4096:
   the inputs' sha256 (fdr and fac JAX's), the walks' statistics, the
   suite under ``engine="cuda"`` and ``"cuda_blocked"`` and the one-card
   classifier (``utils.parity.check`` with each engine's fdist order:
   the count engine within ``parity.count_bound`` of JAX's xla fdist, the
   fold engine bitwise JAX's right fold), the jump walk's pending cells
   and R, the fold's P and K (the phase fails on no pending cell or K =
   0), the suites' and the downslope kernel's times, ``jump_profile`` and
   ``fold_profile`` on the suite's operands; at 4096x4096 ``tiled_suite``
   in 1024x1024 tiles and ``sharded_suite`` on mesh (4, 4), bitwise the
   count engine's suite, each with a downslope retry, timed;
3. timing: the suite and each kernel beside its plain version and its
   bound, median of 5 runs after one warm-up, with CUDA events, and the
   stencil's device time (torch.profiler); a torch.profiler check that the
   in-core downslope stage's device work is one kernel, the downslope
   walks' steps (mean, max; from the plain engine), the downslope kernel
   on the 100-step ramp; the jump
   walk on the basin, the north rivers (walks of 0 to 100 steps), the
   lateral channel and the serpentine: its time (CUDA events), its phase 1
   and rounds apart (device time by kernel from torch.profiler), R and the
   cells entering each round; the fold walk (K7) on the same four: its
   time, K (its rounds), P (the cells folded in rounds) and its device time
   by step (the jump walk, the fold start, the sort, the rounds, the host
   read); the JAX package's cross-check engines on the basin, plain torch
   ops timed with CUDA events: flow ``method="doubling"`` and ``"hybrid"``
   (indices bitwise the count engine's through K4) and downslope
   ``method="descent"`` (within rtol 1e-4, atol 1e-5 of K3's);
4. the out-of-core path: ``tiled_suite`` at 8192x8192 in 4096x4096 tiles
   through the tile kernels, held against the in-core suite of the same
   grid; a forced truncation retry; ``tiled_classify_flood`` against
   ``classify_flood``; pass times, host<->device bytes and the tile
   kernels against their plain versions on one 4096x4096 tile's operands,
   checked and timed, with the padded stencil's device time and a
   torch.profiler check that the tracked downslope call is one kernel;
   ``verify.streaming_flow_invariants`` over every cell of the tiled
   outputs (0 violations);
4c. BASELINE config 5's path (``config5_torch.run`` with its defaults: the
   four link knobs on, as in the JAX script) at 8192x8192 in 4096x4096
   tiles in a temporary directory under ``build/``, phase 4's arrays
   written to the memmaps: launch counters of K5 and K6 (K1 is not
   launched: the writer thread recomputes all of its rasters), the sample
   checks against the float64 oracle, the streaming invariants, the
   classifier; indices, HAND, downslope, slope and fdist bitwise phase 4's
   knob-off tiled outputs, slope_rad, TWI, mod-TWI, GFI and ln(hl/H)
   within TRANSCENDENTAL; pass C's downloads 18 B a cell, plus one byte a
   tile of truncation flags and the retries' downloads, printed apart;
   wall, passes, waits, link and disk rates, peak memory;
4b. the multi-card layer (``parallel``, torch.distributed) on one card:
   ``sharded_suite`` at 8192x8192 (phase 4's inputs) on mesh (2, 4), eight
   4096x2048 blocks on one rank, a world of one over NCCL, through K1, K5
   and K6 (launch counters: blocks x attempts), held per block against
   the in-core suite (indices, HAND, downslope, slope, fdist bitwise),
   then ``sharded_classify_flood`` on the mesh identical to the one-card
   classifier; stage times (CUDA events), halo and group bytes, peak
   device memory, the flow stage by device activity; a forced downslope
   retry past 32-column blocks on mesh (1, 8);
4d. the scale scripts, each in processes of its own as a user runs them:
   ``weak_scaling_torch.py --per-card 4096 --cards 1`` (a world of one
   over NCCL on phase 4's inputs, written to memmaps) and
   ``staged_scale_torch.py`` in its default mode on two gloo ranks on this
   card at the basin's shape, mesh (2, 4), with checkpoints and a resume
   (the staged suite with a flood loader, every rank's blocks against the
   in-core suite and the one-card classifier); their JSON lines read: the
   counted collective bytes equal to the measured, K1, K5 and K6 launched
   once a block (K6 once a block an attempt), every check ``ok``;
5. the large-grid entry point: ``descriptor_suite(engine="cuda_blocked")``
   at the basin's shape against ``engine="torch_blocked"``; then
   ``run_suite_checkpointed(engine="cuda_blocked")`` at 8192x8192 (phase
   4's in-core inputs), killed inside its flow stage and resumed, held
   bitwise against an uninterrupted ``descriptor_suite`` of the same grid,
   with stage seconds, checkpoint bytes and peak device memory (and the
   in-core ``cuda_blocked`` suite's peak); the fold kernel against its
   plain version there, checked and timed, with its device time by step;
6. the reference API: the reference example's script through ``compat``
   on the card (the downslope and jump-walk kernels) against the same
   script with ``device="cpu"``;
7. an oracle probe: the card's suite on a crop of the basin against the
   float64 ``oracle`` (integers exact, floats within rtol 2e-5);
8. BASELINE config 3 at 10000x10000: first the accumulation's C entry
   against ``flow_accumulation_plain`` on the D8 successor of each tile
   cell's DEM (``accumulation_on_tile_mixes``: ``dem_to_classmap``, int32,
   and ``float_dem_to_classmap``, float32): fac, stats and the jumped
   successor bitwise, ``derive_terrain`` launching it once, each timed
   (CUDA events) with its device time by activity, its peak device memory
   and its bound, 8 B a cell (succ read, fac written); then
   ``derive_terrain`` on ``synthetic_dem(10000, 10000, seed=0)`` (int32),
   timed with its D8 kernel, its rounds and peak memory; fdr
   bitwise the CPU's, fac held by the donor-sum identity over every cell
   (and bitwise the CPU's at 2178x1534); the river ``fac > RIVER_FAC``;
   the suite through K2/K3/K4 (launch counters read) against
   ``engine="torch"``; the one-card classifier on a seeded flood map
   against the host ``tiled_classify_flood``, both timed;
8b. a float DEM at the LiDAR cell's size (``phase_float_dem``): the
   cell's own mix (``benchmark/traffic/float_dem_to_classmap.json``,
   ``float_dem`` at 10000x10000, unrounded float32 metres) through
   ``derive_terrain`` and the suite with the cell's settings; K3 on that
   DEM bitwise ``_downslope_jacobi``, with the walks that stop at a
   terminal of fractional elevation counted (the phase fails on none);
   the one-card classifier on its float HAND, launch counters reset just
   before (``cutoff_count`` 5 launches, no other kernel), identical to the
   benchmark's float64 reference; each counting pass's cutoffs again
   through ``cutoff_count`` and ``cutoff_count_plain`` on the same card
   tensors, bitwise, each timed (CUDA events) with the kernel's device
   time and its bound, 8 B a cell (hand f32, flood int32) at the card's
   memory rate;
8c. terrain's D8 kernel at the tile cells' size (``phase_d8``): the DEMs
   of both tile cells' mixes (``dem_to_classmap``, int32, and
   ``float_dem_to_classmap``, float32, at 10000x10000): ``derive_terrain``
   with the launch counters reset just before (``d8_successor`` 1 launch,
   the accumulation 1, no other kernel); ``d8_successor`` and
   ``d8_successor_plain`` on the same card tensor, fdr and succ bitwise,
   each timed (CUDA events) with the kernel's device time and its bound,
   12 B a cell (dem 4 read, fdr and succ 4 each written) at the card's
   memory rate;
9. the measuring entry points: ``bench_torch.py`` in a process of its
   own, as a user runs it, its JSON line read (every key of ``bench.py``'s
   line, engine "cuda", K2, K3 and K4 launched once a suite it ran,
   ``correct`` with parity against the JAX reference); then
   ``bench_configs_torch``'s configs 2 (the suite and the stencil alone at
   4096x4096) and 4 (the calibration at 2178x1534, its threshold the same
   as ``calibration(backend="torch")`` of phase 2's HAND on the CPU).

``--long-drainage`` runs phases 0 and 2c alone; ``--float-dem`` phases 0
and 8b; ``--d8`` phases 0 and 8c; ``--accumulation`` phase 0 and phase
8's ``accumulation_on_tile_mixes``.

``--link-probes`` runs only the host link's probes, on phase 4's grid:
``tiled_suite`` at 8192x8192 with and without ``upload_in_prefetch`` under
torch.profiler (the host-to-device copies' device time, how much of it ran
beside kernels and beside device-to-host copies, the streams of each), and
whether a 256 MiB upload from pageable or pinned host memory on another
thread's stream runs beside a pageable download or beside kernels (CUDA
events).

The run prints its length; the line before the last is a JSON object
with one entry per kernel (the launches of K1, K5 and K6 are the tiled
phase's; the sharded phase prints and checks its own); the last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits non-zero and prints no result, as it does where CUDA is
not available.
"""

import importlib.metadata
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, COLS = 2178, 1534  # the bundled basin's shape
TRANSCENDENTAL = dict(rtol=2e-5, atol=1e-4)  # atanf/tanf/logf/powf ulps
REPEATS = 5

KERNELS = {
    "stencil": dict(
        source="descriptools_tpu_torch/csrc/stencil.cu",
        replaces="descriptools_tpu/ops/pallas/stencil.py:103",
    ),
    "downslope_walk": dict(
        source="descriptools_tpu_torch/csrc/walk.cu",
        replaces="descriptools_tpu/ops/pallas/walk_vmem.py:506",
    ),
    "flow_walk": dict(
        source="descriptools_tpu_torch/csrc/walk.cu",
        replaces="descriptools_tpu/ops/pallas/walk_vmem.py:264",
    ),
    "stencil_padded": dict(
        source="descriptools_tpu_torch/csrc/stencil.cu",
        replaces="descriptools_tpu/ops/pallas/stencil.py:40",
    ),
    "absorbing_walk": dict(
        source="descriptools_tpu_torch/csrc/walk.cu",
        replaces="descriptools_tpu/ops/pallas/walk_vmem.py:704, descriptools_tpu/ops/pallas/walk.py:461",
    ),
    "downslope_walk_tracked": dict(
        source="descriptools_tpu_torch/csrc/walk.cu",
        replaces="descriptools_tpu/ops/pallas/walk.py:120, descriptools_tpu/ops/pallas/walk_vmem.py:506 (trunc0 mode)",
    ),
    "flow_walk_blocked": dict(
        source="descriptools_tpu_torch/csrc/flow_fold.cu",
        replaces="descriptools_tpu/ops/pallas/walk.py:375",
    ),
    # The float-HAND calibration's counting pass: the JAX package has no
    # kernel for it (it calibrates float HAND on the host).
    "cutoff_count": dict(
        source="descriptools_tpu_torch/csrc/classify.cu",
        replaces=None,
    ),
    # Terrain's D8 and successor: the JAX package's D8 is jnp
    # (descriptools_tpu/d8.py:75), no Pallas kernel.
    "d8_successor": dict(
        source="descriptools_tpu_torch/csrc/terrain.cu",
        replaces=None,
    ),
    # Terrain's accumulation rounds: the JAX package's are jnp
    # (descriptools_tpu/ops/terrain.py:37), no Pallas kernel.
    "accumulation": dict(
        source="descriptools_tpu_torch/csrc/accumulation.cu",
        replaces=None,
    ),
}
IN_CORE = ("stencil", "downslope_walk", "flow_walk")
TILED = ("stencil_padded", "absorbing_walk", "downslope_walk_tracked")
BLOCKED = ("stencil", "downslope_walk", "flow_walk_blocked")  # engine="cuda_blocked"
BITWISE = ("indices", "hand", "downslope", "slope", "fdist")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
BIG = 8192  # the tiled phase's grid side: 67,108,864 cells
TILE = 4096  # the JAX package's default tile side
NORTH_STAR = 4096  # the North star's square grid; its other is the basin's shape
NORTH_STAR_REFERENCE = os.path.join(ROOT, "tests", "data", "north_star_reference.npz")
LONG_DRAINAGE_REFERENCE = os.path.join(ROOT, "tests", "data", "long_drainage_reference.npz")
LONG_TILE = 1024  # the long-drainage phase's tiles at 4096x4096: walks cross several
LONG_MESH = (4, 4)  # its mesh at 4096x4096: 1024x1024 blocks on one rank
CONFIG5_PROBE_BYTES = 1 << 30  # the config-5 phase's disk probe (config5_torch.py's default: 4 GiB)
# The H100 SXM's published memory rate (NVIDIA's data sheet) at 700 W:
# 3.35 TB/s, per ms.  The stencils' other bound is their operations: the
# least a cell needs (``stencil_floor``, phase 0) at one operation per lane,
# 4 warp instructions per SM per clock (issue_per_ms; the data sheet's 67
# TFLOP/s of float32 is this rate with an FMA counted twice).  A walk's
# least work is a few integer operations per cell, far under its bytes: its
# bound is the bytes.
HBM_BYTES_PER_MS = 3.35e9


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got, want):
    """Largest |got - want| over cells where both are finite (0 if none)."""
    got, want = got.double(), want.double()
    both = torch.isfinite(got) & torch.isfinite(want)
    if not bool(both.any()):
        return 0.0
    return float((got[both] - want[both]).abs().max())


def check_bitwise(label, got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want)) if got.is_floating_point() else got == want
    bad = int((~same).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} cells differ (bitwise check)")
    return max_abs_err(got, want) if got.is_floating_point() else 0.0


def check_close(label, got, want):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    ok = torch.isclose(got, want, equal_nan=True, **TRANSCENDENTAL)
    bad = int((~ok).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} cells outside rtol/atol {TRANSCENDENTAL}")
    return max_abs_err(got, want)


def median_ms(fn, repeats=REPEATS):
    """Median of ``repeats`` timed runs (CUDA events), after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def timed(inputs, fn, plain, operations_per_cell=0, issue=1.0):
    """The kernel call ``fn`` and its plain version ``plain`` (median_ms),
    with the call's bound: its inputs read once and its outputs written once
    at the card's memory rate, or ``operations_per_cell`` per output cell
    at the card's issue rate ``issue`` (thread instructions per ms),
    whichever takes longer."""
    outputs = fn()
    moved = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    by_bytes = moved / HBM_BYTES_PER_MS
    by_ops = operations_per_cell * outputs[0].numel() / issue
    return dict(ms=median_ms(fn), plain_ms=median_ms(plain), bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_ms=by_bytes, ops_ms=by_ops, cells=outputs[0].numel())


def device_events(fn, calls):
    """[(name, device us in all, records)] of each device activity (kernel,
    memset, copy) in ``calls`` calls of ``fn`` after one warm-up, traced by
    torch.profiler.  A trace can miss records, most at the start of a
    session: some 20 in a process that has run the 8192x8192 phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.device_type == DeviceType.CUDA and ev.count and us:
            events.append((ev.key, us, ev.count))
    return events


def device_ms(fn, launches):
    """Device time of one call of ``fn`` by kernel (``device_events`` of
    REPEATS calls).  ``launches`` maps a fragment of a kernel's name to its
    launches per call; each gets the mean time of the launches the trace
    holds times that number.  Returns ({name: ms, None where the trace
    holds none}, launches held, launches made)."""
    found = {name: [0.0, 0] for name in launches}
    for key, us, count in device_events(fn, REPEATS):
        for name in launches:
            if name in key:
                found[name][0] += us
                found[name][1] += count
    ms = {k: us / n / 1e3 * launches[k] if n else None for k, (us, n) in found.items()}
    return ms, sum(n for _, n in found.values()), REPEATS * sum(launches.values())


def device_kernels_ms(fn, calls=6 * REPEATS):
    """Device time of one call of ``fn`` by device activity
    (``device_events`` of ``calls`` calls, many, since a trace can miss the
    records a session starts with): {name: ms per call}, each the mean of
    the records held times its records per call (their count over
    ``calls``, rounded up)."""
    return {key: us / count / 1e3 * -(-count // calls) for key, us, count in device_events(fn, calls)}


def one_kernel(label, fn, name, card, calls=6 * REPEATS):
    """Fail unless all the device work of a call of ``fn`` is one launch of
    one kernel, whose name holds ``name`` (``device_events`` of ``calls``
    calls); print its device time a launch."""
    events = device_events(fn, calls)
    others = [key for key, _, _ in events if name not in key]
    mine = [(us, n) for key, us, n in events if name in key]
    held = sum(n for _, n in mine)
    if others or len(mine) != 1 or not 0 < held <= calls:
        raise AssertionError(f"{label}: device work {[(k, n) for k, _, n in events]}, not one {name} "
                             f"launch a call")
    print(f"device work of {label} (torch.profiler, {calls} calls): one kernel, {name}, "
          f"{mine[0][0] / held / 1e3:.4f} ms a launch ({held} launches in the trace)  [{card}]")


def sass_functions(lib):
    """{kernel's mangled name: [(address, SASS instruction), ...]} of a
    built library (``cuobjdump -sass``, NOPs left out)."""
    from descriptools_tpu_torch.ops.cuda import build

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = funcs.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", line)
        if ins and cur is not None and not ins.group(2).startswith("NOP"):
            cur.append((int(ins.group(1), 16), ins.group(2)))
    return funcs


def main_path(instructions):
    """The instructions from a kernel's entry to its first unpredicated
    EXIT: the code every thread runs, without the subroutines and cold
    blocks placed after it."""
    for n, (_, ins) in enumerate(instructions):
        if ins.split()[0] == "EXIT":
            return instructions[: n + 1]
    return instructions


def common_path_count(instructions, cells=1):
    """The kernel's own SASS instructions a cell, for its issue efficiency
    (not its bound): those of ``main_path`` less what ordinary
    cells skip: the stubs that call out of line (from the last branch
    before a CALL to the CALL: the IEEE division's slow path and the
    stencil's halo load for blocks at the source's edge) and, for each
    local-memory access (tanf's reduction of arguments past 105615), the
    innermost region a conditional branch jumps over that holds it.  Over
    the ``cells`` a thread computes; the loop over those cells, if the
    kernel keeps one, is the widest backward branch whose body stores
    (STG), and its instructions count ``cells`` times.  The halo's staging,
    index and loop arithmetic and powf's tests of special operands stay
    in: an upper estimate of what a thread runs."""
    path = main_path(instructions)
    forward, loops = [], []
    for addr, ins in path:
        target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if not target:
            continue
        to = int(target.group(1), 16)
        if to > addr and ins.startswith("@"):
            forward.append((addr, to))
        elif to < addr and any("STG" in i for a, i in path if to <= a <= addr):
            loops.append((addr - to, to, addr))
    _, lo, hi = max(loops, default=(0, 1, 0))
    skipped = set()
    for addr, ins in path:
        if re.match(r"(@\S+ )?(LDL|STL)\b", ins):
            spans = [(to - a, a, to) for a, to in forward if a < addr < to]
            if spans:
                _, a, to = min(spans)
                skipped.add((a, to))
    count = stub = 0
    for addr, ins in path:
        if any(a < addr < to for a, to in skipped):
            continue
        words = ins.split()
        op = words[1] if words[0].startswith("@") else words[0]
        weight = cells if lo <= addr <= hi else 1
        if op.startswith("CALL"):
            count, stub = count - stub, 0
            continue
        count += weight
        stub = 0 if op == "BRA" else stub + weight
    return count / cells


# The in-core downslope kernel the path launches (fdr uint8):
# downslope_kernel<false, unsigned char>.
DOWNSLOPE_SASS = "downslope_kernelILb0EhE"


def walk_step_instructions(lib):
    """SASS instructions of one step of the in-core downslope kernel's walk:
    the body of its backward branch (the loop over steps)."""
    for name, ins in sass_functions(lib).items():
        if DOWNSLOPE_SASS in name:
            loops = []
            for addr, i in ins:
                target = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", i)
                if target and int(target.group(1), 16) < addr:
                    loops.append(sum(1 for a, _ in ins if int(target.group(1), 16) <= a <= addr))
            if len(loops) != 1:
                raise AssertionError(f"{name}: {len(loops)} backward branches, expected the walk's loop")
            print(f"sass downslope_walk: {name}: {loops[0]} instructions a step of the walk")
            return loops[0]
    raise AssertionError(f"no {DOWNSLOPE_SASS} kernel in {lib}")


# The stencil kernels the path launches (fac int32), by a fragment of their
# mangled names: stencil_tile_kernel<false, int> and <true, int>.
STENCIL_SASS = {"stencil": "stencil_tile_kernelILb0EiE", "stencil_padded": "stencil_tile_kernelILb1EiE"}


def stencil_cells(root=ROOT):
    """Cells a thread of the checkout's tiled stencil kernel computes:
    ``kCells`` in its ``csrc/stencil.cu`` or in the ``csrc/tile.cuh`` that
    it includes, 1 where there is none (a kernel of one cell a thread)."""
    text = ""
    for name in ("stencil.cu", "tile.cuh"):
        path = os.path.join(root, "descriptools_tpu_torch", "csrc", name)
        if os.path.isfile(path):
            with open(path) as f:
                text += f.read()
    found = re.search(r"constexpr int kCells = (\d+);", text)
    return int(found.group(1)) if found else 1


def stencil_instructions(lib):
    """{kernel: its own common-path SASS instructions a cell} of the
    stencils in the built library ``lib`` (``common_path_count`` over the
    cells a thread computes), with a line for each."""
    cells = stencil_cells()
    per_cell = {}
    for name, ins in sass_functions(lib).items():
        for kernel, fragment in STENCIL_SASS.items():
            if fragment in name:
                per_cell[kernel] = common_path_count(ins, cells)
                print(f"sass {kernel}: {name}: {len(ins)} instructions, {len(main_path(ins))} from the "
                      f"entry to the first EXIT; {cells} cells a thread: {per_cell[kernel]:.2f} a cell "
                      f"on the common path (the kernel's own)")
    if sorted(per_cell) != sorted(STENCIL_SASS):
        raise AssertionError(f"sass: found {sorted(per_cell)} of the stencil kernels {sorted(STENCIL_SASS)}")
    return per_cell


# The stencil's least work a cell, for its bound: what the bitwise contract
# needs of any kernel (the 8 neighbours' minima with NoData left out, two
# IEEE divisions, fac's conversion, then atanf, tanf, two logf, powf and
# three divisions in the kernel's order) on values a thread already holds:
# no tile, halo, loop or NoData branch.  ``stencil_floor`` compiles it
# beside the library and counts it; it is never launched.
STENCIL_FLOOR_CU = r"""
#include "descriptools_tpu_torch/csrc/stencil.cu"

// One buffer of planes, each kPlane floats: the cell, then its neighbours
// E, SE, S, SW, W, NW, N, NE (planes 0-8), fac's int32 bits (9), then
// slope, slope_rad, TWI and mod-TWI (10-13).  Every address is one
// IMAD.WIDE and an immediate offset.
constexpr int kPlane = 1 << 16;

__global__ void stencil_cell_floor(float* __restrict__ p, float d_card, float d_diag, float px2,
                                   float n_topo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float* w = p + i;
  const float zc = w[0];
  float m_card = CUDART_INF_F;
  float m_diag = CUDART_INF_F;
#pragma unroll
  for (int k = 1; k < 9; k += 2) {
    m_card = least_valid(m_card, w[k * kPlane]);
    m_diag = least_valid(m_diag, w[(k + 1) * kPlane]);
  }
  const float f = fac_value(__float_as_int(w[9 * kPlane]));
  float best = 0.0f;
  const float g_card = __fdiv_rn(zc - m_card, d_card);
  if (g_card > best) best = g_card;
  const float g_diag = __fdiv_rn(zc - m_diag, d_diag);
  if (g_diag > best) best = g_diag;
  const float sl = best * 100.0f;
  const float sr = atanf(__fdiv_rn(sl, 100.0f));
  const float area = (f == 0.0f ? 1.0f : f) * px2;
  const float t = tanf(sr + kEps);
  w[10 * kPlane] = sl;
  w[11 * kPlane] = sr;
  w[12 * kPlane] = logf(__fdiv_rn(area, t));
  w[13 * kPlane] = logf(__fdiv_rn(powf(area, n_topo), t));
}
"""
# What the floor kernel leaves out and a cell still needs: the NoData tests
# of the cell and of fac and the four rasters' selects (6), one DEM and one
# fac load and four stores (6).
FLOOR_NODATA_AND_MEMORY = 12
# SASS that moves data or steers control rather than operate on a cell's
# values: loads and stores (counted in FLOOR_NODATA_AND_MEMORY), parameters,
# ids, addresses, register moves and constants, branches.
NOT_OPERATIONS = ("LDG", "STG", "LDC", "ULDC", "S2R", "S2UR", "IMAD.WIDE", "MOV", "IMAD.MOV", "UMOV",
                  "HFMA2.MMA", "BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET")


def fast_path_operations(instructions):
    """Operations on the shortest way through ``main_path`` from the
    kernel's entry to its EXIT: every conditional branch may go either way,
    a CALL (an out-of-line slow path) costs nothing, no backward branch is
    taken; an instruction counts 1 unless NOT_OPERATIONS names it.  For a
    kernel with no early exit this is the least any operand runs: the
    functions' fast paths, without their tests of special operands."""
    path = main_path(instructions)
    at = {addr: n for n, (addr, _) in enumerate(path)}
    cost = [float("inf")] * len(path)  # operations before instruction n
    cost[0] = 0
    for n, (addr, ins) in enumerate(path[:-1]):
        words = ins.split()
        guarded = words[0].startswith("@")
        op = words[1] if guarded else words[0]
        here = cost[n] + (0 if op.startswith(NOT_OPERATIONS) else 1)
        target = re.search(r"0x([0-9a-f]+)$", ins)
        if op.startswith("BRA") and target:
            to = int(target.group(1), 16)
            if to > addr and to in at:
                cost[at[to]] = min(cost[at[to]], here)
            if not (guarded or re.match(r"!?U?P\d", words[-2])):
                continue  # unconditional: no fall-through
        cost[n + 1] = min(cost[n + 1], here)
    return cost[-1]


def stencil_floor(lib):
    """The least operations a cell of the stencil's function:
    ``fast_path_operations`` of STENCIL_FLOOR_CU, compiled with the
    library's flags into a cubin beside ``lib``, plus
    FLOOR_NODATA_AND_MEMORY; printed with its parts."""
    from descriptools_tpu_torch.ops.cuda import build

    src = os.path.join(os.path.dirname(lib), "stencil_floor.cu")
    cubin = os.path.join(os.path.dirname(lib), "stencil_floor.cubin")
    with open(src, "w") as f:
        f.write(STENCIL_FLOOR_CU)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([build.find_nvcc(), *flags, "-cubin", "-I", ROOT, "-o", cubin, src],
                   capture_output=True, text=True, check=True)
    found = [ins for name, ins in sass_functions(cubin).items() if "stencil_cell_floor" in name]
    if len(found) != 1:
        raise AssertionError(f"sass: {len(found)} stencil_cell_floor kernels in {cubin}")
    ops = fast_path_operations(found[0])
    floor = ops + FLOOR_NODATA_AND_MEMORY
    print(f"floor stencil: stencil_cell_floor {len(main_path(found[0]))} instructions from the entry to "
          f"the EXIT, {ops} operations on the fast path, + {FLOOR_NODATA_AND_MEMORY} (NoData tests and "
          f"selects, one DEM and one fac load, four stores) = {floor} a cell")
    return floor


def issue_per_ms():
    """Thread instructions the card can issue per ms: its SMs, 4 warp
    instructions per SM per clock, 32 lanes, at its maximum SM clock."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * 32 * mhz * 1e3, sms, mhz


def jump_profile(cases, card):
    """The jump walk over walk operands (``absorbing_walk``, the local
    phase's entry) on each case, held bitwise against ``doubling_walk``:
    its time (CUDA events) beside the plain version's,
    its device time by phase (torch.profiler: the memset, phase 1 and the
    rounds), R and the cells entering each round (read after a
    synchronisation, here only)."""
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import walk

    bound = walk.jump_bound()
    for label, (ops, cap) in cases.items():
        want = flow.doubling_walk(*ops, cap)
        got = walk.absorbing_walk(*ops, cap)
        torch.cuda.synchronize()
        for name, g, w in zip(("code", "a", "b"), got, want):
            check_bitwise(f"jump/{label}/{name}", g, w)
        pending, rounds = walk.absorbing_walk.pending.tolist(), walk.absorbing_walk.rounds
        whole = median_ms(lambda: walk.absorbing_walk(*ops, cap))
        plain_ms = median_ms(lambda: flow.doubling_walk(*ops, cap))
        steps = got[1] + got[2]
        print(f"jump absorbing_walk {label}: B {bound}, R {rounds}, cells entering each round "
              f"{pending[:-1]} ({pending[0]} pending after phase 1); walk steps mean "
              f"{float(steps.float().mean()):.3f}, max {int(steps.max())}; kernel {whole:.3f} ms, "
              f"plain doubling_walk {plain_ms:.3f} ms  [{card}]")
        dev_ms, held, made = device_ms(lambda: walk.absorbing_walk(*ops, cap),
                                       {"Memset (Device)": 1, "jump_start": 1, "jump_round": rounds})
        shown = {k: "not measured" if v is None else f"{v:.4f} ms" for k, v in dev_ms.items()}
        print(f"jump device time {label} (torch.profiler, per call; the trace held {held} of {made} "
              f"launches): memset {shown['Memset (Device)']}, phase 1 {shown['jump_start']}, {rounds} rounds "
              f"{shown['jump_round']}  [{card}]")


FOLD_STEPS = {  # the fold walk's steps, by kernel-name fragment
    "Memset (Device)": "memsets", "jump_start": "jump walk phase 1", "jump_round": "jump walk rounds",
    "fold_start": "fold start", "band_histogram": "sort: histogram", "band_scan": "scan",
    "band_scatter": "scatter", "fold_round": "rounds", "Memcpy DtoH": "host read",
}


def fold_split(label, fn, card):
    """Device time of one ``flow_walk_blocked`` call ``fn`` by step
    (torch.profiler), printed with K and P (``fn`` gives the same every
    call)."""
    from descriptools_tpu_torch.ops.cuda import walk

    fn()
    fb = walk.flow_walk_blocked
    sort = 1 if fb.pending else 0
    launches = {"Memset (Device)": 2, "jump_start": 1, "jump_round": fb.jump_rounds, "fold_start": 1,
                "band_histogram": sort, "band_scan": sort, "band_scatter": sort, "fold_round": fb.rounds,
                "Memcpy DtoH": 1}
    dev_ms, held, made = device_ms(fn, {k: n for k, n in launches.items() if n})
    shown = ", ".join(
        f"{step} " + ("not launched" if not launches[name]
                      else "not measured" if dev_ms[name] is None else f"{dev_ms[name]:.4f} ms")
        for name, step in FOLD_STEPS.items()
    )
    print(f"fold device time {label} (torch.profiler, per call; K {fb.rounds}, P {fb.pending}; the trace "
          f"held {held} of {made} launches): {shown}  [{card}]")


def fold_profile(cases, card):
    """The fold walk (``flow_walk_blocked``, held bitwise against
    ``fold_walk`` in phase 1) on each case: its time (CUDA events) beside
    the plain version's (``plain_repeats`` runs), K, P, the jump walk's R
    and the device time by step."""
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import walk

    consts = flow.step_consts(12.5)
    for label, (ops, cap, plain_repeats) in cases.items():
        def fn():
            return walk.flow_walk_blocked(*ops, *consts, cap)

        whole = median_ms(fn)
        fb = walk.flow_walk_blocked
        plain_ms = median_ms(lambda: flow.fold_walk(*ops, *consts, cap), plain_repeats)
        print(f"time flow_walk_blocked {label}: kernel {whole:.3f} ms, plain fold_walk {plain_ms:.3f} ms "
              f"(median of {plain_repeats}); K {fb.rounds}, P {fb.pending}, jump walk R {fb.jump_rounds}  "
              f"[{card}]")
        fold_split(label, fn, card)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def basin_inputs():
    """The synthetic basin at the bundled basin's shape: every loader, one
    window."""
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    loaders = windowed_basin(ROWS, COLS, seed=0)
    return {k: f(0, ROWS, 0, COLS) for k, f in loaders.items()}


def tall_north(rows, cols, bump_every):
    """Northward walks across many rows; ascending bumps make the descent
    non-monotone."""
    dem = np.broadcast_to(
        np.round(np.arange(rows, dtype=np.float64) * 0.5 + 100.0)[:, None].astype(np.float32),
        (rows, cols),
    ).copy()
    if bump_every:
        dem[::bump_every, :] += 3.0
    return dem, np.full((rows, cols), 64, np.uint8)


def lateral_channel(rows=384, cols=128):
    """~500-step paths: east along each row, then north up the last column."""
    fdr = np.full((rows, cols), 1, np.uint8)
    fdr[:, -1] = 64
    river = np.zeros((rows, cols), np.int8)
    river[0, -1] = 1
    return fdr, river


def flat_east(rows, cols, bump):
    """A gentle eastward descent (0.01 m per cell, ed 5: 500-step walks);
    an ascending bump at one column makes it non-monotone."""
    dem = np.broadcast_to((1000.0 - 0.01 * np.arange(cols)).astype(np.float32), (rows, cols)).copy()
    if bump:
        dem[:, bump] += 3.0
    return dem, np.full((rows, cols), 1, np.uint8)


def serpentine(rows=200, cols=200):
    """One boustrophedon path of ~40000 steps to a single river cell."""
    fdr = np.zeros((rows, cols), np.uint8)
    for r in range(rows):
        fdr[r, :] = 1 if r % 2 == 0 else 16
        fdr[r, -1 if r % 2 == 0 else 0] = 4
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
    return fdr, river


def two_cell_cycles(rows=512, cols=640):
    """Eastward rows into a river column, cut by E<->W and S<->N pairs: the
    cells upstream of a pair never land."""
    fdr = np.full((rows, cols), 1, np.uint8)
    river = np.zeros((rows, cols), np.int8)
    river[:, -1] = 1
    fdr[10::37, 200], fdr[10::37, 201] = 1, 16
    fdr[30, 450], fdr[31, 450] = 4, 64
    return fdr, river


def north_rivers(rows, cols, spacing=101):
    """Northward flow into a river row every ``spacing`` rows: walks of 0 to
    spacing - 1 steps, about as long as a real basin's longest."""
    fdr = np.full((rows, cols), 64, np.uint8)
    river = np.zeros((rows, cols), np.int8)
    river[::spacing] = 1
    return fdr, river


def b_boundary(bound, k, delta, rows=64):
    """Eastward rows of bound * 2^k + 1 steps into a river column, at a cap
    of bound * 2^k + delta: the rows' first cells land only for delta > 0."""
    steps = (bound << k) + 1
    fdr = np.ones((rows, steps + 1), np.uint8)
    river = np.zeros((rows, steps + 1), np.int8)
    river[:, -1] = 1
    return fdr, river, (bound << k) + delta


def band_edge(width, k, delta, rows=64):
    """Eastward rows into a river column whose longest walks are width * k
    + 1, width * k and width * k - 1 steps (behind 0, 1 and 2 NaN
    absorbers), at a cap of width * k + delta: the fold's band edges."""
    fdr = np.ones((rows, width * k + 2), np.uint8)
    fdr[1::3, :1] = 0
    fdr[2::3, :2] = 0
    river = np.zeros(fdr.shape, np.int8)
    river[:, -1] = 1
    return fdr, river, width * k + delta


def nan_absorbers(rows=1000, cols=1200, seed=5):
    """Random D8 field: fdr-0 cells, border exits, river cells with fdr 0
    (NaN absorbers, not rivers) and a few river cells."""
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    fdr = codes[rng.integers(0, 8, size=(rows, cols))]
    fdr[rng.random((rows, cols)) < 0.04] = 0
    river = (rng.random((rows, cols)) < 0.04).astype(np.int8)
    fdr[7::50, 7] = 0
    river[7::50, 7] = 1
    return fdr, river


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (sm_90), found capability {cap}")
    from descriptools_tpu_torch.ops.cuda import build

    print(f"card: {card_line()}")
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "absent")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, triton {triton}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    lib, seconds, log = build.build()
    regs = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {os.path.relpath(lib, ROOT)} in {seconds:.1f} s; ptxas: {'; '.join(regs)}")
    lines = log.splitlines()
    for n, ln in enumerate(lines):
        if "Function properties for" in ln and "stencil_tile_kernel" in ln and n + 2 < len(lines):
            print(f"ptxas {ln.split()[-1]}: {lines[n + 1].strip()}; {lines[n + 2].split(':', 1)[-1].strip()}")
    own = stencil_instructions(lib)
    floor = stencil_floor(lib)
    step = walk_step_instructions(lib)
    issue, sms, mhz = issue_per_ms()
    print(f"issue rate: {sms} SMs x 4 warp instructions x 32 lanes x {mhz:.0f} MHz = {issue:.4g} thread "
          f"instructions per ms")
    return dict(own=own, floor=floor, issue=issue, walk_step=step)


def phase_kernels(dev, basin, errs):
    """Each kernel's wrapper on the card against its plain version."""
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk
    from descriptools_tpu_torch.utils.synthetic import adversarial_dem, downslope_cases

    def stencil_case(label, dem, fac, fac_dtype=np.int32):
        dem_f = torch.as_tensor(np.asarray(dem, np.float32), device=dev)
        fac_t = torch.as_tensor(np.asarray(fac, fac_dtype), device=dev)
        got = st.stencil(dem_f, fac_t, 12.5, 0.1)
        want = st.stencil_plain(dem_f, fac_t, 12.5, 0.1)
        e = check_bitwise(f"stencil/{label}/slope", got[0], want[0])
        for name, g, w in zip(st.NAMES[1:], got[1:], want[1:]):
            e = max(e, check_close(f"stencil/{label}/{name}", g, w))
        errs["stencil"] = max(errs["stencil"], e)
        print(f"kernel stencil        {label:<26} matches plain (slope bitwise, max_abs_err {e:.3g})")

    def downslope_case(label, dem, fdr, ed, max_steps):
        dem_f = torch.as_tensor(np.asarray(dem, np.float32), device=dev)
        fdr_t = torch.as_tensor(fdr, device=dev)
        got = walk.downslope_walk(dem_f, fdr_t, 12.5, ed, max_steps)
        want = down._downslope_jacobi(dem_f, fdr_t, 12.5, ed, max_steps)
        e = check_bitwise(f"downslope/{label}", got, want)
        errs["downslope_walk"] = max(errs["downslope_walk"], e)
        print(f"kernel downslope_walk {label:<36} matches plain bitwise (downslope)")

    def flow_case(label, fdr, river, max_steps):
        """K4 (``flow_cuda``, from the rasters) against the plain engine on
        fdist's bits and indices; the jump walk over the same operands
        (``absorbing_walk``) on code, a and b."""
        fdr_t, river_t = torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev)
        fdr_eff, code0 = flow.walk_inputs(fdr_t, river_t)
        want = flow.doubling_walk(fdr_eff, code0, max_steps)
        e = 0.0
        for name, g, w in zip(("fdist", "indices"), walk.flow_cuda(fdr_t, river_t, 12.5, max_steps),
                              flow.flow_from_state(*want, 12.5, max_steps)):
            e += check_bitwise(f"flow/{label}/{name}", g.view(torch.int32), w.view(torch.int32))
        errs["flow_walk"] = max(errs["flow_walk"], e)
        e = 0.0
        for name, g, w in zip(("code", "a", "b"), walk.absorbing_walk(fdr_eff, code0, max_steps), want):
            e += check_bitwise(f"jump/{label}/{name}", g, w)
        errs["absorbing_walk"] = max(errs["absorbing_walk"], e)
        print(f"kernel flow_walk      {label:<26} matches plain bitwise (fdist bits, indices; absorbing_walk's "
              f"code, a, b)")

    def fold_case(label, fdr, river, max_steps):
        fdr_eff, code0 = flow.walk_inputs(torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev))
        consts = flow.step_consts(12.5)
        got = walk.flow_walk_blocked(fdr_eff, code0, *consts, max_steps)
        rounds, pending = walk.flow_walk_blocked.rounds, walk.flow_walk_blocked.pending
        want = flow.fold_walk(fdr_eff, code0, *consts, max_steps)
        e = 0.0
        for name, g, w in zip(("code", "dist"), got, want):
            e = max(e, check_bitwise(f"fold/{label}/{name}", g, w))
        fd, idx = flow.flow_from_fold(*got)
        for name, g, w in zip(("fdist", "indices"), (fd, idx), flow.flow_from_fold(*want)):
            e = max(e, check_bitwise(f"fold/{label}/{name}", g, w))
        state = walk.absorbing_walk(fdr_eff, code0, max_steps)
        counts = walk.flow_cuda(torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev), 12.5,
                                max_steps)
        check_bitwise(f"fold/{label}/indices vs flow_cuda", idx, counts[1])
        # P and K follow from the depths.
        depth, width = state[1] + state[2], walk.fold_width()
        if pending != int((depth > width).sum()) or rounds != max(int(depth.max()) - 1, 0) // width:
            raise AssertionError(f"fold/{label}: K {rounds}, P {pending} disagree with the depths")
        start_steps = int(torch.where(depth > 0, (depth - 1) % width + 1, 0).sum())  # the fold start's
        errs["flow_walk_blocked"] = max(errs["flow_walk_blocked"], e)
        landed = int((idx != -100).sum())
        print(f"kernel flow_walk_blocked {label:<30} matches plain bitwise (code, dist, fdist, indices; "
              f"indices = flow_cuda's); K {rounds} rounds, P {pending} pending, {start_steps} fold-start "
              f"steps, {landed} of {idx.numel()} landed, fdist differs from counts on "
              f"{int((fd != counts[0]).sum())} cells")

    stencil_case(f"basin {ROWS}x{COLS}", basin["dem"], basin["fac"])
    stencil_case(f"basin {ROWS}x{COLS}, fac f32", basin["dem"], basin["fac"], np.float32)
    rng = np.random.default_rng(17)
    for shape in ((1, 1), (3, 5), (17, 33), (ROWS, COLS)):
        dem, fac = adversarial_dem(rng, shape), rng.integers(-150, 5000, size=shape)
        for dtype in (np.int32, np.float32):
            stencil_case(f"adversarial {shape[0]}x{shape[1]}, fac {np.dtype(dtype).name}", dem, fac, dtype)
    downslope_case(f"basin {ROWS}x{COLS}", basin["dem"], basin["fdr"], 5.0, 5000)
    flow_case(f"basin {ROWS}x{COLS}", basin["fdr"], basin["river"], 20000)
    for bump in (None, 37):
        dem, fdr = tall_north(320, 128, bump)
        stencil_case(f"tall north bump={bump}", dem, np.arange(dem.size).reshape(dem.shape) % 997)
        downslope_case(f"tall north bump={bump}", dem, fdr, 50.0, 600)
    downslope_case(f"tall north {ROWS}x{COLS}", *tall_north(ROWS, COLS, 37), 50.0, 5000)
    downslope_case(f"basin {ROWS}x{COLS}, fdr int32", basin["dem"], basin["fdr"].astype(np.int32), 5.0, 5000)
    for name, (dem, fdr, ed, max_steps) in downslope_cases().items():
        downslope_case(f"{name}, fdr {fdr.dtype}", dem, fdr, ed, max_steps)
        if fdr.dtype != np.uint8:  # the kernel's own validity test on int32
            downslope_case(f"{name}, fdr int32", dem, fdr.astype(np.int32), ed, max_steps)
    flow_case("lateral channel", *lateral_channel(), 1000)
    flow_case(f"lateral channel {ROWS}x{COLS}", *lateral_channel(ROWS, COLS), 20000)
    flow_case(f"north rivers {ROWS}x{COLS}", *north_rivers(ROWS, COLS), 20000)
    flow_case("serpentine 200x200", *serpentine(), 60000)
    flow_case("serpentine 200x200, cap 20000", *serpentine(), 20000)
    flow_case("2-cell cycles 512x640", *two_cell_cycles(), 20000)
    flow_case("NaN absorbers 1000x1200", *nan_absorbers(), 20000)
    for delta in (-1, 0, 1):
        fdr, river, cap = b_boundary(walk.jump_bound(), 5, delta)
        flow_case(f"B-boundary row, cap {cap}", fdr, river, cap)
    # No hidden host synchronisation in either jump walk entry's launches.
    raster = tuple(torch.as_tensor(t, device=dev) for t in lateral_channel(ROWS, COLS))
    fl = flow.walk_inputs(*raster)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = walk.absorbing_walk(*fl, 20000)
        fused = walk.flow_cuda(*raster, 12.5, 20000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = flow.doubling_walk(*fl, 20000)
    for name, g, w in zip(("code", "a", "b"), got, want):
        check_bitwise(f"jump/sync debug/{name}", g, w)
    for name, g, w in zip(("fdist", "indices"), fused, flow.flow_from_state(*want, 12.5, 20000)):
        check_bitwise(f"flow/sync debug/{name}", g.view(torch.int32), w.view(torch.int32))
    print(f"kernel flow_walk and absorbing_walk, lateral channel {ROWS}x{COLS} under sync debug mode 'error': "
          f"no host synchronisation, match plain bitwise")
    fold_case(f"basin {ROWS}x{COLS}", basin["fdr"], basin["river"], 20000)
    fold_case(f"lateral channel {ROWS}x{COLS}", *lateral_channel(ROWS, COLS), 20000)
    fold_case(f"north rivers {ROWS}x{COLS}", *north_rivers(ROWS, COLS), 20000)
    fold_case("serpentine 200x200, cap 60000", *serpentine(), 60000)
    fold_case("serpentine 200x200, cap 20000", *serpentine(), 20000)
    fold_case("2-cell cycles 512x640", *two_cell_cycles(), 20000)
    fold_case("NaN absorbers 1000x1200", *nan_absorbers(), 20000)
    for delta in (-1, 0, 1):
        fdr, river, cap = band_edge(walk.fold_width(), 5, delta)
        fold_case(f"band-edge rows, cap {cap}", fdr, river, cap)
    torch.cuda.synchronize()


def phase_slice(dev, basin):
    """The suite on CUDA tensors through the kernels, against the plain
    engine on the same card; then the calibration."""
    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters

    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig())
    torch.cuda.synchronize()
    launches = launch_counters()
    missing = [k for k in IN_CORE if launches[k] == 0]
    if missing:
        raise AssertionError(f"the suite launched no {missing} kernel")
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    for name in ("slope", "downslope", "fdist", "indices", "hand"):
        check_bitwise(f"suite/{name}", out[name], plain[name])
    for name in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        check_close(f"suite/{name}", out[name], plain[name])
    valid = inputs[0] != -100
    for name, t in out.items():
        if tuple(t.shape) != (ROWS, COLS):
            raise AssertionError(f"suite/{name}: shape {tuple(t.shape)}")
        # GFI is ln(0) = -inf where the river cell's fac is 0 (reference
        # semantics); every other float raster is finite on valid cells.
        v = t[valid]
        finite = (torch.isfinite(v) | (v == float("-inf"))) if name == "gfi" else torch.isfinite(v)
        if t.is_floating_point() and not bool(finite.all()):
            raise AssertionError(f"suite/{name}: non-finite value on a valid cell")
    # Every landed walk ends on a river cell, and HAND is -100 or >= 0.
    idx = out["indices"].reshape(-1)
    landed = idx != -100
    river = inputs[3].reshape(-1)
    if not bool((river[idx[landed].long()] == 1).all()):
        raise AssertionError("suite/indices: a landed walk ends off the river")
    hand = out["hand"]
    if not bool(((hand == -100) | (hand >= 0)).all()):
        raise AssertionError("suite/hand: a negative value other than NoData")
    t0 = time.perf_counter()
    got = pipeline.classify_flood(out["hand"], basin["flood"])
    classify_s = time.perf_counter() - t0
    want = pipeline.classify_flood(plain["hand"], basin["flood"])
    if got[:3] != want[:3] or not np.array_equal(got[3], want[3]):
        raise AssertionError(f"classify_flood: {got[:3]} vs {want[:3]}")
    th, corr, fit, _ = got
    if not np.isfinite(fit):
        raise AssertionError("classify_flood: Fit is not finite")
    print(f"suite: launches {launches}; landed {int(landed.sum())} of {idx.numel()} cells")
    print(f"classify_flood: threshold {th} Fit {fit!r} Correctness {corr!r} "
          f"(identical to the plain engine); host time {classify_s:.3f} s")
    calibrate_on_card(dev, out["hand"], basin["flood"], got, f"{ROWS}x{COLS}")
    return inputs, launches, out, got


def phase_north_star(dev, card, basin, small):
    """The North star's parity: the suite through K2, K3 and K4 (launch
    counters read) and the one-card classifier, held to the JAX package's
    results in ``north_star_reference.npz`` (``utils.parity.check``) at
    2178x1534 (phase 2's run) and 4096x4096; the suite's time at 4096x4096
    (CUDA events)."""
    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.utils import parity
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    t_phase = time.perf_counter()
    ref = parity.load(NORTH_STAR_REFERENCE)
    if parity.sizes(ref) != [(ROWS, COLS), (NORTH_STAR, NORTH_STAR)]:
        raise AssertionError(f"north star: the reference holds {parity.sizes(ref)}")
    cfg = pipeline.PipelineConfig()
    for rows, cols in parity.sizes(ref):
        inputs = None
        if (rows, cols) == (ROWS, COLS):
            arrays, out, note = basin, small, "phase 2's run"
        else:
            arrays = {k: f(0, rows, 0, cols) for k, f in windowed_basin(rows, cols, seed=0).items()}
            inputs = pipeline.inputs_to_torch(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], dev)
            reset_launch_counters()
            out = pipeline.descriptor_suite(*inputs, cfg)
            torch.cuda.synchronize()
            launches = launch_counters()
            if [k for k in IN_CORE if launches[k] == 0]:
                raise AssertionError(f"north star {rows}x{cols}: launches {launches}")
            note = f"launches {launches}"
        classified = sharded_classify_flood(out["hand"], torch.as_tensor(arrays["flood"], device=dev))
        report = parity.check(ref, rows, cols, arrays, {k: v.cpu().numpy() for k, v in out.items()},
                              (*classified[:3], classified[3].cpu().numpy()))
        errs = ", ".join(f"{k} {r['max_abs_err']:.3g} (sums {r['sum_rel_diff']:.2g})" for k, r in report.items())
        print(f"north star {rows}x{cols} ({note}): inputs, indices, hand, downslope and class map sha256 the JAX "
              f"reference's; threshold {classified[0]} Correctness {classified[1]!r} Fit {classified[2]!r} "
              f"identical; largest error at the sampled cells (sums' relative difference): {errs}")
        if inputs is not None:
            suite_ms = median_ms(lambda: pipeline.descriptor_suite(*inputs, cfg))
            print(f"time north star suite {rows}x{cols}: {suite_ms:.3f} ms "
                  f"({rows * cols / suite_ms / 1e3:.3f} M grid-points/s)  [{card}]")
        del inputs, out
    torch.cuda.empty_cache()
    print(f"north star phase: {time.perf_counter() - t_phase:.1f} s")


def phase_long_drainage(dev, card):
    """Long drainage held to the JAX package (``long_drainage_reference.npz``,
    ``make_north_star_reference.py``): terrain-derived rivers whose walks
    run hundreds of steps, at 2178x1534 and 4096x4096.  At each size:

    - the inputs made by the port (``utils.parity.long_drainage_inputs``:
      ``synthetic_dem`` on the host, ``derive_terrain`` on the card), dem,
      fdr, fac, river and flood sha256 JAX's; ``derive_terrain``'s time;
      the walks' statistics from the plain engines on the card equal to
      the set's (flow steps mean/max, downslope steps mean/max);
    - ``descriptor_suite`` under ``engine="cuda"`` (K2, K3, K4) and
      ``"cuda_blocked"`` (K2, K3, K7), each with the one-card classifier,
      held to the set by ``utils.parity.check``: indices, HAND, downslope
      and the class map by sha256, threshold, Correctness and Fit
      identical, slope, slope_rad, TWI, mod-TWI, GFI and ln(hl/H) within
      today's tolerances, and fdist in the engine's order: the count
      engine within ``parity.count_bound``, atol + (rtol + steps 2^-24)
      |w| (fdist's rtol 1e-6, atol 1e-4), of JAX's xla fdist, the fold
      engine bitwise JAX's right fold (``fdist_fold``) and within the same
      bound of the xla fdist; the largest error printed beside the share
      of its bound; launch counters read around each suite, the jump
      walk's pending cells after phase 1 and R, the fold's P and K (the
      phase fails on no pending cell, or K = 0); each suite's time (CUDA
      events, median of 5);
    - the downslope kernel's time beside its plain version's;
      ``jump_profile`` and ``fold_profile`` on the suite's walk operands:
      the jump walk bitwise ``doubling_walk``, the cells entering each
      round, both walks' device time by step;
    - at 4096x4096, ``tiled_suite`` in 1024x1024 tiles and
      ``sharded_suite`` on mesh (4, 4) (a world of one over NCCL), each
      bitwise the count engine's suite on indices, HAND, downslope, slope
      and fdist, each with at least one downslope retry (walks leave the
      64-cell halo), timed (host clock, a warm run after the checked one).
    """
    from dataclasses import replace

    from descriptools_tpu_torch import pipeline, tiled
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters, walk
    from descriptools_tpu_torch.ops.downslope import _downslope_jacobi
    from descriptools_tpu_torch.ops.terrain import derive_terrain
    from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.utils import parity

    t_phase = time.perf_counter()
    ref = parity.load(LONG_DRAINAGE_REFERENCE)
    if parity.sizes(ref) != [(ROWS, COLS), (NORTH_STAR, NORTH_STAR)]:
        raise AssertionError(f"long drainage: the reference holds {parity.sizes(ref)}")
    dtypes = parity.hash_dtypes(ref)
    for rows, cols in parity.sizes(ref):
        tag = f"{rows}x{cols}"
        p = parity.params(ref, rows, cols)
        t0 = time.perf_counter()
        arrays, inputs = parity.long_drainage_inputs(ref, rows, cols, dev)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        bad = [k for k in parity.INPUTS if parity.sha256(arrays[k], dtypes[k]) != str(ref[f"{tag}.sha256.{k}"])]
        if bad:
            raise AssertionError(f"long drainage {tag}: {bad} differ from the JAX reference's sha256")
        terrain_ms = median_ms(lambda: derive_terrain(inputs[0]))
        walks = parity.walk_stats(inputs[0], inputs[1], inputs[3], p["elevation_difference"])
        if walks != parity.walks(ref, rows, cols):
            raise AssertionError(f"long drainage {tag}: walks {walks} vs the reference's {parity.walks(ref, rows, cols)}")
        print(f"long drainage {tag} (synthetic_dem smooth {p['smooth']:.0f}, amp {p['amp']:.0f}; river fac > "
              f"{p['river_fac']:.0f}; ED {p['elevation_difference']:.0f}): dem, fdr, fac, river, flood sha256 the JAX "
              f"reference's (derive_terrain on the card {terrain_ms:.3f} ms; inputs made in {make_s:.1f} s); walks "
              f"the reference's: {walks['landed']} of {walks['valid']} valid cells landed, flow steps mean "
              f"{walks['flow_steps_sum'] / walks['landed']:.3f}, max {walks['flow_steps_max']}, "
              f"{walks['flow_over_64']} over 64; downslope steps mean "
              f"{walks['downslope_steps_sum'] / walks['valid']:.3f}, max {walks['downslope_steps_max']}  [{card}]")
        flood = torch.as_tensor(arrays["flood"], device=dev)
        cfg = pipeline.PipelineConfig(elevation_difference=p["elevation_difference"])
        count_out = None
        for engine, order, kernels in (("cuda", "count", IN_CORE), ("cuda_blocked", "fold", BLOCKED)):
            ecfg = replace(cfg, engine=engine)
            reset_launch_counters()
            out = pipeline.descriptor_suite(*inputs, ecfg)
            torch.cuda.synchronize()
            launches = launch_counters()
            if [k for k in kernels if launches[k] == 0]:
                raise AssertionError(f"long drainage {tag} {engine}: launches {launches}")
            if engine == "cuda":
                pending, rounds = walk.flow_walk.pending.tolist(), walk.flow_walk.rounds
                if pending[0] == 0:
                    raise AssertionError(f"long drainage {tag}: no cell pending after the jump walk's phase 1")
                walked = f"jump walk: {pending[0]} cells pending after phase 1, R {rounds}, cells entering each " \
                         f"round {pending[:-1]}"
            else:
                fb = walk.flow_walk_blocked
                if fb.rounds == 0:
                    raise AssertionError(f"long drainage {tag}: the fold ran no band round (K = 0)")
                walked = f"fold: K {fb.rounds}, P {fb.pending}, its jump walk's R {fb.jump_rounds}"
            classified = sharded_classify_flood(out["hand"], flood)
            host = {k: v.cpu().numpy() for k, v in out.items()}
            report = parity.check(ref, rows, cols, arrays, host, (*classified[:3], classified[3].cpu().numpy()),
                                  fdist_order=order)
            fd = report["fdist"]
            errs = ", ".join(f"{k} {r['max_abs_err']:.3g}" for k, r in report.items() if k != "fdist")
            suite_ms = median_ms(lambda: pipeline.descriptor_suite(*inputs, ecfg))
            print(f"long drainage {tag} engine={engine}: launches {launches}; {walked}; inputs, indices, hand, "
                  f"downslope and class map sha256 the JAX reference's; threshold {classified[0]} Correctness "
                  f"{classified[1]!r} Fit {classified[2]!r} identical; fdist ({order} order"
                  + (", bitwise JAX's right fold" if order == "fold" else "")
                  + f") largest error against JAX's xla fdist {fd['max_abs_err']:.6g}, {fd['bound_used']:.4f} of "
                  f"count_bound, {fd['beyond_tolerance']} of {2 * int(ref['meta.samples'])} sampled cells beyond "
                  f"rtol 1e-6, atol 1e-4; sums {fd['sum_bound_used']:.4f} of their bound; largest error of the "
                  f"other floats: {errs}; suite {suite_ms:.3f} ms ({rows * cols / suite_ms / 1e3:.3f} M "
                  f"grid-points/s)  [{card}]")
            if engine == "cuda":
                count_out = {k: host[k] for k in BITWISE}
            del out, host, classified
        dem_f = inputs[0].to(torch.float32)
        downslope_args = (dem_f, inputs[1], cfg.px, cfg.elevation_difference, cfg.downslope_max_steps)
        k3_ms = median_ms(lambda: walk.downslope_walk(*downslope_args))
        k3_plain_ms = median_ms(lambda: _downslope_jacobi(*downslope_args), 1)
        print(f"time downslope_walk long drainage {tag}: kernel {k3_ms:.3f} ms, plain _downslope_jacobi "
              f"{k3_plain_ms:.3f} ms (median of 1); walks of {walks['downslope_steps_sum'] / walks['valid']:.3f} "
              f"steps a valid cell, {walks['downslope_steps_max']} at most  [{card}]")
        del dem_f, downslope_args
        ops = flow.walk_inputs(inputs[1], inputs[3])
        cap = cfg.flow_max_steps
        jump_profile({f"long drainage {tag}": (ops, cap)}, card)
        k4_device_time(f"long drainage {tag}", inputs[1], inputs[3], cap, card)
        fold_profile({f"long drainage {tag}": (ops, cap, 1)}, card)
        del ops

        if (rows, cols) == (NORTH_STAR, NORTH_STAR):
            loaders = {k: tiled._array_loader(arrays[k]) for k in ("dem", "fdr", "river", "fac")}

            def run_tiled(stats):
                return tiled.tiled_suite(loaders, (rows, cols), cfg, dev, tile_rows=LONG_TILE, tile_cols=LONG_TILE,
                                         stats=stats)

            multihost.initialize(device="cuda")
            try:
                mesh = make_mesh(LONG_MESH)
                if (mesh.backend, mesh.world) != ("nccl", 1):
                    raise AssertionError(f"long drainage: mesh {mesh}")

                def run_sharded(stats):
                    got = sharded_suite(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], cfg, mesh,
                                        stats=stats)
                    return {k: got[k].cpu().numpy() for k in BITWISE}

                for label, run, expect in (
                        (f"tiled_suite in {LONG_TILE}x{LONG_TILE} tiles", run_tiled, TILED),
                        (f"sharded_suite on mesh {LONG_MESH} (world of one, nccl)", run_sharded, TILED)):
                    stats = {}
                    reset_launch_counters()
                    t0 = time.perf_counter()
                    got = run(stats)
                    torch.cuda.synchronize()
                    first_s = time.perf_counter() - t0
                    launches = launch_counters()
                    if [k for k in expect if launches[k] == 0]:
                        raise AssertionError(f"long drainage {tag} {label}: launches {launches}")
                    for k in BITWISE:
                        check_bitwise(f"long drainage {tag} {label}/{k}", torch.as_tensor(np.asarray(got[k])),
                                      torch.as_tensor(count_out[k]))
                    retries = stats["downslope_retries"]
                    if retries == 0:
                        raise AssertionError(f"long drainage {tag} {label}: no downslope retry ran")
                    halos = ([a["halo"] for a in stats["downslope_attempts"]] if "downslope_attempts" in stats
                             else sorted({r["halo"] for r in stats["downslope_retry_halos"]}))
                    del got
                    t0 = time.perf_counter()
                    run({})
                    torch.cuda.synchronize()
                    warm_s = time.perf_counter() - t0
                    print(f"long drainage {tag} {label}: launches {launches}; indices, hand, downslope, slope, fdist "
                          f"bitwise the count engine's in-core suite; downslope_retries {retries}, retry halos "
                          f"{halos}; wall {first_s:.3f} s checked, {warm_s:.3f} s warm (host clock)  [{card}]")
            finally:
                multihost.shutdown()
        del arrays, inputs, flood, count_out
        torch.cuda.empty_cache()
    print(f"long drainage phase: {time.perf_counter() - t_phase:.1f} s")


def wall_ms(fn, repeats=REPEATS):
    """Median host-clock ms of ``fn`` to a synchronised card, after one
    warm-up: for calls that read results back to the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def calibrate_on_card(dev, hand, flood, host, label):
    """The one-card exact classifier and ``calibration(backend="torch")``
    on the card against the host float64 result ``host`` of
    ``classify_flood``: the classifier identical (threshold, Correctness,
    Fit, class map); the float32 calibration identical to its own run on
    the CPU, and set beside the float64 threshold."""
    from descriptools_tpu_torch import evaluation
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

    card = card_line()
    flood_t = torch.as_tensor(flood, device=dev)
    got = sharded_classify_flood(hand, flood_t)
    if got[:3] != host[:3] or not np.array_equal(got[3].cpu().numpy(), host[3]):
        raise AssertionError(f"sharded_classify_flood {label}: {got[:3]} vs the host's {host[:3]}")
    one_card_ms = wall_ms(lambda: sharded_classify_flood(hand, flood_t))
    elements = np.unique(hand.cpu().numpy())
    desc = evaluation.min_max_scale(hand, elements[1], elements[-1])
    desc_cpu = evaluation.min_max_scale(hand.cpu(), elements[1], elements[-1])
    check_bitwise(f"min_max_scale {label}", desc.cpu(), desc_cpu)
    th = evaluation.calibration(desc, flood_t, backend="torch")
    th_cpu = evaluation.calibration(desc_cpu, flood_t.cpu(), backend="torch")
    if th != th_cpu:
        raise AssertionError(f"calibration(backend='torch') {label}: card {th}, CPU {th_cpu}")
    torch_ms = wall_ms(lambda: evaluation.calibration(desc, flood_t, backend="torch"))
    print(f"sharded_classify_flood {label} on the card: threshold, Correctness, Fit and class map identical to "
          f"the host classify_flood; {one_card_ms:.3f} ms  [{card}]")
    print(f"calibration(backend='torch') {label} on the card: threshold {th} (the CPU's; the host float64 "
          f"threshold {host[0]}: {'the same' if th == host[0] else 'another'}); {torch_ms:.3f} ms  [{card}]")


def stencil_device_time(label, fn, t, own, sass, card):
    """Print the device time of one stencil call ``fn`` (torch.profiler):
    its kernel and all its device work, beside its event time (``t``, from
    ``timed``); then the kernel's share of its bound (the floor's
    operations) and its issue efficiency: its ``own`` SASS a cell at the
    card's issue rate over its device time."""
    dev_ms = device_kernels_ms(fn)
    kernel = sum(v for k, v in dev_ms.items() if "stencil" in k)
    if not kernel:
        print(f"device time {label} (torch.profiler): not measured (the trace held no stencil kernel); "
              f"event {t['ms']:.4f} ms  [{card}]")
        return
    own_ms = own * t["cells"] / sass["issue"]
    print(f"device time {label} (torch.profiler, per call): kernel {kernel:.4f} ms, all the call's device "
          f"work {sum(dev_ms.values()):.4f} ms ({len(dev_ms)} kernels); event {t['ms']:.4f} ms; bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}; floor {sass['floor']} operations a cell), "
          f"{100 * t['bound_ms'] / kernel:.1f} % of it; own SASS {own:.2f} a cell, {own_ms:.4f} ms at the "
          f"issue rate: issued at {100 * own_ms / kernel:.1f} %  [{card}]")


def k4_device_time(label, fdr, river, cap, card):
    """Print the device time of one in-core flow entry call (``flow_cuda``;
    torch.profiler) by step: the memset, phase 1, the R rounds and
    ``flow_finish_kernel``, beside its event time and its bound: fdr and
    river read once, fdist and indices written once."""
    from descriptools_tpu_torch.ops.cuda import walk

    fn = lambda: walk.flow_cuda(fdr, river, 12.5, cap)
    out = fn()
    rounds = walk.flow_walk.rounds
    bound = sum(t.numel() * t.element_size() for t in (fdr, river, *out)) / HBM_BYTES_PER_MS
    dev_ms, held, made = device_ms(fn, {"Memset (Device)": 1, "jump_start": 1, "jump_round": rounds,
                                        "flow_finish": 1})
    shown = {k: "not measured" if v is None else f"{v:.4f} ms" for k, v in dev_ms.items()}
    whole = sum(v for v in dev_ms.values() if v is not None)
    share = f"{100 * bound / whole:.1f} %" if whole else "not measured"
    print(f"device time flow_walk {label} (torch.profiler, per call; the trace held {held} of {made} launches): "
          f"memset {shown['Memset (Device)']}, phase 1 {shown['jump_start']}, {rounds} rounds "
          f"{shown['jump_round']}, finish {shown['flow_finish']}; in all {whole:.4f} ms; event "
          f"{median_ms(fn):.4f} ms; bound {bound:.4f} ms (fdr {fdr.dtype} and river read, fdist and indices "
          f"written), {share} of it  [{card}]")


def phase_timing(dev, inputs, card, sass):
    """Kernels beside their plain versions, then the suite, at the basin's
    shape."""
    from descriptools_tpu_torch import pipeline
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk

    dem, fdr, fac, river = inputs
    dem_f = dem.to(torch.float32)
    down_in = (dem_f, fdr)
    f_ops = flow.walk_inputs(fdr, river)
    stencil_in = (dem_f, fac)
    calls = {
        "stencil": (stencil_in, lambda: st.stencil(*stencil_in, 12.5, 0.1),
                    lambda: st.stencil_plain(*stencil_in, 12.5, 0.1), sass["floor"]),
        "downslope_walk": (down_in, lambda: (walk.downslope_walk(*down_in, 12.5, 5.0, 5000),),
                           lambda: (down._downslope_jacobi(*down_in, 12.5, 5.0, 5000),), 0),
        # K4 as the suite runs it: fdr and river read, fdist and indices written.
        "flow_walk": ((fdr, river), lambda: walk.flow_cuda(fdr, river, 12.5, 20000),
                      lambda: flow.flow_from_state(*flow.doubling_walk(*f_ops, 20000), 12.5, 20000), 0),
    }
    for name, g, w in zip(("fdist", "indices"), calls["flow_walk"][1](), calls["flow_walk"][2]()):
        check_bitwise(f"time flow_walk/{name}", g.view(torch.int32), w.view(torch.int32))
    times = {name: timed(*call, sass["issue"]) for name, call in calls.items()}
    for name, t in times.items():
        print(f"time {name:<15} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; bytes {t['bytes_ms']:.4f}, "
              f"operations {t['ops_ms']:.4f})  [{card}]")
    stencil_device_time(f"stencil {ROWS}x{COLS}", calls["stencil"][1], times["stencil"],
                        sass["own"]["stencil"], sass, card)
    k4_device_time(f"{ROWS}x{COLS}", fdr, river, 20000, card)
    cfg = pipeline.PipelineConfig()
    one_kernel(f"the in-core downslope stage {ROWS}x{COLS}",
               lambda: pipeline._engine_downslope(dem_f, fdr, cfg, "cuda"), "downslope_kernel", card)
    pk, _ = down.jacobi_walk(*down.walk_inputs(dem_f, fdr, 12.5), 5.0, 5000)
    _, a, b = walk.absorbing_walk(*f_ops, 20000)
    for name, steps in (("downslope", (pk & 0xFFFF) + (pk >> 16)), ("flow", a + b)):
        print(f"basin {name} walk steps: mean {float(steps.float().mean()):.3f}, max {int(steps.max())}")
    # The synthetic basin's walks are short; time both walks where every
    # cell walks far, at the same shape.
    dem_n, fdr_n = tall_north(ROWS, COLS, None)
    dn = (torch.as_tensor(dem_n, device=dev), torch.as_tensor(fdr_n, device=dev))
    pk, _ = down.jacobi_walk(*down.walk_inputs(*dn, 12.5), 50.0, 5000)
    steps = (pk & 0xFFFF) + (pk >> 16)
    ramp_steps = int(steps.sum())
    print(f"tall north downslope walk steps (ed 50): mean {float(steps.float().mean()):.3f}, "
          f"max {int(steps.max())}")
    fdr_l, river_l = lateral_channel(ROWS, COLS)
    fl = flow.walk_inputs(torch.as_tensor(fdr_l, device=dev), torch.as_tensor(river_l, device=dev))
    fs = flow.walk_inputs(*(torch.as_tensor(t, device=dev) for t in serpentine()))
    fn = flow.walk_inputs(*(torch.as_tensor(t, device=dev) for t in north_rivers(ROWS, COLS)))
    jump_cases = {
        f"basin {ROWS}x{COLS}": (f_ops, 20000),
        f"north rivers {ROWS}x{COLS} (walks of 0 to 100 steps)": (fn, 20000),
        f"lateral channel {ROWS}x{COLS} (walks of up to {ROWS + COLS - 2} steps)": (fl, 20000),
        "serpentine 200x200 (one 40000-step path), cap 60000": (fs, 60000),
    }
    jump_profile(jump_cases, card)
    ramp = timed(dn, lambda: (walk.downslope_walk(*dn, 12.5, 50.0, 5000),),
                 lambda: (down._downslope_jacobi(*dn, 12.5, 50.0, 5000),))
    # fold_walk sweeps 40000 times on the serpentine, a host read each: its
    # plain time there is one run.
    fold_profile({label: (ops, cap, 1 if cap > 20000 else REPEATS)
                  for label, (ops, cap) in jump_cases.items()}, card)
    print(f"time downslope_walk, tall north (100-step walks), ed 50 {ROWS}x{COLS}: kernel {ramp['ms']:.3f} "
          f"ms, plain {ramp['plain_ms']:.3f} ms, bound {ramp['bound_ms']:.4f} ms ({ramp['bound_by']})  [{card}]")
    # Every start walks: the walk's loop, issued at the card's rate, is
    # most of the kernel (an issue efficiency, not a bound).
    issue_ms = sass["walk_step"] * ramp_steps / sass["issue"]
    print(f"downslope_walk on the ramp: {ramp_steps} steps x {sass['walk_step']} instructions at the issue "
          f"rate take {issue_ms:.4f} ms: issued at {100 * issue_ms / ramp['ms']:.1f} % of the event time  [{card}]")
    suite_ms = median_ms(lambda: pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig()))
    plain_ms = median_ms(
        lambda: pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    )
    cells = ROWS * COLS
    print(
        f"time suite {ROWS}x{COLS}: kernels {suite_ms:.3f} ms "
        f"({cells / suite_ms / 1e3:.3f} M grid-points/s), plain {plain_ms:.3f} ms "
        f"({cells / plain_ms / 1e3:.3f} M grid-points/s)  [{card}]"
    )
    cross_check_engines(dem_f, fdr, river, card)
    return times


def cross_check_engines(dem_f, fdr, river, card):
    """The JAX package's cross-check engines (plain torch ops on the card,
    no kernel) on the basin, held to the kernels' stages and timed (CUDA
    events): flow ``method="doubling"`` and ``"hybrid"``, indices bitwise
    the count engine's (K4); downslope ``method="descent"`` within JAX's
    own jacobi-vs-descent tolerance (rtol 1e-4, atol 1e-5) of K3's."""
    from descriptools_tpu_torch.ops import flow
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")

    count = lambda: flow.flow_distance_index(fdr, river, 12.5, engine="cuda")
    _, idx_count = count()
    for method in ("doubling", "hybrid"):
        run = lambda m=method: flow.flow_distance_index(fdr, river, 12.5, method=m)
        fd, idx = run()
        check_bitwise(f"flow method={method}/indices", idx, idx_count)
        print(f"time flow_distance_index(method={method!r}) {ROWS}x{COLS}: {median_ms(run):.3f} ms (count engine "
              f"through K4: {median_ms(count):.3f} ms); indices bitwise the count engine's, fdist "
              f"{max_abs_err(fd, count()[0]):.3g} from it  [{card}]")
    k3 = lambda: down.downslope(dem_f, fdr, 12.5, 5.0, engine="cuda")
    descent = lambda: down.downslope(dem_f, fdr, 12.5, 5.0, method="descent")
    got, want = descent(), k3()
    bad = int((~torch.isclose(got, want, rtol=1e-4, atol=1e-5, equal_nan=True)).sum())
    if bad:
        raise AssertionError(f"downslope method='descent': {bad} cells outside rtol 1e-4, atol 1e-5 of K3")
    print(f"time downslope(method='descent') {ROWS}x{COLS}: {median_ms(descent):.3f} ms (K3: {median_ms(k3):.3f} "
          f"ms); within rtol 1e-4, atol 1e-5 of K3, largest difference {max_abs_err(got, want):.3g}  [{card}]")


def phase_tile_kernels(dev, basin, errs):
    """The tiled path's kernels against their plain versions, bitwise."""
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk
    from descriptools_tpu_torch.parallel import boundary
    from descriptools_tpu_torch.utils.synthetic import adversarial_dem, downslope_cases

    def stencil_case(label, padded, fac):
        got = st.stencil_padded(padded, fac, 12.5, 0.1)
        want = st.stencil_padded_plain(padded, fac, 12.5, 0.1)
        e = check_bitwise(f"stencil_padded/{label}/slope", got[0], want[0])
        for name, g, w in zip(st.NAMES[1:], got[1:], want[1:]):
            e = max(e, check_close(f"stencil_padded/{label}/{name}", g, w))
        errs["stencil_padded"] = max(errs["stencil_padded"], e)
        print(f"kernel stencil_padded {label:<34} matches plain (slope bitwise, max_abs_err {e:.3g})")
        return got

    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fac = torch.as_tensor(basin["fac"], device=dev)
    stencil_case("basin window 1024x1024, real halo",
                 dem_f[499:1525, 199:1225].contiguous(), fac[500:1524, 200:1224])
    whole = torch.full((ROWS + 2, COLS + 2), -100.0, device=dev)
    whole[1:-1, 1:-1] = dem_f
    got = stencil_case(f"basin {ROWS}x{COLS}, NoData ring", whole, fac)
    check_bitwise("stencil_padded/whole basin vs in-core stencil", got[0], st.stencil(dem_f, fac, 12.5, 0.1)[0])
    stencil_case(f"basin {ROWS}x{COLS}, NoData ring, fac f32", whole, fac.to(torch.float32))
    rng = np.random.default_rng(19)
    for rows, cols in ((1, 1), (3, 5), (17, 33), (TILE, TILE)):
        padded = torch.as_tensor(adversarial_dem(rng, (rows + 2, cols + 2)), device=dev)
        fac_a = rng.integers(-150, 5000, size=(rows, cols))
        for dtype in (np.int32, np.float32):
            stencil_case(f"adversarial {rows}x{cols}, fac {np.dtype(dtype).name}", padded,
                         torch.as_tensor(fac_a.astype(dtype), device=dev))

    def absorbing_check(label, fdr_eff, code0, max_steps):
        got = walk.absorbing_walk(fdr_eff, code0, max_steps)
        want = flow.doubling_walk(fdr_eff, code0, max_steps)
        for name, g, wnt in zip(("code", "a", "b"), got, want):
            e = check_bitwise(f"absorbing/{label}/{name}", g, wnt)
            errs["absorbing_walk"] = max(errs["absorbing_walk"], e)

    def absorbing_case(label, fdr, river, tile, max_steps=20000):
        rows, cols = fdr.shape
        h, w = tile
        ny, nx = -(-rows // h), -(-cols // w)
        R, C = ny * h, nx * w
        fdr_p = np.zeros((R, C), np.uint8)
        fdr_p[:rows, :cols] = fdr
        riv_p = np.zeros((R, C), np.int8)
        riv_p[:rows, :cols] = river
        fdr_p = torch.as_tensor(fdr_p, device=dev)
        riv_p = torch.as_tensor(riv_p, device=dev)
        exits = 0
        for iy in range(ny):
            for ix in range(nx):
                sl = np.s_[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w]
                fdr_eff, code0, role, *_ = boundary.local_walk_operands(
                    fdr_p[sl], riv_p[sl], iy, ix, h, w, R, C
                )
                exits += int((role == boundary.EXIT).sum())
                absorbing_check(f"{label}/{iy},{ix}", fdr_eff, code0, max_steps)
        if exits == 0:
            raise AssertionError(f"absorbing/{label}: no EXIT role fired")
        print(f"kernel absorbing_walk {label:<34} matches plain bitwise (code, a, b), "
              f"{ny * nx} tiles, {exits} exit cells")

    absorbing_case("basin, 512x512 tiles", basin["fdr"], basin["river"], (512, 512))
    absorbing_case(f"lateral channel {ROWS}x{COLS}, 512 tiles", *lateral_channel(ROWS, COLS), (512, 512))
    fdr_s, riv_s = serpentine()
    fdr_eff, code0, *_ = boundary.local_walk_operands(
        torch.as_tensor(fdr_s, device=dev), torch.as_tensor(riv_s, device=dev), 0, 0, 200, 200, 200, 200
    )
    absorbing_check("serpentine", fdr_eff, code0, 60000)
    print(f"kernel absorbing_walk {'serpentine 200x200, one tile':<34} matches plain bitwise (code, a, b)")

    def tracked_case(label, dem, fdr, origin, grid, ed, max_steps, must_fire):
        """The window's interior at halos 0 and 8 against the plain
        composition (trunc_cells, the tracked walk, the interior)."""
        d = torch.as_tensor(np.asarray(dem, np.float32), device=dev).contiguous()
        f = torch.as_tensor(np.asarray(fdr), device=dev).contiguous()
        flagged = []
        for halo in (0, 8):
            got = walk.downslope_walk_tracked(d, f, 12.5, ed, max_steps, *origin, *grid, halo)
            want = down.downslope_window(d, f, 12.5, ed, max_steps, *origin, *grid, halo)
            e = check_bitwise(f"tracked/{label}/halo {halo}/downslope", got[0], want[0])
            check_bitwise(f"tracked/{label}/halo {halo}/trunc", got[1], want[1])
            errs["downslope_walk_tracked"] = max(errs["downslope_walk_tracked"], e)
            flagged.append(int(got[1].sum()))
        if must_fire and flagged[0] == 0:
            raise AssertionError(f"tracked/{label}: no truncation flag fired")
        print(f"kernel downslope_walk_tracked {label:<36} matches plain bitwise (downslope, trunc) at halos "
              f"0 and 8; {flagged} flagged")

    for bump in (None, 40):
        dem, fdr = flat_east(512, 2048, bump)
        tracked_case(f"flat east 512x2048 bump={bump}", dem, fdr, (0, 0), (512, 4 * 2048), 5.0, 5000, True)
    tracked_case("basin window 1024x1024", basin["dem"][300:1324, 200:1224], basin["fdr"][300:1324, 200:1224],
                 (300, 200), (ROWS, COLS), 5.0, 5000, True)
    dem, fdr = tall_north(ROWS, COLS, 37)
    tracked_case("tall north rows 1000-1512", dem[1000:1512], fdr[1000:1512], (1000, 0), (ROWS, COLS),
                 50.0, 5000, True)
    cases = downslope_cases()
    dem, fdr, _, _ = cases["fdr_int16"]
    tracked_case("adversarial 40x56, fdr int16", np.round(dem), fdr, (0, 9), (40, 86), 5.0, 200, True)
    tracked_case("adversarial 40x56, fdr int32", np.round(dem), fdr.astype(np.int32), (0, 9), (40, 86),
                 5.0, 200, True)
    dem, fdr, _, _ = cases["fractional_terminal_stops"]
    tracked_case("fractional 40x56, east edge cut", dem, fdr, (0, 0), (40, 112), 50.0, 5000, True)
    dem, fdr, _, _ = cases["terminal_holds_still"]
    tracked_case("terminal holds still 40x56", dem, fdr, (3, 0), (50, 56), 5.0, 30, False)
    torch.cuda.synchronize()


def phase_tiled(dev, card, classified_small, hand_small, basin, errs, sass):
    """The out-of-core path at full size, a forced retry, the streaming
    calibration; pass times, link bytes, and the tile kernels against their
    plain versions on one tile's operands, checked and timed."""
    from descriptools_tpu_torch import pipeline, tiled, verify
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk
    from descriptools_tpu_torch.parallel import boundary
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    cfg = pipeline.PipelineConfig()
    loaders = windowed_basin(BIG, BIG, seed=0)
    stats = {}
    reset_launch_counters()
    t0 = time.perf_counter()
    out = tiled.tiled_suite(loaders, (BIG, BIG), cfg, dev, tile_rows=TILE, tile_cols=TILE, stats=stats)
    tiled_s = time.perf_counter() - t0
    launches = launch_counters()
    tiles = stats["tiles"]
    if tiles != 4 or launches["absorbing_walk"] != 2 * tiles:
        raise AssertionError(f"tiled: {tiles} tiles, launches {launches}")
    if launches["stencil_padded"] < tiles or launches["downslope_walk_tracked"] < tiles:
        raise AssertionError(f"tiled: a tile kernel launched less than once per tile: {launches}")
    print(f"tiled {BIG}x{BIG} in {TILE}x{TILE} tiles: launches {launches}; wall {tiled_s:.3f} s "
          f"(passes {stats['pass_s']}; retries {stats['downslope_retries']})  [{card}]")
    for p, row in stats["link"].items():
        rate = lambda b, s: f"{b / 1e9:.3f} GB in {s:.3f} s ({b / s / 1e9 if s else 0.0:.3f} GB/s)"
        print(f"tiled link pass {p}: h2d {rate(row['h2d_bytes'], row['h2d_s'])}, "
              f"d2h {rate(row['d2h_bytes'], row['d2h_s'])}  [{card}]")
    print(f"tiled host waits: prefetch {stats['suite_prefetch_wait_s']:.3f} s, "
          f"writes {stats['suite_write_wait_s']:.3f} s, device_get {stats['suite_device_get_s']:.3f} s  [{card}]")

    t0 = time.perf_counter()
    full = {k: loaders[k](0, BIG, 0, BIG) for k in ("dem", "fdr", "fac", "river", "flood")}
    print(f"in-core inputs {BIG}x{BIG} generated on the host in {time.perf_counter() - t0:.3f} s  [{card}]")
    inputs = pipeline.inputs_to_torch(full["dem"], full["fdr"], full["fac"], full["river"], dev)
    want = pipeline.descriptor_suite(*inputs, cfg)
    for name in ("indices", "hand", "downslope", "slope", "fdist"):
        check_bitwise(f"tiled/{name}", torch.as_tensor(out[name], device=dev), want[name])
    for name in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        check_close(f"tiled/{name}", torch.as_tensor(out[name], device=dev), want[name])
    print(f"tiled {BIG}x{BIG} matches the in-core suite (indices, hand, downslope, slope, fdist bitwise)")
    # The in-core reference runs PR 1's kernels: hold it, too, against the
    # plain engine at this size.
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    for name in ("indices", "hand", "downslope", "slope", "fdist"):
        check_bitwise(f"in-core {BIG}x{BIG}/{name}", want[name], plain[name])
    for name in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        check_close(f"in-core {BIG}x{BIG}/{name}", want[name], plain[name])
    print(f"in-core suite {BIG}x{BIG} matches the plain engine (indices, hand, downslope, slope, fdist bitwise)")
    del want, plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    incore_ms = median_ms(lambda: pipeline.descriptor_suite(*inputs, cfg))
    print(f"time in-core suite {BIG}x{BIG}: {incore_ms:.3f} ms "
          f"({BIG * BIG / incore_ms / 1e3:.3f} M grid-points/s), peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; tiled wall {tiled_s:.3f} s  [{card}]")

    # The tile kernels on the operands the tiled path gives them at 4096x4096
    # (a 4098x4098 padded block, tile (0,0)'s local walk, a 4224x4224 halo
    # window): each held against its plain version, then both timed.
    dem, fdr, fac, river = inputs
    dem_f = dem.to(torch.float32)
    lo, hi = TILE // 2, TILE // 2 + TILE
    padded = dem_f[lo - 1 : hi + 1, lo - 1 : hi + 1].contiguous()
    fac_t = fac[lo:hi, lo:hi].contiguous()
    loc = boundary.local_walk_operands(fdr[:TILE, :TILE], river[:TILE, :TILE], 0, 0, TILE, TILE, BIG, BIG)[:2]
    halo = 64
    ext = np.s_[lo - halo : hi + halo, lo - halo : hi + halo]
    d_ext, f_ext = dem_f[ext].contiguous(), fdr[ext].contiguous()
    ed, down_steps, flow_steps = cfg.elevation_difference, cfg.downslope_max_steps, cfg.flow_max_steps
    window = (cfg.px, ed, down_steps, lo - halo, lo - halo, BIG, BIG, halo)
    pairs = {
        "stencil_padded": (
            (padded, fac_t),
            lambda: st.stencil_padded(padded, fac_t, cfg.px, cfg.n_topo),
            lambda: st.stencil_padded_plain(padded, fac_t, cfg.px, cfg.n_topo),
            sass["floor"],
            ("slope", "slope_rad", "twi", "mod_twi"),
        ),
        "absorbing_walk": (
            loc,
            lambda: walk.absorbing_walk(*loc, flow_steps),
            lambda: flow.doubling_walk(*loc, flow_steps),
            0,
            ("code", "a", "b"),
        ),
        "downslope_walk_tracked": (
            (d_ext, f_ext),
            lambda: walk.downslope_walk_tracked(d_ext, f_ext, *window),
            lambda: down.downslope_window(d_ext, f_ext, *window),
            0,
            ("downslope", "trunc"),
        ),
    }
    for kernel, (_, fn, plain, _, names) in pairs.items():
        e = 0.0
        for name, g, w in zip(names, fn(), plain()):
            check = check_close if name in ("slope_rad", "twi", "mod_twi") else check_bitwise
            e = max(e, check(f"tile {TILE}x{TILE}/{kernel}/{name}", g, w))
        errs[kernel] = max(errs[kernel], e)
        print(f"kernel {kernel:<22} one {TILE}x{TILE} tile's operands: matches plain "
              f"({', '.join(names)}; max_abs_err {e:.3g})")
    times = {kernel: timed(*call[:4], sass["issue"]) for kernel, call in pairs.items()}
    torch.cuda.synchronize()
    print(f"jump absorbing_walk one {TILE}x{TILE} tile: R {walk.absorbing_walk.rounds}, cells entering "
          f"each round {walk.absorbing_walk.pending.tolist()[:-1]}")
    for name, t in times.items():
        print(f"time {name:<22} one {TILE}x{TILE} tile: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; bytes {t['bytes_ms']:.4f}, "
              f"operations {t['ops_ms']:.4f})  [{card}]")
    stencil_device_time(f"stencil_padded one {TILE}x{TILE} tile", pairs["stencil_padded"][1],
                        times["stencil_padded"], sass["own"]["stencil_padded"], sass, card)
    one_kernel(f"downslope_walk_tracked on one {TILE + 2 * halo}x{TILE + 2 * halo} window",
               pairs["downslope_walk_tracked"][1], "downslope_kernel", card)
    pk, _ = down.jacobi_walk(*down.walk_inputs(d_ext, f_ext, cfg.px), ed, down_steps)
    steps = ((pk & 0xFFFF) + (pk >> 16))[halo:-halo, halo:-halo]
    print(f"tile window downslope walk steps (interior): mean {float(steps.float().mean()):.3f}, "
          f"max {int(steps.max())}")
    del pairs, inputs, dem, fdr, fac, river, dem_f, padded, loc, d_ext, f_ext, pk, steps
    torch.cuda.empty_cache()

    # Streaming calibration at full size (host numpy), alone.
    t0 = time.perf_counter()
    th, corr, fit, cmap = tiled.tiled_classify_flood(out["hand"], tiled._array_loader(full["flood"]), (BIG, BIG),
                                                     tile_rows=TILE, tile_cols=TILE)
    big_classify_s = time.perf_counter() - t0
    if not (np.isfinite(fit) and cmap.shape == (BIG, BIG)):
        raise AssertionError(f"tiled_classify_flood {BIG}x{BIG}: Fit {fit}, map {cmap.shape}")
    print(f"tiled_classify_flood {BIG}x{BIG}: threshold {th} Fit {fit!r} Correctness {corr!r}; "
          f"host time {big_classify_s:.3f} s  [{card}]")

    # The flow fixed-point invariants over every cell of the tiled outputs.
    t0 = time.perf_counter()
    rep = verify.streaming_flow_invariants({k: tiled._array_loader(full[k]) for k in ("dem", "fdr", "river")},
                                           out, (BIG, BIG), cfg.px, cfg.flow_max_steps,
                                           tile_rows=TILE, tile_cols=TILE)
    if not rep["ok"] or rep["cells_checked"] != BIG * BIG:
        raise AssertionError(f"verify {BIG}x{BIG}: {rep['per_check']}, examples {rep['examples']}")
    print(f"verify.streaming_flow_invariants over the tiled {BIG}x{BIG} outputs: {rep['invariant_violations']} "
          f"violations in {rep['cells_checked']} cells ({rep['landed_cells']} landed); host time "
          f"{time.perf_counter() - t0:.3f} s")

    # Calibration at the basin's shape, ragged 1024x1024 tiles: identical
    # to classify_flood.
    hand_np = hand_small.cpu().numpy()
    flood = basin["flood"]
    got = tiled.tiled_classify_flood(hand_np, lambda ys, ye, xs, xe: flood[ys:ye, xs:xe], (ROWS, COLS),
                                     tile_rows=1024, tile_cols=1024)
    if got[:3] != classified_small[:3] or not np.array_equal(got[3], classified_small[3]):
        raise AssertionError(f"tiled_classify_flood: {got[:3]} vs {classified_small[:3]}")
    print(f"tiled_classify_flood {ROWS}x{COLS} in 1024x1024 tiles: threshold, Fit, Correctness "
          "and class map identical to classify_flood")

    # Forced retry: 100-step northward walks (ed 50) from a halo of 8.
    dem_n, fdr_n = tall_north(ROWS, COLS, None)
    river_n = np.zeros((ROWS, COLS), np.int8)
    river_n[0] = 1
    arrays = dict(dem=dem_n.astype(np.int32), fdr=fdr_n, river=river_n, fac=np.ones((ROWS, COLS), np.int32))
    cfg50 = pipeline.PipelineConfig(elevation_difference=50.0)
    stats = {}
    loaders = {k: tiled._array_loader(a) for k, a in arrays.items()}
    got = tiled.tiled_suite(loaders, (ROWS, COLS), cfg50, dev, tile_rows=512, tile_cols=512,
                            downslope_halo=8, stats=stats)
    if stats["downslope_retries"] == 0:
        raise AssertionError("tiled retry: no truncation retry fired")
    want = pipeline.descriptor_suite(*pipeline.inputs_to_torch(
        arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], dev), cfg50)
    for name in ("downslope", "indices", "hand"):
        check_bitwise(f"tiled retry/{name}", torch.as_tensor(got[name], device=dev), want[name])
    halos = sorted({r["halo"] for r in stats["downslope_retry_halos"]})
    print(f"tiled retry tall north {ROWS}x{COLS}, 512 tiles, halo 8: {stats['downslope_retries']} retries "
          f"(halos {halos}); downslope, indices, hand bitwise the in-core suite")
    return launches, times, full, out


def gpu_rows(trace):
    """Device intervals (us) of a torch.profiler chrome trace, by row:
    kernels, host-to-device and device-to-host copies; and the streams each
    row ran on."""
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    rows, streams = {"kernel": [], "htod": [], "dtoh": []}, {"kernel": set(), "htod": set(), "dtoh": set()}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        row = ("kernel" if cat == "kernel" else "htod" if cat == "gpu_memcpy" and "HtoD" in name
               else "dtoh" if cat == "gpu_memcpy" and "DtoH" in name else None)
        if row:
            rows[row].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            streams[row].add(e.get("args", {}).get("stream"))
    return rows, streams


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(a, b):
    """Time (us) during which a row of ``a`` and a row of ``b`` both ran."""
    a, b = _union(a), _union(b)
    total, j = 0.0, 0
    for x0, x1 in a:
        while j < len(b) and b[j][1] <= x0:
            j += 1
        k = j
        while k < len(b) and b[k][0] < x1:
            total += min(x1, b[k][1]) - max(x0, b[k][0])
            k += 1
    return total


def profiled_rows(fn):
    """``gpu_rows`` of a torch.profiler trace of ``fn()`` (the trace file
    under ``build/``, removed)."""
    import tempfile

    fd, trace = tempfile.mkstemp(suffix=".json", dir=os.path.join(ROOT, "build"))
    os.close(fd)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        return gpu_rows(trace)
    finally:
        os.remove(trace)


def copy_overlap(dev, card):
    """Whether a host-to-device copy on a stream of another thread runs
    beside a device-to-host copy, and beside kernels, of the main thread: a 256 MiB upload from pageable or from pinned host memory,
    started with a 1 GiB pageable download and then with a run of matrix
    products.  Each side is bracketed by CUDA events on its own stream,
    timed from one event before both; the overlap is the intersection of
    the two intervals."""
    import threading

    down = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    a = torch.randn(8192, 8192, device=dev)
    main = torch.cuda.current_stream(dev)
    for pinned in (False, True):
        host = torch.empty(1 << 28, dtype=torch.uint8, pin_memory=pinned)
        side = torch.cuda.Stream(dev)
        for beside, work in (("a pageable download", lambda: down.cpu()),
                             ("matrix products", lambda: [a @ a for _ in range(40)])):
            ev = {k: torch.cuda.Event(enable_timing=True) for k in ("t0", "up0", "up1", "w0", "w1")}

            def up():
                with torch.cuda.stream(side):
                    ev["up0"].record(side)
                    host.to(dev, non_blocking=pinned)
                    ev["up1"].record(side)
                side.synchronize()

            torch.cuda.synchronize(dev)
            ev["t0"].record(main)
            th = threading.Thread(target=up)
            th.start()
            ev["w0"].record(main)
            work()
            ev["w1"].record(main)
            th.join()
            torch.cuda.synchronize(dev)
            at = {k: ev["t0"].elapsed_time(e) for k, e in ev.items() if k != "t0"}
            both = max(0.0, min(at["up1"], at["w1"]) - max(at["up0"], at["w0"]))
            print(f"copy overlap: a 256 MiB upload from {'pinned' if pinned else 'pageable'} host memory on another "
                  f"thread's stream, {at['up0']:.3f}-{at['up1']:.3f} ms, beside {beside} on the main stream, "
                  f"{at['w0']:.3f}-{at['w1']:.3f} ms: together {both:.3f} ms  [{card}]")
    del down, a


def upload_overlap(dev, card, full):
    """``tiled_suite`` at 8192x8192 in 4096x4096 tiles (phase 4's arrays)
    under torch.profiler, with and without ``upload_in_prefetch``: the
    host-to-device copies' device time, and how much of it ran while a
    kernel or a device-to-host copy ran, with the streams of each row."""
    from descriptools_tpu_torch import pipeline, tiled

    loaders = {k: tiled._array_loader(full[k]) for k in ("dem", "fdr", "river", "fac")}
    for knob in (False, True):
        rows, streams = profiled_rows(lambda: tiled.tiled_suite(
            loaders, (BIG, BIG), pipeline.PipelineConfig(), dev, tile_rows=TILE, tile_cols=TILE,
            upload_in_prefetch=knob))
        if not rows["htod"] or not rows["kernel"]:
            raise AssertionError(f"upload overlap: the trace holds no copies or kernels: {len(rows['htod'])}, "
                                 f"{len(rows['kernel'])}")
        ms = lambda us: f"{us / 1e3:.3f}"
        htod = sum(b - a for a, b in rows["htod"])
        print(f"upload_in_prefetch={knob} {BIG}x{BIG} in {TILE}x{TILE} tiles (pageable host memory): host-to-device "
              f"copies {ms(htod)} ms of device time in {len(rows['htod'])} copies on streams "
              f"{sorted(streams['htod'], key=str)}, of it {ms(overlap_us(rows['htod'], rows['kernel']))} ms beside "
              f"kernels (streams {sorted(streams['kernel'], key=str)}) and "
              f"{ms(overlap_us(rows['htod'], rows['dtoh']))} ms beside device-to-host copies; kernels "
              f"{ms(sum(b - a for a, b in rows['kernel']))} ms, device-to-host "
              f"{ms(sum(b - a for a, b in rows['dtoh']))} ms  [{card}]")


def phase_config5(dev, card, full, tiled_out):
    """BASELINE config 5's path (``config5_torch.run``, the link knobs on
    as by default) at 8192x8192 in 4096x4096 tiles in a temporary
    directory, fed phase 4's arrays through the memmaps: launch counters of
    K1, K5 and K6, the sample checks, the streaming invariants and the
    classifier; indices, HAND, downslope, slope and fdist bitwise phase 4's
    knob-off tiled outputs, the rest within TRANSCENDENTAL; K1 not
    launched (the writer thread recomputes all of its rasters); pass C's
    downloads 18 B a cell, the truncation flags and retries apart.  The
    memmaps are written to ``bench_torch.py``'s input cache, where phase 9's
    out-of-core modes read them (the generator runs once)."""
    import tempfile

    import bench_torch
    import config5_torch

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="config5_", dir=os.path.join(ROOT, "build"))
    try:
        r, out, _ = config5_torch.run(BIG, TILE, 0, os.path.join(tmp, "out"),
                                      os.path.join(ROOT, bench_torch.INPUT_CACHE), dev,
                                      arrays=full, disk_probe_bytes=CONFIG5_PROBE_BYTES)
        launches = {k: r["launches"].get(k, 0) for k in TILED}  # counted from 0 over the tiled suite
        tiles = (BIG // TILE) ** 2
        # With the knobs on, the writer thread recomputes all of the
        # stencil's rasters, and pass C does not run it.
        if (launches["absorbing_walk"] != 2 * tiles or launches["downslope_walk_tracked"] < tiles
                or launches["stencil_padded"]):
            raise AssertionError(f"config 5 {BIG}x{BIG}: launches {launches}")
        checks = r["checks"]
        if not r["ok"]:
            raise AssertionError(f"config 5 {BIG}x{BIG}: {checks.get('failures')}")
        knobs = {k: r[k] for k in config5_torch.KNOB_BYTES_PER_CELL}
        if not all(knobs.values()) or r["download_bytes_per_cell"] != 18:
            raise AssertionError(f"config 5 {BIG}x{BIG}: knobs {knobs}, {r['download_bytes_per_cell']} B a cell")
        for k in BITWISE:
            if not np.array_equal(np.asarray(out[k]), tiled_out[k], equal_nan=out[k].dtype.kind == "f"):
                raise AssertionError(f"config 5 {BIG}x{BIG}/{k}: differs from phase 4's tiled output")
        for k in CLOSE:
            check_close(f"config 5 {BIG}x{BIG}/{k}", torch.as_tensor(np.asarray(out[k]), device=dev),
                        torch.as_tensor(tiled_out[k], device=dev))
        if out["hand"].dtype != np.int16:
            raise AssertionError(f"config 5: HAND is {out['hand'].dtype}, the dem's int16 expected")
        # Pass C downloads 18 B a cell, one byte a tile (the truncation
        # flag), and a retry's interior downslope and its flag.
        flags, retries = tiles, len(r["downslope_retry_halos"]) * (TILE * TILE * 4 + 1)
        c_d2h = r["d2h_bytes_by_pass"]["C"]
        if c_d2h != 18 * BIG * BIG + flags + retries:
            raise AssertionError(f"config 5 {BIG}x{BIG}: pass C downloaded {c_d2h} B, not 18 B a cell "
                                 f"+ {flags} + {retries}")
        inv, cl = checks["invariants"], checks["classification"]
        gb = lambda b: f"{b / 1e9:.3f} GB"
        print(f"config5 {BIG}x{BIG} in {TILE}x{TILE} tiles from memmaps, knobs {knobs}: launches {launches}; indices, "
              f"hand, downslope, slope, fdist bitwise phase 4's knob-off tiled outputs, slope_rad, twi, mod_twi, gfi, "
              f"ln_hl_h within {TRANSCENDENTAL}; {len(checks['windows'])} sample windows "
              f"ok; {inv['invariant_violations']} invariant violations in {inv['cells_checked']} cells "
              f"({inv['seconds']:.3f} s); threshold {cl['threshold']} Fit {cl['fit']!r} ({cl['seconds']:.3f} s)")
        print(f"config5 {BIG}x{BIG}: pass C downloaded {c_d2h} B = 18 B x {BIG * BIG} cells + {flags} B of "
              f"truncation flags + {retries} B of {len(r['downslope_retry_halos'])} retries; waits "
              f"{r['host_waits_s']}; writer thread {r['writer_s']}")
        print(f"config5 {BIG}x{BIG}: prep {r['input_prep_seconds']:.3f} s; wall {r['wall_s']:.3f} s (passes "
              f"{r['pass_s']}); peak device memory {r['peak_device_bytes'] / 2**30:.3f} GiB; link h2d "
              f"{gb(r['link']['h2d_bytes'])} at {r['link']['h2d_GBps']:.3f} GB/s, d2h {gb(r['link']['d2h_bytes'])} "
              f"at {r['link']['d2h_GBps']:.3f} GB/s; disk read {gb(r['disk']['suite_read_bytes'])}, written "
              f"{gb(r['disk']['suite_write_bytes'])}, probe {gb(r['disk']['probe']['bytes'])} written at "
              f"{r['disk']['probe']['write_Bps'] / 1e9:.3f} GB/s, read at {r['disk']['probe']['read_Bps'] / 1e9:.3f} "
              f"GB/s; floor {r['floor_s']:.3f} s ({r['bound_by']}), wall/floor {r['wall_over_floor']:.2f}  [{card}]")
        del out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"config5 phase: {time.perf_counter() - t_phase:.1f} s (sample checks {checks['sample_seconds']:.1f} s)")


SHARDED_MESH = (2, 4)  # 4096x2048 blocks of the 8192x8192 grid, all on one rank
SCALE_PER_CARD = 4096  # the weak-scaling script's share of the card in the scale scripts' phase
SCALE_MESH = (2, 4)  # the staged script's mesh at the basin's shape: 1089x384 blocks, 2 padding columns


def sharded_hook(times):
    """A ``stage_hook`` that records each stage's CUDA-event ms in ``times``."""
    def hook(name, compute):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = compute()
        stop.record()
        times.append((name, start, stop))
        return out

    return hook


def check_sharded_blocks(label, out, want, keys):
    """This rank's blocks of each ShardedRaster of ``out`` against the
    same window of the in-core rasters ``want``: BITWISE keys bitwise, the
    rest within TRANSCENDENTAL."""
    for name in keys:
        for b, t in out[name].blocks.items():
            ys, ye, xs, xe = out[name].window(b)
            check = check_bitwise if name in BITWISE else check_close
            check(f"{label}/{name}/block {b}", t, want[name][ys:ye, xs:xe])


def phase_sharded(dev, card, full):
    """The multi-card layer on one card: (a) a world of one over NCCL, mesh
    (2, 4) at 8192x8192, through K1, K5 and K6, against the in-core suite
    and the one-card classifier, with a forced retry through the
    multi-block exchange.  Ranks in processes of their own run in phase
    4d (``phase_scale_scripts``) and under ``--cards``."""
    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.downslope import downslope
    from descriptools_tpu_torch.parallel import (
        make_mesh, multihost, sharded_downslope, sharded_flow_hand, sharded_suite)
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.parallel.sharded import _staged

    cfg = pipeline.PipelineConfig()
    multihost.initialize(device="cuda")
    try:
        mesh = make_mesh(SHARDED_MESH)
        if (mesh.backend, mesh.world, mesh.device) != ("nccl", 1, dev):
            raise AssertionError(f"sharded: mesh {mesh}")
        blocks = mesh.n_blocks
        inputs = pipeline.inputs_to_torch(full["dem"], full["fdr"], full["fac"], full["river"], dev)
        want = pipeline.descriptor_suite(*inputs, cfg)
        # Config 3's flood map: HAND <= FLOOD_HAND, 90 % of those cells (seed 0).
        rand = torch.rand(want["hand"].shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        flood = ((want["hand"] != -100) & (want["hand"] <= FLOOD_HAND) & (rand < 0.9)).to(torch.int32)
        del rand
        one_card = sharded_classify_flood(want["hand"], flood)
        del inputs
        # inputs_to_torch's dtypes: dem and fac int32, fdr and river as given.
        args = (np.asarray(full["dem"], np.int32), full["fdr"], np.asarray(full["fac"], np.int32), full["river"],
                cfg, mesh)
        stats, stage_ms = {}, []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counters()
        t0 = time.perf_counter()
        out = sharded_suite(*args, shape=(BIG, BIG), crop=False, stage_hook=sharded_hook(stage_ms),
                            stats=stats)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counters()
        peak = torch.cuda.max_memory_allocated(dev)
        attempts = len(stats["downslope_attempts"])
        expect = dict(stencil_padded=blocks, absorbing_walk=blocks, downslope_walk_tracked=blocks * attempts)
        if any(launches[k] != n for k, n in expect.items()) or any(
                launches[k] for k in launches if k not in expect):
            raise AssertionError(f"sharded {BIG}x{BIG}: launches {launches}, expected {expect}")
        check_sharded_blocks(f"sharded {BIG}x{BIG}", out, want, (*BITWISE, *CLOSE))
        print(f"sharded_suite {BIG}x{BIG} on mesh {SHARDED_MESH} (world of one, nccl): launches {launches} "
              f"({blocks} blocks, {attempts} downslope attempt(s)); indices, hand, downslope, slope, fdist bitwise "
              f"the in-core suite")
        got = sharded_classify_flood(out["hand"], flood.cpu().numpy(), mesh, shape=(BIG, BIG))
        if got[:3] != one_card[:3] or not torch.equal(got[3], one_card[3]):
            raise AssertionError(f"sharded classify {BIG}x{BIG}: {got[:3]} vs one card {one_card[:3]}")
        print(f"sharded_classify_flood {BIG}x{BIG} on mesh {SHARDED_MESH} (flood: HAND <= {FLOOD_HAND}, 90 %, seed 0): "
              f"threshold {got[0]} Fit {got[2]!r} Correctness {got[1]!r}, class map identical to the one-card "
              "classifier")
        del out, got, want, one_card
        first_ms = {name: start.elapsed_time(stop) for name, start, stop in stage_ms}

        # Timed: the same run again, warm.
        stats, stage_ms = {}, []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = sharded_suite(*args, shape=(BIG, BIG), crop=False, stage_hook=sharded_hook(stage_ms), stats=stats)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        ms = {name: start.elapsed_time(stop) for name, start, stop in stage_ms}
        del out
        print(f"time sharded_suite {BIG}x{BIG} mesh {SHARDED_MESH}: stages (CUDA events) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"; wall {wall_s * 1e3:.3f} ms with staging from host numpy (first run {first_s * 1e3:.3f} ms, "
              + ", ".join(f"{k} {v:.3f}" for k, v in first_ms.items()) + f"); halo strips {stats['halo_bytes']} B "
              f"(device copies), handed to the group {stats['comm_bytes']} B in {stats['comm_calls']} calls; peak "
              f"device memory {peak / 2**30:.3f} GiB  [{card}]")
        # The flow stage by device activity (torch.profiler), on staged blocks.
        staged = [_staged(a, mesh, fill) for a, fill in zip(args[:4], (-100, 0, -100, 0))]
        flow = device_events(lambda: sharded_flow_hand(staged[0], staged[1], staged[3], staged[2], cfg.px, mesh,
                                                       shape=(BIG, BIG), fac0=float(args[2][0, 0]), crop=False), 1)
        flow.sort(key=lambda e: -e[1])
        print(f"sharded flow stage {BIG}x{BIG} by device activity (one call, torch.profiler): "
              f"{sum(us for _, us, _ in flow) / 1e3:.3f} ms in {sum(n for _, _, n in flow)} activities; top: "
              + "; ".join(f"{k[:60]} {us / 1e3:.3f} ms x{n}" for k, us, n in flow[:6]) + f"  [{card}]")
        del staged, flow

        # Forced retry: walks of 50-200 cells east from a halo of 8 on 32-wide
        # blocks, so the halo grows past one block.
        cols = 256
        prof = np.round((cols - np.arange(cols, dtype=np.float64)) ** 2 / 50.0)
        dem_e = (500.0 + prof * np.ones((48, 1))).astype(np.float32)
        fdr_e = np.full((48, cols), 1, np.uint8)
        mesh18 = make_mesh((1, 8))
        stats = {}
        reset_launch_counters()
        got = sharded_downslope(dem_e, fdr_e, cfg.px, 100.0, mesh18, halo=8, stats=stats)
        torch.cuda.synchronize()
        tracked = launch_counters()["downslope_walk_tracked"]
        halos = [a["halo"] for a in stats["downslope_attempts"]]
        ref = downslope(torch.as_tensor(dem_e, device=dev), torch.as_tensor(fdr_e, device=dev), cfg.px, 100.0,
                        engine="cuda")
        check_bitwise("sharded retry/downslope", got, ref)
        if stats["downslope_retries"] == 0 or halos[-1] <= cols // 8 or tracked != 8 * len(halos):
            raise AssertionError(f"sharded retry: halos {halos}, K6 launches {tracked}")
        print(f"sharded_downslope gentle east 48x{cols} on mesh (1, 8), halo 8: {stats['downslope_retries']} retries "
              f"(halos {halos}, past the 32-column blocks), K6 launches {tracked}; bitwise the in-core kernel")
    finally:
        multihost.shutdown()


SCRIPT_TIMEOUT_S = 300


def run_script(argv, timeout=SCRIPT_TIMEOUT_S):
    """Run a script at the repository's root (``[script, *args]``) as a user
    runs it, in a process of its own; raise unless it exits 0.  Returns its
    output and its JSON result line (the last line that is a JSON object)."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, argv[0]), *argv[1:]], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv)}: exit code {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.stdout, json.loads(lines[-1])


def check_script_launches(label, per_rank, blocks, attempts):
    """K1, K5 and K6 launched by a script's rank: one a block (K6 one a
    block an attempt)."""
    want = dict(stencil_padded=blocks, absorbing_walk=blocks, downslope_walk_tracked=blocks * attempts)
    for r, got in enumerate(per_rank):
        if got != want:
            raise AssertionError(f"{label} rank {r}: launches {got}, expected {want}")


def run_staged(argv, backend, card, timeout=SCRIPT_TIMEOUT_S):
    """``staged_scale_torch.py`` in its default mode with ``argv`` (``--n``,
    ``--mesh``, ``--cards``, ...), checkpoints in a temporary directory
    under ``build/``: every rank's blocks against the in-core suite on its
    card, the classification identical to the one-card classifier, the
    resume saving no stage again, the counted collective bytes equal to
    the measured, K1, K5 and K6 launched once a block (K6 once a block an
    attempt), over ``backend``.  Prints its line."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="staged_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        _, st = run_script(["staged_scale_torch.py", *argv, "--ckpt-dir", os.path.join(tmp, "ckpt")], timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not st["ok"] or st["backend"] != backend or st["resume"]["stages_saved_again"]:
        raise AssertionError(f"staged_scale_torch.py {' '.join(argv)}: {json.dumps(st)[:4000]}")
    blocks = st["mesh"][0] * st["mesh"][1] // st["ranks"]
    check_script_launches("staged_scale_torch.py", st["launches_per_rank"], blocks, st["downslope_retries"] + 1)
    print(f"staged_scale_torch.py --n {st['grid'][0]} {st['grid'][1]} --mesh {tuple(st['mesh'])} on {st['ranks']} "
          f"{backend} rank(s), {st['cards']} card(s): ok (every rank's blocks against the in-core suite, "
          f"classification identical to the one-card classifier, threshold {st['classification'][0]}); staging "
          f"{st['staging_s']:.3f} s, first run {st['first_run_s']:.3f} s with checkpoints ({st['checkpoint']['bytes']} "
          f"B in {st['checkpoint']['files']} files), resume {st['resume']['seconds']:.3f} s saving no stage again; "
          f"warm {st['warm_s'] * 1e3:.3f} ms, stages "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in st["warm_stage_ms"].items())
          + f"; bytes {st['collective_bytes']} equal to the count; launches {st['launches_per_rank']}; peak GiB "
          f"{st['peak_device_GiB_per_rank']}; {time.perf_counter() - t0:.1f} s with start-up  [{card}]")
    return st


def phase_scale_scripts(dev, card, full):
    """The scale scripts on this card, each in processes of its own as a
    user runs it: ``weak_scaling_torch.py`` in a world of one over NCCL at
    4096x4096 a card (phase 4's 8192x8192 inputs written to memmaps by
    ``config5_torch.prepare_inputs``; the script reads their top-left
    window), then ``staged_scale_torch.py``'s default mode on two gloo
    ranks on this card at the basin's shape, mesh (2, 4) (padded to 1536
    columns), with checkpoints and a resume.  Each script resets the launch
    counts before its runs and reports them: K1, K5 and K6 one a block (K6
    one a block an attempt)."""
    import tempfile

    import config5_torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="scale_", dir=os.path.join(ROOT, "build"))
    try:
        inputs = os.path.join(tmp, "inputs")
        config5_torch.prepare_inputs(BIG, 0, inputs, arrays=full)
        t0 = time.perf_counter()
        _, ws = run_script(["weak_scaling_torch.py", "--per-card", str(SCALE_PER_CARD), "--cards", "1", "--seed",
                            "0", "--input-cache", inputs])
        rows = ws["weak_scaling"]
        row = rows[0] if len(rows) == 1 else None
        if not ws["ok"] or row is None or (row["devices"], row["backend"], row["weak_scaling_efficiency"]) != (
                1, "nccl", 1.0) or not row["collective_bytes_match"]:
            raise AssertionError(f"weak_scaling_torch.py: {json.dumps(ws)[:4000]}")
        check_script_launches("weak_scaling_torch.py", row["launches_per_run_per_rank"], row["blocks_per_rank"],
                              len(row["downslope_halos"]))
        ph = ", ".join(f"{k} {v['seconds'] * 1e3:.3f} ms" for k, v in row["phases"].items())
        print(f"weak_scaling_torch.py --per-card {SCALE_PER_CARD} --cards 1 (world of one, {row['backend']}): "
              f"{row['grid'][0]}x{row['grid'][1]} on mesh {row['mesh']}, {row['seconds'] * 1e3:.3f} ms a run "
              f"(median of {ws['iters']}), {row['grid_points_per_s'] / 1e6:.2f} M grid-points/s; stages {ph}; null "
              f"baseline {row['null_baseline_seconds'] * 1e3:.3f} ms; in core {row['single_device_seconds'] * 1e3:.3f} "
              f"ms (overhead {row['decomposition_overhead_vs_single_device']:.3f}); bytes {row['collective_bytes']} "
              f"equal to the count; launches a run {row['launches_per_run_per_rank'][0]}; peak "
              f"{row['peak_device_GiB_per_rank'][0]:.3f} GiB; {time.perf_counter() - t0:.1f} s with start-up  "
              f"[{card}]")
        run_staged(["--n", str(ROWS), str(COLS), "--mesh", *map(str, SCALE_MESH), "--cards", "1", "--ranks", "2"],
                   "gloo", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"scale scripts phase: {time.perf_counter() - t_phase:.1f} s")


def main_cards(n):
    """``--cards n``: ``staged_scale_torch.py``'s default mode over NCCL
    across n cards, one rank a card, mesh (2, 4) at 8192x8192 (``run_staged``:
    each rank checks its blocks, then resumes); then
    ``weak_scaling_torch.py --per-card 8192`` over 1, 2, ... n cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"chip_smoke --cards {n}: needs {n} CUDA devices")
    start = time.perf_counter()
    phase_device()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"cards: {cards}")
    run_staged(["--n", str(BIG), "--mesh", *map(str, SHARDED_MESH), "--cards", str(n)], "nccl", cards[0],
               timeout=900)
    t0 = time.perf_counter()
    out, ws = run_script(["weak_scaling_torch.py", "--per-card", str(BIG), "--cards", str(n)], timeout=1800)
    print("\n".join(ln for ln in out.splitlines() if not ln.startswith("{")))
    print(json.dumps(ws))
    if not ws["ok"] or [r["devices"] for r in ws["weak_scaling"]] != [1 << k for k in range(n.bit_length())]:
        raise AssertionError(f"weak_scaling_torch.py --cards {n}: {ws['failures']}")
    for v in ws["conclusion"]:
        print(f"weak scaling: {v['text']}")
    print(f"weak_scaling_torch.py --per-card {BIG} --cards {n}: {time.perf_counter() - t0:.1f} s; run "
          f"{time.perf_counter() - start:.1f} s")


def phase_checkpointed(dev, card, basin, full, errs):
    """The large-grid entry point: the blocked engine at the basin's shape
    against its plain version, then the checkpointed suite at 8192x8192,
    killed inside its flow stage and resumed, against the uninterrupted
    suite; the fold kernel against its plain version at that size."""
    import tempfile

    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.cuda import walk

    blocked = pipeline.PipelineConfig(engine="cuda_blocked")
    small = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(*small, blocked)
    torch.cuda.synchronize()
    launches = launch_counters()
    if any(launches[k] == 0 for k in BLOCKED) or launches["flow_walk"]:
        raise AssertionError(f"cuda_blocked suite: launches {launches}")
    plain = pipeline.descriptor_suite(*small, pipeline.PipelineConfig(engine="torch_blocked"))
    for name in BITWISE:
        check_bitwise(f"blocked suite/{name}", out[name], plain[name])
    for name in CLOSE:
        check_close(f"blocked suite/{name}", out[name], plain[name])
    counts = pipeline.descriptor_suite(*small, pipeline.PipelineConfig(engine="cuda"))
    check_bitwise("blocked suite/indices vs cuda", out["indices"], counts["indices"])
    print(f"cuda_blocked suite {ROWS}x{COLS}: launches {launches}; matches torch_blocked (integers, slope, "
          f"downslope, fdist bitwise); fdist differs from engine='cuda' on "
          f"{int((out['fdist'] != counts['fdist']).sum())} cells")
    del small, out, plain, counts

    inputs = pipeline.inputs_to_torch(full["dem"], full["fdr"], full["fac"], full["river"], dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipeline.descriptor_suite(*inputs, blocked)
    torch.cuda.synchronize()
    print(f"in-core cuda_blocked suite {BIG}x{BIG}: peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB  [{card}]")
    real_flow, real_stencil, real_down = (
        pipeline._engine_flow, pipeline._engine_stencil, pipeline._engine_downslope)

    def dying_flow(*a, **k):
        raise RuntimeError("simulated preemption")

    def poisoned(*a, **k):
        raise AssertionError("the resume recomputed a completed stage")

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ckdir = os.path.join(tmp, "ck")
        first, resumed = {}, {}
        reset_launch_counters()
        try:
            pipeline._engine_flow = dying_flow
            try:
                pipeline.run_suite_checkpointed(*inputs, blocked, ckdir, stats=first)
                raise AssertionError("the patched flow stage did not die")
            except RuntimeError as err:
                if "simulated preemption" not in str(err):
                    raise
            pipeline._engine_flow = real_flow
            pipeline._engine_stencil = pipeline._engine_downslope = poisoned
            before = launch_counters()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state = pipeline.run_suite_checkpointed(*inputs, blocked, ckdir, stats=resumed)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            pipeline._engine_flow, pipeline._engine_stencil, pipeline._engine_downslope = (
                real_flow, real_stencil, real_down)
        launches = launch_counters()
        if any(launches[k] == 0 for k in BLOCKED) or launches["flow_walk"]:
            raise AssertionError(f"checkpointed {BIG}x{BIG}: launches {launches}")
        if launches["stencil"] != before["stencil"] or launches["downslope_walk"] != before["downslope_walk"]:
            raise AssertionError(f"the resume relaunched a completed stage's kernel: {before} -> {launches}")
        if [resumed[s]["resumed"] for s in ("stencil", "walks", "flow", "pointwise")] != [True, True, False, False]:
            raise AssertionError(f"resume stages: {resumed}")
        on_disk = sum(os.path.getsize(os.path.join(ckdir, f)) for f in os.listdir(ckdir))
    for name, row in [*((f"killed run {k}", v) for k, v in first.items()),
                      *((f"resume {k}", v) for k, v in resumed.items())]:
        print(f"checkpointed {BIG}x{BIG} {name}: {row['seconds']:.3f} s, saved {row['saved_bytes'] / 1e9:.3f} GB, "
              f"loaded {row['loaded_bytes'] / 1e9:.3f} GB{' (resumed)' if row['resumed'] else ''}  [{card}]")
    print(f"checkpointed {BIG}x{BIG}: launches {launches}; resume {resume_s:.3f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB; {on_disk / 1e9:.3f} GB on disk  [{card}]")

    want = pipeline.descriptor_suite(*inputs, blocked)
    for name, t in want.items():
        check_bitwise(f"checkpointed {BIG}x{BIG}/{name}", state[name], t)
    hand, fac = state["hand"], inputs[2]
    valid = inputs[0] != -100
    if not bool(torch.isfinite(state["fdist"][valid]).all()) or not bool(((hand == -100) | (hand >= 0)).all()):
        raise AssertionError(f"checkpointed {BIG}x{BIG}: non-finite fdist or negative HAND")
    print(f"checkpointed {BIG}x{BIG} killed in the flow stage and resumed: every raster bitwise the "
          f"uninterrupted cuda_blocked suite; the resume loaded stencil and walks")
    del state, want, hand, fac, valid

    # The fold kernel against its plain version on this grid's operands.
    ops = flow.walk_inputs(inputs[1], inputs[3])
    consts = flow.step_consts(12.5)
    e = 0.0
    for name, g, w in zip(("code", "dist"), walk.flow_walk_blocked(*ops, *consts, 20000),
                          flow.fold_walk(*ops, *consts, 20000)):
        e = max(e, check_bitwise(f"fold {BIG}x{BIG}/{name}", g, w))
    errs["flow_walk_blocked"] = max(errs["flow_walk_blocked"], e)
    def fold_big():
        return walk.flow_walk_blocked(*ops, *consts, 20000)

    t = timed(ops, fold_big, lambda: flow.fold_walk(*ops, *consts, 20000))
    fb = walk.flow_walk_blocked
    print(f"time flow_walk_blocked {BIG}x{BIG} (K {fb.rounds}, P {fb.pending}, jump walk R {fb.jump_rounds}): "
          f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); matches plain bitwise (code, dist)  [{card}]")
    fold_split(f"{BIG}x{BIG}", fold_big, card)
    del ops, inputs
    torch.cuda.empty_cache()
    return launches, {"flow_walk_blocked": t}


def reference_script(compat, basin, device):
    """The reference example's flow (Example/example.py:59-147) through
    ``compat`` on ``device``: rasters and the evaluation's results."""
    dem, fdr, river = basin["dem"].astype(np.int16), basin["fdr"], basin["river"]
    fac = basin["fac"].astype(np.int64)
    sl = compat.sloper(dem, 12.5, device=device).astype("float32")
    out = dict(slope=sl)
    sl = np.where(dem == -100, -100, np.arctan(sl / 100).astype("float32"))
    out["twi"], out["mod_twi"] = compat.topographic_index(fac, sl, 12.5, 0.1, device=device)
    out["downslope"] = compat.downsloper(dem, fdr, 12.5, 5, device=device)
    out["fdist"], out["indices"], out["hand"] = compat.flow_hand_index(dem, fdr, river, 12.5, device=device)
    out["gfi"] = compat.gfi_calculator(out["hand"], fac, out["indices"], 0.4, 0.1, 12.5, device=device)
    out["ln_hl_h"] = compat.ln_hl_H_calculator(out["hand"], fac, 0.4, 0.1, 12.5, device=device)
    elements = np.unique(out["hand"])
    out["desc"] = compat.minMaxScale(out["hand"], elements[1], elements[-1], -100)
    th = compat.calibration(out["desc"], basin["flood"], "under")
    c, f, out["class_map"] = compat.avaliacao(compat.binary_map(out["desc"], th, "under"), basin["flood"])
    return out, (th, c, f)


def phase_compat(dev, basin):
    """The reference script through ``compat`` on the card (the downslope
    and jump-walk kernels) against the same script on the CPU."""
    from descriptools_tpu_torch import compat
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters

    card = card_line()
    reset_launch_counters()
    t0 = time.perf_counter()
    got, got_eval = reference_script(compat, basin, dev)
    card_s = time.perf_counter() - t0
    launches = launch_counters()
    if not (launches["downslope_walk"] and launches["flow_walk"]):
        raise AssertionError(f"compat on the card: launches {launches}")
    t0 = time.perf_counter()
    want, want_eval = reference_script(compat, basin, "cpu")
    cpu_s = time.perf_counter() - t0
    for name in ("indices", "hand", "downslope", "slope", "fdist", "desc", "class_map"):
        check_bitwise(f"compat/{name}", torch.as_tensor(got[name]), torch.as_tensor(want[name]))
    for name in ("twi", "mod_twi", "gfi", "ln_hl_h"):
        check_close(f"compat/{name}", torch.as_tensor(got[name]), torch.as_tensor(want[name]))
    if got_eval != want_eval:
        raise AssertionError(f"compat evaluation: card {got_eval}, CPU {want_eval}")
    print(f"compat reference script {ROWS}x{COLS} on the card (launches {launches}): equal to device='cpu' "
          f"(indices, hand, downslope, slope, fdist, class map bitwise; threshold {got_eval[0]} Fit "
          f"{float(got_eval[2])!r}); card {card_s:.3f} s, CPU {cpu_s:.3f} s  [{card}]")


def phase_oracle(dev, basin):
    """The card's suite on a crop of the basin against the float64 oracles
    of ``oracle/core``: integers exact, floats within rtol 2e-5."""
    from descriptools_tpu_torch import oracle, pipeline

    crop = np.s_[900:1150, 400:700]
    dem, fdr, fac, river = (basin[k][crop] for k in ("dem", "fdr", "fac", "river"))
    cfg = pipeline.PipelineConfig()
    out = {k: v.cpu().numpy() for k, v in pipeline.descriptor_suite(
        *pipeline.inputs_to_torch(dem, fdr, fac, river, dev), cfg).items()}
    fdist, idx = oracle.flow_distance_index_oracle(fdr, river, cfg.px)
    hand = oracle.hand_oracle(dem.astype(np.int32), idx)
    for name, want in (("indices", idx), ("hand", hand)):
        if not np.array_equal(out[name], want):
            raise AssertionError(f"oracle probe/{name}: {int((out[name] != want).sum())} cells differ")
    sl_rad = out["slope_rad"].astype(np.float64)
    rfac = oracle.river_accumulation_oracle(fac, idx)
    floats = {
        "slope": (oracle.slope_oracle(dem, cfg.px), 1e-3),
        "fdist": (fdist, 1e-3),
        "downslope": (oracle.downslope_oracle(dem, fdr, cfg.px, cfg.elevation_difference), 1e-4),
        "twi": (oracle.topographic_index_oracle(fac, sl_rad, cfg.px), 1e-4),
        "mod_twi": (oracle.modified_topographic_index_oracle(fac, sl_rad, cfg.px, cfg.n_topo), 1e-4),
        "gfi": (oracle.gfi_oracle(hand, rfac, cfg.n_gfi, cfg.b_gfi, cfg.px), 1e-4),
        "ln_hl_h": (oracle.ln_hl_h_oracle(hand, fac, cfg.n_gfi, cfg.b_gfi, cfg.px), 1e-4),
    }
    worst = {}
    for name, (want, atol) in floats.items():
        got = out[name].astype(np.float64)
        if not np.allclose(got, want, rtol=2e-5, atol=atol, equal_nan=True):
            raise AssertionError(f"oracle probe/{name}: outside rtol 2e-5, atol {atol}")
        both = np.isfinite(got) & np.isfinite(want)
        worst[name] = float(np.abs(got - want)[both].max()) if both.any() else 0.0
    print(f"oracle probe, the card's suite on the basin crop [900:1150, 400:700]: indices and hand exact, "
          f"{int((idx != -100).sum())} landed; floats within rtol 2e-5 (max abs err {worst})")


SIDE = 10000  # BASELINE config 3: a 10000x10000 DEM, 1e8 cells
RIVER_FAC = 10  # config 3's river: cells with more than this many upstream cells
FLOOD_HAND = 5  # config 3's flood map: HAND <= this, 90 % of those cells (seeded)


def phase_config3(dev, card, errs):
    """BASELINE config 3 on the card: terrain from a 10000x10000 DEM, the
    accumulation's entry against its plain version on both tile mixes
    (``accumulation_on_tile_mixes``), the suite through the kernels, the
    exact calibration on the card.  Returns the accumulation's
    ({"accumulation": launches}, {"accumulation": timing})."""
    from descriptools_tpu_torch import d8, pipeline, tiled
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.cuda import terrain as ct
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    # Accumulation bitwise to the CPU at the basin's shape.
    small = synthetic_dem(ROWS, COLS, seed=0).astype(np.int32)
    got = terrain.derive_terrain(torch.as_tensor(small, device=dev))
    want = terrain.derive_terrain(torch.as_tensor(small))
    for name, g, w in zip(("fdr", "fac"), got, want):
        check_bitwise(f"derive_terrain {ROWS}x{COLS} {name}", g.cpu(), w)
    print(f"derive_terrain synthetic_dem({ROWS}, {COLS}, seed=0) on the card: fdr and fac bitwise the CPU's")
    acc_launches, acc_times = accumulation_on_tile_mixes(dev, card, errs)

    t0 = time.perf_counter()
    dem_np = synthetic_dem(SIDE, SIDE, seed=0).astype(np.int32)
    print(f"config 3: synthetic_dem({SIDE}, {SIDE}, seed=0) as int32 generated on the host in "
          f"{time.perf_counter() - t0:.3f} s")
    dem = torch.as_tensor(dem_np, device=dev)
    n = SIDE * SIDE
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    fdr, fac = terrain.derive_terrain(dem, stats=stats)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    terrain_ms = median_ms(lambda: terrain.derive_terrain(dem), 3)
    d8_ms = median_ms(lambda: ct.d8_successor(dem), 3)
    print(f"config 3 derive_terrain {SIDE}x{SIDE}: {terrain_ms:.3f} ms, d8_successor {d8_ms:.3f} ms of it; "
          f"{stats['rounds']} rounds, live cells entering each: {stats['live']}; peak device memory "
          f"{peak / 2**30:.3f} GiB  [{card}]")

    t0 = time.perf_counter()
    fdr_cpu = d8.d8_flow_direction(torch.from_numpy(dem_np))
    cpu_s = time.perf_counter() - t0
    check_bitwise("config 3 fdr vs the CPU", fdr.cpu(), fdr_cpu)
    del fdr_cpu
    # The donor-sum identity over every cell: fac[c] = sum over the cells
    # d whose D8 step lands on c of (fac[d] + 1); NoData cells hold -100.
    succ, _, ok, _ = d8.successor(fdr, SIDE, SIDE)
    ok = ok.reshape(-1)
    flat = fac.reshape(-1).long()
    donor_sum = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, succ.reshape(-1)[ok].long(), flat[ok] + 1)
    data = dem.reshape(-1) != -100
    bad = int(((flat != donor_sum) & data).sum()) + int(((flat != -100) & ~data).sum()) + int((ok & ~data).sum())
    if bad:
        raise AssertionError(f"config 3: {bad} cells break the donor-sum identity")
    del succ, ok, flat, donor_sum, data
    print(f"config 3 fdr bitwise the CPU's d8_flow_direction ({cpu_s:.3f} s on the host); fac: 0 donor-sum "
          f"violations over {n} cells; max fac {int(fac.max())}")

    river = (fac > RIVER_FAC).to(torch.int8)
    cfg = pipeline.PipelineConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(dem, fdr, fac, river, cfg)
    torch.cuda.synchronize()
    launches = launch_counters()
    if any(launches[k] == 0 for k in IN_CORE):
        raise AssertionError(f"config 3 suite: launches {launches}")
    suite_peak = torch.cuda.max_memory_allocated(dev)
    suite_ms = median_ms(lambda: pipeline.descriptor_suite(dem, fdr, fac, river, cfg), 3)
    plain = pipeline.descriptor_suite(dem, fdr, fac, river, pipeline.PipelineConfig(engine="torch"))
    for name in BITWISE:
        check_bitwise(f"config 3 suite/{name}", out[name], plain[name])
    for name in CLOSE:
        check_close(f"config 3 suite/{name}", out[name], plain[name])
    del plain
    landed = int((out["indices"] != -100).sum())
    print(f"config 3 suite {SIDE}x{SIDE}, river fac > {RIVER_FAC} ({int(river.sum())} cells): launches "
          f"{launches}; matches engine='torch' (integers, slope, downslope, fdist bitwise); {landed} landed; "
          f"{suite_ms:.3f} ms ({n / suite_ms / 1e3:.3f} M grid-points/s), peak device memory "
          f"{suite_peak / 2**30:.3f} GiB  [{card}]")

    hand = out["hand"]
    del out
    rand = torch.rand(hand.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    flood = ((hand != -100) & (hand <= FLOOD_HAND) & (rand < 0.9)).to(torch.int8)
    del rand
    got = sharded_classify_flood(hand, flood)
    one_card_ms = wall_ms(lambda: sharded_classify_flood(hand, flood), 3)
    hand_np, flood_np = hand.cpu().numpy(), flood.cpu().numpy()
    t0 = time.perf_counter()
    want = tiled.tiled_classify_flood(hand_np, tiled._array_loader(flood_np), (SIDE, SIDE),
                                      tile_rows=TILE, tile_cols=TILE)
    host_s = time.perf_counter() - t0
    if got[:3] != want[:3] or not np.array_equal(got[3].cpu().numpy(), want[3]):
        raise AssertionError(f"config 3 classify: card {got[:3]}, host {want[:3]}")
    print(f"config 3 sharded_classify_flood {SIDE}x{SIDE} (flood: HAND <= {FLOOD_HAND}, 90 %, seed 0): "
          f"threshold {got[0]} Fit {got[2]!r} Correctness {got[1]!r}, class map identical to the host "
          f"tiled_classify_flood; card {one_card_ms:.3f} ms, host {host_s:.3f} s  [{card}]")
    del hand, flood, dem, fdr, fac, river, got
    torch.cuda.empty_cache()
    return acc_launches, acc_times


FLOAT_MIX = os.path.join(ROOT, "benchmark", "traffic", "float_dem_to_classmap.json")
FLOAT_CONFIG = os.path.join(ROOT, "benchmark", "configs", "lidar_3dep_1m.json")
FLOAT_SEED = 2147507200  # the first of the LiDAR cell's reading seeds


def phase_float_dem(dev, card, errs):
    """A float DEM at the LiDAR cell's size: the cell's mix and settings,
    K3 bitwise its plain engine with fractional terminal stops, the float
    calibration's launches and result, and its counting kernel against
    its plain version on each stage's cutoffs.  Returns ({"cutoff_count":
    launches}, {"cutoff_count": timing}), the timing of the stage with the
    most cutoffs."""
    from benchmark import inputs as bench_inputs
    from benchmark.reference import classify as ref_classify
    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.ops.cuda import classify as cc
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.downslope import _downslope_jacobi, jacobi_walk, walk_inputs
    from descriptools_tpu_torch.parallel import classify as pc

    t_phase = time.perf_counter()
    with open(FLOAT_MIX) as f:
        mix = json.load(f)
    with open(FLOAT_CONFIG) as f:
        config = json.load(f)
    rows, cols = config["rows"], config["cols"]
    cfg = pipeline.PipelineConfig(**config["pipeline"])
    torch.cuda.empty_cache()
    x = bench_inputs.make_input(mix, rows, cols, FLOAT_SEED, dev)
    dem, flood = x["dem"], x["flood"]
    valid = dem != -100
    frac = int((valid & (dem != torch.round(dem))).sum())
    fdr, fac = terrain.derive_terrain(dem)
    river = (fac > mix["river"]["fac_above"]).to(torch.int8)
    out = pipeline.descriptor_suite(dem, fdr, fac, river, cfg)
    hand = out["hand"]
    downslope = out["downslope"]
    del out
    print(f"float DEM {rows}x{cols} (the LiDAR mix, seed {FLOAT_SEED}): {frac} of {int(valid.sum())} valid cells "
          f"at a fractional elevation; river fac > {mix['river']['fac_above']} ({int(river.sum())} cells)  [{card}]")

    # K3 (the suite's downslope) on the fractional DEM against the plain
    # engine, and the walks that stop at a terminal of fractional elevation
    # (where an offset encoding of terminals would round).
    args = (dem, fdr, cfg.px, cfg.elevation_difference, cfg.downslope_max_steps)
    check_bitwise("float DEM downslope: K3 vs _downslope_jacobi", downslope, _downslope_jacobi(*args))
    fdr_eff, z, term0 = walk_inputs(dem, fdr, cfg.px)
    pk, z_stop, at_terminal = jacobi_walk(fdr_eff, z, term0, cfg.elevation_difference,
                                          cfg.downslope_max_steps, trunc0=term0)
    stopped = at_terminal & (pk != 0) & valid
    frac_stops = int((stopped & (z_stop != torch.round(z_stop))).sum())
    if not frac_stops:
        raise AssertionError("float DEM: no walk stops at a terminal of fractional elevation")
    print(f"float DEM downslope: K3 bitwise _downslope_jacobi; {int(stopped.sum())} walks stop at a terminal, "
          f"{frac_stops} of them at a fractional elevation")
    del fdr_eff, z, term0, pk, z_stop, at_terminal, stopped, downslope, fdr, fac, river

    # The float calibration: its launches with the counters reset just
    # before, its result against the benchmark's float64 reference, and
    # each stage's cutoffs recorded for the kernel's own check.
    stages = []
    real = pc._block_cut_counts

    def recording(hand_blk, bench_blk, h00, cuts, under):
        stages.append(np.array(cuts, dtype=np.float32))
        return real(hand_blk, bench_blk, h00, cuts, under)

    pc._block_cut_counts = recording
    try:
        reset_launch_counters()
        got = pc.sharded_classify_flood(hand, flood)
        torch.cuda.synchronize()
        launches = launch_counters()
    finally:
        pc._block_cut_counts = real
    if launches["cutoff_count"] != 5 or any(n for k, n in launches.items() if k != "cutoff_count"):
        raise AssertionError(f"float calibration: launches {launches}, not 5 cutoff_count")
    th, correctness, fit, class_map = ref_classify.classify_flood(hand, flood, torch.float64)
    want = (float(th), float(correctness), float(fit))
    if got[:3] != want or not torch.equal(got[3], class_map):
        raise AssertionError(f"float calibration: {got[:3]} vs the reference's {want}")
    del class_map
    classify_ms = wall_ms(lambda: pc.sharded_classify_flood(hand, flood), 3)
    print(f"float calibration sharded_classify_flood {rows}x{cols}: launches {launches}; threshold {got[0]} "
          f"Fit {got[2]!r} Correctness {got[1]!r}, class map identical to the benchmark's float64 reference; "
          f"cutoffs a pass {[len(c) for c in stages]}; {classify_ms:.3f} ms  [{card}]")

    # The counting kernel against its plain version on the same card
    # tensors, a stage at a time: bitwise, timed, its bound the bytes.
    hand_s, flood_s = hand.to(torch.float32).contiguous(), flood.to(torch.int32).contiguous()
    h00 = hand_s[0, 0]
    cells = hand_s.numel()
    bound = cells * (4 + 4) / HBM_BYTES_PER_MS
    rows_out = []
    for cuts in stages:
        kernel = lambda c=cuts: cc.cutoff_count(hand_s, flood_s, h00, c)  # noqa: E731
        plain = lambda c=cuts: cc.cutoff_count_plain(hand_s, flood_s, h00, c)  # noqa: E731
        check_bitwise(f"cutoff_count {len(cuts)} cutoffs vs cutoff_count_plain", kernel(), plain())
        # Many calls: a trace late in a session can miss its first records.
        traced = [ms for name, ms in device_kernels_ms(kernel).items() if "cutoff_count_kernel" in name]
        shown = f"{traced[0]:.4f}" if len(traced) == 1 else f"not traced ({len(traced)} kernels)"
        rows_out.append(dict(cuts=len(cuts), ms=median_ms(kernel), plain_ms=median_ms(plain)))
        print(f"time cutoff_count {len(cuts)} cutoffs: kernel {rows_out[-1]['ms']:.4f} ms (device {shown}), "
              f"plain {rows_out[-1]['plain_ms']:.3f} ms, bound {bound:.4f} ms (8 B a cell)  [{card}]")
    errs["cutoff_count"] = 0.0
    widest = max(rows_out, key=lambda r: r["cuts"])
    del hand, flood, hand_s, flood_s, got, dem, valid, x
    torch.cuda.empty_cache()
    print(f"float DEM phase: {time.perf_counter() - t_phase:.1f} s")
    return ({"cutoff_count": launches["cutoff_count"]},
            {"cutoff_count": dict(ms=widest["ms"], plain_ms=widest["plain_ms"], bound_ms=bound,
                                  bound_by="bytes")})


TILE_MIXES = (("srtm_tile_10k", "dem_to_classmap"), ("lidar_3dep_1m", "float_dem_to_classmap"))
D8_SEED = 2147507300
ACCUMULATION_SEED = 2147507400


def tile_mix_dem(dev, config_name, mix_name, seed):
    """(the DEM of a tile cell's mix at its size on the card, rows, cols)."""
    from benchmark import inputs as bench_inputs

    with open(os.path.join(ROOT, "benchmark", "traffic", f"{mix_name}.json")) as f:
        mix = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs", f"{config_name}.json")) as f:
        config = json.load(f)
    rows, cols = config["rows"], config["cols"]
    return bench_inputs.make_input(mix, rows, cols, seed, dev)["dem"], rows, cols


def accumulation_on_tile_mixes(dev, card, errs):
    """The accumulation's C entry against ``flow_accumulation_plain`` on the
    card, on the D8 successor of each tile cell's DEM (its mix at its size):
    fac, stats and the jumped successor bitwise; ``derive_terrain``, with
    the counters reset just before, launches the entry once; each timed
    (CUDA events, with the successor's copy that each call needs: the
    rounds overwrite it) with its device time by activity (torch.profiler)
    and its peak device memory above what it was given, beside the bound,
    8 B a cell (succ read, fac written) at the card's memory rate.
    Returns ({"accumulation": launches a ``derive_terrain``},
    {"accumulation": timing}), the timing on the LiDAR mix, the longer."""
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.cuda import terrain as ct

    t_phase = time.perf_counter()
    rows_out = []
    for config_name, mix_name in TILE_MIXES:
        torch.cuda.empty_cache()
        dem, rows, cols = tile_mix_dem(dev, config_name, mix_name, ACCUMULATION_SEED)
        reset_launch_counters()
        terrain.derive_terrain(dem)
        torch.cuda.synchronize()
        counted = launch_counters()
        if counted["accumulation"] != 1:
            raise AssertionError(f"derive_terrain on the {mix_name} DEM: launches {counted}, not one accumulation")
        fdr, succ = ct.d8_successor(dem)
        del dem
        calls = {}
        for name, fn in (("entry", terrain.flow_accumulation), ("plain", terrain.flow_accumulation_plain)):
            jumped = succ.clone()
            stats = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fac = fn(fdr, stats=stats, succ=jumped)
            torch.cuda.synchronize()
            calls[name] = dict(fac=fac, stats=stats, succ=jumped,
                               peak=torch.cuda.max_memory_allocated(dev) - base)
        check_bitwise(f"accumulation {mix_name} fac vs flow_accumulation_plain", calls["entry"]["fac"],
                      calls["plain"]["fac"])
        check_bitwise(f"accumulation {mix_name} jumped succ vs flow_accumulation_plain", calls["entry"]["succ"],
                      calls["plain"]["succ"])
        if calls["entry"]["stats"] != calls["plain"]["stats"]:
            raise AssertionError(f"accumulation {mix_name} stats: {calls['entry']['stats']} vs "
                                 f"{calls['plain']['stats']}")
        stats = calls["entry"]["stats"]
        peaks = {k: v["peak"] for k, v in calls.items()}
        del calls, fac, jumped
        entry = lambda: terrain.flow_accumulation(fdr, succ=succ.clone())  # noqa: E731
        plain = lambda: terrain.flow_accumulation_plain(fdr, succ=succ.clone())  # noqa: E731
        bound = fdr.numel() * 8 / HBM_BYTES_PER_MS
        row = dict(ms=median_ms(entry), plain_ms=median_ms(plain, 3), bound_ms=bound, bound_by="bytes")
        rows_out.append(row)
        for name, fn in (("entry", entry), ("plain", plain)):
            by_activity = device_kernels_ms(fn, calls=3 if name == "plain" else 6 * REPEATS)
            top = sorted(by_activity.items(), key=lambda kv: -kv[1])[:6]
            print(f"accumulation {mix_name} {name}: device time a call by activity (torch.profiler, the "
                  f"successor's copy included): " + ", ".join(f"{k[:48]} {v:.4f} ms" for k, v in top)
                  + f"; all {len(by_activity)} activities {sum(by_activity.values()):.4f} ms")
        print(f"time accumulation {mix_name} {rows}x{cols} (seed {ACCUMULATION_SEED}): entry {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.3f} ms (each with the successor's copy), bound {bound:.4f} ms (8 B a "
              f"cell); {stats['rounds']} rounds, live cells entering each {stats['live']} "
              f"({sum(stats['live'])} in all); peak device memory above its operands: entry "
              f"{peaks['entry'] / 2**30:.3f} GiB, plain {peaks['plain'] / 2**30:.3f} GiB; fac, stats and the "
              f"jumped successor bitwise; derive_terrain launches it once  [{card}]")
        del fdr, succ
    errs["accumulation"] = 0.0
    torch.cuda.empty_cache()
    print(f"accumulation phase: {time.perf_counter() - t_phase:.1f} s")
    return {"accumulation": counted["accumulation"]}, {"accumulation": rows_out[-1]}


def phase_d8(dev, card, errs):
    """Terrain's D8 kernel on each tile cell's DEM (its mix at its size):
    ``derive_terrain``, with the launch counters set to 0 just before,
    launches ``d8_successor`` once, the accumulation once and no other
    kernel; fdr and succ are bitwise the plain version's on the same card
    tensor; the kernel's time (CUDA events) and device time
    (torch.profiler) beside its bound and the plain version's time.  Returns ({"d8_successor": launches a
    ``derive_terrain``}, {"d8_successor": timing}), the timing on the
    first mix."""
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
    from descriptools_tpu_torch.ops.cuda import terrain as ct

    t_phase = time.perf_counter()
    launches = []
    rows_out = []
    for config_name, mix_name in TILE_MIXES:
        torch.cuda.empty_cache()
        dem, rows, cols = tile_mix_dem(dev, config_name, mix_name, D8_SEED)
        reset_launch_counters()
        terrain.derive_terrain(dem)
        torch.cuda.synchronize()
        counted = launch_counters()
        if counted != {**dict.fromkeys(counted, 0), "d8_successor": 1, "accumulation": 1}:
            raise AssertionError(f"derive_terrain on the {mix_name} DEM: launches {counted}, not one "
                                 f"d8_successor, one accumulation and no other kernel")
        launches.append(counted["d8_successor"])
        kernel = lambda d=dem: ct.d8_successor(d)  # noqa: E731
        plain = lambda d=dem: ct.d8_successor_plain(d)  # noqa: E731
        got, want = kernel(), plain()
        check_bitwise(f"d8_successor {mix_name} fdr vs d8_successor_plain", got[0], want[0])
        check_bitwise(f"d8_successor {mix_name} succ vs d8_successor_plain", got[1], want[1])
        del got, want
        traced = [ms for name, ms in device_kernels_ms(kernel).items() if "d8_kernel" in name]
        shown = f"{traced[0]:.4f}" if len(traced) == 1 else f"not traced ({len(traced)} kernels)"
        bound = dem.numel() * (dem.element_size() + 4 + 4) / HBM_BYTES_PER_MS
        rows_out.append(dict(ms=median_ms(kernel), plain_ms=median_ms(plain, 3), bound_ms=bound,
                             bound_by="bytes"))
        print(f"time d8_successor {mix_name} {rows}x{cols} ({dem.dtype}, seed {D8_SEED}): kernel "
              f"{rows_out[-1]['ms']:.4f} ms (device {shown}), plain {rows_out[-1]['plain_ms']:.3f} ms, bound "
              f"{bound:.4f} ms ({dem.element_size() + 8} B a cell); fdr and succ bitwise; derive_terrain "
              f"launches it {launches[-1]} time(s) and no other kernel  [{card}]")
        del dem
    errs["d8_successor"] = 0.0
    torch.cuda.empty_cache()
    print(f"d8 phase: {time.perf_counter() - t_phase:.1f} s")
    return {"d8_successor": launches[0]}, {"d8_successor": rows_out[0]}


def bench_line(argv, engine, kernels, checked, card):
    """``bench_torch.py`` with ``argv`` as a user runs it, its line checked:
    every key of ``bench.py``'s line, ``engine``, each of ``kernels``
    launched once a suite or run and no other (or ``kernels(line)``: the
    launches of each a run), ``correct`` against ``checked`` (a fragment of
    ``checked_against``); the long-drainage and out-of-core modes' inputs
    made apart from the timing (``prep_s``), the out-of-core ones read from
    phase 4c's memmaps (``cached``).  Prints the line and returns it."""
    import bench_torch as bt

    t0 = time.perf_counter()
    _, line = run_script(["bench_torch.py", *argv])
    runs = line.get("suites_run", line.get("runs"))
    per_run = kernels(line) if callable(kernels) else dict.fromkeys(kernels, 1)
    want = {k: per_run.get(k, 0) * runs for k in line["kernels"]}
    new_mode = any(a in argv for a in ("--long-drainage", "--tiled", "--checkpointed"))
    out_of_core = "runs" in line
    if (set(bt.JAX_KEYS) - set(line) or line["engine"] != engine or line["kernels"] != want
            or line["correct"] is not True or checked not in line["checked_against"]
            or (new_mode and "prep_s" not in line) or (out_of_core and line["cached"] is not True)):
        raise AssertionError(f"bench_torch.py {' '.join(argv)}: expected launches {want}: {json.dumps(line)[:4000]}")
    print(f"bench_torch.py {' '.join(argv)}: {json.dumps(line)}")
    timing = (f"sustained {line['sustained_s'] * 1e3:.4f} ms, latency {line['latency_s'] * 1e3:.4f} ms"
              if "sustained_s" in line else f"median run {line['steady_state_ms']} ms of {line['run_s']}")
    print(f"bench_torch.py {' '.join(argv)} {line['metric']}: {line['value']} grid-points/s, {timing}, vs_baseline "
          f"{line['vs_baseline']} (CPU {line['baseline']['seconds']:.4f} s, engine {line['baseline']['engine']}, "
          f"{line['baseline']['threads']} threads, cached {line['baseline']['cached']})"
          + (f", prep {line['prep_s']:.3f} s (timed apart)" if "prep_s" in line else "")
          + f"; launches {line['kernels']} over {runs}; correct, max_abs_err {line['max_abs_err']:.3g}; "
          f"{time.perf_counter() - t0:.1f} s with start-up  [{card}]")
    return line


def phase_bench(card, hand, flood):
    """The measuring entry points: ``bench_torch.py`` as a user runs it in
    each mode, each line checked (``bench_line``): the default input under
    "auto" (K2, K3, K4) and "cuda_blocked" (K2, K3, K7; its suite held to
    "torch_blocked", one synchronising call a suite), both held to the
    North star's reference; ``--long-drainage 2178x1534`` under both
    engines, held to the long-drainage set in the engine's fdist order, with
    the walk statistics, the jump walk's pending cells and R (and the fold's
    P and K); ``--tiled 8192 --tile 4096`` (K1 and K6 once a tile, K5
    twice, K6 once more a retry, every run) and ``--checkpointed 8192`` (K2,
    K3, K4 once a run), both on phase 4c's memmaps (``cached``: the
    generator is not run again) and bitwise the in-core suite; then
    ``bench_configs_torch``'s configs 2 and 4 at their sizes, config 4's
    threshold against ``calibration(backend="torch")`` on the CPU of
    ``hand`` (phase 2's, the same inputs) and ``flood``.  The memmaps are
    removed afterwards."""
    import bench_configs_torch as bc
    import bench_torch as bt
    from descriptools_tpu_torch import evaluation, oracle

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        north = "north_star_reference"
        bench_line([], "cuda", IN_CORE, north, card)
        bench_line(["--engine", "cuda_blocked"], "cuda_blocked", BLOCKED, north, card)
        for engine, kernels in (("cuda", IN_CORE), ("cuda_blocked", BLOCKED)):
            line = bench_line(["--long-drainage", f"{ROWS}x{COLS}", "--engine", engine], engine, kernels,
                              "long_drainage_reference", card)
            w = line["walks"]
            if not w["pending_after_phase1"] or (engine == "cuda_blocked" and not w["fold_K"]):
                raise AssertionError(f"bench_torch.py --long-drainage {engine}: walks {w}")
        tiles = (BIG // TILE) ** 2
        line = bench_line(["--tiled", str(BIG), "--tile", str(TILE)], "cuda",
                          lambda ln: dict(stencil_padded=tiles, absorbing_walk=2 * tiles,
                                          downslope_walk_tracked=tiles + ln["downslope_retries"]), "in-core", card)
        if line["tiles"] != tiles:
            raise AssertionError(f"bench_torch.py --tiled: {line['tiles']} tiles")
        bench_line(["--checkpointed", str(BIG)], "cuda", IN_CORE, "in-core", card)
    finally:
        shutil.rmtree(os.path.join(ROOT, bt.INPUT_CACHE), ignore_errors=True)
    for config in (bc.config2_full_suite_4096, bc.config2_stencil_slope_twi_4096):
        r = config()
        if r["cells"] != 4096 * 4096 or not r["seconds"] > r.get("bound_s", 0.0):
            raise AssertionError(f"{config.__name__}: {r}")
        print(f"bench_configs_torch {config.__name__}: {json.dumps(r)}  [{card}]")
    r = bc.config4_calibration_basin()
    elements = np.unique(hand)
    desc = torch.as_tensor(oracle.min_max_scale_oracle(hand, elements[1], elements[-1]), dtype=torch.float32)
    th_cpu = evaluation.calibration(desc, torch.as_tensor(flood), "under", backend="torch")
    if r["cells"] != ROWS * COLS or r["threshold"] != th_cpu:
        raise AssertionError(f"config4_calibration_basin: {r}; the CPU's threshold {th_cpu}")
    print(f"bench_configs_torch config4_calibration_basin: {json.dumps(r)} (threshold the CPU's)  [{card}]")
    torch.cuda.empty_cache()
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s")


def main():
    start = time.perf_counter()
    sass = phase_device()
    dev = torch.device("cuda", 0)
    card = card_line()
    basin = basin_inputs()
    errs = dict.fromkeys(KERNELS, 0.0)
    phase_kernels(dev, basin, errs)
    phase_tile_kernels(dev, basin, errs)
    inputs, launches, small, classified = phase_slice(dev, basin)
    hand_small = small["hand"].cpu().numpy()
    phase_north_star(dev, card, basin, small)
    phase_long_drainage(dev, card)
    times = phase_timing(dev, inputs, card, sass)
    del inputs
    tiled_launches, tiled_times, full, tiled_out = phase_tiled(dev, card, classified, small["hand"], basin,
                                                               errs, sass)
    launches.update({k: tiled_launches[k] for k in TILED})
    times.update(tiled_times)
    phase_config5(dev, card, full, tiled_out)
    del small, tiled_out
    phase_sharded(dev, card, full)
    phase_scale_scripts(dev, card, full)
    blocked_launches, blocked_times = phase_checkpointed(dev, card, basin, full, errs)
    launches["flow_walk_blocked"] = blocked_launches["flow_walk_blocked"]
    times.update(blocked_times)
    del full
    phase_compat(dev, basin)
    phase_oracle(dev, basin)
    acc_launches, acc_times = phase_config3(dev, card, errs)
    launches.update(acc_launches)
    times.update(acc_times)
    float_launches, float_times = phase_float_dem(dev, card, errs)
    launches.update(float_launches)
    times.update(float_times)
    d8_launches, d8_times = phase_d8(dev, card, errs)
    launches.update(d8_launches)
    times.update(d8_times)
    phase_bench(card, hand_small, basin["flood"])
    # No single PyTorch call computes any of these functions: library_ms null.
    kernels = [
        dict(name=name, route="cuda", **meta, launches=launches[name], max_abs_err=errs[name],
             **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}, library_ms=None)
        for name, meta in KERNELS.items()
    ]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    print(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


def main_long_drainage():
    """``--long-drainage``: the device phase and the long-drainage phase
    alone (``phase_long_drainage``)."""
    phase_device()
    dev, card = torch.device("cuda", 0), card_line()
    phase_long_drainage(dev, card)
    print(card)


def main_float_dem():
    """``--float-dem``: the device phase and the float-DEM phase alone
    (``phase_float_dem``), with the counting kernel's row."""
    phase_device()
    dev, card = torch.device("cuda", 0), card_line()
    errs = {"cutoff_count": 0.0}
    launches, times = phase_float_dem(dev, card, errs)
    print(card)
    print(json.dumps({"kernels": [dict(name="cutoff_count", route="cuda", **KERNELS["cutoff_count"],
                                       launches=launches["cutoff_count"], max_abs_err=errs["cutoff_count"],
                                       **times["cutoff_count"], library_ms=None)]}))


def main_d8():
    """``--d8``: the device phase and the D8 phase alone (``phase_d8``),
    with the D8 kernel's row."""
    phase_device()
    dev, card = torch.device("cuda", 0), card_line()
    errs = {"d8_successor": 0.0}
    launches, times = phase_d8(dev, card, errs)
    print(card)
    print(json.dumps({"kernels": [dict(name="d8_successor", route="cuda", **KERNELS["d8_successor"],
                                       launches=launches["d8_successor"], max_abs_err=errs["d8_successor"],
                                       **times["d8_successor"], library_ms=None)]}))


def main_accumulation():
    """``--accumulation``: the device phase and the accumulation's part of
    phase 8 alone (``accumulation_on_tile_mixes``), with the entry's row."""
    phase_device()
    dev, card = torch.device("cuda", 0), card_line()
    errs = {"accumulation": 0.0}
    launches, times = accumulation_on_tile_mixes(dev, card, errs)
    print(card)
    print(json.dumps({"kernels": [dict(name="accumulation", route="cuda", **KERNELS["accumulation"],
                                       launches=launches["accumulation"], max_abs_err=errs["accumulation"],
                                       **times["accumulation"], library_ms=None)]}))


def main_link_probes():
    """``--link-probes``: the host link's probes alone, on phase 4's grid
    (``upload_overlap``, ``copy_overlap``); no kernel is checked."""
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    phase_device()
    dev, card = torch.device("cuda", 0), card_line()
    loaders = windowed_basin(BIG, BIG, seed=0)
    full = {k: loaders[k](0, BIG, 0, BIG) for k in ("dem", "fdr", "fac", "river")}
    upload_overlap(dev, card, full)
    copy_overlap(dev, card)
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"]:
        main_cards(int(sys.argv[2]))
    elif sys.argv[1:] == ["--link-probes"]:
        main_link_probes()
    elif sys.argv[1:] == ["--long-drainage"]:
        main_long_drainage()
    elif sys.argv[1:] == ["--float-dem"]:
        main_float_dem()
    elif sys.argv[1:] == ["--d8"]:
        main_d8()
    elif sys.argv[1:] == ["--accumulation"]:
        main_accumulation()
    else:
        main()
