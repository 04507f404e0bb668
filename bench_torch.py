#!/usr/bin/env python3
"""Benchmark: the full descriptor suite's throughput on one NVIDIA card,
with the PyTorch port (``descriptools_tpu_torch``).  The counterpart of
``bench.py``; it imports torch, numpy and the port only.

    python3 bench_torch.py                       # windowed_basin(2178, 1534, seed=0)
    python3 bench_torch.py --synthetic 4096      # synthetic_basin(4096, 4096, seed=0)
    python3 bench_torch.py --basin DIR           # a basin in the reference Example layout
    python3 bench_torch.py --long-drainage 2178x1534   # or 4096x4096
    python3 bench_torch.py --tiled 8192 --tile 4096    # tiled.tiled_suite over memmaps
    python3 bench_torch.py --checkpointed 8192         # pipeline.run_suite_checkpointed
    python3 bench_torch.py --engine cuda_blocked       # any in-core mode: the walk tier

Every mode prints ONE JSON line, with every key of ``bench.py``'s line.
The in-core modes (the default input, ``--synthetic``, ``--basin``,
``--long-drainage``):

value       = sustained grid-points/s of ``pipeline.descriptor_suite``
              (slope, TWI, mod-TWI, downslope, fdist/indices/HAND, GFI,
              ln(hl/H)) on the card, under ``--engine`` (default "auto",
              which is "cuda" on the card: K2, K3 and the jump walk K4;
              "cuda_blocked" runs the fold K7 for the flow walk, the tier
              ``bench.py`` runs above the TPU's VMEM budget; "torch" and
              "torch_blocked" are their plain versions).  Sustained =
              batches of 5 suites dispatched back to back with one
              ``torch.cuda.synchronize`` each, host clock around the batch,
              median of 7 batches after one warm-up;
              ``latency_ms_incl_sync_rtt`` is the same with batches of 1
              (on this card there is no relay: the "round trip" is the
              synchronize).
vs_baseline = the suite on the host CPU under the plain count engine
              ("torch", whatever the card's engine: one denominator an
              input), over the sustained time; cached per revision and
              metric in ``build/bench_cpu_<metric>.json``.

One more suite, outside the timing, runs under torch.profiler: its
synchronising CUDA runtime calls are counted (0 under "cuda"; under
"cuda_blocked" exactly one, the fold's 8-byte read of P and K) and its
rasters are checked.  ``correct``: that suite is held to the plain engine
of the same fdist order on the card (indices, HAND, downslope, slope and
fdist bitwise, the rest within rtol 2e-5, atol 1e-4); on the default input
also its rasters and the host ``classify_flood`` to the JAX package's
committed results (``tests/data/north_star_reference.npz``,
``utils.parity.check``); on ``--long-drainage`` its rasters and the one-card
``sharded_classify_flood`` to ``tests/data/long_drainage_reference.npz`` in
the engine's fdist order (``parity.check(..., fdist_order="count" |
"fold")``), and the walk statistics of the plain engines to the set's.

The out-of-core modes read ``config5_torch.prepare_inputs(N, seed=0)``'s
``.npy`` memmaps (``windowed_basin(N, N, seed=0)``), written once to
``build/bench_inputs/`` and reused:

``--tiled N --tile T``: ``tiled.tiled_suite`` (link knobs off, engine
    "auto", no input cache) in TxT tiles; ``--checkpointed N``:
    ``pipeline.run_suite_checkpointed`` on the inputs on the card, a fresh
    checkpoint directory a run.  value = cells over the median host-clock
    wall of 5 runs after one warm-up; vs_baseline = the in-core suite on
    the host CPU on the same inputs (engine "torch"), one run, cached as
    above and shared by both modes.  ``correct``:
    indices, HAND, downslope, slope and fdist of the last run bitwise the
    in-core suite on the card, the rest within rtol 2e-5, atol 1e-4.

Every line carries the card's name and power limit, the torch and CUDA
versions and the kernels' launches over the timed runs; the script raises
unless every launch is the mode's (one of each of the engine's kernels a
suite; for ``--tiled`` K1 one a tile, K5 two a tile, K6 one a tile and one
a retry, a run; for ``--checkpointed`` K2, K3 and K4 one a run).  The
inputs' generation or staging is timed apart (``prep_s``; ``cached`` where
the memmaps were reused), never inside ``value``.  Any mismatch raises
before the line is printed.

Departure from ``bench.py``: the default input is the synthetic basin at
the bundled basin's shape (the bundled basin is not shipped); ``--basin``
reads a real one.  Without a card the script raises and prints nothing.
"""

import argparse
import hashlib
import json
import os
import platform
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import config5_torch  # noqa: E402
from config5_torch import card_line  # noqa: E402
from descriptools_tpu_torch import pipeline, placement, tiled  # noqa: E402
from descriptools_tpu_torch.ops.cuda import launch_counters  # noqa: E402
from descriptools_tpu_torch.utils import parity, provenance  # noqa: E402

WARMUP = 1
ITERS = 7
BATCH = 5
CPU_ITERS = 3  # the CPU leg is slow and steady: 3 batches, as in bench.py
BIG_ITERS = 5  # out-of-core runs after the warm-up
BIG_CPU_ITERS = 1  # the CPU leg of the long-drainage and out-of-core modes: one run, no warm-up
# The CPU leg's engine, whatever the card's: the plain count engine, the
# CPU's fastest (the plain fold took 687 s at 4096² on long drainage, the
# count engine 148 s), so that each input has one denominator and
# vs_baseline compares across engines.
CPU_ENGINE = "torch"
DEFAULT_SHAPE = (2178, 1534)  # the bundled basin's
DEFAULT_TILE = 4096  # the JAX package's default tile side
REFERENCE = os.path.join(ROOT, "tests", "data", "north_star_reference.npz")
LONG_DRAINAGE_REFERENCE = os.path.join(ROOT, "tests", "data", "long_drainage_reference.npz")
INPUT_CACHE = os.path.join("build", "bench_inputs")  # under the root: the out-of-core modes' memmaps
# The keys of bench.py's line (tests/test_torch_bench.py reads them from
# its source); the line below holds each of them.
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "steady_state_ms", "latency_ms_incl_sync_rtt",
            "methodology", "n_timing_batches", "engine", "walk_tiers", "rev")
IN_CORE = ("stencil", "downslope_walk", "flow_walk")  # K2, K3, K4: one launch each a suite
BLOCKED = ("stencil", "downslope_walk", "flow_walk_blocked")  # K2, K3, K7 under "cuda_blocked"
# One launch each a suite, by engine; flow_walk_blocked runs its jump walk
# inside its own launcher, so flow_walk stays 0 under "cuda_blocked".
SUITE_KERNELS = {"cuda": IN_CORE, "cuda_blocked": BLOCKED}
BITWISE = ("indices", "hand", "downslope", "slope", "fdist")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
TRANSCENDENTAL = dict(rtol=2e-5, atol=1e-4)
# The plain engine of each engine's fdist order: what ``correct`` holds a
# suite to.
PLAIN = {"cuda": "torch", "cuda_blocked": "torch_blocked", "torch": "torch", "torch_blocked": "torch_blocked"}
FDIST_ORDER = {"cuda": "count", "torch": "count", "cuda_blocked": "fold", "torch_blocked": "fold"}
# What each stage runs under each engine (bench.py's walk_tiers).
STAGES = {
    "cuda": dict(stencil="K2 stencil_tile_kernel<false> (csrc/stencil.cu)",
                 downslope="K3 downslope_kernel<false> (csrc/walk.cu)",
                 flow="K4 jump walk (csrc/walk.cu)"),
    "cuda_blocked": dict(stencil="K2 stencil_tile_kernel<false> (csrc/stencil.cu)",
                         downslope="K3 downslope_kernel<false> (csrc/walk.cu)",
                         flow="K7 anchored fold (csrc/flow_fold.cu)"),
    "torch": dict(stencil="stencil_plain", downslope="_downslope_jacobi", flow="doubling_walk"),
    "torch_blocked": dict(stencil="stencil_plain", downslope="_downslope_jacobi", flow="fold_walk"),
    "tiled": dict(stencil="K1 stencil_tile_kernel<true> (csrc/stencil.cu)",
                  downslope="K6 downslope_kernel<true> (csrc/walk.cu)",
                  flow="K5 jump walk, absorbing_walk (csrc/walk.cu)"),
}
TILED = ("stencil_padded", "absorbing_walk", "downslope_walk_tracked")  # K1, K5, K6
# Synchronising CUDA runtime calls: the host waits on the device in each.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
FOLD_SYNCS = 1  # csrc/flow_fold.cu: one read of P and K (8 B) a call
EXPECTED_SYNCS = {"cuda": 0, "cuda_blocked": FOLD_SYNCS}  # a suite's; the plain engines are not checked
SOURCES = ("descriptools_tpu_torch", "bench_torch.py", "config5_torch.py")  # what _rev hashes without git


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_suite(device, inputs, cfg, batch=1, iters=ITERS, warmup=WARMUP):
    """Median seconds per suite run.

    ``batch=1``: the latency of one suite and its synchronize.
    ``batch=k``: k suites dispatched back to back with ONE synchronize,
    the sustained rate of the card when work is queued."""

    def run():
        outs = [pipeline.descriptor_suite(*inputs, cfg) for _ in range(batch)]
        _sync(device)
        return outs

    return _median_s(run, iters, warmup) / batch


def _median_s(run, iters, warmup):
    """Median host-clock seconds of ``run()`` over ``iters`` calls after
    ``warmup`` calls; ``run`` ends synchronised."""
    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _walk_tiers(engine):
    """What each stage ran: the kernel under a CUDA engine, the plain
    function under a torch one."""
    return dict(STAGES[engine])


def _grid(text):
    """"ROWSxCOLS" -> (rows, cols)."""
    try:
        rows, cols = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected ROWSxCOLS, got {text!r}") from None
    return rows, cols


def parser():
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="correct: each line's suite is held to the plain engine of its fdist order; the default input "
               "also to tests/data/north_star_reference.npz, --long-drainage to "
               "tests/data/long_drainage_reference.npz in the engine's fdist order; --tiled and --checkpointed "
               "bitwise the in-core suite on the card.  See the module's docstring.")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--synthetic", type=int, metavar="N", help="synthetic_basin(N, N, seed=0)")
    src.add_argument("--basin", metavar="DIR", help="a basin in the reference Example layout")
    src.add_argument("--long-drainage", type=_grid, metavar="ROWSxCOLS",
                     help="the long-drainage set's input at 2178x1534 or 4096x4096, held to its JAX reference")
    src.add_argument("--tiled", type=int, metavar="N",
                     help="tiled.tiled_suite over windowed_basin(N, N, seed=0) memmaps, held to the in-core suite")
    src.add_argument("--checkpointed", type=int, metavar="N",
                     help="pipeline.run_suite_checkpointed on windowed_basin(N, N, seed=0), held to the in-core suite")
    ap.add_argument("--tile", type=int, metavar="T", help=f"--tiled's tile side (default {DEFAULT_TILE})")
    ap.add_argument("--engine", choices=placement.ENGINES,
                    help="the in-core modes' engine (default auto: cuda on the card); cuda_blocked runs the fold")
    return ap


def _parse(argv):
    ap = parser()
    args = ap.parse_args(list(argv))
    out_of_core = args.tiled is not None or args.checkpointed is not None
    if args.tile is not None and args.tiled is None:
        ap.error("--tile needs --tiled")
    if args.engine is not None and out_of_core:
        ap.error("--engine applies to the in-core modes; --tiled and --checkpointed run engine 'auto'")
    if args.engine is None:
        args.engine = "auto"
    if args.tiled is not None and args.tile is None:
        args.tile = DEFAULT_TILE
    return args


def _inputs(args):
    """({dem, fdr, fac, river[, flood]} numpy, dem and fac int32; metric)."""
    if args.synthetic is not None:
        from descriptools_tpu_torch.utils.synthetic import synthetic_basin

        size = args.synthetic
        dem, fdr, river, fac = synthetic_basin(size, size, seed=0)
        arrays = dict(dem=dem.astype("int32"), fdr=fdr, fac=fac.astype("int32"), river=river)
        return arrays, f"full_descriptor_suite_synthetic_{size}"
    if args.basin is not None:
        from descriptools_tpu_torch.io import load_example_inputs

        data = load_example_inputs(args.basin)
        arrays = dict(dem=data["dem"].astype("int32"), fdr=data["fdr"], fac=data["fac"].astype("int32"),
                      river=data["river"], flood=data["flood"])
        return arrays, "full_descriptor_suite_bundled_basin"
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    rows, cols = DEFAULT_SHAPE
    arrays = {k: f(0, rows, 0, cols) for k, f in windowed_basin(rows, cols, seed=0).items()}
    return arrays, f"full_descriptor_suite_windowed_basin_{rows}x{cols}"


def check_suite(out, plain, what="engine='torch'"):
    """Hold a suite's rasters to the plain engine's on the same inputs:
    BITWISE exactly (NaN equal to NaN), CLOSE within TRANSCENDENTAL.
    Returns the largest |difference| over the finite cells of the float
    rasters; raises AssertionError naming every raster that differs."""
    bad, err = [], 0.0
    for name in BITWISE + CLOSE:
        got, want = out[name], plain[name]
        if got.dtype != want.dtype or got.shape != want.shape:
            bad.append(f"{name}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
            continue
        if name in BITWISE:
            same = got == want
            if got.is_floating_point():
                same |= torch.isnan(got) & torch.isnan(want)
        else:
            same = torch.isclose(got, want, equal_nan=True, **TRANSCENDENTAL)
        if not bool(same.all()):
            bad.append(f"{name}: {int((~same).sum())} cells differ"
                       + ("" if name in BITWISE else f" beyond {TRANSCENDENTAL}"))
        if got.is_floating_point():
            both = torch.isfinite(got) & torch.isfinite(want)
            if bool(both.any()):
                err = max(err, float((got[both].double() - want[both].double()).abs().max()))
    if bad:
        raise AssertionError(f"the timed suite against {what}: " + "; ".join(bad))
    return err


def sync_calls(events, window):
    """How many of ``events`` ((name, start, end) on one clock) are
    synchronising CUDA runtime calls (``SYNC_CALLS``) inside ``window``
    ((start, end))."""
    lo, hi = window
    return sum(1 for name, start, end in events if name in SYNC_CALLS and lo <= start and end <= hi)


SYNC_WINDOW = "bench_torch_counted_suite"


def count_syncs(fn, device):
    """(``fn()``, the synchronising CUDA runtime calls it made: torch.profiler's
    runtime events inside a ``record_function`` window around ``fn``, which
    include the kernel library's own; the profiler's own synchronize at its
    stop lies outside).  On the CPU there is no CUDA call to count: 0."""
    if device.type != "cuda":
        return fn(), 0
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SYNC_WINDOW):
            out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    window = next((start, end) for name, start, end in spans if name == SYNC_WINDOW)
    return out, sync_calls(spans, window)


def check_syncs(engine, counted):
    """Raise unless ``counted``, one suite's synchronising calls, is the
    engine's (``EXPECTED_SYNCS``); the plain engines are not checked.
    Returns the expected count (None where unchecked)."""
    want = EXPECTED_SYNCS.get(engine)
    if want is not None and counted != want:
        raise AssertionError(f"engine {engine!r}: {counted} synchronising CUDA calls in one suite, expected {want} "
                             f"({', '.join(SYNC_CALLS)})")
    return want


def _cpu_model():
    """The host CPU's model name (Linux), else its architecture."""
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if ln.startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    proc = platform.processor()
    return proc if proc not in ("", "unknown") else platform.machine()


def source_rev(root=ROOT):
    """"src-" and 16 hex digits of the sha256 of ``SOURCES`` under ``root``
    (names and bytes of their .py, .cu and .cuh files)."""
    h = hashlib.sha256()
    for top in SOURCES:
        path = os.path.join(root, top)
        files = [path] if os.path.isfile(path) else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs if f.endswith((".py", ".cu", ".cuh")))
        for f in files:
            h.update(os.path.relpath(f, root).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return "src-" + h.hexdigest()[:16]


def _rev():
    """The checkout's revision: git's, else (a copy without ``.git``) the
    hash of the port's sources (:func:`source_rev`)."""
    return provenance.git_rev(ROOT) or source_rev(ROOT)


def _cpu_baseline(run_cpu, metric, rev, root):
    """The same work on the host CPU: {t_cpu, threads, cpu_model, rev,
    cached}.  ``run_cpu()`` measures it (seconds; a failure raises).  Read
    from ``build/bench_cpu_<metric>.json`` under ``root`` where it was
    measured at this revision, else measured and written there."""
    path = os.path.join(root, "build", f"bench_cpu_{metric}.json")
    keys = ("rev", "t_cpu", "threads", "cpu_model")
    try:
        with open(path) as fh:
            cached = json.load(fh)
        entry = {k: cached[k] for k in keys}
        if rev and entry["rev"] == rev:
            return dict(entry, cached=True)
    except (FileNotFoundError, json.JSONDecodeError, KeyError):
        pass
    t_cpu = run_cpu()
    entry = dict(rev=rev, t_cpu=t_cpu, threads=torch.get_num_threads(), cpu_model=_cpu_model())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(entry, fh)
    return dict(entry, cached=False)


def _launches(before):
    after = launch_counters()
    return {k: after[k] - before[k] for k in after}


def _long_drainage(args, device, reference):
    """The long-drainage set's input at ``args.long_drainage``, made by the
    port on ``device``: (ref, numpy arrays, tensors, params, prep seconds)."""
    rows, cols = args.long_drainage
    ref = parity.load(LONG_DRAINAGE_REFERENCE) if reference is None else reference
    if f"{rows}x{cols}.params" not in ref:
        raise ValueError(f"--long-drainage {rows}x{cols}: the set holds {parity.sizes(ref)}")
    t0 = time.perf_counter()
    arrays, tensors = parity.long_drainage_inputs(ref, rows, cols, device)
    _sync(device)
    return ref, arrays, tensors, parity.params(ref, rows, cols), time.perf_counter() - t0


def _walk_report(engine, walks):
    """The walk statistics (the set's), and what the engine's walk kernel
    reported for the last suite: the jump walk's pending cells after
    phase 1 and R; under "cuda_blocked" also the fold's P and K."""
    from descriptools_tpu_torch.ops.cuda import walk

    report = dict(flow_steps_mean=walks["flow_steps_sum"] / walks["landed"],
                  flow_steps_max=walks["flow_steps_max"],
                  downslope_steps_mean=walks["downslope_steps_sum"] / walks["valid"],
                  downslope_steps_max=walks["downslope_steps_max"],
                  landed=walks["landed"], valid=walks["valid"], flow_over_64=walks["flow_over_64"])
    if engine == "cuda":
        pending = walk.flow_walk.pending.tolist()
        report.update(pending_after_phase1=pending[0], jump_rounds=walk.flow_walk.rounds, pending_by_round=pending)
    elif engine == "cuda_blocked":
        fb = walk.flow_walk_blocked
        pending = fb.jump_pending.tolist()
        report.update(pending_after_phase1=pending[0], jump_rounds=fb.jump_rounds, pending_by_round=pending,
                      fold_P=fb.pending, fold_K=fb.rounds)
    if engine in SUITE_KERNELS and not report["pending_after_phase1"]:
        raise AssertionError(f"long drainage, engine {engine}: no cell pending after the jump walk's phase 1")
    if engine == "cuda_blocked" and report["fold_K"] == 0:
        raise AssertionError("long drainage, engine cuda_blocked: the fold ran no band round (K = 0)")
    return report


def measure(argv=(), *, device="cuda", iters=ITERS, batch=BATCH, root=ROOT, reference=None):
    """The line's dict for ``argv`` (the script's flags), its suites on
    ``device`` (the card unless the caller asks for "cpu"; raises where no
    CUDA device is available); the CPU leg's cache and the out-of-core
    modes' memmaps under ``root``.  ``reference``: the long-drainage set
    (default: the committed one); ``iters``: the timed batches (runs out
    of core, at most ``BIG_ITERS``)."""
    device = pipeline.check_device(device)
    args = _parse(argv)
    if args.tiled is not None or args.checkpointed is not None:
        return _measure_out_of_core(args, device, min(iters, BIG_ITERS), root)
    engine = pipeline.resolve_engine(args.engine, device)
    flood = None
    if args.long_drainage is not None:
        ref, arrays, inputs, params, prep_s = _long_drainage(args, device, reference)
        rows, cols = args.long_drainage
        metric = f"full_descriptor_suite_long_drainage_{rows}x{cols}"
        cfg = pipeline.PipelineConfig(elevation_difference=params["elevation_difference"], engine=args.engine)
        flood = torch.as_tensor(arrays["flood"], device=device)
    else:
        arrays, metric = _inputs(args)
        rows, cols = arrays["dem"].shape
        cfg = pipeline.PipelineConfig(engine=args.engine)
        inputs = pipeline.inputs_to_torch(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], device)
    cells = rows * cols

    before = launch_counters()
    t_latency = _time_suite(device, inputs, cfg, iters=iters)
    t_accel = _time_suite(device, inputs, cfg, batch=batch, iters=iters)
    # One more suite, outside the timing, under torch.profiler: its
    # synchronising calls are counted (one under "cuda" would hold every
    # batch to the latency; "cuda_blocked" makes the fold's one).  Its
    # rasters are the ones checked below.
    out, syncs = count_syncs(lambda: pipeline.descriptor_suite(*inputs, cfg), device)
    _sync(device)
    sync_want = check_syncs(engine, syncs)
    suites = (WARMUP + iters) * (1 + batch) + 1
    kernels = _launches(before)
    want = {k: suites if k in SUITE_KERNELS.get(engine, ()) else 0 for k in kernels}
    if kernels != want:
        raise AssertionError(f"kernel launches over {suites} suites: {kernels}, expected {want}")

    plain_engine = PLAIN[engine]
    if plain_engine == engine:  # a plain engine is its own reference
        checked, err = f"engine='{engine}' is the plain engine", 0.0
    else:
        plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(
            elevation_difference=cfg.elevation_difference, engine=plain_engine))
        checked = f"engine='{plain_engine}' on {device.type}"
        err = check_suite(out, plain, checked)
        del plain
    extra = {}
    if args.long_drainage is not None:
        stats = parity.walk_stats(inputs[0], inputs[1], inputs[3], cfg.elevation_difference)
        if stats != parity.walks(ref, rows, cols):
            raise AssertionError(f"long drainage {rows}x{cols}: walks {stats} vs the set's {parity.walks(ref, rows, cols)}")
        walks = _walk_report(engine, stats)
        from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

        classified = sharded_classify_flood(out["hand"], flood)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        order = FDIST_ORDER[engine]
        report = parity.check(ref, rows, cols, arrays, host, (*classified[:3], classified[3].cpu().numpy()),
                              fdist_order=order)
        err = max([err] + [r["max_abs_err"] for r in report.values()])
        checked += (f"; {os.path.relpath(LONG_DRAINAGE_REFERENCE, ROOT)} {rows}x{cols} in the {order} order "
                    "(utils.parity.check, one-card sharded_classify_flood)")
        extra = dict(prep_s=prep_s, walks=walks,
                     fdist=dict(order=order, **{k: report["fdist"][k] for k in ("max_abs_err", "bound_used")}),
                     threshold=classified[0])
    elif args.synthetic is None and args.basin is None:
        host = {k: v.cpu().numpy() for k, v in out.items()}
        classified = pipeline.classify_flood(host["hand"], arrays["flood"])
        report = parity.check(parity.load(REFERENCE), rows, cols, arrays, host, classified)
        err = max([err] + [r["max_abs_err"] for r in report.values()])
        checked += f"; {os.path.relpath(REFERENCE, ROOT)} {rows}x{cols} (utils.parity.check)"
    del out

    rev = _rev()
    base_iters = CPU_ITERS if args.long_drainage is None else BIG_CPU_ITERS
    base_warmup = WARMUP if args.long_drainage is None else 0

    def run_cpu():
        cpu = torch.device("cpu")
        cpu_in = tuple(t.cpu() for t in inputs)
        cpu_cfg = pipeline.PipelineConfig(elevation_difference=cfg.elevation_difference, engine=CPU_ENGINE)
        return _time_suite(cpu, cpu_in, cpu_cfg, iters=base_iters, warmup=base_warmup)

    base = _cpu_baseline(run_cpu, metric, rev, root)
    sync_word = "torch.cuda.synchronize" if device.type == "cuda" else "synchronize (a no-op on the CPU)"
    return {
        "metric": metric,
        "value": round(cells / t_accel, 1),
        "unit": "grid-points/s/chip",
        "vs_baseline": round(base["t_cpu"] / t_accel, 3),
        "steady_state_ms": round(t_accel * 1e3, 1),
        "latency_ms_incl_sync_rtt": round(t_latency * 1e3, 1),
        "methodology": (
            f"sustained: {batch} suites dispatched back to back, then one {sync_word}; host clock "
            f"(time.perf_counter) around each batch; median of {iters} timed batches after {WARMUP} "
            f"warm-up, over {batch}; latency: batches of 1 (no relay: the round trip is the synchronize); "
            f"one more suite under torch.profiler: {syncs} synchronising CUDA calls "
            + (f"(expected {sync_want})" if sync_want is not None else "(not checked for a plain engine)")
            + f"; vs_baseline: the suite on the host CPU, engine '{CPU_ENGINE}' whatever the card's, median of {base_iters}"
            + (f" after {base_warmup} warm-up" if base_warmup else "")
        ),
        "n_timing_batches": iters,
        "engine": engine,
        "walk_tiers": _walk_tiers(engine),
        "rev": rev,
        # The port's additions.
        "grid": [rows, cols],
        "cells": cells,
        "sustained_s": t_accel,
        "latency_s": t_latency,
        "device": card_line() if device.type == "cuda" else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "kernels": kernels,
        "suites_run": suites,
        "correct": True,
        "checked_against": checked,
        "max_abs_err": err,
        "baseline": dict(device="cpu", engine=CPU_ENGINE, seconds=base["t_cpu"], threads=base["threads"],
                         cpu_model=base["cpu_model"], iters=base_iters, cached=base["cached"]),
        **extra,
    }


def _memmap_inputs(n, root):
    """``windowed_basin(n, n, seed=0)`` as memmaps under ``root``'s
    ``INPUT_CACHE`` (``config5_torch.prepare_inputs``, in up to 8
    processes): (loaders, {name: memmap}, seconds, cached)."""
    cache = os.path.join(root, INPUT_CACHE)
    windows = -(-n // 4096) ** 2  # prepare_inputs' windows
    t0 = time.perf_counter()
    _, cached = config5_torch.prepare_inputs(n, 0, cache, workers=max(1, min(8, windows, os.cpu_count() or 1)))
    loaders = config5_torch.disk_loaders(cache)
    maps = {k: np.load(os.path.join(cache, f"{k}.npy"), mmap_mode="r") for k in ("dem", "fdr", "fac", "river")}
    return loaders, maps, time.perf_counter() - t0, cached


def _memmap_tensors(maps, device):
    """(dem, fdr, fac, river) tensors on ``device`` in the memmaps' dtypes,
    read from the memmaps once."""
    return tuple(torch.from_numpy(np.array(maps[k])).to(device) for k in ("dem", "fdr", "fac", "river"))


def _measure_out_of_core(args, device, iters, root):
    """``--tiled`` and ``--checkpointed``: see the module's docstring."""
    cfg = pipeline.PipelineConfig()
    engine = cfg.resolve_engine(device)
    n = args.tiled if args.tiled is not None else args.checkpointed
    loaders, maps, prep_s, cached = _memmap_inputs(n, root)
    cells = n * n
    build = os.path.join(root, "build")

    if args.tiled is not None:
        tile = args.tile
        metric = f"tiled_descriptor_suite_windowed_basin_{n}_tile_{tile}"
        label = f"tiled.tiled_suite in {tile}x{tile} tiles (link knobs off, no input cache)"

        def stage(dev):
            return dev

        def run(dev, stats):
            out = tiled.tiled_suite(loaders, (n, n), cfg, dev, tile_rows=tile, tile_cols=tile,
                                    cache_inputs=False, stats=stats)
            _sync(dev)
            return out
    else:
        metric = f"checkpointed_descriptor_suite_windowed_basin_{n}"
        label = "pipeline.run_suite_checkpointed, a fresh checkpoint directory a run"

        def stage(dev):
            inputs = _memmap_tensors(maps, dev)
            _sync(dev)
            return inputs

        def run(inputs, stats):
            os.makedirs(build, exist_ok=True)
            ckdir = tempfile.mkdtemp(prefix="bench_ckpt_", dir=build)
            try:
                out = pipeline.run_suite_checkpointed(*inputs, cfg, ckdir, stats=stats)
                _sync(inputs[0].device)
            finally:
                shutil.rmtree(ckdir, ignore_errors=True)
            return out

    t0 = time.perf_counter()
    staged = stage(device)  # the inputs on the card (--checkpointed), or the device (--tiled)
    prep_s += time.perf_counter() - t0

    before = launch_counters()
    walls, stats = [], []
    for i in range(WARMUP + iters):
        st = {}
        t0 = time.perf_counter()
        out = run(staged, st)
        wall = time.perf_counter() - t0
        if i >= WARMUP:
            walls.append(wall)
            stats.append(st)
        if i + 1 < WARMUP + iters:
            del out
    kernels = _launches(before)
    runs = WARMUP + iters
    if args.tiled is not None:
        tiles = stats[-1]["tiles"]
        retries = stats[-1]["downslope_retries"]
        per_run = dict(stencil_padded=tiles, absorbing_walk=2 * tiles, downslope_walk_tracked=tiles + retries)
        want = {k: per_run.get(k, 0) * runs if engine == "cuda" else 0 for k in kernels}
        extra = dict(tiles=tiles, downslope_retries=retries, pass_s=stats[-1]["pass_s"],
                     link={p: dict(r) for p, r in stats[-1]["link"].items()})
        tiers = _walk_tiers("tiled" if engine == "cuda" else engine)
    else:
        want = {k: runs if engine == "cuda" and k in IN_CORE else 0 for k in kernels}
        extra = dict(stages_s={k: v["seconds"] for k, v in stats[-1].items()},
                     saved_bytes=sum(v["saved_bytes"] for v in stats[-1].values()))
        tiers = _walk_tiers(engine)
    if kernels != want:
        raise AssertionError(f"{metric}: kernel launches over {runs} runs: {kernels}, expected {want}")
    # An integer count of retries is the same in every run: the inputs are.
    if args.tiled is not None and any(s["downslope_retries"] != stats[-1]["downslope_retries"] for s in stats):
        raise AssertionError(f"{metric}: retries differ between runs: {[s['downslope_retries'] for s in stats]}")

    inputs = staged if args.checkpointed is not None else _memmap_tensors(maps, device)
    want_out = pipeline.descriptor_suite(*inputs, cfg)
    got = {k: torch.as_tensor(out[k]).to(device) for k in BITWISE + CLOSE}
    err = check_suite(got, want_out, f"the in-core suite (engine '{engine}') on {device.type}")
    del got, want_out, out, inputs, staged

    rev = _rev()
    base_iters = BIG_CPU_ITERS
    cpu = torch.device("cpu")

    def run_cpu():
        on_cpu = _memmap_tensors(maps, cpu)
        cpu_cfg = pipeline.PipelineConfig(engine=CPU_ENGINE)
        return _median_s(lambda: pipeline.descriptor_suite(*on_cpu, cpu_cfg), base_iters, 0)

    # One CPU leg for both out-of-core modes of a grid: the in-core suite.
    base = _cpu_baseline(run_cpu, f"in_core_windowed_basin_{n}", rev, root)
    t_run = statistics.median(walls)
    sync_word = "torch.cuda.synchronize" if device.type == "cuda" else "synchronize (a no-op on the CPU)"
    return {
        "metric": metric,
        "value": round(cells / t_run, 1),
        "unit": "grid-points/s/chip",
        "vs_baseline": round(base["t_cpu"] / t_run, 3),
        "steady_state_ms": round(t_run * 1e3, 1),
        "latency_ms_incl_sync_rtt": round(t_run * 1e3, 1),
        "methodology": (
            f"{label}: host clock (time.perf_counter) around each run, which ends in one {sync_word}; median "
            f"of {iters} runs after {WARMUP} warm-up; latency is the same run (one run is one request); inputs "
            f"read from config5_torch.prepare_inputs' memmaps ({INPUT_CACHE}), written before the timing "
            f"(prep_s); vs_baseline: the in-core suite on the host CPU on the same inputs, engine "
            f"'{CPU_ENGINE}', median of {base_iters} with no warm-up"
        ),
        "n_timing_batches": iters,
        "engine": engine,
        "walk_tiers": tiers,
        "rev": rev,
        "grid": [n, n],
        "cells": cells,
        "run_s": walls,
        "device": card_line() if device.type == "cuda" else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "kernels": kernels,
        "runs": runs,
        "correct": True,
        "checked_against": f"the in-core suite (engine '{engine}') on {device.type}: {', '.join(BITWISE)} bitwise",
        "max_abs_err": err,
        "prep_s": prep_s,
        "cached": cached,
        "baseline": dict(device="cpu", engine=CPU_ENGINE, seconds=base["t_cpu"], threads=base["threads"],
                         cpu_model=base["cpu_model"], iters=base_iters, cached=base["cached"]),
        **extra,
    }


def main(argv=None):
    pipeline.check_device("cuda")  # raises without a card, before any work
    print(json.dumps(measure(sys.argv[1:] if argv is None else argv)))


if __name__ == "__main__":
    main()
