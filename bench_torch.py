#!/usr/bin/env python3
"""Benchmark: the full descriptor suite's throughput on one NVIDIA card,
with the PyTorch port (``descriptools_tpu_torch``).  The counterpart of
``bench.py``; it imports torch, numpy and the port only.

    python3 bench_torch.py                  # windowed_basin(2178, 1534, seed=0)
    python3 bench_torch.py --synthetic 4096 # synthetic_basin(4096, 4096, seed=0)
    python3 bench_torch.py --basin DIR      # a basin in the reference Example layout

Prints ONE JSON line, with every key of ``bench.py``'s line:

value       = sustained grid-points/s of ``pipeline.descriptor_suite``
              (slope, TWI, mod-TWI, downslope, fdist/indices/HAND, GFI,
              ln(hl/H)) on the card, through the hand-written kernels
              (``PipelineConfig()``: engine "auto", "cuda" on the card).
              Sustained = batches of 5 suites dispatched back to back with
              one ``torch.cuda.synchronize`` each, host clock around the
              batch, median of 7 batches after one warm-up;
              ``latency_ms_incl_sync_rtt`` is the same with batches of 1
              (on this card there is no relay: the "round trip" is the
              synchronize).
vs_baseline = the same suite on the host CPU (engine "torch": the kernels'
              plain versions), median of 3 after one warm-up, over the
              sustained time; cached per git revision and metric in
              ``build/bench_cpu_<metric>.json``.

Beside them: the card's name and power limit, the torch and CUDA
versions, the kernels' launches over the timed runs (one of K2, K3 and K4
per suite, else the script raises), and ``correct``: after the timing, the
card's suite is held to ``engine="torch"`` on the card (indices, HAND,
downslope, slope and fdist bitwise, the rest within rtol 2e-5, atol
1e-4) and, for the default input, its rasters and the host
``classify_flood`` to the JAX package's committed results
(``tests/data/north_star_reference.npz``, ``utils.parity.check``).  Any
mismatch raises before the line is printed.

Departure from ``bench.py``: the default input is the synthetic basin at
the bundled basin's shape (the bundled basin is not shipped); ``--basin``
reads a real one.  Without a card the script raises and prints nothing.
"""

import argparse
import json
import os
import platform
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from config5_torch import card_line  # noqa: E402
from descriptools_tpu_torch import pipeline  # noqa: E402
from descriptools_tpu_torch.ops.cuda import launch_counters  # noqa: E402
from descriptools_tpu_torch.utils import parity, provenance  # noqa: E402

WARMUP = 1
ITERS = 7
BATCH = 5
CPU_ITERS = 3  # the CPU leg is slow and steady: 3 batches, as in bench.py
DEFAULT_SHAPE = (2178, 1534)  # the bundled basin's
REFERENCE = os.path.join(ROOT, "tests", "data", "north_star_reference.npz")
# The keys of bench.py's line (tests/test_torch_bench.py reads them from
# its source); the line below holds each of them.
JAX_KEYS = ("metric", "value", "unit", "vs_baseline", "steady_state_ms", "latency_ms_incl_sync_rtt",
            "methodology", "n_timing_batches", "engine", "walk_tiers", "rev")
IN_CORE = ("stencil", "downslope_walk", "flow_walk")  # K2, K3, K4: one launch each a suite
BITWISE = ("indices", "hand", "downslope", "slope", "fdist")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
TRANSCENDENTAL = dict(rtol=2e-5, atol=1e-4)
# What each stage runs under each engine (bench.py's walk_tiers).
STAGES = {
    "cuda": dict(stencil="K2 stencil_tile_kernel<false> (csrc/stencil.cu)",
                 downslope="K3 downslope_kernel<false> (csrc/walk.cu)",
                 flow="K4 jump walk (csrc/walk.cu)"),
    "cuda_blocked": dict(stencil="K2 stencil_tile_kernel<false> (csrc/stencil.cu)",
                         downslope="K3 downslope_kernel<false> (csrc/walk.cu)",
                         flow="K7 anchored fold (csrc/flow_fold.cu)"),
    "torch": dict(stencil="stencil_plain", downslope="_downslope_jacobi", flow="doubling_walk"),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_suite(device, inputs, cfg, batch=1, iters=ITERS):
    """Median seconds per suite run.

    ``batch=1``: the latency of one suite and its synchronize.
    ``batch=k``: k suites dispatched back to back with ONE synchronize,
    the sustained rate of the card when work is queued."""

    def run():
        outs = [pipeline.descriptor_suite(*inputs, cfg) for _ in range(batch)]
        _sync(device)
        return outs

    for _ in range(WARMUP):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / batch


def _walk_tiers(engine):
    """What each stage ran: the kernel under a CUDA engine, the plain
    function under a torch one."""
    return dict(STAGES[engine])


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--synthetic", type=int, metavar="N", help="synthetic_basin(N, N, seed=0)")
    src.add_argument("--basin", metavar="DIR", help="a basin in the reference Example layout")
    return ap


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


def check_suite(out, plain):
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
        raise AssertionError("the timed suite against engine='torch': " + "; ".join(bad))
    return err


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


def _rev():
    """The checkout's git revision (None outside a git checkout)."""
    return provenance.git_rev(ROOT)


def _cpu_baseline(arrays, cfg, metric, rev, root):
    """The suite on the host CPU: {t_cpu, threads, cpu_model, rev, cached}.
    Read from ``build/bench_cpu_<metric>.json`` under ``root`` where it was
    measured at this git revision, else measured (a failure raises) and
    written there."""
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
    cpu = torch.device("cpu")
    inputs = pipeline.inputs_to_torch(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], cpu)
    t_cpu = _time_suite(cpu, inputs, cfg, iters=CPU_ITERS)
    entry = dict(rev=rev, t_cpu=t_cpu, threads=torch.get_num_threads(), cpu_model=_cpu_model())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(entry, fh)
    return dict(entry, cached=False)


def measure(argv=(), *, device="cuda", iters=ITERS, batch=BATCH, root=ROOT):
    """The line's dict for ``argv`` (the script's flags), its suites on
    ``device`` (the card unless the caller asks for "cpu"; raises where no
    CUDA device is available); the CPU leg's cache under ``root``."""
    device = pipeline.check_device(device)
    args = parser().parse_args(list(argv))
    arrays, metric = _inputs(args)
    rows, cols = arrays["dem"].shape
    cells = rows * cols
    cfg = pipeline.PipelineConfig()
    engine = cfg.resolve_engine(device)
    inputs = pipeline.inputs_to_torch(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], device)

    before = launch_counters()
    t_latency = _time_suite(device, inputs, cfg, iters=iters)
    t_accel = _time_suite(device, inputs, cfg, batch=batch, iters=iters)
    # One more suite, outside the timing: under "error" any host
    # synchronisation inside the suite raises (it would hold every batch
    # to the latency).  Its rasters are the ones checked below.
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipeline.descriptor_suite(*inputs, cfg)
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    _sync(device)
    suites = (WARMUP + iters) * (1 + batch) + 1
    after = launch_counters()
    kernels = {k: after[k] - before[k] for k in after}
    want = {k: suites if engine == "cuda" and k in IN_CORE else 0 for k in kernels}
    if kernels != want:
        raise AssertionError(f"kernel launches over {suites} suites: {kernels}, expected {want}")

    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    err = check_suite(out, plain)
    del plain
    checked = f"engine='torch' on {device.type}"
    if args.synthetic is None and args.basin is None:
        host = {k: v.cpu().numpy() for k, v in out.items()}
        classified = pipeline.classify_flood(host["hand"], arrays["flood"])
        report = parity.check(parity.load(REFERENCE), rows, cols, arrays, host, classified)
        err = max([err] + [r["max_abs_err"] for r in report.values()])
        checked += f"; {os.path.relpath(REFERENCE, ROOT)} {rows}x{cols} (utils.parity.check)"
    del out

    rev = _rev()
    base = _cpu_baseline(arrays, cfg, metric, rev, root)
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
            f"vs_baseline: the same suite on the host CPU, engine 'torch', median of {CPU_ITERS}"
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
        "baseline": dict(device="cpu", engine="torch", seconds=base["t_cpu"], threads=base["threads"],
                         cpu_model=base["cpu_model"], iters=CPU_ITERS, cached=base["cached"]),
    }


def main(argv=None):
    pipeline.check_device("cuda")  # raises without a card, before any work
    print(json.dumps(measure(sys.argv[1:] if argv is None else argv)))


if __name__ == "__main__":
    main()
