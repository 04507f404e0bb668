#!/usr/bin/env python3
"""The spread of ``bench_torch.py``'s commands over fresh processes, and
the card's busy share in each, on one NVIDIA card.

    python3 bench_spread_torch.py --repeat 10 --out build/spread.json
    python3 bench_spread_torch.py --repeat 10 -- --long-drainage 2178x1534 --engine cuda_blocked

Each command (``COMMANDS``, or the one given after ``--``) runs ``--repeat``
times as ``python3 bench_torch.py ARGS``, each in a process of its own, as
a user runs it; every line must say ``correct``.  Per command it reports
the median, quartiles (``statistics.quantiles``, inclusive) and min-max of
the timed seconds (in core: ``sustained_s``, a suite of a batch of 5, and
``latency_s``; out of core: the median run of each process) and of
``value``, with the spread (max - min) and the interquartile range over
the median.

Then one more process a command (``--profile``) builds the same inputs,
runs the timed unit once to warm up and once under torch.profiler inside a
``record_function`` window (in core: a batch of 5 suites and one
synchronize; out of core: one run): the busy share is the union of the
card's kernel, copy and memset intervals inside the window over the
window's length (host clock of the profiler), the idle share its
complement; the kernels' device time a suite (a run) beside the window's.
The profiled run is not one of the timed ones.

Prints one JSON object per command as it finishes and one summary line
last; ``--out`` also writes the summary.  Needs a card; imports torch,
numpy and the port only.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

COMMANDS = (
    (),
    ("--engine", "cuda_blocked"),
    ("--synthetic", "4096"),
    ("--long-drainage", "2178x1534"),
    ("--long-drainage", "2178x1534", "--engine", "cuda_blocked"),
    ("--tiled", "8192", "--tile", "4096"),
    ("--checkpointed", "8192"),
)
TIMEOUT_S = 900  # one process of bench_torch.py


def summary(xs):
    """Median, quartiles, min, max, (max - min) / median and IQR / median."""
    xs = sorted(xs)
    med = statistics.median(xs)
    q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else (xs[0],) * 3
    return dict(n=len(xs), median=med, q1=q1, q3=q3, min=xs[0], max=xs[-1],
                spread_over_median=(xs[-1] - xs[0]) / med, iqr_over_median=(q3 - q1) / med)


def _run(argv, timeout=TIMEOUT_S):
    """Run a script of the repository in a process of its own; its last
    JSON line.  Raises unless it exits 0."""
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(argv)}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


def spread(args, repeat):
    """``repeat`` fresh processes of ``bench_torch.py args``: the lines'
    timings summarised."""
    lines, walls = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        line = _run([os.path.join(ROOT, "bench_torch.py"), *args])
        walls.append(time.perf_counter() - t0)
        if line["correct"] is not True:
            raise AssertionError(f"bench_torch.py {' '.join(args)}: {line}")
        lines.append(line)
    in_core = "sustained_s" in lines[0]
    timed = [ln["sustained_s"] if in_core else statistics.median(ln["run_s"]) for ln in lines]
    out = dict(command=" ".join(["python3", "bench_torch.py", *args]), metric=lines[0]["metric"],
               device=lines[0]["device"], engine=lines[0]["engine"], timed_s=summary(timed),
               value=summary([ln["value"] for ln in lines]), process_wall_s=summary(walls),
               vs_baseline=summary([ln["vs_baseline"] for ln in lines]),
               per_process=[dict(timed_s=t, value=ln["value"]) for t, ln in zip(timed, lines)])
    if in_core:
        out["latency_s"] = summary([ln["latency_s"] for ln in lines])
    out["prep_s"] = summary([ln["prep_s"] for ln in lines]) if "prep_s" in lines[0] else None
    return out


def _window_rows(trace, name):
    """(window (start, end) us of the ``record_function`` named ``name``,
    the card's kernel, copy and memset intervals, the kernels' alone)."""
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    window, device, kernels = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        span = (start, start + float(e.get("dur", 0.0)))
        cat = e.get("cat", "")
        if e.get("name") == name and cat == "user_annotation":
            window = span
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(span)
            if cat == "kernel":
                kernels.append(span)
    if window is None:
        raise AssertionError(f"the trace holds no window {name!r}")
    return window, device, kernels


def _clipped_union_us(intervals, window):
    """Length (us) of the union of ``intervals`` inside ``window``."""
    total, end = 0.0, window[0]
    for a, b in sorted(intervals):
        a, b = max(a, end, window[0]), min(b, window[1])
        if b > a:
            total += b - a
            end = b
    return total


def busy_share(fn, units):
    """Profile ``fn()`` (``units`` suites or runs, ending synchronised)
    once: {window_ms, busy_ms, busy_share, idle_share, kernel_ms_per_unit}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fd, trace = tempfile.mkstemp(suffix=".json", dir=os.path.join(ROOT, "build"))
    os.close(fd)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench_window"):
                fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        window, device, kernels = _window_rows(trace, "bench_window")
    finally:
        os.remove(trace)
    span = window[1] - window[0]
    busy = _clipped_union_us(device, window)
    return dict(window_ms=span / 1e3, busy_ms=busy / 1e3, busy_share=busy / span, idle_share=1 - busy / span,
                kernel_ms_per_unit=sum(b - a for a, b in kernels) / 1e3 / units, units=units)


def profile_command(args):
    """The timed unit of ``bench_torch.py args`` on the card, warmed up once,
    then profiled (:func:`busy_share`)."""
    import torch

    import bench_torch as bt
    from descriptools_tpu_torch import pipeline, tiled

    device = pipeline.check_device("cuda")
    a = bt._parse(args)
    if a.tiled is not None or a.checkpointed is not None:
        n = a.tiled if a.tiled is not None else a.checkpointed
        loaders, maps, _, _ = bt._memmap_inputs(n, ROOT)
        cfg = pipeline.PipelineConfig()
        if a.tiled is not None:
            def fn():
                tiled.tiled_suite(loaders, (n, n), cfg, device, tile_rows=a.tile, tile_cols=a.tile,
                                  cache_inputs=False)
        else:
            inputs = bt._memmap_tensors(maps, device)
            os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)

            def fn():
                with tempfile.TemporaryDirectory(prefix="bench_ckpt_", dir=os.path.join(ROOT, "build")) as d:
                    pipeline.run_suite_checkpointed(*inputs, cfg, d)
        units = 1
    else:
        if a.long_drainage is not None:
            _, _, inputs, params, _ = bt._long_drainage(a, device, None)
            cfg = pipeline.PipelineConfig(elevation_difference=params["elevation_difference"], engine=a.engine)
        else:
            arrays, _ = bt._inputs(a)
            inputs = pipeline.inputs_to_torch(arrays["dem"], arrays["fdr"], arrays["fac"], arrays["river"], device)
            cfg = pipeline.PipelineConfig(engine=a.engine)
        units = bt.BATCH

        def fn():
            for _ in range(units):
                pipeline.descriptor_suite(*inputs, cfg)
    fn()
    torch.cuda.synchronize()
    return busy_share(fn, units)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=10, help="fresh processes a command (default 10)")
    ap.add_argument("--out", help="also write the summary line to this file")
    ap.add_argument("--profile", action="store_true",
                    help="profile the command's timed unit once in this process (what each command's extra "
                         "process runs)")
    ap.add_argument("bench_args", nargs=argparse.REMAINDER,
                    help="after --: one bench_torch.py command's flags (default: every command of COMMANDS)")
    return ap


def main(argv=None):
    args = parser().parse_args(sys.argv[1:] if argv is None else argv)
    bench_args = [a for a in args.bench_args if a != "--"] if args.bench_args else None
    from descriptools_tpu_torch import pipeline

    pipeline.check_device("cuda")  # raises without a card
    if args.profile:
        print(json.dumps(profile_command(bench_args or [])))
        return
    commands = [tuple(bench_args)] if bench_args is not None else COMMANDS
    results = []
    for cmd in commands:
        t0 = time.perf_counter()
        res = spread(cmd, args.repeat)
        res["profile"] = _run([os.path.join(ROOT, "bench_spread_torch.py"), "--profile", "--", *cmd])
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
        results.append(res)
    line = dict(repeat=args.repeat, commands=results)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(line, fh)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
