#!/usr/bin/env python3
"""Time the port's flow walks, stencils and suite in several checkouts, in one call.

    python3 compare_walks.py OLD NEW NEW OLD    # each the root of a checkout

One process per argument, run one after another in the order given, so a
checkout's numbers can be set beside another's taken on the same card.
Each process puts its checkout first on ``sys.path``: ``descriptools_tpu_torch``
and its kernels (built into that checkout's ``build/``) come from there.
The inputs come from this file's directory (``chip_smoke.py``'s
generators), the same in every process.  Each process times, on one card:

- ``flow_walk`` (K4) at 2178x1534, cap 20000, on the synthetic basin, on
  northward flow into a river row every 101 rows (walks of 0 to 100 steps)
  and on the lateral channel (walks of up to 3710 steps);
- ``absorbing_walk`` (K5/K8) on tile (0, 0) of the tiled phase's 8192x8192
  grid in 4096x4096 tiles;
- ``flow_walk_blocked`` (K7) at 2178x1534, cap 20000, on the basin, the
  north rivers and the lateral channel;
- ``stencil`` (K2) on the synthetic basin and ``stencil_padded`` (K1) on
  tile (0, 0)'s padded 4098x4098 block of that grid: event time, device
  time (torch.profiler: the stencil kernel alone and all the call's device
  work), a sha256 of the four rasters, and the SASS instructions of the
  checkout's stencil kernels;
- ``descriptor_suite`` on the synthetic basin, default configuration and
  ``engine="cuda_blocked"`` (with the latter's peak device memory);

each count walk held bitwise against ``doubling_walk`` and each fold walk
against ``fold_walk``, each time the median of
20 CUDA-event runs after a warm-up.  Every process prints its numbers, and
whether the stencils' rasters are identical in every checkout; the last
line is one JSON object with all of them and the card's name and power
limit.
"""

import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REPEATS = 20


def median_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def one(tree):
    """Time the checkout at ``tree``; print its numbers as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    # This directory's chip_smoke.py, not the checkout's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import descriptools_tpu_torch
    from descriptools_tpu_torch import pipeline, tiled
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import build, walk
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.parallel import boundary
    from descriptools_tpu_torch.utils.synthetic import windowed_basin

    if not torch.cuda.is_available():
        raise SystemExit("compare_walks: torch.cuda.is_available() is false")
    package = os.path.dirname(descriptools_tpu_torch.__file__)
    if package != os.path.join(os.path.abspath(tree), "descriptools_tpu_torch"):
        raise SystemExit(f"compare_walks: imported {package}, not the package of {tree}")
    dev = torch.device("cuda", 0)
    basin = cs.basin_inputs()
    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    on_dev = lambda arrays: flow.walk_inputs(*(torch.as_tensor(a, device=dev) for a in arrays))
    cases = {
        "flow_walk basin": (walk.flow_walk, flow.walk_inputs(inputs[1], inputs[3])),
        "flow_walk north rivers": (walk.flow_walk, on_dev(cs.north_rivers(cs.ROWS, cs.COLS))),
        "flow_walk lateral channel": (walk.flow_walk, on_dev(cs.lateral_channel(cs.ROWS, cs.COLS))),
    }
    loaders = windowed_basin(cs.BIG, cs.BIG, seed=0)
    tile = [torch.as_tensor(loaders[k](0, cs.TILE, 0, cs.TILE), device=dev) for k in ("fdr", "river")]
    loc = boundary.local_walk_operands(*tile, 0, 0, cs.TILE, cs.TILE, cs.BIG, cs.BIG)[:2]
    cases["absorbing_walk 4096x4096 tile"] = (walk.absorbing_walk, loc)
    ms = {}
    for label, (fn, ops) in cases.items():
        for name, g, w in zip(("code", "a", "b"), fn(*ops, 20000), flow.doubling_walk(*ops, 20000)):
            cs.check_bitwise(f"{label}/{name}", g, w)
        ms[label] = median_ms(torch, lambda: fn(*ops, 20000))
    consts = flow.step_consts(12.5)
    for label in ("basin", "north rivers", "lateral channel"):
        ops = cases[f"flow_walk {label}"][1]
        for name, g, w in zip(("code", "dist"), walk.flow_walk_blocked(*ops, *consts, 20000),
                              flow.fold_walk(*ops, *consts, 20000)):
            cs.check_bitwise(f"flow_walk_blocked {label}/{name}", g, w)
        ms[f"flow_walk_blocked {label}"] = median_ms(
            torch, lambda: walk.flow_walk_blocked(*ops, *consts, 20000))
    # The stencils: K2 on the basin, K1 on tile (0, 0)'s 4098x4098 padded
    # block (a NoData ring above and to the left, real neighbours below and
    # to the right), each with its device time and its rasters' sha256.
    dem_dt = np.asarray(loaders["dem"](0, 1, 0, 1)).dtype
    padded = tiled.load_window(loaders["dem"], 0, cs.TILE, 0, cs.TILE, (cs.BIG, cs.BIG), -100, dem_dt, halo=1)
    padded = torch.as_tensor(padded, device=dev).to(torch.float32).contiguous()
    fac_tile = torch.as_tensor(np.asarray(loaders["fac"](0, cs.TILE, 0, cs.TILE), np.int32), device=dev)
    stencils = {
        "stencil basin": (st.stencil, (inputs[0].to(torch.float32), inputs[2])),
        "stencil_padded 4096x4096 tile": (st.stencil_padded, (padded, fac_tile)),
    }
    device, sha = {}, {}
    for label, (fn, ops) in stencils.items():
        call = lambda: fn(*ops, 12.5, 0.1)
        sha[label] = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in call())).hexdigest()
        ms[label] = median_ms(torch, call)
        by_kernel = cs.device_kernels_ms(call)
        kernel = [v for k, v in by_kernel.items() if "stencil" in k]
        device[label] = dict(kernel=sum(kernel) if kernel else None, call=sum(by_kernel.values()),
                             by_kernel=by_kernel)
    del padded, fac_tile
    cfg = pipeline.PipelineConfig()
    ms["descriptor_suite basin"] = median_ms(torch, lambda: pipeline.descriptor_suite(*inputs, cfg))
    blocked = pipeline.PipelineConfig(engine="cuda_blocked")
    ms["descriptor_suite cuda_blocked basin"] = median_ms(
        torch, lambda: pipeline.descriptor_suite(*inputs, blocked))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipeline.descriptor_suite(*inputs, blocked)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    # B of a tree with the jump walk; None for one with the serial walk.
    bound = walk.jump_bound() if hasattr(walk, "jump_bound") else None
    lib = build.build()[0]
    cells = cs.stencil_cells(tree)
    sass = {name: dict(main=len(cs.main_path(ins)), total=len(ins), per_cell=cs.common_path_count(ins, cells))
            for name, ins in cs.sass_functions(lib).items() if "stencil" in name}
    print(json.dumps({"tree": tree, "package": package, "B": bound, "ms": ms,
                      "stencil_device_ms": device, "stencil_sha256": sha, "stencil_sass": sass,
                      "cuda_blocked_suite_peak_MiB": peak_mib}))


def main(trees):
    import chip_smoke as cs

    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"compare_walks: {tree} failed ({out.returncode})")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"{tree} (B {run['B']}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in run["ms"].items())
              + f"; cuda_blocked suite peak {run['cuda_blocked_suite_peak_MiB']:.3f} MiB")
        for label, dev in run["stencil_device_ms"].items():
            shown = ("not measured (the trace held no stencil kernel)" if dev["kernel"] is None else
                     f"{dev['kernel']:.4f} ms in the stencil kernel, {dev['call']:.4f} ms in all the call's "
                     f"device work ({', '.join(dev['by_kernel'])})")
            print(f"{tree} {label}: device {shown}; event {run['ms'][label]:.4f} ms; rasters sha256 "
                  f"{run['stencil_sha256'][label]}")
        print(f"{tree} stencil SASS instructions (common path a cell; entry to first EXIT, all): "
              + ", ".join(f"{k} {v['per_cell']:.2f}; {v['main']}, {v['total']}"
                          for k, v in run["stencil_sass"].items()))
    for label in runs[0]["stencil_sha256"]:
        same = len({run["stencil_sha256"][label] for run in runs}) == 1
        print(f"{label}: the four rasters are {'identical' if same else 'NOT identical'} in every checkout")
    card = cs.card_line()
    print(card)
    print(json.dumps({"card": card, "repeats": REPEATS, "runs": runs}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
