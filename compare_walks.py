#!/usr/bin/env python3
"""Time the port's walks, stencils and suite in several checkouts, in one call.

    python3 compare_walks.py OLD NEW NEW OLD    # each the root of a checkout
    python3 compare_walks.py --downslope A B ...  # the downslope stage alone

One process per argument, run one after another in the order given, so a
checkout's numbers can be set beside another's taken on the same card.
Each process puts its checkout first on ``sys.path``: ``descriptools_tpu_torch``
and its kernels (built into that checkout's ``build/``) come from there.
The inputs come from this file's directory (``chip_smoke.py``'s
generators), the same in every process.  Each process times, on one card:

- the in-core flow entry (K4, ``ops.cuda.walk.flow_cuda``: fdr and river
  to fdist and indices) at 2178x1534, cap 20000, on the synthetic basin,
  on northward flow into a river row every 101 rows (walks of 0 to 100
  steps) and on the lateral channel (walks of up to 3710 steps);
- ``absorbing_walk`` (K5/K8, the jump walk over walk operands) on the same
  three grids' operands and on tile (0, 0) of the tiled phase's 8192x8192
  grid in 4096x4096 tiles;
- ``flow_walk_blocked`` (K7) at 2178x1534, cap 20000, on the basin, the
  north rivers and the lateral channel;
- ``stencil`` (K2) on the synthetic basin and ``stencil_padded`` (K1) on
  tile (0, 0)'s padded 4098x4098 block of that grid: event time, device
  time (torch.profiler: the stencil kernel alone and all the call's device
  work), a sha256 of the four rasters, and the SASS instructions of the
  checkout's stencil kernels;
- the downslope stage: in core (``ops.cuda.walk.downslope_cuda``) on the
  synthetic basin and on the 100-step ramp (tall north, ed 50, cap 5000),
  and tracked on tile (0, 0)'s 4224x4224 window of the 8192x8192 grid (as
  the tiled path composes it: the interior's downslope and flags, then
  ``.any()``): event time, device time (torch.profiler: all the call's
  device work, by kernel), a sha256 of the downslope and flag rasters.  A
  checkout whose ``downslope_walk`` takes the walk operands (before the
  fused kernel) is composed as its own ``downslope_cuda`` and tiled path
  compose it;
- the in-core suite's stages on the synthetic basin, each alone (stencil;
  downslope, and for an operand-level checkout its ``walk_inputs``, kernel
  and post-pass apart; the flow stage, ``flow_cuda``; HAND and river fac;
  GFI and ln(hl/H));
- ``descriptor_suite`` on the synthetic basin, default configuration and
  ``engine="cuda_blocked"`` (with the latter's peak device memory), and the
  default suite on tile (0, 0)'s 4096x4096 inputs with its peak device
  memory;

With ``--downslope`` each process times the downslope stage alone (a
sweep of kernel variants: copies of ``descriptools_tpu_torch`` with
``csrc/walk.cu`` edited).

each count walk held bitwise against ``doubling_walk`` (the flow entry's
fdist and indices against ``flow_from_state`` of it) and each fold walk
against ``fold_walk``, each time the median of
20 CUDA-event runs after a warm-up.  Every process prints its numbers, and
whether the stencils' and the downslope's rasters are identical in every
checkout; the last line is one JSON object with all of them and the card's
name and power limit.
"""

import hashlib
import importlib.util
import inspect
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


def one(tree, only_downslope=False):
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
    if only_downslope:
        downslope, stages = downslope_and_stages(torch, cs, dev, inputs, windowed_basin(cs.BIG, cs.BIG, seed=0))
        print(json.dumps({"tree": tree, "package": package, "downslope": downslope, "stages_ms": stages,
                          "walk_step_sass": walk_step_sass(cs, build)}))
        return
    on_dev = lambda arrays: tuple(torch.as_tensor(a, device=dev) for a in arrays)
    rasters = {
        "basin": (inputs[1], inputs[3]),
        "north rivers": on_dev(cs.north_rivers(cs.ROWS, cs.COLS)),
        "lateral channel": on_dev(cs.lateral_channel(cs.ROWS, cs.COLS)),
    }
    operands = {label: flow.walk_inputs(*r) for label, r in rasters.items()}
    loaders = windowed_basin(cs.BIG, cs.BIG, seed=0)
    tile = [torch.as_tensor(loaders[k](0, cs.TILE, 0, cs.TILE), device=dev) for k in ("fdr", "river")]
    loc = boundary.local_walk_operands(*tile, 0, 0, cs.TILE, cs.TILE, cs.BIG, cs.BIG)[:2]
    ms = {}
    for label, ops in (*operands.items(), ("4096x4096 tile", loc)):
        want = flow.doubling_walk(*ops, 20000)
        for name, g, w in zip(("code", "a", "b"), walk.absorbing_walk(*ops, 20000), want):
            cs.check_bitwise(f"absorbing_walk {label}/{name}", g, w)
        ms[f"absorbing_walk {label}"] = median_ms(torch, lambda: walk.absorbing_walk(*ops, 20000))
        if label in rasters:
            k4 = lambda r=rasters[label]: walk.flow_cuda(*r, 12.5, 20000)
            for name, g, w in zip(("fdist", "indices"), k4(), flow.flow_from_state(*want, 12.5, 20000)):
                cs.check_bitwise(f"flow_cuda {label}/{name}", g.view(torch.int32), w.view(torch.int32))
            ms[f"flow_cuda {label}"] = median_ms(torch, k4)
    consts = flow.step_consts(12.5)
    for label, ops in operands.items():
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
    downslope, stages = downslope_and_stages(torch, cs, dev, inputs, loaders)
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
    # The default suite on tile (0, 0)'s 4096x4096 inputs, and its peak.
    big = pipeline.inputs_to_torch(*(loaders[k](0, cs.TILE, 0, cs.TILE) for k in ("dem", "fdr", "fac", "river")),
                                   dev)
    ms["descriptor_suite 4096x4096"] = median_ms(torch, lambda: pipeline.descriptor_suite(*big, cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    pipeline.descriptor_suite(*big, cfg)
    torch.cuda.synchronize()
    peak_4096_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    del big
    # B of a tree with the jump walk; None for one with the serial walk.
    bound = walk.jump_bound() if hasattr(walk, "jump_bound") else None
    lib = build.build()[0]
    cells = cs.stencil_cells(tree)
    sass = {name: dict(main=len(cs.main_path(ins)), total=len(ins), per_cell=cs.common_path_count(ins, cells))
            for name, ins in cs.sass_functions(lib).items() if "stencil" in name}
    print(json.dumps({"tree": tree, "package": package, "B": bound, "ms": ms,
                      "stencil_device_ms": device, "stencil_sha256": sha, "stencil_sass": sass,
                      "downslope": downslope, "stages_ms": stages, "walk_step_sass": walk_step_sass(cs, build),
                      "cuda_blocked_suite_peak_MiB": peak_mib, "suite_4096_peak_MiB": peak_4096_mib}))


def walk_step_sass(cs, build):
    """SASS instructions a step of the checkout's fused downslope kernel
    (``chip_smoke.walk_step_instructions``), None for a checkout without
    it."""
    lib = build.build()[0]
    if not any(cs.DOWNSLOPE_SASS in name for name in cs.sass_functions(lib)):
        return None
    return cs.walk_step_instructions(lib)


def downslope_and_stages(torch, cs, dev, inputs, loaders):
    """The downslope stage in core (basin, ramp) and tracked (tile (0, 0)'s
    window), each {event ms, device ms, device activities, the walk kernel's
    device ms, sha256}; then the in-core suite's stages on the basin,
    {stage: event ms}."""
    from descriptools_tpu_torch import pipeline, tiled
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import walk

    # Before the fused kernel, downslope_walk took (fdr_eff, z, zt0, ...).
    fused = "dem_f" in inspect.signature(walk.downslope_walk).parameters
    px, ed, steps = 12.5, 5.0, 5000
    dem, fdr, fac, river = inputs
    dem_f = dem.to(torch.float32).contiguous()
    ramp = tuple(torch.as_tensor(a, device=dev) for a in cs.tall_north(cs.ROWS, cs.COLS, None))
    halo, big = 64, (cs.BIG, cs.BIG)
    d_ext = torch.as_tensor(tiled.load_window(loaders["dem"], 0, cs.TILE, 0, cs.TILE, big, -100,
                                              np.asarray(loaders["dem"](0, 1, 0, 1)).dtype, halo=halo),
                            device=dev).to(torch.float32)
    f_ext = torch.as_tensor(tiled.load_window(loaders["fdr"], 0, cs.TILE, 0, cs.TILE, big, 0, np.uint8,
                                              halo=halo), device=dev)
    window = (px, ed, steps, -halo, -halo, *big, halo)

    def tracked():
        if fused:
            dn, tr = walk.downslope_walk_tracked(d_ext, f_ext, *window)
        else:  # the parent's tiled._downslope_ext
            tr0 = down.trunc_cells(d_ext, f_ext, -halo, -halo, *big)
            fdr_eff, z, zt0 = down.walk_inputs(d_ext, f_ext, px)
            pk, zt, tr = walk.downslope_walk_tracked(fdr_eff, z, zt0, ed, steps, tr0)
            dn = down.downslope_from_state(z, pk, zt, px)
            dn, tr = dn[halo:-halo, halo:-halo], tr[halo:-halo, halo:-halo]
        return dn, tr, tr.any()

    calls = {
        "basin": lambda: (walk.downslope_cuda(dem_f, fdr, px, ed, steps),),
        "ramp (tall north, ed 50)": lambda: (walk.downslope_cuda(*ramp, px, 50.0, steps),),
        "tracked 4224x4224 window of tile (0, 0)": tracked,
    }
    out = {}
    for label, call in calls.items():
        rasters = call()[:2]
        by_kernel = cs.device_kernels_ms(call)
        walk_ms = sum(v for k, v in by_kernel.items() if "downslope" in k)
        out[label] = dict(event_ms=median_ms(torch, call), device_ms=sum(by_kernel.values()),
                          kernels=len(by_kernel), walk_kernel_ms=walk_ms,
                          sha256=hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in rasters)).hexdigest())
    del d_ext, f_ext
    # The in-core suite's stages, each alone.
    cfg = pipeline.PipelineConfig()
    _, indices = walk.flow_cuda(fdr, river, px, cfg.flow_max_steps)
    hand, river_fac = flow.hand_and_river_fac(dem, fac, indices)
    stages = {
        "stencil": lambda: pipeline._engine_stencil(dem_f, fac, cfg, "cuda"),
        "downslope": lambda: pipeline._engine_downslope(dem_f, fdr, cfg, "cuda"),
    }
    if not fused:
        d_ops = down.walk_inputs(dem_f, fdr, px)
        pk, zt = walk.downslope_walk(*d_ops, ed, steps)
        stages.update({
            "downslope walk_inputs": lambda: down.walk_inputs(dem_f, fdr, px),
            "downslope kernel": lambda: walk.downslope_walk(*d_ops, ed, steps),
            "downslope post-pass": lambda: down.downslope_from_state(d_ops[1], pk, zt, px),
        })
    stages.update({
        "flow": lambda: walk.flow_cuda(fdr, river, px, cfg.flow_max_steps),
        "HAND + river fac": lambda: flow.hand_and_river_fac(dem, fac, indices),
        "GFI + ln(hl/H)": lambda: (pipeline._gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, px),
                                   pipeline.ln_hl_h(hand, fac, cfg.n_gfi, cfg.b_gfi, px)),
        "suite": lambda: pipeline.descriptor_suite(*inputs, cfg),
    })
    return out, {name: median_ms(torch, fn) for name, fn in stages.items()}


def main(trees, only_downslope=False):
    import chip_smoke as cs

    runs = []
    for tree in trees:
        flags = ["--one-downslope" if only_downslope else "--one", tree]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), *flags],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"compare_walks: {tree} failed ({out.returncode})")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run)
        print_downslope(tree, run)
        if only_downslope:
            continue
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
        print(f"{tree} suite 4096x4096 {run['ms']['descriptor_suite 4096x4096']:.4f} ms, peak "
              f"{run['suite_4096_peak_MiB']:.3f} MiB")
    for label in [] if only_downslope else runs[0]["stencil_sha256"]:
        same = len({run["stencil_sha256"][label] for run in runs}) == 1
        print(f"{label}: the four rasters are {'identical' if same else 'NOT identical'} in every checkout")
    for label in runs[0]["downslope"]:
        same = len({run["downslope"][label]["sha256"] for run in runs}) == 1
        print(f"downslope {label}: the rasters are {'identical' if same else 'NOT identical'} in every checkout")
    card = cs.card_line()
    print(card)
    print(json.dumps({"card": card, "repeats": REPEATS, "runs": runs}))


def print_downslope(tree, run):
    for label, row in run["downslope"].items():
        print(f"{tree} downslope {label}: event {row['event_ms']:.4f} ms, device {row['device_ms']:.4f} ms "
              f"in {row['kernels']} device activities, {row['walk_kernel_ms']:.4f} ms of it in the walk "
              f"kernel; rasters sha256 {row['sha256']}")
    print(f"{tree} stages (basin, event ms): " + ", ".join(f"{k} {v:.4f}" for k, v in run["stages_ms"].items()))
    print(f"{tree} downslope walk: {run['walk_step_sass']} SASS instructions a step")


if __name__ == "__main__":
    if sys.argv[1:2] in (["--one"], ["--one-downslope"]):
        one(sys.argv[2], only_downslope=sys.argv[1] == "--one-downslope")
    elif sys.argv[1:2] == ["--downslope"] and len(sys.argv) > 2:
        main(sys.argv[2:], only_downslope=True)
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
