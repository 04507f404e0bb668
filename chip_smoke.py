#!/usr/bin/env python3
"""Drive the PyTorch port (descriptools_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing its own lines:

0. device and toolchain: the card (name and power limit from nvidia-smi),
   torch and CUDA versions, nvcc, and the build of ``csrc/*.cu``;
1. every CUDA kernel against its plain PyTorch version on the card, at the
   basin's shape (2178x1534, synthetic) and on adversarial fixtures
   (long northward walks, with and without ascending bumps; a lateral
   channel; a 40000-step serpentine);
2. the slice: ``descriptor_suite`` on CUDA tensors (the kernels run), then
   ``classify_flood``, held against the ``engine="torch"`` run on the same
   card, with every kernel's launch count checked;
3. timing: the suite and each kernel beside its plain version, median of 5
   runs after one warm-up, with CUDA events.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits non-zero and prints no result, as it does where CUDA is
not available.
"""

import importlib.metadata
import importlib.util
import json
import os
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
}


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


def median_ms(fn):
    """Median of REPEATS timed runs (CUDA events), after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


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


def serpentine(rows=200, cols=200):
    """One boustrophedon path of ~40000 steps to a single river cell."""
    fdr = np.zeros((rows, cols), np.uint8)
    for r in range(rows):
        fdr[r, :] = 1 if r % 2 == 0 else 16
        fdr[r, -1 if r % 2 == 0 else 0] = 4
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
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


def phase_kernels(dev, basin, errs):
    """Each kernel's wrapper on the card against its plain version."""
    from descriptools_tpu_torch.ops import downslope as down
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk

    def stencil_case(label, dem, fac):
        dem_f = torch.as_tensor(np.asarray(dem, np.float32), device=dev)
        fac_t = torch.as_tensor(np.asarray(fac, np.int32), device=dev)
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
        fdr_eff, z, zt0 = down.walk_inputs(dem_f, fdr_t, 12.5)
        pk, zt = walk.downslope_walk(fdr_eff, z, zt0, ed, max_steps)
        wpk, wzt = down.jacobi_walk(fdr_eff, z, zt0, ed, max_steps)
        check_bitwise(f"downslope/{label}/pk", pk, wpk)
        e = check_bitwise(f"downslope/{label}/Zt", zt, wzt)
        e += check_bitwise(
            f"downslope/{label}/downslope",
            down.downslope_from_state(z, pk, zt, 12.5),
            down.downslope_from_state(z, wpk, wzt, 12.5),
        )
        errs["downslope_walk"] = max(errs["downslope_walk"], e)
        print(f"kernel downslope_walk {label:<26} matches plain bitwise (pk, Zt, downslope)")

    def flow_case(label, fdr, river, max_steps):
        fdr_t = torch.as_tensor(fdr, device=dev)
        fdr_eff, code0 = flow.walk_inputs(fdr_t, torch.as_tensor(river, device=dev))
        got = walk.flow_walk(fdr_eff, code0, max_steps)
        want = flow.doubling_walk(fdr_eff, code0, max_steps)
        e = 0.0
        for name, g, w in zip(("code", "a", "b"), got, want):
            e += check_bitwise(f"flow/{label}/{name}", g, w)
        for name, g, w in zip(
            ("fdist", "indices"),
            flow.flow_from_state(*got, 12.5, max_steps),
            flow.flow_from_state(*want, 12.5, max_steps),
        ):
            e += check_bitwise(f"flow/{label}/{name}", g, w)
        errs["flow_walk"] = max(errs["flow_walk"], e)
        print(f"kernel flow_walk      {label:<26} matches plain bitwise (code, a, b, fdist, indices)")

    stencil_case(f"basin {ROWS}x{COLS}", basin["dem"], basin["fac"])
    downslope_case(f"basin {ROWS}x{COLS}", basin["dem"], basin["fdr"], 5.0, 5000)
    flow_case(f"basin {ROWS}x{COLS}", basin["fdr"], basin["river"], 20000)
    for bump in (None, 37):
        dem, fdr = tall_north(320, 128, bump)
        stencil_case(f"tall north bump={bump}", dem, np.arange(dem.size).reshape(dem.shape) % 997)
        downslope_case(f"tall north bump={bump}", dem, fdr, 50.0, 600)
    downslope_case(f"tall north {ROWS}x{COLS}", *tall_north(ROWS, COLS, 37), 50.0, 5000)
    flow_case("lateral channel", *lateral_channel(), 1000)
    flow_case(f"lateral channel {ROWS}x{COLS}", *lateral_channel(ROWS, COLS), 20000)
    flow_case("serpentine 200x200", *serpentine(), 60000)
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
    missing = [k for k, v in launches.items() if v == 0]
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
    return inputs, launches


def phase_timing(dev, inputs, card):
    """Kernels beside their plain versions, then the suite, at the basin's
    shape."""
    from descriptools_tpu_torch import pipeline
    from descriptools_tpu_torch.ops import downslope as down
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk

    dem, fdr, fac, river = inputs
    dem_f = dem.to(torch.float32)
    d_ops = down.walk_inputs(dem_f, fdr, 12.5)
    f_ops = flow.walk_inputs(fdr, river)
    times = {
        "stencil": (
            median_ms(lambda: st.stencil(dem_f, fac, 12.5, 0.1)),
            median_ms(lambda: st.stencil_plain(dem_f, fac, 12.5, 0.1)),
        ),
        "downslope_walk": (
            median_ms(lambda: walk.downslope_walk(*d_ops, 5.0, 5000)),
            median_ms(lambda: down.jacobi_walk(*d_ops, 5.0, 5000)),
        ),
        "flow_walk": (
            median_ms(lambda: walk.flow_walk(*f_ops, 20000)),
            median_ms(lambda: flow.doubling_walk(*f_ops, 20000)),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"time {name:<15} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    pk, _ = walk.downslope_walk(*d_ops, 5.0, 5000)
    _, a, b = walk.flow_walk(*f_ops, 20000)
    for name, steps in (("downslope", (pk & 0xFFFF) + (pk >> 16)), ("flow", a + b)):
        print(f"basin {name} walk steps: mean {float(steps.float().mean()):.3f}, max {int(steps.max())}")
    # The synthetic basin's walks are short; time both walks where every
    # cell walks far, at the same shape.
    dem_n, fdr_n = tall_north(ROWS, COLS, None)
    dn = down.walk_inputs(torch.as_tensor(dem_n, device=dev), torch.as_tensor(fdr_n, device=dev), 12.5)
    fdr_l, river_l = lateral_channel(ROWS, COLS)
    fl = flow.walk_inputs(torch.as_tensor(fdr_l, device=dev), torch.as_tensor(river_l, device=dev))
    long_walks = {
        "downslope_walk, tall north (100-step walks), ed 50": (
            median_ms(lambda: walk.downslope_walk(*dn, 50.0, 5000)),
            median_ms(lambda: down.jacobi_walk(*dn, 50.0, 5000)),
        ),
        f"flow_walk, lateral channel (walks of up to {ROWS + COLS - 2} steps)": (
            median_ms(lambda: walk.flow_walk(*fl, 20000)),
            median_ms(lambda: flow.doubling_walk(*fl, 20000)),
        ),
    }
    for name, (ms, plain_ms) in long_walks.items():
        print(f"time {name} {ROWS}x{COLS}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
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
    return times


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    card = card_line()
    basin = basin_inputs()
    errs = dict.fromkeys(KERNELS, 0.0)
    phase_kernels(dev, basin, errs)
    inputs, launches = phase_slice(dev, basin)
    times = phase_timing(dev, inputs, card)
    kernels = [
        dict(name=name, route="cuda", **meta, launches=launches[name],
             max_abs_err=errs[name], ms=times[name][0], plain_ms=times[name][1])
        for name, meta in KERNELS.items()
    ]
    print(card)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
