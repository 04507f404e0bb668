#!/usr/bin/env python3
"""Drive the PyTorch port (descriptools_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of the repository

Phases, each printing its own lines:

0. device and toolchain: the card (name and power limit from nvidia-smi),
   torch and CUDA versions, nvcc, and the build of ``csrc/*.cu``;
1. every CUDA kernel against its plain PyTorch version on the card, at the
   basin's shape (2178x1534, synthetic) and on adversarial fixtures
   (long northward walks, with and without ascending bumps; a lateral
   channel; a 40000-step serpentine, under and over the cap; 2-cell
   cycles; NaN absorbers); the tiled path's kernels on tile operands
   (basin windows and tiles, a lateral channel cut into tiles, a flat
   eastward walk and a ramp cut by a window edge);
2. the in-core path: ``descriptor_suite`` on CUDA tensors (the kernels
   run), then ``classify_flood``, held against the ``engine="torch"`` run
   on the same card, with every kernel's launch count checked;
3. timing: the suite and each kernel beside its plain version, median of 5
   runs after one warm-up, with CUDA events;
4. the out-of-core path: ``tiled_suite`` at 8192x8192 in 4096x4096 tiles
   through the tile kernels, held against the in-core suite of the same
   grid; a forced truncation retry; ``tiled_classify_flood`` against
   ``classify_flood``; pass times, host<->device bytes and the tile
   kernels against their plain versions on one 4096x4096 tile's operands,
   checked and timed;
5. the large-grid entry point: ``descriptor_suite(engine="cuda_blocked")``
   at the basin's shape against ``engine="torch_blocked"``; then
   ``run_suite_checkpointed(engine="cuda_blocked")`` at 8192x8192 (phase
   4's in-core inputs), killed inside its flow stage and resumed, held
   bitwise against an uninterrupted ``descriptor_suite`` of the same grid,
   with stage seconds, checkpoint bytes and peak device memory; the fold
   kernel against its plain version there, checked and timed.

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
}
IN_CORE = ("stencil", "downslope_walk", "flow_walk")
TILED = ("stencil_padded", "absorbing_walk", "downslope_walk_tracked")
BLOCKED = ("stencil", "downslope_walk", "flow_walk_blocked")  # engine="cuda_blocked"
BITWISE = ("indices", "hand", "downslope", "slope", "fdist")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
BIG = 8192  # the tiled phase's grid side: 67,108,864 cells
TILE = 4096  # the JAX package's default tile side


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

    def fold_case(label, fdr, river, max_steps):
        fdr_eff, code0 = flow.walk_inputs(torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev))
        consts = flow.step_consts(12.5)
        got = walk.flow_walk_blocked(fdr_eff, code0, *consts, max_steps)
        rounds = walk.flow_walk_blocked.rounds
        want = flow.fold_walk(fdr_eff, code0, *consts, max_steps)
        e = 0.0
        for name, g, w in zip(("code", "dist"), got, want):
            e = max(e, check_bitwise(f"fold/{label}/{name}", g, w))
        fd, idx = flow.flow_from_fold(*got)
        for name, g, w in zip(("fdist", "indices"), (fd, idx), flow.flow_from_fold(*want)):
            e = max(e, check_bitwise(f"fold/{label}/{name}", g, w))
        counts = flow.flow_from_state(*walk.flow_walk(fdr_eff, code0, max_steps), 12.5, max_steps)
        check_bitwise(f"fold/{label}/indices vs flow_walk", idx, counts[1])
        errs["flow_walk_blocked"] = max(errs["flow_walk_blocked"], e)
        landed = int((idx != -100).sum())
        print(f"kernel flow_walk_blocked {label:<30} matches plain bitwise (code, dist, fdist, indices; "
              f"indices = flow_walk's); {rounds} launches, {landed} of {idx.numel()} landed, "
              f"fdist differs from counts on {int((fd != counts[0]).sum())} cells")

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
    fold_case(f"basin {ROWS}x{COLS}", basin["fdr"], basin["river"], 20000)
    fold_case(f"lateral channel {ROWS}x{COLS}", *lateral_channel(ROWS, COLS), 20000)
    fold_case("serpentine 200x200, cap 60000", *serpentine(), 60000)
    fold_case("serpentine 200x200, cap 20000", *serpentine(), 20000)
    fold_case("2-cell cycles 512x640", *two_cell_cycles(), 20000)
    fold_case("NaN absorbers 1000x1200", *nan_absorbers(), 20000)
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
    return inputs, launches, out["hand"], got


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
    consts = flow.step_consts(12.5)
    fold = {
        "flow_walk_blocked, basin": f_ops,
        f"flow_walk_blocked, lateral channel (walks of up to {ROWS + COLS - 2} steps)": fl,
    }
    for name, ops in fold.items():
        ms = median_ms(lambda: walk.flow_walk_blocked(*ops, *consts, 20000))
        long_walks[f"{name} ({walk.flow_walk_blocked.rounds} launches)"] = (
            ms, median_ms(lambda: flow.fold_walk(*ops, *consts, 20000)))
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


def phase_tile_kernels(dev, basin, errs):
    """The tiled path's kernels against their plain versions, bitwise."""
    from descriptools_tpu_torch.ops import downslope as down
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.cuda import stencil as st
    from descriptools_tpu_torch.ops.cuda import walk
    from descriptools_tpu_torch.parallel import boundary

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
        d = torch.as_tensor(np.asarray(dem, np.float32), device=dev).contiguous()
        f = torch.as_tensor(np.asarray(fdr), device=dev).contiguous()
        tr0 = down.trunc_cells(d, f, *origin, *grid)
        ops = down.walk_inputs(d, f, 12.5)
        got = walk.downslope_walk_tracked(*ops, ed, max_steps, tr0)
        want = down.jacobi_walk(*ops, ed, max_steps, tr0)
        for name, g, wnt in zip(("pk", "Zt", "trunc"), got, want):
            check_bitwise(f"tracked/{label}/{name}", g, wnt)
        e = check_bitwise(
            f"tracked/{label}/downslope",
            down.downslope_from_state(ops[1], got[0], got[1], 12.5),
            down.downslope_from_state(ops[1], want[0], want[1], 12.5),
        )
        errs["downslope_walk_tracked"] = max(errs["downslope_walk_tracked"], e)
        flagged = int(got[2].sum())
        if must_fire and flagged == 0:
            raise AssertionError(f"tracked/{label}: no truncation flag fired")
        print(f"kernel downslope_walk_tracked {label:<30} matches plain bitwise (pk, Zt, trunc, downslope); "
              f"{flagged} flagged")

    for bump in (None, 40):
        dem, fdr = flat_east(512, 2048, bump)
        tracked_case(f"flat east 512x2048 bump={bump}", dem, fdr, (0, 0), (512, 4 * 2048), 5.0, 5000, True)
    tracked_case("basin window 1024x1024", basin["dem"][300:1324, 200:1224], basin["fdr"][300:1324, 200:1224],
                 (300, 200), (ROWS, COLS), 5.0, 5000, True)
    dem, fdr = tall_north(ROWS, COLS, 37)
    tracked_case("tall north rows 1000-1512", dem[1000:1512], fdr[1000:1512], (1000, 0), (ROWS, COLS),
                 50.0, 5000, True)
    torch.cuda.synchronize()


def phase_tiled(dev, card, classified_small, hand_small, basin, errs):
    """The out-of-core path at full size, a forced retry, the streaming
    calibration; pass times, link bytes, and the tile kernels against their
    plain versions on one tile's operands, checked and timed."""
    from descriptools_tpu_torch import pipeline, tiled
    from descriptools_tpu_torch.ops import downslope as down
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
    full = {k: loaders[k](0, BIG, 0, BIG) for k in ("dem", "fdr", "fac", "river")}
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
    tr0 = down.trunc_cells(d_ext, f_ext, lo - halo, lo - halo, BIG, BIG)
    d_ops = down.walk_inputs(d_ext, f_ext, cfg.px)
    ed, down_steps, flow_steps = cfg.elevation_difference, cfg.downslope_max_steps, cfg.flow_max_steps
    pairs = {
        "stencil_padded": (
            lambda: st.stencil_padded(padded, fac_t, cfg.px, cfg.n_topo),
            lambda: st.stencil_padded_plain(padded, fac_t, cfg.px, cfg.n_topo),
            ("slope", "slope_rad", "twi", "mod_twi"),
        ),
        "absorbing_walk": (
            lambda: walk.absorbing_walk(*loc, flow_steps),
            lambda: flow.doubling_walk(*loc, flow_steps),
            ("code", "a", "b"),
        ),
        "downslope_walk_tracked": (
            lambda: walk.downslope_walk_tracked(*d_ops, ed, down_steps, tr0),
            lambda: down.jacobi_walk(*d_ops, ed, down_steps, tr0),
            ("pk", "Zt", "trunc"),
        ),
    }
    for kernel, (fn, plain, names) in pairs.items():
        e = 0.0
        for name, g, w in zip(names, fn(), plain()):
            check = check_close if name in ("slope_rad", "twi", "mod_twi") else check_bitwise
            e = max(e, check(f"tile {TILE}x{TILE}/{kernel}/{name}", g, w))
        errs[kernel] = max(errs[kernel], e)
        print(f"kernel {kernel:<22} one {TILE}x{TILE} tile's operands: matches plain "
              f"({', '.join(names)}; max_abs_err {e:.3g})")
    times = {kernel: (median_ms(fn), median_ms(plain)) for kernel, (fn, plain, _) in pairs.items()}
    for name, (ms, plain_ms) in times.items():
        print(f"time {name:<22} one {TILE}x{TILE} tile: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    del pairs, inputs, dem, fdr, fac, river, dem_f, padded, loc, d_ext, f_ext, tr0, d_ops
    torch.cuda.empty_cache()

    # Streaming calibration at full size (host numpy), alone.
    t0 = time.perf_counter()
    th, corr, fit, cmap = tiled.tiled_classify_flood(out["hand"], loaders["flood"], (BIG, BIG),
                                                     tile_rows=TILE, tile_cols=TILE)
    big_classify_s = time.perf_counter() - t0
    if not (np.isfinite(fit) and cmap.shape == (BIG, BIG)):
        raise AssertionError(f"tiled_classify_flood {BIG}x{BIG}: Fit {fit}, map {cmap.shape}")
    print(f"tiled_classify_flood {BIG}x{BIG}: threshold {th} Fit {fit!r} Correctness {corr!r}; "
          f"host time {big_classify_s:.3f} s  [{card}]")
    del out

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
    return launches, times, full


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
    ms = median_ms(lambda: walk.flow_walk_blocked(*ops, *consts, 20000))
    rounds = walk.flow_walk_blocked.rounds
    plain_ms = median_ms(lambda: flow.fold_walk(*ops, *consts, 20000))
    print(f"time flow_walk_blocked {BIG}x{BIG} ({rounds} launches): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
          f"matches plain bitwise (code, dist)  [{card}]")
    del ops, inputs
    torch.cuda.empty_cache()
    return launches, {"flow_walk_blocked": (ms, plain_ms)}


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    card = card_line()
    basin = basin_inputs()
    errs = dict.fromkeys(KERNELS, 0.0)
    phase_kernels(dev, basin, errs)
    phase_tile_kernels(dev, basin, errs)
    inputs, launches, hand_small, classified = phase_slice(dev, basin)
    times = phase_timing(dev, inputs, card)
    del inputs
    tiled_launches, tiled_times, full = phase_tiled(dev, card, classified, hand_small, basin, errs)
    launches.update({k: tiled_launches[k] for k in TILED})
    times.update(tiled_times)
    blocked_launches, blocked_times = phase_checkpointed(dev, card, basin, full, errs)
    launches["flow_walk_blocked"] = blocked_launches["flow_walk_blocked"]
    times.update(blocked_times)
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
