#!/usr/bin/env python3
"""Write the JAX package's results at the North star's sizes, the references
the PyTorch port is held to at 2178x1534 and 4096x4096 (``chip_smoke.py``
on the card, ``tests/test_torch_north_star.py`` and
``tests/test_torch_long_drainage.py`` on the CPU):

- ``tests/data/north_star_reference.npz``, on ``windowed_basin``, whose
  walks take a few steps;
- ``tests/data/long_drainage_reference.npz``, on terrain-derived rivers
  whose walks run hundreds of steps (``long_drainage_reference``).

    JAX_PLATFORMS=cpu python3 make_north_star_reference.py   # both sets
    JAX_PLATFORMS=cpu python3 make_north_star_reference.py --set long_drainage

It runs the JAX package on the CPU only and imports nothing of the port.

**The North star set.** For ``windowed_basin(rows, cols, seed=0)`` at each
size it runs
``descriptools_tpu.pipeline.descriptor_suite`` under
``PipelineConfig(engine="xla")`` (dem and fac as int32), then
``classify_flood`` on its HAND, and keeps, per size:

- the sha256 of each input raster and of indices, HAND, downslope and the
  class map, each hashed as C-order bytes of the dtype in ``HASHED``;
- threshold, Correctness and Fit (float64);
- for each float raster: its values at 2048 seeded cells of the grid and at
  2048 seeded cells with ``indices != -100`` (positions stored beside
  them); the exact counts of -100, NaN, +inf and -inf cells; the float64
  sum and sum of |x| over the other cells.

A few hundred KB, not the rasters.  Only a change of the JAX package or of
``utils.synthetic.windowed_basin`` should change the file.

**The long-drainage set.**  At each size of ``LONG_DRAINAGE``, with its
``smooth``, ``amp``, river threshold ``T`` and ``elevation_difference``:

- dem = ``synthetic_dem(rows, cols, seed=0, smooth, amp)`` as int32; fdr
  and fac from ``ops.terrain.derive_terrain(dem)``; river = ``(fac > T) &
  (dem != -100)`` (as ``Example/example.py:52`` forms it), int8;
- the flood map, a rule that does not read HAND: the valid cells at or
  below the 20th percentile of the valid elevations
  (``synthetic_basin``'s quantile rule), 1, the other valid cells 0, -100
  where the DEM is NoData (int32);
- ``descriptor_suite`` under ``PipelineConfig(engine="xla",
  elevation_difference=ED)``, then ``classify_flood``.

It keeps what the North star set keeps, and besides:

- ``fdist_fold``, fdist as the right fold of JAX's frontier sweeps: the
  xla engine's resolver (``ops.flow.resolve_absorbing_walk``) with a
  residue cap of 0, so that its sweeps resolve every walk.  The xla suite
  stops its sweeps once at most ``n // 8`` cells are unresolved
  (``ops/flow.py:149,331``) and resolves that residue by doubling, whose
  sums run in another order; ``fdist_fold`` is what a right fold gives;
- each landed cell's flow steps at the sampled cells (``steps.at.*``) and
  the float64 sum of steps x |fdist| over fdist's finite cells, which
  bound a count engine's fdist (``utils/parity.py`` in the port);
- the generator's and the config's parameters (``params``);
- the walk statistics (``walks``, integers, ``WALKS`` names them): valid
  and landed cells; the landed cells' flow steps (sum, max, cells over
  64); the valid cells' downslope steps (sum, max), counted by a numpy
  walk of the jacobi engine's stop rule (``downslope_steps``);
- how far ``fdist_fold`` lies from the suite's fdist over every cell
  (``fold_vs_suite``: cells that differ, cells beyond fdist's tolerance of
  rtol 1e-6, atol 1e-4, the largest difference and the largest relative
  one), the size of that departure.

It refuses to write a set whose walks fall under ``FLOORS``: flow steps
mean >= 80, max >= 1000, at least 10 % of the landed cells over 64 steps;
downslope mean >= 64; at least 80 % of the valid cells landed.
"""

import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "tests", "data", "north_star_reference.npz")
LONG_OUT = os.path.join(ROOT, "tests", "data", "long_drainage_reference.npz")
SIZES = ((2178, 1534), (4096, 4096))
# (rows, cols): (smooth, amp, river fac threshold T, elevation_difference).
# smooth stays under min(rows, cols): np.convolve(mode="same") changes
# length past it.
LONG_DRAINAGE = {(2178, 1534): (1023, 50000.0, 2000, 3000.0), (4096, 4096): (1023, 50000.0, 4000, 1500.0)}
PARAMS = ("smooth", "amp", "river_fac", "elevation_difference", "flood_quantile")
FLOOD_QUANTILE = 0.20
WALKS = ("valid", "landed", "flow_steps_sum", "flow_steps_max", "flow_over_64",
         "downslope_steps_sum", "downslope_steps_max")
# The fdist tolerance of tests/test_torch_pipeline.py (the port's utils/parity.py).
FDIST_TOLERANCE = dict(rtol=1e-6, atol=1e-4)
FOLD_VS_SUITE = ("cells_differing", "cells_beyond_tolerance", "max_abs_diff", "max_rel_diff")
FLOORS = dict(flow_mean=80, flow_max=1000, flow_over_64_share=0.10, downslope_mean=64, landed_share=0.80)
SEED = 0
SAMPLES = 2048
NODATA = -100
INPUTS = ("dem", "fdr", "river", "fac", "flood")
HASHED = dict(dem=np.int32, fdr=np.uint8, river=np.int8, fac=np.int32, flood=np.int32,
              indices=np.int32, hand=np.int32, downslope=np.float32, class_map=np.uint8)
FLOATS = ("slope", "fdist", "slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")


def sha256(name, a):
    a = np.asarray(a)
    c = a.astype(HASHED[name])
    if not np.array_equal(c, a, equal_nan=a.dtype.kind == "f"):
        raise ValueError(f"{name}: {a.dtype} values change as {np.dtype(HASHED[name])}")
    return hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest()


def float_summary(a):
    """(counts of -100, NaN, +inf, -inf and the rest; sum and sum of |x|
    of the rest, in float64)."""
    a = np.asarray(a, np.float64).reshape(-1)
    nodata, nan = a == NODATA, np.isnan(a)
    pinf, ninf = a == np.inf, a == -np.inf
    rest = a[~(nodata | nan | pinf | ninf)]
    counts = np.array([nodata.sum(), nan.sum(), pinf.sum(), ninf.sum(), rest.size], np.int64)
    return counts, np.array([rest.sum(), np.abs(rest).sum()], np.float64)


def reference(rows, cols):
    import jax.numpy as jnp

    from descriptools_tpu import pipeline
    from descriptools_tpu.utils.synthetic import windowed_basin

    tag = f"{rows}x{cols}"
    t0 = time.perf_counter()
    d = {k: f(0, rows, 0, cols) for k, f in windowed_basin(rows, cols, seed=SEED).items()}
    t1 = time.perf_counter()
    out = pipeline.descriptor_suite(
        jnp.asarray(d["dem"], jnp.int32), jnp.asarray(d["fdr"]),
        jnp.asarray(d["fac"], jnp.int32), jnp.asarray(d["river"]),
        pipeline.PipelineConfig(engine="xla"),
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    t2 = time.perf_counter()
    th, corr, fit, class_map = pipeline.classify_flood(out["hand"], d["flood"])
    t3 = time.perf_counter()
    print(f"{tag}: inputs {t1 - t0:.1f} s, suite {t2 - t1:.1f} s, classify {t3 - t2:.1f} s; "
          f"threshold {th} Correctness {corr!r} Fit {fit!r}", flush=True)

    ref = {f"{tag}.shape": np.array([rows, cols], np.int64)}
    for k in INPUTS:
        ref[f"{tag}.sha256.{k}"] = np.array(sha256(k, d[k]))
    for k in ("indices", "hand", "downslope"):
        ref[f"{tag}.sha256.{k}"] = np.array(sha256(k, out[k]))
    ref[f"{tag}.sha256.class_map"] = np.array(sha256("class_map", class_map))
    ref[f"{tag}.classify"] = np.array([th, corr, fit], np.float64)
    pos = sample_positions(ref, rows, cols, out["indices"])
    for k in FLOATS:
        summarise(ref, tag, k, out[k], pos)
    return ref


def sample_positions(ref, rows, cols, indices):
    """SAMPLES seeded cells of the grid and SAMPLES of its landed cells,
    kept in ``ref``."""
    tag = f"{rows}x{cols}"
    rng = np.random.default_rng([rows, cols, SEED])
    landed = np.flatnonzero(np.asarray(indices).reshape(-1) != NODATA)
    pos = {
        "all": np.sort(rng.choice(rows * cols, SAMPLES, replace=False)),
        "landed": np.sort(rng.choice(landed, SAMPLES, replace=False)),
    }
    for where, p in pos.items():
        ref[f"{tag}.pos.{where}"] = p.astype(np.int64)
    return pos


def summarise(ref, tag, k, a, pos):
    """A float raster's values at the sampled cells, counts and sums."""
    flat = np.asarray(a).reshape(-1)
    for where, p in pos.items():
        ref[f"{tag}.{k}.at.{where}"] = flat[p]
    ref[f"{tag}.{k}.counts"], ref[f"{tag}.{k}.sums"] = float_summary(flat)


def downslope_steps(dem, fdr, elevation_difference, max_steps):
    """Each cell's downslope walk length (int64), by the jacobi engine's
    stop rule (``ops/downslope.py:_downslope_jacobi``): a start that is a
    terminal (no valid step, a step off the grid or onto NoData, NoData
    itself) walks 0 steps; a walk stops at the first cell at or below its
    start's elevation less ``elevation_difference``, or at the first
    terminal, or after ``max_steps`` steps."""
    import jax.numpy as jnp

    from descriptools_tpu.d8 import successor

    rows, cols = dem.shape
    succ, _, in_bounds, valid = (np.asarray(t).reshape(-1) for t in successor(jnp.asarray(fdr), rows, cols))
    z = dem.astype(np.float32).reshape(-1)
    terminal = ~valid | ~in_bounds | (z[succ] == np.float32(NODATA)) | (z == np.float32(NODATA))
    zt = np.where(terminal, z - np.float32(1 << 20), z)
    thresh = z - np.float32(elevation_difference)
    live = np.flatnonzero(~(zt <= thresh))
    cur = live.copy()
    steps = np.zeros(z.size, np.int64)
    for _ in range(max_steps):
        if not live.size:
            break
        cur = succ[cur]
        steps[live] += 1
        go = ~(zt[cur] <= thresh[live])
        live, cur = live[go], cur[go]
    return steps.reshape(rows, cols)


def long_drainage_run(rows, cols, smooth, amp, river_fac, ed):
    """The JAX package on one long-drainage input (see the module's
    docstring): {"inputs": numpy dem, fdr, river, fac, flood; "out": the
    xla suite's rasters; "classified": classify_flood's (threshold,
    Correctness, Fit, class map); "fdist_fold": the right fold of the
    frontier sweeps; "steps": each landed cell's flow steps (0 elsewhere);
    "walks": the walk statistics; "seconds": each step's}."""
    import jax
    import jax.numpy as jnp

    from descriptools_tpu import pipeline
    from descriptools_tpu.constants import DOWNSLOPE_MAX_STEPS, FLOW_MAX_STEPS
    from descriptools_tpu.ops import flow
    from descriptools_tpu.ops.terrain import derive_terrain
    from descriptools_tpu.utils.synthetic import synthetic_dem

    t0 = time.perf_counter()
    dem = synthetic_dem(rows, cols, seed=SEED, smooth=smooth, amp=amp).astype(np.int32)
    fdr, fac = (np.asarray(a) for a in derive_terrain(jnp.asarray(dem)))
    valid = dem != NODATA
    river = ((fac > river_fac) & valid).astype(np.int8)
    q = np.quantile(dem[valid], FLOOD_QUANTILE)
    flood = np.where(valid, (dem <= q).astype(np.int32), np.int32(NODATA))
    t1 = time.perf_counter()
    cfg = pipeline.PipelineConfig(engine="xla", elevation_difference=ed)
    out = pipeline.descriptor_suite(jnp.asarray(dem), jnp.asarray(fdr), jnp.asarray(fac), jnp.asarray(river), cfg)
    out = {k: np.asarray(v) for k, v in out.items()}
    t2 = time.perf_counter()
    classified = pipeline.classify_flood(out["hand"], flood)

    @jax.jit
    def right_fold(fdr, river):
        succ, step, absorbing, _, is_river = flow.flow_states(fdr, river, rows, cols)
        stepd = jnp.where(absorbing, 0.0, step * jnp.float32(cfg.px))
        resolved, dist, steps, absorber, tag = flow.resolve_absorbing_walk(
            fdr, absorbing, stepd, succ, FLOW_MAX_STEPS, 0, tag0=is_river.astype(jnp.float32))
        landed = resolved & (tag > 0) & (steps <= FLOW_MAX_STEPS)
        return (jnp.where(landed, dist, jnp.float32(NODATA)).reshape(rows, cols),
                jnp.where(landed, absorber, NODATA).reshape(rows, cols),
                jnp.where(landed, steps, 0.0).astype(jnp.int32).reshape(rows, cols))

    fdist_fold, fold_indices, steps = (np.asarray(a) for a in right_fold(jnp.asarray(fdr), jnp.asarray(river)))
    if not np.array_equal(fold_indices, out["indices"]):
        raise AssertionError(f"{rows}x{cols}: the frontier sweeps' indices differ from the suite's")
    t3 = time.perf_counter()
    down = downslope_steps(dem, fdr, ed, DOWNSLOPE_MAX_STEPS)
    t4 = time.perf_counter()
    landed = out["indices"] != NODATA
    walks = dict(valid=int(valid.sum()), landed=int(landed.sum()), flow_steps_sum=int(steps[landed].sum()),
                 flow_steps_max=int(steps.max()), flow_over_64=int((steps > 64).sum()),
                 downslope_steps_sum=int(down[valid].sum()), downslope_steps_max=int(down.max()))
    return dict(inputs=dict(dem=dem, fdr=fdr, river=river, fac=fac, flood=flood), out=out, classified=classified,
                fdist_fold=fdist_fold, steps=steps, walks=walks,
                seconds=dict(inputs=t1 - t0, suite=t2 - t1, right_fold=t3 - t2, downslope_steps=t4 - t3))


def long_drainage_summary(rows, cols, params, run):
    """What the long-drainage set keeps of one ``long_drainage_run``, with
    its ``params`` (``PARAMS``' order)."""
    tag = f"{rows}x{cols}"
    out, steps, fdist_fold = run["out"], run["steps"], run["fdist_fold"]
    th, corr, fit, class_map = run["classified"]
    ref = {f"{tag}.shape": np.array([rows, cols], np.int64),
           f"{tag}.params": np.array(params, np.float64),
           f"{tag}.walks": np.array([run["walks"][k] for k in WALKS], np.int64)}
    for k in INPUTS:
        ref[f"{tag}.sha256.{k}"] = np.array(sha256(k, run["inputs"][k]))
    for k in ("indices", "hand", "downslope"):
        ref[f"{tag}.sha256.{k}"] = np.array(sha256(k, out[k]))
    ref[f"{tag}.sha256.class_map"] = np.array(sha256("class_map", class_map))
    ref[f"{tag}.classify"] = np.array([th, corr, fit], np.float64)
    pos = sample_positions(ref, rows, cols, out["indices"])
    for k in FLOATS:
        summarise(ref, tag, k, out[k], pos)
    summarise(ref, tag, "fdist_fold", fdist_fold, pos)
    for where, p in pos.items():
        ref[f"{tag}.steps.at.{where}"] = steps.reshape(-1)[p]
    fd = out["fdist"].astype(np.float64)
    rest = np.isfinite(fd) & (fd != NODATA)
    ref[f"{tag}.fdist.steps_abs_sum"] = np.array((steps[rest] * np.abs(fd[rest])).sum(), np.float64)
    diff = np.abs(fdist_fold.astype(np.float64)[rest] - fd[rest])
    beyond = diff > FDIST_TOLERANCE["atol"] + FDIST_TOLERANCE["rtol"] * np.abs(fd[rest])
    ref[f"{tag}.fold_vs_suite"] = np.array(
        [(diff > 0).sum(), beyond.sum(), diff.max(), (diff / np.maximum(np.abs(fd[rest]), 1.0)).max()], np.float64)
    return ref


def long_drainage_reference(rows, cols):
    """The long-drainage set at one size of ``LONG_DRAINAGE``; refuses
    walks under ``FLOORS``."""
    smooth, amp, river_fac, ed = LONG_DRAINAGE[(rows, cols)]
    tag = f"{rows}x{cols}"
    run = long_drainage_run(rows, cols, smooth, amp, river_fac, ed)
    stats = floor_terms(run["walks"])
    th, corr, fit, _ = run["classified"]
    secs = ", ".join(f"{k} {v:.1f} s" for k, v in run["seconds"].items())
    print(f"{tag} long drainage (smooth {smooth}, amp {amp}, T {river_fac}, ED {ed}): {secs}; max fac "
          f"{int(run['inputs']['fac'].max())}; threshold {th} Correctness {corr!r} Fit {fit!r}; "
          f"walks {run['walks']}; {stats}", flush=True)
    low = [k for k, floor in FLOORS.items() if not stats[k] >= floor]
    if low:
        raise AssertionError(f"{tag}: the walks fall under the floors {FLOORS}: {low} ({stats})")
    ref = long_drainage_summary(rows, cols, (smooth, amp, river_fac, ed, FLOOD_QUANTILE), run)
    print(f"{tag}: the right fold against the suite's fdist over every cell: "
          f"{dict(zip(FOLD_VS_SUITE, ref[f'{tag}.fold_vs_suite'].tolist()))}", flush=True)
    return ref


def floor_terms(walks):
    """The floors' terms from the integer walk statistics."""
    return dict(flow_mean=walks["flow_steps_sum"] / walks["landed"], flow_max=walks["flow_steps_max"],
                flow_over_64_share=walks["flow_over_64"] / walks["landed"],
                downslope_mean=walks["downslope_steps_sum"] / walks["valid"],
                landed_share=walks["landed"] / walks["valid"])


def meta(jax, extra):
    return {
        "meta.seed": np.array(SEED, np.int64),
        "meta.samples": np.array(SAMPLES, np.int64),
        "meta.hashed": np.array([f"{k}:{np.dtype(v).name}" for k, v in HASHED.items()]),
        "meta.floats": np.array(FLOATS),
        "meta.jax": np.array(f"jax {jax.__version__}, numpy {np.__version__}, "
                             f"{jax.default_backend()} backend, PipelineConfig(engine='xla'{extra})"),
    }


def write(path, ref):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **ref)
    print(f"wrote {os.path.relpath(path, ROOT)}: {os.path.getsize(path)} bytes, {len(ref)} arrays")


def main(argv=None):
    import jax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", choices=("all", "north_star", "long_drainage"), default="all",
                    help="which reference to write (default: both)")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    if args.set in ("all", "north_star"):
        ref = meta(jax, "")
        ref["meta.sizes"] = np.array(SIZES, np.int64)
        for rows, cols in SIZES:
            ref.update(reference(rows, cols))
        write(OUT, ref)
    if args.set in ("all", "long_drainage"):
        ref = meta(jax, ", elevation_difference=ED")
        ref["meta.sizes"] = np.array(list(LONG_DRAINAGE), np.int64)
        ref["meta.params"] = np.array(PARAMS)
        ref["meta.walks"] = np.array(WALKS)
        ref["meta.fold_vs_suite"] = np.array(FOLD_VS_SUITE)
        ref["meta.floors"] = np.array([f"{k}>={v}" for k, v in FLOORS.items()])
        for rows, cols in LONG_DRAINAGE:
            ref.update(long_drainage_reference(rows, cols))
        write(LONG_OUT, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
