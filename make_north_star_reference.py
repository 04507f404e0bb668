#!/usr/bin/env python3
"""Write the JAX package's results at the North star's sizes to
``tests/data/north_star_reference.npz``: the reference the PyTorch port is
held to at 2178x1534 and 4096x4096 (``chip_smoke.py`` on the card,
``tests/test_torch_north_star.py`` on the CPU).

    JAX_PLATFORMS=cpu python3 make_north_star_reference.py   # about 70 s

It runs the JAX package on the CPU only and imports nothing of the port.
For ``windowed_basin(rows, cols, seed=0)`` at each size it runs
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
"""

import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "tests", "data", "north_star_reference.npz")
SIZES = ((2178, 1534), (4096, 4096))
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
    rng = np.random.default_rng([rows, cols, SEED])
    landed = np.flatnonzero(out["indices"].reshape(-1) != NODATA)
    pos = {
        "all": np.sort(rng.choice(rows * cols, SAMPLES, replace=False)),
        "landed": np.sort(rng.choice(landed, SAMPLES, replace=False)),
    }
    for where, p in pos.items():
        ref[f"{tag}.pos.{where}"] = p.astype(np.int64)
    for k in FLOATS:
        flat = out[k].reshape(-1)
        for where, p in pos.items():
            ref[f"{tag}.{k}.at.{where}"] = flat[p]
        ref[f"{tag}.{k}.counts"], ref[f"{tag}.{k}.sums"] = float_summary(flat)
    return ref


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    ref = {
        "meta.seed": np.array(SEED, np.int64),
        "meta.samples": np.array(SAMPLES, np.int64),
        "meta.hashed": np.array([f"{k}:{np.dtype(v).name}" for k, v in HASHED.items()]),
        "meta.floats": np.array(FLOATS),
        "meta.sizes": np.array(SIZES, np.int64),
        "meta.jax": np.array(f"jax {jax.__version__}, numpy {np.__version__}, "
                             f"{jax.default_backend()} backend, PipelineConfig(engine='xla')"),
    }
    for rows, cols in SIZES:
        ref.update(reference(rows, cols))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **ref)
    print(f"wrote {os.path.relpath(OUT, ROOT)}: {os.path.getsize(OUT)} bytes, {len(ref)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
