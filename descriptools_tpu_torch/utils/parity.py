"""Hold the suite's results to a committed reference of the JAX package's.

``make_north_star_reference.py`` runs the JAX package (``descriptor_suite``
under ``PipelineConfig(engine="xla")``, then ``classify_flood``) on
``windowed_basin(rows, cols, seed=0)`` at the North star's sizes and keeps
a summary of its results in ``tests/data/north_star_reference.npz``;
:func:`check` holds another run's results to it:

- the input rasters, indices, HAND, downslope and the class map by the
  sha256 of their bytes in the dtypes the file names (``meta.hashed``);
- threshold, Correctness and Fit identical;
- each float raster at the file's sampled cells within its tolerance
  (``TOLERANCES``: those of ``tests/test_torch_pipeline.py``);
- the counts of -100, NaN, +inf and -inf cells exact;
- the float64 sum and sum of |x| of the other cells within the bound the
  per-cell tolerance implies: |sum(g) - sum(w)| <= rtol sum(|w|) + atol N.
"""

import hashlib

import numpy as np

from descriptools_tpu_torch.constants import NODATA

INPUTS = ("dem", "fdr", "river", "fac", "flood")
HASHED = ("indices", "hand", "downslope", "class_map")
FLOATS = ("slope", "fdist", "slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
TRANSCENDENTAL = dict(rtol=2e-5, atol=1e-4)
TOLERANCES = dict(
    slope=dict(rtol=1e-6, atol=0.0),
    fdist=dict(rtol=1e-6, atol=1e-4),
    **{k: TRANSCENDENTAL for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")},
)


def load(path):
    """The reference file as a dict of numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def sizes(ref):
    """The (rows, cols) the reference holds."""
    return [tuple(int(v) for v in s) for s in ref["meta.sizes"]]


def hash_dtypes(ref):
    return dict(s.split(":") for s in ref["meta.hashed"].tolist())


def sha256(a, dtype):
    """sha256 of ``a``'s C-order bytes as ``dtype``; raises where that cast
    changes a value."""
    a = np.asarray(a)
    c = a.astype(dtype)
    if not np.array_equal(c, a, equal_nan=a.dtype.kind == "f"):
        raise ValueError(f"{a.dtype} values change as {np.dtype(dtype)}")
    return hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest()


def float_summary(a):
    """(counts of -100, NaN, +inf, -inf and the other cells; the float64
    sum and sum of |x| of the other cells)."""
    a = np.asarray(a, np.float64).reshape(-1)
    nodata, nan = a == NODATA, np.isnan(a)
    pinf, ninf = a == np.inf, a == -np.inf
    rest = a[~(nodata | nan | pinf | ninf)]
    counts = np.array([nodata.sum(), nan.sum(), pinf.sum(), ninf.sum(), rest.size], np.int64)
    return counts, np.array([rest.sum(), np.abs(rest).sum()], np.float64)


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        ok = (np.abs(got - want) <= atol + rtol * np.abs(want)) | (got == want)
    return ok | (np.isnan(got) & np.isnan(want))


def check(ref, rows, cols, inputs, out, classified):
    """Hold one size's results to the reference.

    ``inputs``: numpy rasters dem, fdr, river, fac, flood; ``out``: the
    suite's rasters as numpy; ``classified``: (threshold, correctness, fit,
    class_map).  Returns, per float raster, the largest |got - want| at the
    sampled cells and the relative difference of the sums; raises
    AssertionError naming every item that disagrees."""
    tag = f"{rows}x{cols}"
    if f"{tag}.shape" not in ref:
        raise KeyError(f"the reference holds no {tag} entry")
    dtypes = hash_dtypes(ref)
    bad = []
    for k in INPUTS:
        if sha256(inputs[k], dtypes[k]) != str(ref[f"{tag}.sha256.{k}"]):
            bad.append(f"input {k}: sha256 differs (the generator drifted)")
    th, corr, fit, class_map = classified
    got_hashed = dict(indices=out["indices"], hand=out["hand"], downslope=out["downslope"],
                      class_map=class_map)
    for k, a in got_hashed.items():
        if tuple(np.shape(a)) != (rows, cols):
            bad.append(f"{k}: shape {np.shape(a)}")
        elif sha256(a, dtypes[k]) != str(ref[f"{tag}.sha256.{k}"]):
            bad.append(f"{k}: sha256 differs")
    want = ref[f"{tag}.classify"]
    got = np.array([th, corr, fit], np.float64)
    if not np.array_equal(got, want):
        bad.append(f"threshold, Correctness, Fit {got.tolist()} vs {want.tolist()}")
    report = {}
    for k in FLOATS:
        tol = TOLERANCES[k]
        flat = np.asarray(out[k]).reshape(-1)
        err = 0.0
        for where in ("all", "landed"):
            g, w = flat[ref[f"{tag}.pos.{where}"]], ref[f"{tag}.{k}.at.{where}"]
            ok = _close(g, w, **tol)
            if not ok.all():
                bad.append(f"{k}: {int((~ok).sum())} of {ok.size} sampled cells ({where}) outside {tol}")
            fin = np.isfinite(g) & np.isfinite(w)
            if fin.any():
                err = max(err, float(np.abs(g[fin].astype(np.float64) - w[fin].astype(np.float64)).max()))
        counts, sums = float_summary(flat)
        want_counts, want_sums = ref[f"{tag}.{k}.counts"], ref[f"{tag}.{k}.sums"]
        if not np.array_equal(counts, want_counts):
            bad.append(f"{k}: counts of -100, NaN, +inf, -inf, rest {counts.tolist()} vs {want_counts.tolist()}")
        bound = tol["rtol"] * want_sums[1] + tol["atol"] * want_counts[4]
        diff = np.abs(sums - want_sums)
        if not (diff <= bound).all():
            bad.append(f"{k}: sums {sums.tolist()} vs {want_sums.tolist()} beyond {bound}")
        report[k] = dict(max_abs_err=err, sum_rel_diff=float(diff[0] / max(abs(want_sums[0]), 1e-300)),
                         sum_bound_used=float(diff.max() / bound) if bound else float(diff.max()))
    if bad:
        raise AssertionError(f"{tag} against the JAX reference: " + "; ".join(bad))
    return report
