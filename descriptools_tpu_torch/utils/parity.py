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

The same script writes ``tests/data/long_drainage_reference.npz``: the JAX
suite on terrain-derived rivers whose walks run hundreds of steps
(:func:`long_drainage_inputs` makes the same inputs with the port).  There
JAX's fdist (the xla engine's hybrid: a right fold for the cells its
frontier sweeps resolve, a doubling order for the residue it leaves) and
the port's two fdist orders part by more than fdist's tolerance, and
:func:`check` takes the port's order (``fdist_order``):

- ``"count"`` (the count engines, ``a c_card + b c_diag``): each sampled
  cell within ``count_bound``, atol + (rtol + steps 2^-24) |w|, with
  ``steps`` the cell's walk length and fdist's rtol and atol.  Any order
  of summing ``steps`` positive f32 step lengths lies within
  (steps - 1) 2^-24 |w| of the exact sum, to first order, and the count
  form within 2 2^-24 |w|, so the two differ by at most
  (steps + 1) 2^-24 |w|; rtol = 1e-6 (16.8 x 2^-24) covers the rest.
  The sums within rtol sum(|w|) + 2^-24 sum(steps |w|) + atol N;
- ``"fold"`` (the fold engines, the right fold): fdist bitwise the
  reference's ``fdist_fold`` (the right fold of JAX's frontier sweeps run
  to the end) at the sampled cells, in its counts and in its sums; and,
  as a measure of the departure, within ``count_bound`` of the suite's.
"""

import hashlib

import numpy as np
import torch

from descriptools_tpu_torch.constants import DOWNSLOPE_MAX_STEPS, FLOW_MAX_STEPS, NODATA

INPUTS = ("dem", "fdr", "river", "fac", "flood")
HASHED = ("indices", "hand", "downslope", "class_map")
FLOATS = ("slope", "fdist", "slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
TRANSCENDENTAL = dict(rtol=2e-5, atol=1e-4)
TOLERANCES = dict(
    slope=dict(rtol=1e-6, atol=0.0),
    fdist=dict(rtol=1e-6, atol=1e-4),
    **{k: TRANSCENDENTAL for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")},
)
UNIT_ROUNDOFF = 2.0 ** -24  # float32's
FDIST_ORDERS = ("count", "fold")
# The long-drainage set's names (make_north_star_reference.py).
PARAMS = ("smooth", "amp", "river_fac", "elevation_difference", "flood_quantile")
WALKS = ("valid", "landed", "flow_steps_sum", "flow_steps_max", "flow_over_64",
         "downslope_steps_sum", "downslope_steps_max")


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


def count_bound(want, steps, rtol=TOLERANCES["fdist"]["rtol"], atol=TOLERANCES["fdist"]["atol"]):
    """The largest |got - want| a count engine's fdist may show against an
    fdist summed in another order: atol + (rtol + steps 2^-24) |want|."""
    want = np.abs(np.asarray(want, np.float64))
    return atol + (rtol + np.asarray(steps, np.float64) * UNIT_ROUNDOFF) * want


def params(ref, rows, cols):
    """The long-drainage set's generator and config parameters at one size."""
    return dict(zip(PARAMS, (float(v) for v in ref[f"{rows}x{cols}.params"])))


def walks(ref, rows, cols):
    """The long-drainage set's walk statistics at one size (ints)."""
    return dict(zip(WALKS, (int(v) for v in ref[f"{rows}x{cols}.walks"])))


def long_drainage_inputs(ref, rows, cols, device):
    """The long-drainage set's inputs, made by the port: dem =
    ``synthetic_dem(rows, cols, seed, smooth, amp)`` as int32 on the host;
    fdr and fac by ``ops.terrain.derive_terrain`` on ``device``; river =
    ``(fac > T) & (dem != -100)``; the flood map 1 at the valid cells at or
    below the ``flood_quantile`` of the valid elevations, 0 at the other
    valid cells, -100 at NoData.  Returns ({name: numpy raster}, the
    suite's (dem, fdr, fac, river) tensors on ``device``)."""
    from descriptools_tpu_torch.ops.terrain import derive_terrain
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    p = params(ref, rows, cols)
    dem = synthetic_dem(rows, cols, seed=int(ref["meta.seed"]), smooth=int(p["smooth"]),
                        amp=p["amp"]).astype(np.int32)
    dem_t = torch.as_tensor(dem, device=device)
    fdr, fac = derive_terrain(dem_t)
    river = ((fac > int(p["river_fac"])) & (dem_t != NODATA)).to(torch.int8)
    valid = dem != NODATA
    q = np.quantile(dem[valid], p["flood_quantile"])
    flood = np.where(valid, (dem <= q).astype(np.int32), np.int32(NODATA))
    arrays = dict(dem=dem, fdr=fdr.cpu().numpy(), river=river.cpu().numpy(), fac=fac.cpu().numpy(), flood=flood)
    return arrays, (dem_t, fdr, fac, river)


def walk_stats(dem, fdr, river, elevation_difference, px=12.5, flow_max_steps=FLOW_MAX_STEPS,
               downslope_max_steps=DOWNSLOPE_MAX_STEPS):
    """The walk statistics of ``WALKS`` (ints) from the port's plain
    engines on the tensors' device: the flow walk's steps
    (``ops.flow.doubling_walk``) over the landed cells, the downslope
    walk's (``ops.downslope.jacobi_walk``) over the valid cells."""
    from descriptools_tpu_torch.ops import flow
    from descriptools_tpu_torch.ops.downslope import jacobi_walk
    from descriptools_tpu_torch.ops.downslope import walk_inputs as downslope_inputs

    code, a, b = flow.doubling_walk(*flow.walk_inputs(fdr, river), flow_max_steps)
    landed = code >= 0
    steps = torch.where(landed, a + b, 0).long()
    pk, _ = jacobi_walk(*downslope_inputs(dem.to(torch.float32), fdr, px), elevation_difference,
                        downslope_max_steps)
    d_steps = ((pk & 0xFFFF) + (pk >> 16)).long()
    valid = dem != NODATA
    got = dict(valid=valid.sum(), landed=landed.sum(), flow_steps_sum=steps.sum(), flow_steps_max=steps.max(),
               flow_over_64=(steps > 64).sum(), downslope_steps_sum=d_steps[valid].sum(),
               downslope_steps_max=d_steps.max())
    return {k: int(got[k]) for k in WALKS}


def _fdist_against(ref, tag, flat, fdist_order, tol, bad):
    """fdist held to a long-drainage set in ``fdist_order``: (largest
    |got - want| at the sampled cells against the suite's fdist, its
    largest share of ``count_bound``, the sampled cells beyond fdist's
    tolerance, the sums' relative difference and share of their bound)."""
    err, used, beyond = 0.0, 0.0, 0
    for where in ("all", "landed"):
        p = ref[f"{tag}.pos.{where}"]
        g, w = flat[p], ref[f"{tag}.fdist.at.{where}"]
        if fdist_order == "fold":
            wf = ref[f"{tag}.fdist_fold.at.{where}"]
            if not np.array_equal(g, wf, equal_nan=True):
                bad.append(f"fdist: {int((g != wf).sum())} of {g.size} sampled cells ({where}) differ from "
                           "the right fold (fdist_fold)")
        fin = np.isfinite(g) & np.isfinite(w)
        diff = np.abs(g[fin].astype(np.float64) - w[fin].astype(np.float64))
        bound = count_bound(w[fin], ref[f"{tag}.steps.at.{where}"][fin], **tol)
        out = (diff > bound).sum()
        if out or not np.array_equal(np.isfinite(g), np.isfinite(w)):
            bad.append(f"fdist: {int(out)} of {g.size} sampled cells ({where}) beyond count_bound")
        if diff.size:
            err, used = max(err, float(diff.max())), max(used, float((diff / bound).max()))
            beyond += int((~_close(g[fin], w[fin], **tol)).sum())
    counts, sums = float_summary(flat)
    want_counts, want_sums = ref[f"{tag}.fdist.counts"], ref[f"{tag}.fdist.sums"]
    if not np.array_equal(counts, want_counts):
        bad.append(f"fdist: counts of -100, NaN, +inf, -inf, rest {counts.tolist()} vs {want_counts.tolist()}")
    if fdist_order == "fold":
        fc, fs = ref[f"{tag}.fdist_fold.counts"], ref[f"{tag}.fdist_fold.sums"]
        if not (np.array_equal(counts, fc) and np.array_equal(sums, fs)):
            bad.append(f"fdist: counts {counts.tolist()} and sums {sums.tolist()} vs the right fold's "
                       f"{fc.tolist()}, {fs.tolist()}")
    bound = (tol["rtol"] * want_sums[1] + UNIT_ROUNDOFF * float(ref[f"{tag}.fdist.steps_abs_sum"])
             + tol["atol"] * want_counts[4])
    diff = np.abs(sums - want_sums)
    if not (diff <= bound).all():
        bad.append(f"fdist: sums {sums.tolist()} vs {want_sums.tolist()} beyond {bound}")
    return dict(max_abs_err=err, bound_used=used, beyond_tolerance=beyond,
                sum_rel_diff=float(diff[0] / max(abs(want_sums[0]), 1e-300)),
                sum_bound_used=float(diff.max() / bound) if bound else float(diff.max()))


def check(ref, rows, cols, inputs, out, classified, fdist_order=None):
    """Hold one size's results to the reference.

    ``inputs``: numpy rasters dem, fdr, river, fac, flood; ``out``: the
    suite's rasters as numpy; ``classified``: (threshold, correctness, fit,
    class_map).  ``fdist_order`` (the long-drainage set only): "count" or
    "fold", the order the suite's engine sums fdist in (see the module's
    docstring); None holds fdist to its tolerance.  Returns, per float
    raster, the largest |got - want| at the sampled cells and the relative
    difference of the sums (for fdist in an order, also ``bound_used``, the
    largest share of ``count_bound``, and ``beyond_tolerance``, the sampled
    cells beyond fdist's tolerance); raises AssertionError naming every
    item that disagrees."""
    tag = f"{rows}x{cols}"
    if f"{tag}.shape" not in ref:
        raise KeyError(f"the reference holds no {tag} entry")
    if fdist_order not in (None, *FDIST_ORDERS):
        raise ValueError(f"fdist_order must be None or one of {FDIST_ORDERS}, got {fdist_order!r}")
    if fdist_order is not None and f"{tag}.fdist_fold.counts" not in ref:
        raise KeyError(f"{tag}: fdist_order needs the long-drainage set's fdist_fold and steps")
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
        if k == "fdist" and fdist_order is not None:
            report[k] = _fdist_against(ref, tag, flat, fdist_order, tol, bad)
            continue
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
