"""NumPy oracle for the flood-map classifier (reference evaluation.py).

Float64 throughout, matching the reference's NumPy arithmetic so the
committed golden classified map is bitwise reproducible.
"""

import numpy as np

from descriptools_tpu_torch.constants import NODATA


def min_max_scale_oracle(mat, mn, mx, nodata=NODATA):
    """Normalise to [0,1]; nodata -> NaN.  Spec: evaluation.py:5-9."""
    mat = np.asarray(mat, dtype=np.float64)
    scaled = np.where(mat == nodata, np.nan, mat)
    return (scaled - mn) / (mx - mn)


def binary_map_oracle(desc, threshold, under):
    """Threshold the descriptor into a binary flood map.

    Spec: evaluation.py:90-123 — cells equal to desc[0,0] are treated as
    NoData (a quirk; on already-scaled input desc[0,0] is NaN and the equality
    never fires, but NaN cells still classify as 0 via the isnan branch).
    """
    desc = np.asarray(desc, dtype=np.float64)
    masked = np.where(desc == desc[0, 0], np.nan, desc)
    if under == "under":
        hit = masked <= threshold
    else:
        hit = masked >= threshold
    return np.where(np.isnan(masked), 0, np.where(hit, 1, 0)).astype(np.int64)


def _normalise_benchmark(bench):
    """Benchmark 1 -> 2, -100 -> 0 (evaluation.py:149-150), non-mutating.

    The reference mutates its input in place; because the mapping is
    idempotent on its own output ({0,2} fixed points), a pure transform is
    observably identical across repeated calls.
    """
    bench = np.asarray(bench)
    out = np.where(bench == 1, 2, bench)
    out = np.where(out == NODATA, 0, out)
    return out.astype(np.int64)


def confusion_oracle(pred_binary, bench):
    """(correctness, fit, result map).  Spec: evaluation.py:126-171.

    result = pred + normalised_bench encodes 0 TN / 1 FP / 2 FN / 3 TP.
    """
    result = np.asarray(pred_binary, dtype=np.int64) + _normalise_benchmark(bench)
    count = np.bincount(result.reshape(-1), minlength=4)
    return correctness_oracle(count), fit_oracle(count), result


def correctness_oracle(count):
    """TP/(FN+TP) — recall.  Spec: evaluation.py:174-191."""
    return count[3] / (count[2] + count[3])


def fit_oracle(count):
    """TP/(TP+FN+FP) — critical-success index.  Spec: evaluation.py:194-211."""
    return count[3] / (count[3] + count[2] + count[1])


def calibration_oracle(desc, bench, under):
    """Coarse-to-fine 1-D threshold search maximising Fit.

    Spec: evaluation.py:12-87, reproduced stage by stage with the exact
    iteration order and comparison strictness (>= in the first refinement,
    > afterwards) because ties select different thresholds otherwise.
    Returns threshold / 10000 like the reference.
    """

    def fit_at(th):
        _, f, _ = confusion_oracle(binary_map_oracle(desc, th, under), bench)
        return f

    f1 = fit_at(25 / 100)
    f2 = fit_at(50 / 100)
    f3 = fit_at(75 / 100)
    if f3 > f2:
        if f3 > f1:
            fit_index, iteration_value = f3, 75
        else:
            fit_index, iteration_value = f1, 25
    else:
        if f2 > f1:
            fit_index, iteration_value = f2, 50
        else:
            fit_index, iteration_value = f1, 25

    threshold = None
    for i in range(iteration_value - 20, iteration_value + 30, 10):
        f = fit_at(i / 100)
        if f >= fit_index:
            fit_index = f
            threshold = i

    iteration_value = threshold
    for i in range(iteration_value - 5, iteration_value + 6, 1):
        f = fit_at(i / 100)
        if f > fit_index:
            fit_index = f
            threshold = i

    iteration_value = threshold * 10
    threshold = iteration_value
    for i in range(iteration_value - 10, iteration_value + 11, 1):
        f = fit_at(i / 1000)
        if f > fit_index:
            fit_index = f
            threshold = i

    iteration_value = threshold * 10
    threshold = iteration_value
    for i in range(iteration_value - 10, iteration_value + 11, 1):
        f = fit_at(i / 10000)
        if f > fit_index:
            fit_index = f
            threshold = i

    return threshold / 10000
