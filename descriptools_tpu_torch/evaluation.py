"""Flood-map linear binary classifier: scaling, thresholding, Fit and
Correctness, and the coarse-to-fine threshold calibration (torch).

Counterpart of ``descriptools_tpu/evaluation.py``.  Two calibration
backends:
  - ``numpy`` (the default): float64, bit-identical to the reference
    arithmetic; the calibrated threshold matches the JAX package's exactly;
  - ``torch``: the counterpart of JAX's ``backend="jax"``, float32 on the
    device of ``desc``: each search stage's thresholds counted by
    ``batch_fit`` with integer sums and one float32 division each, so its
    Fit values, and its threshold, are JAX's bitwise.

The tensor functions mirror JAX's dtype rules: a Python threshold or
bound is rounded to float32 before it meets the raster, and every
division by a scalar divides by a 0-dim tensor on the raster's device (an
IEEE division; CUDA's ``div`` by a Python scalar multiplies by the
reciprocal).
"""

import numpy as np
import torch

from descriptools_tpu_torch import oracle
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.placement import check_device


def _scalar(value, like):
    """``value`` rounded to ``like``'s dtype, as a 0-dim tensor on its
    device, filled there (``torch.full``: the value is a launch argument;
    a copy from the host would wait on a card for every queued launch)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def min_max_scale(mat, mn, mx, nodata=NODATA):
    """Normalise to [0,1] in float32; nodata -> NaN.  Spec: evaluation.py:5-9.

    ``mx - mn`` is formed on the host, as JAX forms it, then rounded to
    float32."""
    mat = mat.to(torch.float32)
    scaled = torch.where(mat == nodata, float("nan"), mat)
    return (scaled - _scalar(mn, scaled)) / _scalar(mx - mn, scaled)


def binary_map(desc, threshold, under="under"):
    """Threshold a (scaled) descriptor into {0,1} int32.  Spec:
    evaluation.py:90-123.

    Cells equal to desc[0,0] (the reference's implicit NoData probe) and NaN
    cells classify as 0; ``threshold`` is rounded to desc's dtype first.
    """
    masked = torch.where(desc == desc[0, 0], float("nan"), desc)
    th = _scalar(threshold, masked)
    hit = masked <= th if under == "under" else masked >= th
    return (hit & ~torch.isnan(masked)).to(torch.int32)


def _normalise_benchmark(bench):
    bench = bench.to(torch.int32)
    out = torch.where(bench == 1, 2, bench)
    return torch.where(out == NODATA, 0, out)


def confusion(pred_binary, bench):
    """(correctness, fit, result map).  Spec: evaluation.py:126-171.

    The count is JAX's ``bincount(length=4)``: int32, negative results in
    bin 0, results above 3 dropped."""
    result = pred_binary.to(torch.int32) + _normalise_benchmark(bench)
    flat = result.reshape(-1).clamp(min=0)
    count = torch.bincount(flat[flat < 4], minlength=4).to(torch.int32)
    return correctness(count), fit(count), result


def correctness(count):
    """TP/(FN+TP).  Spec: evaluation.py:174-191."""
    return count[3] / (count[2] + count[3])


def fit(count):
    """TP/(TP+FN+FP).  Spec: evaluation.py:194-211."""
    return count[3] / (count[3] + count[2] + count[1])


def batch_fit(desc, bench, thresholds, under="under"):
    """Fit index (float32) for each of ``thresholds`` on desc's device.

    Per threshold, the true positives and the predicted cells are counted
    with integer sums, and Fit is ``tp / (tp + fn + fp)`` in float32
    (NaN when all three are 0), as JAX's vmapped ``batch_fit`` forms it.
    One threshold at a time: no (thresholds x cells) buffer."""
    desc = desc.to(torch.float32)
    masked = torch.where(desc == desc[0, 0], float("nan"), desc).reshape(-1)
    bench01 = (_normalise_benchmark(bench) == 2).reshape(-1)
    ths = torch.as_tensor(thresholds, dtype=torch.float32, device=desc.device).reshape(-1)
    flooded = bench01.sum()
    counts = []
    for k in range(ths.numel()):
        pred = masked <= ths[k] if under == "under" else masked >= ths[k]
        tp = (pred & bench01).sum()
        counts.append(torch.stack([tp, pred.sum() - tp, flooded - tp]))
    tp, fp, fn = torch.stack(counts).to(torch.int32).unbind(1)
    return tp / (tp + fn + fp)


def coarse_to_fine_search(fits_at):
    """Threshold-search loop shared by every calibration backend.

    ``fits_at(values, scale)`` evaluates Fit at the batch of thresholds
    ``v/scale`` and returns a float64 array.  Stage structure, iteration
    order and comparison strictness (>= in the first refinement, > after)
    replicate the reference exactly (evaluation.py:12-87 /
    oracle.calibration_oracle).
    """
    f1, f2, f3 = fits_at([25, 50, 75], 100)
    if f3 > f2:
        fit_index, iteration_value = (f3, 75) if f3 > f1 else (f1, 25)
    else:
        fit_index, iteration_value = (f2, 50) if f2 > f1 else (f1, 25)

    threshold = None
    grid = list(range(iteration_value - 20, iteration_value + 30, 10))
    for i, f in zip(grid, fits_at(grid, 100)):
        if f >= fit_index:
            fit_index, threshold = f, i

    grid = list(range(threshold - 5, threshold + 6, 1))
    for i, f in zip(grid, fits_at(grid, 100)):
        if f > fit_index:
            fit_index, threshold = f, i

    threshold *= 10
    grid = list(range(threshold - 10, threshold + 11, 1))
    for i, f in zip(grid, fits_at(grid, 1000)):
        if f > fit_index:
            fit_index, threshold = f, i

    threshold *= 10
    grid = list(range(threshold - 10, threshold + 11, 1))
    for i, f in zip(grid, fits_at(grid, 10000)):
        if f > fit_index:
            fit_index, threshold = f, i

    return threshold / 10000


def calibration(desc, bench, under="under", backend="numpy", *, device="cuda"):
    """Coarse-to-fine threshold search maximising Fit.

    ``backend="numpy"`` is float64-exact on the host; ``"torch"`` counts
    each stage's threshold batch with ``batch_fit`` in float32 on the
    device of ``desc``, one host read a stage.  A tensor ``desc`` stays
    where it is; numpy is moved to ``device`` (the card unless the caller
    asks for ``"cpu"``; raises where no CUDA device is available)."""
    if backend == "numpy":
        return oracle.calibration_oracle(np.asarray(desc), np.asarray(bench), under)
    if backend != "torch":
        raise ValueError(f"unsupported calibration backend {backend!r}")
    if not isinstance(desc, torch.Tensor):
        desc = torch.as_tensor(np.asarray(desc), device=check_device(device))
    bench = torch.as_tensor(bench, device=desc.device)

    def fits_at(values, scale):
        ths = torch.tensor([v / scale for v in values], dtype=torch.float32, device=desc.device)
        return batch_fit(desc, bench, ths, under=under).cpu().numpy().astype(np.float64)

    return coarse_to_fine_search(fits_at)
