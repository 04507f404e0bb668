"""Flood-map threshold calibration.

Counterpart of ``descriptools_tpu/evaluation.py``, numpy backend only: the
float64 oracle is bit-identical to the reference arithmetic, and the
calibrated threshold must match the JAX package's exactly.
"""

import numpy as np

from descriptools_tpu_torch import oracle


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


def calibration(desc, bench, under="under", backend="numpy"):
    """Coarse-to-fine threshold search maximising Fit (float64 numpy)."""
    if backend != "numpy":
        raise ValueError(f"unsupported calibration backend {backend!r}")
    return oracle.calibration_oracle(np.asarray(desc), np.asarray(bench), under)
