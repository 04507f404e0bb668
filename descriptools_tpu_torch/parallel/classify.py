"""Exact integer cutoff of the float64 flood calibration (numpy).

Copy of ``descriptools_tpu/parallel/classify.py::_integer_cutoff``, held
bitwise to the original by the tests; the streaming calibration
(``tiled.tiled_classify_flood``) uses it.  The rest of that module (the
sharded classifier) waits for the multi-card layer.
"""

import numpy as np


def _integer_cutoff(th, mn, mx, under):
    """The integer h at which the float64 scaled predicate flips.

    under:  largest  h with fl64((h - mn)/(mx - mn)) <= th  (pred: h <= cut)
    else:   smallest h with fl64((h - mn)/(mx - mn)) >= th  (pred: h >= cut)

    fl64 is monotone non-decreasing in h, so ~32 host-side f64 evaluations
    bisect the range; comparing integer-valued f32 HAND against the integer
    cutoff is then EXACTLY the oracle's float64 comparison.
    """
    mn, mx, th = np.float64(mn), np.float64(mx), np.float64(th)
    lo, hi = int(np.floor(mn)) - 1, int(np.ceil(mx)) + 1

    def scaled(h):
        return (np.float64(h) - mn) / (mx - mn)

    if under == "under":
        # invariant: scaled(lo) <= th < scaled(hi)  (clamp degenerate ends)
        if scaled(lo) > th:
            return lo - 1  # predicate empty
        if scaled(hi) <= th:
            return hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if scaled(mid) <= th:
                lo = mid
            else:
                hi = mid
        return lo
    # 'over': smallest h with scaled(h) >= th
    if scaled(hi) < th:
        return hi + 1  # predicate empty
    if scaled(lo) >= th:
        return lo
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if scaled(mid) >= th:
            hi = mid
        else:
            lo = mid
    return hi
