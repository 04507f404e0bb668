"""Plain flood-map calibration and classification (descriptools'
evaluation.py, as Example/example.py:106-147 runs it).

HAND is scaled to [0, 1] between its second-smallest distinct value and
its largest (NoData becomes NaN); a threshold search keeps the threshold
of the best Fit, ``TP / (TP + FN + FP)``, in four stages of its own
strictness; the class map is ``prediction + benchmark`` with the
benchmark's 1 as 2 and NoData as 0 (0 TN, 1 FP, 2 FN, 3 TP).  Cells equal
to the scaled raster's corner are NoData to the prediction (a quirk of
descriptools).  Computed in ``dtype``: float64, as descriptools computes
it, or a lower precision for the control.
"""

import torch

from benchmark.reference.terrain import NODATA


class Classifier:
    """The scaled HAND and the normalised benchmark of one raster."""

    def __init__(self, hand, flood, dtype=torch.float64):
        vals = torch.unique(hand)
        mn, mx = vals[1].to(dtype), vals[-1].to(dtype)
        desc = torch.where(hand == NODATA, torch.nan, hand.to(dtype))
        desc = (desc - mn) / (mx - mn)
        self.masked = torch.where(desc == desc[0, 0], torch.nan, desc)
        self.nan = torch.isnan(self.masked)
        f = flood.to(torch.int64)
        f = torch.where(f == 1, 2, f)
        self.bench = torch.where(f == NODATA, 0, f)
        self.dtype = dtype

    def result(self, th):
        """prediction + benchmark at threshold ``th`` (the under rule)."""
        hit = self.masked <= torch.tensor(th, dtype=self.dtype, device=self.masked.device)
        return (hit & ~self.nan).to(torch.int64) + self.bench

    def scores(self, th):
        """(correctness, fit) at ``th``."""
        count = torch.bincount(self.result(th).reshape(-1), minlength=4).tolist()
        return count[3] / (count[2] + count[3]), count[3] / (count[3] + count[2] + count[1])


def calibrate(clf):
    """The threshold of the four-stage search (descriptools' evaluation.py)."""

    def fit_at(th):
        return clf.scores(th)[1]

    f1, f2, f3 = fit_at(0.25), fit_at(0.50), fit_at(0.75)
    if f3 > f2:
        fit_index, value = (f3, 75) if f3 > f1 else (f1, 25)
    else:
        fit_index, value = (f2, 50) if f2 > f1 else (f1, 25)
    threshold = None
    for i in range(value - 20, value + 30, 10):
        f = fit_at(i / 100)
        if f >= fit_index:
            fit_index, threshold = f, i
    value = threshold
    for i in range(value - 5, value + 6):
        f = fit_at(i / 100)
        if f > fit_index:
            fit_index, threshold = f, i
    for scale in (1000, 10000):
        value = threshold * 10
        threshold = value
        for i in range(value - 10, value + 11):
            f = fit_at(i / scale)
            if f > fit_index:
                fit_index, threshold = f, i
    return threshold / 10000


def classify_flood(hand, flood, dtype=torch.float64):
    """(threshold, correctness, fit, class map uint8)."""
    clf = Classifier(hand, flood, dtype)
    th = calibrate(clf)
    correctness, fit = clf.scores(th)
    return th, correctness, fit, clf.result(th).to(torch.uint8)
