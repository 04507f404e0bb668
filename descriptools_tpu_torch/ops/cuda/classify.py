"""The calibration's counting pass on the card.

Wrapper of ``csrc/classify.cu``: :func:`cutoff_count` counts, in one pass
over a HAND raster and its flood map, the valid cells that each of a
search stage's float32 cutoffs hits and the flooded ones among them, and
the flooded cells of the raster (``parallel.classify`` forms TP, FP and FN
from them).  No TPU kernel corresponds: the JAX package calibrates float
HAND on the host.  On a CUDA tensor it launches ``cutoff_count_kernel``;
on a CPU tensor it runs its plain version, :func:`cutoff_count_plain`
(``bucketize`` and a scatter-add of the joint bins), which gives the same
integers.
"""

import ctypes

import numpy as np
import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.cuda import build

MAX_CUTS = 32  # csrc/classify.cu::kMaxCuts


def _check_cuts(cuts):
    cuts = np.ascontiguousarray(cuts, dtype=np.float32).reshape(-1)
    if not 1 <= cuts.size <= MAX_CUTS:
        raise ValueError(f"cutoff_count takes 1 to {MAX_CUTS} cutoffs, got {cuts.size}")
    return cuts


def cutoff_count_plain(hand, flood, h00, cuts, under="under"):
    """int64 ``(2k + 1,)``: for each of the k float32 ``cuts``, the valid
    cells with ``hand <= cut`` (``>=`` under ``"over"``), then the valid
    flooded cells among them, then the flooded cells of the raster.  A cell
    is valid where HAND is not NoData and, where ``h00`` (the raster's
    corner) is data, not equal to it; flooded where flood is 1 or 2
    (``parallel.classify._valid_mask``; the benchmark's normalisation,
    evaluation.py:149-150)."""
    cuts = _check_cuts(cuts)
    k = cuts.size
    h = hand.reshape(-1).to(torch.float32)
    f = flood.reshape(-1).to(torch.int32)
    flooded = (f == 1) | (f == 2)
    valid = (h != NODATA) & ~((h00 != NODATA) & (h == h00)) & ~torch.isnan(h)
    order = np.argsort(cuts, kind="stable")
    bounds = torch.as_tensor(cuts[order], device=h.device)
    # Interval of each cell among the sorted cutoffs: under, the number of
    # cutoffs below it (it is hit by the rest); over, the number at or
    # below it (it is hit by those).
    interval = torch.bucketize(h, bounds, right=under != "under")
    key = torch.where(valid, 2 * interval + flooded.to(interval.dtype), 2 * (k + 1))
    # bincount's counts, by a scatter-add (no read of the keys' range)
    joint = torch.zeros(2 * (k + 1) + 1, dtype=torch.int64, device=h.device)
    joint = joint.scatter_add_(0, key, torch.ones_like(key))[: 2 * (k + 1)].reshape(k + 1, 2)
    per = joint.sum(1)
    if under == "under":
        pred, tp = per.cumsum(0)[:k], joint[:, 1].cumsum(0)[:k]
    else:
        pred = per.flip(0).cumsum(0).flip(0)[1:]
        tp = joint[:, 1].flip(0).cumsum(0).flip(0)[1:]
    out = torch.empty(2 * k + 1, dtype=torch.int64, device=h.device)
    inv = torch.as_tensor(order, device=h.device)
    out[inv] = pred
    out[k + inv] = tp
    out[2 * k] = flooded.sum()
    return out


def cutoff_count(hand, flood, h00, cuts, under="under"):
    """:func:`cutoff_count_plain`'s counts in one launch on the card
    (``hand`` float32 and ``flood`` int32, contiguous; ``h00`` a one-element
    float32 tensor there), as an int64 tensor on the card."""
    if not hand.is_cuda:
        return cutoff_count_plain(hand, flood, h00, cuts, under)
    cuts = _check_cuts(cuts)
    n = hand.numel()
    build.check_cuda_tensor(hand, "hand", torch.float32, tuple(hand.shape))
    build.check_cuda_tensor(flood, "flood", torch.int32, tuple(hand.shape))
    h00 = h00.reshape(1)
    build.check_cuda_tensor(h00, "h00", torch.float32, (1,))
    out = torch.zeros(2 * cuts.size + 1, dtype=torch.int64, device=hand.device)
    sms = torch.cuda.get_device_properties(hand.device).multi_processor_count
    with torch.cuda.device(hand.device):
        build.launch(
            "launch_cutoff_count", hand.data_ptr(), flood.data_ptr(), h00.data_ptr(), n,
            cuts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(cuts.size),
            int(under != "under"), out.data_ptr(), sms, build.stream_handle(hand.device),
        )
    cutoff_count.launches += 1
    return out


cutoff_count.launches = 0
