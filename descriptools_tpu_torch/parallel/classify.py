"""Flood-map calibration and classification on the device, float64-EXACT.

Counterpart of ``descriptools_tpu/parallel/classify.py``, on one device
(``mesh=None``) or over the blocks of a mesh.  The reference classifies on the host: ``np.unique`` for
min and max, float64 min-max scaling, then ~30 serial full-raster
confusion scans (evaluation.py:5-87); ``pipeline.classify_flood`` keeps
that float64 path.  Here:

  1. the stats pass: min, second distinct min, max, the ``hand[0, 0]``
     probe and a count of non-integer cells (exactly ``np.unique(hand)[1]``
     and ``[-1]``: the second element is the smallest value distinct from
     the global min);
  2. the threshold search: HAND from an integer DEM is integer-valued, so
     the float64 predicate ``fl64((h - mn)/(mx - mn)) <= th`` reduces to
     ``h <= cutoff(th)`` with an integer cutoff found by host-side float64
     bisection (``_integer_cutoff``).  ONE device pass builds the joint
     histogram of (integer HAND value x flooded bit); every cutoff's
     TP/FP/FN falls out of host prefix sums, so the whole coarse-to-fine
     search costs one pass and selects the identical threshold.  Value
     ranges wider than ``NBINS_MAX`` fall back to one counting pass a
     search stage;
  3. the class map (0 TN / 1 FP / 2 FN / 3 TP, evaluation.py:153-166),
     uint8, on the device.

Each block reduction is a function of its own (``_block_*``): the mesh
path reduces each over a rank's blocks and adds an all-reduce after it
(MIN for the min and the second min, MAX for the max, SUM for the counts
and histograms) and broadcasts the corner probe from block 0's rank; the
host part (``_search``) is shared.

Spec: reference evaluation.py:5-211 via the oracle; binary_map's corner
probe quirk (evaluation.py:111-112) is kept: when hand[0,0] is not NoData,
cells equal to it classify as 0.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.evaluation import _scalar, coarse_to_fine_search
from descriptools_tpu_torch.utils import timing

NBINS_MAX = 1 << 22  # widest HAND value range the one-pass histogram bins
_F32_EXACT = 1 << 24  # integers above this are not exactly f32-representable
_BIG = 3e38


def _block_extrema(hand_blk):
    """(min, max) of a block."""
    return hand_blk.min(), hand_blk.max()


def _block_second_min(hand_blk, gmin):
    """The block's least value above the global min (3e38 if none)."""
    return torch.where(hand_blk == gmin, _scalar(_BIG, hand_blk), hand_blk).min()


def _block_nonint(hand_blk):
    """Data cells of the block whose value is not an integer."""
    data = hand_blk != NODATA
    return (data & (hand_blk != torch.round(hand_blk))).sum()


def _valid_mask(hand_blk, h00):
    """binary_map's NoData handling (evaluation.py:111-112): NoData cells
    and, when the corner is data, cells equal to it."""
    nd = hand_blk == NODATA
    probe_live = h00 != NODATA
    return ~nd & ~(probe_live & (hand_blk == h00))


def _bench01(bench_blk):
    """benchmark 1 -> flooded, NODATA -> dry (evaluation.py:149-150)."""
    b = bench_blk.to(torch.int32)
    return torch.where(b == 1, 2, torch.where(b == NODATA, 0, b)) == 2


def _block_histogram(hand_blk, bench_blk, h00, lo, nbins):
    """Per integer HAND value ``lo + i``: valid cells and valid & flooded
    cells (int64, ``nbins`` each), and the flooded cells of the block.
    One ``bincount`` of the joint key ``2 i + flooded``; invalid cells go
    to a spare bin past the end."""
    valid = _valid_mask(hand_blk, h00)
    flooded = _bench01(bench_blk)
    idx = (hand_blk - _scalar(lo, hand_blk)).to(torch.int32).clamp(0, nbins - 1)
    key = torch.where(valid, 2 * idx + flooded.to(torch.int32), 2 * nbins)
    joint = torch.bincount(key.reshape(-1), minlength=2 * nbins + 1)
    timing.count("host_reads", 2)  # bincount reads its input's least and largest values
    ht = joint[1 : 2 * nbins : 2]
    return joint[0 : 2 * nbins : 2] + ht, ht, flooded.sum()


def _hit(hand_blk, cut, under):
    return hand_blk <= cut if under == "under" else hand_blk >= cut


def _block_counts(hand_blk, bench_blk, h00, cuts, under):
    """(len(cuts), 3) int64: TP, FP, FN of ``hand <= cut`` (``>=`` over)
    for each cut, one cut at a time."""
    valid = _valid_mask(hand_blk, h00)
    flooded = _bench01(bench_blk)
    n_fl = flooded.sum()
    rows = []
    timing.count("host_writes")
    for cut in torch.as_tensor(cuts, dtype=torch.float32, device=hand_blk.device):
        pred = valid & _hit(hand_blk, cut, under)
        tp = (pred & flooded).sum()
        rows.append(torch.stack([tp, pred.sum() - tp, n_fl - tp]))
    return torch.stack(rows)


def _block_classmap(hand_blk, bench_blk, h00, cut, under):
    pred = (_valid_mask(hand_blk, h00) & _hit(hand_blk, _scalar(cut, hand_blk), under)).to(torch.int32)
    bench = bench_blk.to(torch.int32)
    bnorm = torch.where(bench == 1, 2, torch.where(bench == NODATA, 0, bench))
    return (pred + bnorm).to(torch.uint8)


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


def _read(t):
    """``t`` on the host as a numpy array: one host read, counted."""
    timing.count("host_reads")
    return t.cpu().numpy()


def _histogram_counts(hv, ht, n_fl, lo, nbins, under):
    """``counts_at(cuts)`` from the joint histogram: host prefix sums."""
    cum_v = np.cumsum(_read(hv).astype(np.int64))
    cum_t = np.cumsum(_read(ht).astype(np.int64))
    n_fl = int(_read(n_fl))

    def counts_at(cuts):
        acc = np.empty((len(cuts), 3), np.int64)  # tp, fp, fn
        for k, cut in enumerate(cuts):
            i = int(cut) - lo
            if under == "under":
                tp, pred = (
                    (0, 0) if i < 0
                    else (int(cum_t[min(i, nbins - 1)]), int(cum_v[min(i, nbins - 1)]))
                )
            else:  # v >= cut
                below = (0, 0) if i <= 0 else (
                    int(cum_t[min(i, nbins) - 1]),
                    int(cum_v[min(i, nbins) - 1]),
                )
                tp = int(cum_t[-1]) - below[0]
                pred = int(cum_v[-1]) - below[1]
            acc[k] = (tp, pred - tp, n_fl - tp)
        return acc

    return counts_at


def _mesh_classify_flood(hand, flood, mesh, under, shape, crop):
    """The mesh path: each ``_block_*`` reduced over this rank's blocks,
    then one all-reduce (MIN for the min and, in a second round, the second
    min; MAX for the max; SUM for the counts and histograms); ``hand[0,
    0]`` broadcast from the rank that owns block 0.  The host part is the
    one-device path's."""
    import torch.distributed as dist

    from descriptools_tpu_torch.parallel.mesh import ShardedRaster, all_reduce, broadcast, crop_from_mesh
    from descriptools_tpu_torch.parallel.sharded import _resolve_shape, _staged

    shape = _resolve_shape(hand, mesh, shape)
    hand_s = _staged(hand, mesh, NODATA, np.float32)
    flood_s = _staged(flood, mesh, NODATA, np.int32)
    R, C = hand_s.shape
    if R * C >= 1 << 31:
        raise ValueError(f"grid {R}x{C} overflows int32 confusion counts")
    rows, cols = shape
    dev = mesh.device

    def real(b):
        """The block's cells inside the original raster (the padding must
        not leak NODATA into the value range)."""
        ys, _, xs, _ = hand_s.window(b)
        return hand_s.blocks[b][: max(rows - ys, 0), : max(cols - xs, 0)]

    live = [t for t in map(real, mesh.blocks) if t.numel()]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    extrema = [_block_extrema(t) for t in live]
    gmin = all_reduce(mesh, torch.stack([big, *(lo for lo, _ in extrema)]).min(), dist.ReduceOp.MIN)
    mx = all_reduce(mesh, torch.stack([-big, *(hi for _, hi in extrema)]).max(), dist.ReduceOp.MAX)
    mn2 = all_reduce(mesh, torch.stack([big, *(_block_second_min(t, gmin) for t in live)]).min(),
                     dist.ReduceOp.MIN)
    nonint = all_reduce(mesh, sum((_block_nonint(t) for t in live), torch.zeros((), dtype=torch.int64, device=dev)),
                        dist.ReduceOp.SUM)
    block0 = hand_s.blocks[0][0, 0] if 0 in hand_s.blocks else torch.zeros((), device=dev)
    h00 = broadcast(mesh, block0, mesh.owner(0))
    gmin, mn2, mx, nonint = torch.stack([gmin, mn2, mx, nonint.to(torch.float32)]).double().cpu().numpy()

    def per_block(fn):
        """``fn(hand block, flood block)`` summed over this rank's blocks,
        then over the ranks."""
        acc = sum(fn(hand_s.blocks[b], flood_s.blocks[b]) for b in mesh.blocks)
        return all_reduce(mesh, acc, dist.ReduceOp.SUM)

    def histogram(lo, nbins):
        def joint(h, f):
            hv, ht, n_fl = _block_histogram(h, f, h00, lo, nbins)
            return torch.cat([hv, ht, n_fl.reshape(1)])

        j = per_block(joint)
        return j[:nbins], j[nbins : 2 * nbins], j[2 * nbins]

    def counts(cuts):
        return per_block(lambda h, f: _block_counts(h, f, h00, cuts, under)).cpu().numpy()

    th, correctness, fit, cut_i = _search(gmin, mn2, mx, nonint, under, histogram, counts)
    class_map = ShardedRaster(mesh, hand_s.shape, {
        b: _block_classmap(hand_s.blocks[b], flood_s.blocks[b], h00, float(cut_i), under)
        for b in mesh.blocks
    })
    if crop:
        class_map = crop_from_mesh(class_map.gather(), shape)
    return th, correctness, fit, class_map


def _search(gmin, mn2, mx, nonint, under, histogram, counts):
    """The host part: the integer and range checks, the coarse-to-fine
    search over the joint histogram (``histogram(lo, nbins)`` -> (hv, ht,
    n_fl)) or, above ``NBINS_MAX`` bins, one counting pass a search stage
    (``counts(cuts)`` -> (len(cuts), 3) TP, FP, FN).  Returns (threshold,
    correctness, fit, integer cutoff)."""
    if nonint != 0:
        raise ValueError(
            "HAND is not integer-valued; the exact sharded calibration "
            "requires an integer DEM — use pipeline.classify_flood"
        )
    # np.unique(hand)[1] / [-1] (pipeline.classify_flood): the smallest
    # value distinct from the global min, and the max.
    mn = mn2
    if not np.isfinite(mn) or mx <= mn or abs(mn) > _F32_EXACT or mx > _F32_EXACT:
        raise ValueError(f"degenerate HAND value range [{mn}, {mx}]")

    # Smallest real HAND value (NODATA is the min iff the raster has any).
    lo = int(gmin if gmin != NODATA else mn2)
    nbins = int(mx) - lo + 1
    if nbins <= NBINS_MAX:
        # One counting pass for the ENTIRE search: joint histogram + host
        # prefix sums.
        counts_at = _histogram_counts(*histogram(lo, nbins), lo, nbins, under)
    else:
        # Huge value ranges: one device counting pass per search stage.
        counts_at = counts

    def fits_at(values, scale):
        cuts = [_integer_cutoff(v / scale, mn, mx, under) for v in values]
        c = counts_at(cuts).astype(np.float64)
        tp, fp, fn = c[:, 0], c[:, 1], c[:, 2]
        return tp / (tp + fn + fp)

    th = coarse_to_fine_search(fits_at)

    cut_i = _integer_cutoff(th, mn, mx, under)
    tp, fp, fn = counts_at([cut_i])[0].astype(np.float64)
    return th, float(tp / (fn + tp)), float(tp / (tp + fn + fp)), cut_i


def sharded_classify_flood(hand, flood, mesh=None, under="under", shape=None, crop=True, *,
                           device="cuda"):
    """Calibrate + classify a HAND raster against a flood benchmark,
    selecting the IDENTICAL float64 threshold as ``pipeline.classify_flood``
    with no host-side raster.  Returns ``(threshold, correctness, fit,
    class_map)``.

    ``mesh=None``: one device.  ``hand`` and ``flood`` are numpy rasters,
    moved to ``device`` (the card unless the caller asks for ``"cpu"``;
    raises where no CUDA device is available), or tensors, which stay where
    they are.  ``shape`` is the real raster inside a larger staged one (pad
    fill NODATA; default: the whole raster), and ``crop`` crops the class
    map (a uint8 tensor on the device) to it.

    ``mesh`` (a ``parallel.mesh.Mesh``): the blocks of this rank, from
    numpy rasters of the global grid or ``ShardedRaster``s of the mesh
    (``shape`` required for those); the statistics are reduced over the
    ranks.  The class map stays a ``ShardedRaster`` with ``crop=False``,
    and is the cropped global map on every rank with ``crop=True``.

    Requires integer-valued HAND (integer DEM input; the reference example
    feeds int16) and raises otherwise, pointing at the host float path.

    Spans (``utils.timing``), on one device: ``classify`` and, inside it,
    ``classify.stats`` (the casts and the statistics' one host read),
    ``classify.search`` (``_search``: the histogram pass or the counting
    passes, and the host's search) and ``classify.map``; each read of a
    device value on the host adds 1 to the open span's ``host_reads``, and
    each copy of a host value to the device 1 to its ``host_writes``.
    """
    if mesh is not None:
        from descriptools_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, got {type(mesh).__name__}")
        return _mesh_classify_flood(hand, flood, mesh, under, shape, crop)
    with timing.span("classify"):
        with timing.span("classify.stats"):
            if not isinstance(hand, torch.Tensor):
                from descriptools_tpu_torch.pipeline import check_device

                hand = torch.as_tensor(np.asarray(hand), device=check_device(device))
            dev = hand.device
            hand_s = hand.to(torch.float32)
            flood_s = torch.as_tensor(flood, device=dev).to(torch.int32)
            R, C = hand_s.shape
            if R * C >= 1 << 31:
                raise ValueError(f"grid {R}x{C} overflows int32 confusion counts")
            rows, cols = (R, C) if shape is None else (int(s) for s in shape)

            real = hand_s[:rows, :cols]
            gmin, mx = _block_extrema(real)
            mn2 = _block_second_min(real, gmin)
            h00 = hand_s[0, 0]
            stats = torch.stack([gmin, mn2, mx, _block_nonint(real).to(torch.float32)])
            gmin, mn2, mx, nonint = _read(stats.double())
        with timing.span("classify.search"):
            th, correctness, fit, cut_i = _search(
                gmin, mn2, mx, nonint, under,
                lambda lo, nbins: _block_histogram(hand_s, flood_s, h00, lo, nbins),
                lambda cuts: _read(_block_counts(hand_s, flood_s, h00, cuts, under)),
            )
        with timing.span("classify.map"):
            class_map = _block_classmap(hand_s, flood_s, h00, float(cut_i), under)
            if crop:
                class_map = class_map[:rows, :cols]
    return th, correctness, fit, class_map
