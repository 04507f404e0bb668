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
  2. the threshold search.  The float64 predicate ``fl64((h - mn)/(mx -
     mn)) <= th`` is monotone in ``h``, so it is ``h <= cutoff(th)`` in
     float32 for one cutoff a threshold, found on the host by float64
     bisection:
       - integer HAND (an integer DEM): an integer cutoff
         (``_integer_cutoff``), an exact float32 value within
         ``_F32_EXACT``;
       - float HAND (a float DEM): a float32 cutoff (``_float_cutoffs``,
         over the ordered float32 bit patterns);
     either way one counting pass a search stage whose cutoffs are not
     counted yet (``ops.cuda.classify.cutoff_count``: a hand-written
     kernel on the card), at most 5 passes and 5 host reads a search; the
     final threshold's counts are its last stage's;
  3. the class map (0 TN / 1 FP / 2 FN / 3 TP, evaluation.py:153-166),
     uint8, on the device.

Each block reduction is a function of its own (``_block_*``): the mesh
path reduces each over a rank's blocks and adds an all-reduce after it
(MIN for the min and the second min, MAX for the max, SUM for the counts)
and broadcasts the corner probe from block 0's rank; the host part
(``_search``) is shared.

Spec: reference evaluation.py:5-211 via the oracle; binary_map's corner
probe quirk (evaluation.py:111-112) is kept: when hand[0,0] is not NoData,
cells equal to it classify as 0.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.evaluation import _scalar, coarse_to_fine_search
from descriptools_tpu_torch.ops.cuda.classify import cutoff_count
from descriptools_tpu_torch.placement import check_device
from descriptools_tpu_torch.utils import timing

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


def _hit(hand_blk, cut, under):
    return hand_blk <= cut if under == "under" else hand_blk >= cut


def _block_cut_counts(hand_blk, bench_blk, h00, cuts, under):
    """One counting pass over a block (``ops.cuda.classify.cutoff_count``):
    int64 ``(2k + 1,)``, the valid cells each float32 cut hits, the valid
    flooded ones among them, the flooded cells."""
    return cutoff_count(hand_blk.to(torch.float32).contiguous(), bench_blk.to(torch.int32).contiguous(),
                        h00.to(torch.float32), cuts, under)


def _tp_fp_fn(c, k):
    """(k, 3) int64 TP, FP, FN from a counting pass's ``(2k + 1,)``."""
    c = np.asarray(c, np.int64)
    pred, tp, n_fl = c[:k], c[k : 2 * k], c[2 * k]
    return np.stack([tp, pred - tp, n_fl - tp], axis=1)


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


def _f32_keys(x):
    """Ordered int64 keys of float32 values: monotone in the value, -0.0
    and +0.0 one key."""
    bits = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _f32_of_keys(keys):
    keys = np.asarray(keys, np.int64)
    bits = np.where(keys < 0, (-keys) | 0x80000000, keys).astype(np.uint32)
    return bits.view(np.float32)


def _float_cutoffs(ths, mn, mx, under):
    """The float32 h at which the float64 scaled predicate flips, for each
    threshold of ``ths``: the float counterpart of :func:`_integer_cutoff`.

    under:  largest  float32 h with fl64((h - mn)/(mx - mn)) <= th  (pred: h <= cut)
    else:   smallest float32 h with fl64((h - mn)/(mx - mn)) >= th  (pred: h >= cut)

    fl64 is monotone non-decreasing in h, so the flip is one point of the
    ordered float32 bit patterns, and comparing float32 HAND against it is
    EXACTLY the oracle's float64 comparison.  It lies within a float32 step
    or two of ``f32(mn + th (mx - mn))`` wherever that sum does not cancel,
    so each threshold first evaluates the 17 patterns around it, all of a
    stage's thresholds in one array, and takes the flip where they hold
    it.  The rest (an empty or full predicate, or a range whose sum
    cancels) bisect the whole finite range (:func:`_bisect_cutoffs`).  The
    search runs between a stage's counting passes, with the card idle, so
    its host time is the job's."""
    ths = np.asarray(ths, np.float64)
    mn, mx = np.float64(mn), np.float64(mx)
    timing.count("float_cutoffs", int(ths.size))

    def holds(keys, th):
        scaled = (_f32_of_keys(keys).astype(np.float64) - mn) / (mx - mn)
        return scaled <= th if under == "under" else scaled >= th

    big = np.finfo(np.float32).max
    top = int(_f32_keys(big))
    guess = _f32_keys(np.clip(mn + ths * (mx - mn), -big, big).astype(np.float32))
    near = np.clip(guess[:, None] + np.arange(-8, 9), -top, top)
    ok = holds(near, ths[:, None])  # along a row: True then False under, False then True over
    n_ok = ok.sum(axis=1)
    if under == "under":
        flip, pick = ok[:, 0] & ~ok[:, -1], n_ok - 1
    else:
        flip, pick = ~ok[:, 0] & ok[:, -1], near.shape[1] - n_ok
    pick = np.clip(pick, 0, near.shape[1] - 1)
    cut = _f32_of_keys(np.take_along_axis(near, pick[:, None], axis=1)[:, 0])
    if not flip.all():
        cut[~flip] = _bisect_cutoffs(ths[~flip], holds, under, top)
    return cut


def _bisect_cutoffs(ths, holds, under, top):
    """:func:`_float_cutoffs` by bisection over the whole finite float32
    range (about 32 float64 evaluations).  An empty predicate gives the
    cutoff that no finite value passes (-inf under, +inf over), a full one
    the cutoff every finite value passes."""
    lo = np.full(ths.shape, -top, np.int64)
    hi = np.full(ths.shape, top, np.int64)
    at_lo, at_hi = holds(lo, ths), holds(hi, ths)
    empty, full = (~at_lo, at_hi) if under == "under" else (~at_hi, at_lo)
    # invariant on the live thresholds: the predicate holds at one end and
    # fails at the other (lo under, hi over)
    step = ~(empty | full) & (hi - lo > 1)
    while bool(step.any()):
        mid = (lo + hi) // 2
        ok = holds(mid, ths)
        if under == "under":
            lo, hi = np.where(step & ok, mid, lo), np.where(step & ~ok, mid, hi)
        else:
            lo, hi = np.where(step & ~ok, mid, lo), np.where(step & ok, mid, hi)
        step &= hi - lo > 1
    cut = _f32_of_keys(lo if under == "under" else hi)
    inf = np.float32(np.inf)
    if under == "under":
        return np.where(empty, -inf, np.where(full, inf, cut)).astype(np.float32)
    return np.where(empty, inf, np.where(full, -inf, cut)).astype(np.float32)


def _read(t):
    """``t`` on the host as a numpy array: one host read, counted."""
    timing.count("host_reads")
    return t.cpu().numpy()


def _mesh_classify_flood(hand, flood, mesh, under, shape, crop):
    """The mesh path: each ``_block_*`` reduced over this rank's blocks,
    then one all-reduce (MIN for the min and, in a second round, the second
    min; MAX for the max; SUM for the counts, one a counting pass);
    ``hand[0, 0]`` broadcast from the rank that owns block 0.  The host part
    is the one-device path's."""
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
    mn2, mx, nonint = torch.stack([mn2, mx, nonint.to(torch.float32)]).double().cpu().numpy()

    def per_block(fn):
        """``fn(hand block, flood block)`` summed over this rank's blocks,
        then over the ranks."""
        acc = sum(fn(hand_s.blocks[b], flood_s.blocks[b]) for b in mesh.blocks)
        return all_reduce(mesh, acc, dist.ReduceOp.SUM)

    def counts(cuts):
        with timing.span("classify.count", passes=1, cuts=len(cuts)):
            c = per_block(lambda h, f: _block_cut_counts(h, f, h00, cuts, under))
            return _tp_fp_fn(_read(c), len(cuts))

    th, correctness, fit, cut = _search(mn2, mx, nonint, under, counts)
    class_map = ShardedRaster(mesh, hand_s.shape, {
        b: _block_classmap(hand_s.blocks[b], flood_s.blocks[b], h00, float(cut), under)
        for b in mesh.blocks
    })
    if crop:
        class_map = crop_from_mesh(class_map.gather(), shape)
    return th, correctness, fit, class_map


def _stage_counts(counts):
    """``counts_at(cuts)`` over counting passes (``counts(float32 cuts)`` ->
    (len, 3) TP, FP, FN): one pass for the cuts not counted yet, so the
    final threshold's cut, which its last stage counted, costs none."""
    seen = {}

    def counts_at(cuts):
        cuts = np.asarray(cuts, np.float32)
        new = [c for c in dict.fromkeys(cuts.tolist()) if c not in seen]
        if new:
            seen.update(zip(new, counts(np.asarray(new, np.float32))))
        return np.stack([seen[c] for c in cuts.tolist()])

    return counts_at


def _search(mn, mx, nonint, under, counts):
    """The host part: the range checks, the cutoffs (integer HAND's or
    float HAND's, by ``nonint``), and the coarse-to-fine search over one
    counting pass a search stage (``counts(float32 cuts)`` -> (len(cuts),
    3) TP, FP, FN).  Returns (threshold, correctness, fit, cutoff)."""
    # np.unique(hand)[1] / [-1] (pipeline.classify_flood): the smallest
    # value distinct from the global min, and the max.
    if not np.isfinite(mn) or mx <= mn or (nonint == 0 and (abs(mn) > _F32_EXACT or mx > _F32_EXACT)):
        raise ValueError(f"degenerate HAND value range [{mn}, {mx}]")

    if nonint != 0:
        def cutoffs(ths):
            return _float_cutoffs(ths, mn, mx, under)
    else:
        def cutoffs(ths):
            # Exact float32 values: integer HAND lies within +-_F32_EXACT (checked above).
            return np.array([_integer_cutoff(th, mn, mx, under) for th in ths], np.float32)

    counts_at = _stage_counts(counts)

    def fits_at(values, scale):
        c = counts_at(cutoffs([v / scale for v in values])).astype(np.float64)
        tp, fp, fn = c[:, 0], c[:, 1], c[:, 2]
        return tp / (tp + fn + fp)

    th = coarse_to_fine_search(fits_at)

    cut = cutoffs([th])[0]
    tp, fp, fn = counts_at([cut])[0].astype(np.float64)
    return th, float(tp / (fn + tp)), float(tp / (tp + fn + fp)), cut.item()


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

    Integer HAND (an integer DEM: the reference example feeds int16) and
    float HAND (a float DEM) are both calibrated from one counting pass a
    search stage, and both select the float64 path's threshold exactly.

    Spans (``utils.timing``), on one device: ``classify`` and, inside it,
    ``classify.stats`` (the casts and the statistics' one host read),
    ``classify.search`` (``_search``: the counting passes and the host's
    search; ``float_cutoffs``, the float32 bisections it ran) with a
    ``classify.count`` span a counting pass (``passes`` 1, ``cuts``, the
    cutoffs it counted) and ``classify.map``;
    each read of a device value on the host adds 1 to the open span's
    ``host_reads``.  Its scalars are filled on the device, so it makes no
    ``host_writes``.
    """
    if mesh is not None:
        from descriptools_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh or None, got {type(mesh).__name__}")
        return _mesh_classify_flood(hand, flood, mesh, under, shape, crop)
    with timing.span("classify"):
        with timing.span("classify.stats"):
            if not isinstance(hand, torch.Tensor):
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
            stats = torch.stack([mn2, mx, _block_nonint(real).to(torch.float32)])
            mn2, mx, nonint = _read(stats.double())
        def counts(cuts):
            with timing.span("classify.count", passes=1, cuts=len(cuts)):
                return _tp_fp_fn(_read(_block_cut_counts(hand_s, flood_s, h00, cuts, under)), len(cuts))

        with timing.span("classify.search"):
            th, correctness, fit, cut = _search(mn2, mx, nonint, under, counts)
        with timing.span("classify.map"):
            class_map = _block_classmap(hand_s, flood_s, h00, float(cut), under)
            if crop:
                class_map = class_map[:rows, :cols]
    return th, correctness, fit, class_map
