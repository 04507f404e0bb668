"""The downslope, flow and absorbing walks on the card.

Wrappers of ``csrc/walk.cu``:

- :func:`downslope_walk` replaces ``descriptools_tpu/ops/pallas/walk_vmem.py
  ::_downslope_kernel``: the whole downslope stage in one launch, from dem
  (float32) and fdr to the downslope raster, one serial walk per CUDA
  thread with the terminal test and the ratio formed in the kernel; its
  plain version is ``ops.downslope._downslope_jacobi`` (``walk_inputs``,
  ``jacobi_walk``, ``downslope_from_state``).  The serial walk is exact
  for any fdr, so the JAX wrapper's monotone-descent probe and its
  fallback branch have no counterpart here.
- :func:`downslope_walk_tracked` replaces ``descriptools_tpu/ops/pallas/
  walk.py::_downslope_kernel`` (the blocked tier with truncation flags)
  and the ``trunc0`` mode of ``walk_vmem.py::_downslope_kernel``: the same
  kernel on a tile's halo window, launched over the tile alone, with the
  flag; its plain version is ``ops.downslope.downslope_window``
  (``trunc_cells``, the tracked ``_downslope_jacobi``, then the interior).
- :func:`flow_cuda` replaces ``walk_vmem.py::_walk2_kernel`` with the
  flow stage around it: one C entry, ``launch_flow_walk``, from fdr and
  the river mask as given to fdist and indices (phase 1 forms each cell's
  absorbing role itself, and one kernel after the rounds forms the
  outputs); its plain version is ``ops.flow.walk_inputs``,
  ``doubling_walk`` and ``flow_from_state``.  Its launches, R and pending
  cells are counted on ``flow_walk``.  The step counts are two separate
  int32 rasters, so no path can overflow them and the JAX packed-count
  guard with its ``_walk3_kernel`` fallback has no counterpart here.
- :func:`absorbing_walk` replaces the generic absorbing walks
  ``walk_vmem.py::_walk3_kernel`` and ``walk.py::_walk3_kernel`` (the
  local phase of ``parallel.boundary``): the jump walk over walk operands
  that the caller built (``launch_jump_walk``); its plain version is
  ``ops.flow.doubling_walk`` on the same operands.
  Both are one jump walk: a serial walk of at most B (:func:`jump_bound`)
  steps per thread, then pointer-jumping rounds over the cells still
  walking, queued on the stream with no host read (``csrc/walk.cu`` says
  how).
- :func:`flow_walk_blocked` (``csrc/flow_fold.cu``) replaces
  ``walk.py::_flow_kernel``, the JAX blocked flow tier; its plain version
  is ``ops.flow.fold_walk``.  It forms fdist as the right fold of the step
  lengths, as that tier does, where :func:`flow_cuda` sums counts: an
  anchored fold after the jump walk, each cell folding at most W steps
  onto an anchor that an earlier launch finished, with one host read per
  call.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version.  There is no other fallback.  :func:`flow_cuda` forms
its operands and outputs on the card, by the rule of ``flow.flow_states``
and the expression of ``flow_from_state``; every other flow walk's
operands are built and its results finished in torch ops shared with the
plain engines (``flow.walk_inputs`` before, ``flow_from_state`` and
``flow_from_fold`` after), so every engine's output is bitwise the same
function of the walk state.
"""

import ctypes
import types

import numpy as np
import torch

from descriptools_tpu_torch.ops.downslope import _downslope_jacobi, check_max_steps, downslope_window
from descriptools_tpu_torch.ops import flow as _flow
from descriptools_tpu_torch.ops.cuda import build
from descriptools_tpu_torch.utils import timing


# fdr dtypes the downslope kernel reads as they are (uint8 as given by
# run_example, load_window and utils.synthetic).
FDR_DTYPES = (torch.uint8, torch.int32)


def fdr_operand(fdr):
    """fdr as the downslope kernel reads it: uint8 and int32 as they are;
    any other integer dtype as int32, with every value outside 0-255 set to
    0, so that a code such as 257 stays invalid (``d8.decode`` treats every
    value outside the D8 set as invalid) and does not wrap onto one."""
    if fdr.dtype not in FDR_DTYPES:
        if fdr.is_floating_point() or fdr.is_complex() or fdr.dtype == torch.bool:
            raise ValueError(f"fdr: expected an integer dtype, got {fdr.dtype}")
        fdr = torch.where((fdr >= 0) & (fdr <= 255), fdr, 0).to(torch.int32)
    return fdr.contiguous()


def _downslope_args(dem_f, fdr, px, elevation_difference, max_steps):
    """Checked kernel arguments shared by both entries: (fdr, its is-int32
    flag, ed, max_steps, c_card, c_diag)."""
    check_max_steps(max_steps)
    build.check_cuda_tensor(dem_f, "dem_f", torch.float32, tuple(dem_f.shape))
    fdr = fdr_operand(fdr)
    build.check_cuda_tensor(fdr, "fdr", fdr.dtype, tuple(dem_f.shape))
    c_card, c_diag = _flow.step_consts(px)  # as unpack_dist forms them
    return (fdr, int(fdr.dtype == torch.int32), float(np.float32(elevation_difference)),
            int(max_steps), c_card, c_diag)


def downslope_walk(dem_f, fdr, px, elevation_difference, max_steps):
    """Downslope index (float32) of a whole grid, in one launch."""
    if not dem_f.is_cuda:
        return _downslope_jacobi(dem_f, fdr, px, elevation_difference, max_steps)
    fdr, is_int32, ed, steps, c_card, c_diag = _downslope_args(
        dem_f, fdr, px, elevation_difference, max_steps)
    rows, cols = dem_f.shape
    out = torch.empty_like(dem_f)
    with torch.cuda.device(dem_f.device):
        build.launch(
            "launch_downslope", dem_f.data_ptr(), fdr.data_ptr(), is_int32, out.data_ptr(),
            rows, cols, ed, steps, c_card, c_diag, build.stream_handle(dem_f.device),
        )
    downslope_walk.launches += 1
    return out


downslope_walk.launches = 0


def downslope_walk_tracked(dem_f, fdr, px, elevation_difference, max_steps, row0, col0,
                           grid_rows, grid_cols, halo):
    """(downslope f32, trunc bool) of the interior of a tile's window, in
    one launch.  The window holds the tile and a ring of ``halo`` cells;
    ``row0``, ``col0`` is its origin in the global grid (``grid_rows`` x
    ``grid_cols``).  trunc marks walks that stopped at a terminal that only
    the window's edge made (``ops.downslope.trunc_cells``)."""
    if not dem_f.is_cuda:
        return downslope_window(dem_f, fdr, px, elevation_difference, max_steps,
                                      row0, col0, grid_rows, grid_cols, halo)
    fdr, is_int32, ed, steps, c_card, c_diag = _downslope_args(
        dem_f, fdr, px, elevation_difference, max_steps)
    rows, cols = dem_f.shape
    if halo < 0 or 2 * halo > min(rows, cols):
        raise ValueError(f"halo {halo} does not fit a {rows}x{cols} window")
    shape = (rows - 2 * halo, cols - 2 * halo)
    out = torch.empty(shape, dtype=torch.float32, device=dem_f.device)
    trunc = torch.empty(shape, dtype=torch.bool, device=dem_f.device)  # one byte, 0 or 1
    with torch.cuda.device(dem_f.device):
        build.launch(
            "launch_downslope_tracked", dem_f.data_ptr(), fdr.data_ptr(), is_int32,
            out.data_ptr(), trunc.data_ptr(), rows, cols, int(halo), int(row0), int(col0),
            int(grid_rows), int(grid_cols), ed, steps, c_card, c_diag,
            build.stream_handle(dem_f.device),
        )
    downslope_walk_tracked.launches += 1
    return out, trunc


downslope_walk_tracked.launches = 0


JUMP_MAX_STEPS = 1 << 30  # the counts' sums stay below 2^31 under this cap
# Lengths of the jump walk's lists, one a round and the last list's: R + 1,
# and R <= 30 for any B >= 1 under JUMP_MAX_STEPS.
_JUMP_COUNTS = 32


def jump_bound():
    """B, the steps of the jump walk's phase 1 (``csrc/walk.cu`` kJumpB)."""
    return build.library().jump_walk_bound()


def _check_jump_max_steps(max_steps):
    if max_steps >= JUMP_MAX_STEPS:
        raise ValueError(f"max_steps {max_steps} >= 2^30 would overflow the step counts")


def _jump_buffers(fdr_eff, code0):
    """Checked operands' outputs and scratch of the jump walk: (code, a, b,
    counts, scratch)."""
    shape = tuple(code0.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(code0, "code0", torch.int32, shape)
    dev = code0.device
    code, a, b = (torch.empty_like(code0) for _ in range(3))
    counts = torch.empty(_JUMP_COUNTS, dtype=torch.int32, device=dev)  # zeroed by the launcher
    # Two int2 state buffers, done and two lists: 28 B a cell.
    scratch = torch.empty(7 * code0.numel(), dtype=torch.int32, device=dev)
    return code, a, b, counts, scratch


def _count_jump(counted, rounds, counts):
    """Count a jump walk's launch on ``counted``, set ``counted.rounds``
    (R) and ``counted.pending`` (a device tensor: ``pending[k]`` cells
    entered round k), and add R to the open span's counter ``rounds``."""
    counted.launches += 1
    counted.rounds = rounds
    counted.pending = counts[: rounds + 1]
    timing.count("rounds", rounds)


# K4's counters: the launches of ``launch_flow_walk`` by :func:`flow_cuda`,
# and its last R (``rounds``) and ``pending`` cells, as :func:`_count_jump`
# sets them (read by ``ops.cuda.launch_counters`` and the benchmark).
flow_walk = types.SimpleNamespace(launches=0, rounds=0, pending=None)


def absorbing_walk(fdr_eff, code0, max_steps):
    """(code, a, b) int32 of a block's local walk: ``code0`` holds the
    absorber's local index at every absorbing cell, UNRES elsewhere; where
    no absorber is reached within ``max_steps``, (UNRES, 0, 0).  Counted by
    :func:`_count_jump`."""
    _check_jump_max_steps(max_steps)
    if not code0.is_cuda:
        return _flow.doubling_walk(fdr_eff, code0, max_steps)
    shape = tuple(code0.shape)
    dev = code0.device
    code, a, b, counts, scratch = _jump_buffers(fdr_eff, code0)
    rounds = ctypes.c_int(0)
    with torch.cuda.device(dev):
        build.launch(
            "launch_jump_walk", fdr_eff.data_ptr(), code0.data_ptr(), code.data_ptr(),
            a.data_ptr(), b.data_ptr(), counts.data_ptr(), counts.numel(), scratch.data_ptr(),
            shape[0], shape[1], int(max_steps), ctypes.byref(rounds), build.stream_handle(dev),
        )
    _count_jump(absorbing_walk, rounds.value, counts)
    return code, a, b


absorbing_walk.launches = 0
absorbing_walk.rounds = 0
absorbing_walk.pending = None


def downslope_cuda(dem, fdr, px, elevation_difference, max_steps):
    """Downslope index through :func:`downslope_walk` (one launch where dem
    is float32 already)."""
    dem_f = dem.to(torch.float32).contiguous()
    return downslope_walk(dem_f, fdr, px, elevation_difference, max_steps)


# river dtypes the flow entry reads as they are: one byte a cell, 1 a river.
RIVER_DTYPES = (torch.int8, torch.uint8, torch.bool)
_I32 = torch.iinfo(torch.int32)


def flow_operands(fdr, river):
    """(fdr, river) as ``launch_flow_walk`` reads them, on the rasters'
    device: fdr uint8 and int32 as they are, any other integer dtype as
    int32 with every value int32 cannot hold set to -1 (like it, non-zero
    and outside the D8 set); river int8, uint8 and bool as they are (the
    byte 1 is a river), any other dtype as uint8 ``river == 1``.  Every
    cell keeps its role under ``flow.flow_states``."""
    if fdr.dtype not in FDR_DTYPES:
        if fdr.is_floating_point() or fdr.is_complex() or fdr.dtype == torch.bool:
            raise ValueError(f"fdr: expected an integer dtype, got {fdr.dtype}")
        info = torch.iinfo(fdr.dtype)
        if info.min < _I32.min or info.max > _I32.max:
            fdr = torch.where((fdr >= _I32.min) & (fdr <= _I32.max), fdr, -1)
        fdr = fdr.to(torch.int32)
    if river.dtype not in RIVER_DTYPES:
        river = (river == 1).to(torch.uint8)
    return fdr.contiguous(), river.contiguous()


def flow_cuda(fdr, river, px, max_steps):
    """(fdist f32, indices int32) of the in-core flow walk.

    On the card one C entry, ``launch_flow_walk``, queued with no host
    read: a memset, phase 1 reading fdr and river as :func:`flow_operands`
    gives them, R rounds, and ``flow_finish_kernel``.  Counted as a launch
    of ``flow_walk``, whose ``rounds`` and ``pending`` it sets; adds R to
    the open span's counter ``rounds`` and 1 to ``fused``.  On the CPU the
    plain engine, through ``walk_inputs`` and ``flow_from_state``.  Refuses
    ``max_steps >= 2^30`` on any device."""
    _check_jump_max_steps(max_steps)
    if not fdr.is_cuda:
        state = _flow.doubling_walk(*_flow.walk_inputs(fdr, river), max_steps)
        return _flow.flow_from_state(*state, px, max_steps)
    rows, cols = fdr.shape
    n = rows * cols
    if n >= _flow.I32_IDX_LIMIT:
        raise ValueError(f"{n} cells overflow flat int32 indices")
    fdr, river = flow_operands(fdr, river)
    build.check_cuda_tensor(river, "river", river.dtype, (rows, cols))
    dev = fdr.device
    fdist = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    indices = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    counts = torch.empty(_JUMP_COUNTS, dtype=torch.int32, device=dev)  # zeroed by the launcher
    # The jump walk's 28 B a cell, then code, a and b: 40 B a cell.
    scratch = torch.empty(10 * n, dtype=torch.int32, device=dev)
    c_card, c_diag = _flow.step_consts(px)
    rounds = ctypes.c_int(0)
    with torch.cuda.device(dev):
        build.launch(
            "launch_flow_walk", fdr.data_ptr(), int(fdr.dtype == torch.int32), river.data_ptr(),
            fdist.data_ptr(), indices.data_ptr(), counts.data_ptr(), counts.numel(),
            scratch.data_ptr(), rows, cols, int(max_steps), c_card, c_diag, ctypes.byref(rounds),
            build.stream_handle(dev),
        )
    _count_jump(flow_walk, rounds.value, counts)
    timing.count("fused")
    return fdist, indices


def fold_width():
    """W, the depths of one band of the anchored fold (``csrc/flow_fold.cu``
    kFoldW)."""
    return build.library().fold_band_width()


def flow_walk_blocked(fdr_eff, code0, c_card, c_diag, max_steps):
    """(code int32, dist f32) of the fold walk: the absorber's code and the
    right fold of the step lengths ``c_card`` / ``c_diag`` along the path;
    (UNRES, 0) where no absorber is reached within ``max_steps``.

    The anchored fold: the jump walk gives every cell's code and depth t;
    each cell folds its first ((t - 1) mod W) + 1 steps onto the anchor
    they reach, at a depth that is a multiple of W; after one host read,
    the cells deeper than W are folded in K rounds, band by band of W
    depths, each onto an anchor an earlier launch finished.  Sets, for the
    last call, ``flow_walk_blocked.rounds`` (K), ``.pending`` (the cells
    folded in rounds), ``.jump_rounds`` (the jump walk's R) and
    ``.jump_pending`` (a device tensor: the cells entering each of the
    jump walk's rounds, as ``absorbing_walk.pending``).  Refuses
    ``max_steps >= 2^30`` on any device, as the jump walk does."""
    _check_jump_max_steps(max_steps)
    if not code0.is_cuda:
        return _flow.fold_walk(fdr_eff, code0, c_card, c_diag, max_steps)
    shape = tuple(code0.shape)
    dev = code0.device
    # a and b are scratch here; the fold reuses the jump walk's scratch.
    code, a, b, counts, scratch = _jump_buffers(fdr_eff, code0)
    dist = torch.empty(shape, dtype=torch.float32, device=dev)
    # [P, K], a histogram (then cursors) and offsets over the bands a depth
    # within the cap can reach.
    k_cap = max(min(int(max_steps), code0.numel()) - 1, 0) // fold_width()
    bands = torch.empty(3 + 2 * k_cap, dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        build.launch(
            "launch_flow_walk_blocked",
            fdr_eff.data_ptr(), code0.data_ptr(), code.data_ptr(), dist.data_ptr(),
            a.data_ptr(), b.data_ptr(), counts.data_ptr(), counts.numel(), scratch.data_ptr(),
            bands.data_ptr(), bands.numel(), shape[0], shape[1], float(np.float32(c_card)),
            float(np.float32(c_diag)), int(max_steps), info, build.stream_handle(dev),
        )
    flow_walk_blocked.launches += 1
    flow_walk_blocked.jump_rounds, flow_walk_blocked.pending, flow_walk_blocked.rounds = info
    flow_walk_blocked.jump_pending = counts[: info[0] + 1]
    return code, dist


flow_walk_blocked.launches = 0
flow_walk_blocked.rounds = 0
flow_walk_blocked.pending = 0
flow_walk_blocked.jump_rounds = 0
flow_walk_blocked.jump_pending = None


def flow_blocked_cuda(fdr, river, px, max_steps):
    """(fdist, indices) through :func:`flow_walk_blocked`."""
    fdr_eff, code0 = _flow.walk_inputs(fdr, river)
    code, dist = flow_walk_blocked(fdr_eff, code0, *_flow.step_consts(px), max_steps)
    return _flow.flow_from_fold(code, dist)
