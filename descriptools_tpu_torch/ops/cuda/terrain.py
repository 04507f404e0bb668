"""Terrain's D8 stencil and flow accumulation on the card.

Wrappers of ``csrc/terrain.cu`` and ``csrc/accumulation.cu``, for
``ops.terrain.derive_terrain``: :func:`d8_successor` gives each cell of a
DEM its D8 code and its successor in one pass, and :func:`accumulation`
counts each cell's upstream cells from that successor by level doubling.
No TPU kernel corresponds: the JAX package's D8 and accumulation are
``jnp`` (``descriptools_tpu/d8.py:75``, ``descriptools_tpu/ops/terrain.py:37``).
On a CUDA tensor each launches its kernels; on a CPU tensor it runs its
plain version (:func:`d8_successor_plain`: ``d8.d8_flow_direction``, then
``d8.sink_successor``; :func:`accumulation_plain`: the rounds in torch),
which gives the same integers.  There is no other fallback.
"""

import numpy as np
import torch

from descriptools_tpu_torch.constants import D8_STEP, NODATA
from descriptools_tpu_torch.d8 import d8_flow_direction, sink_successor
from descriptools_tpu_torch.ops.cuda import build
from descriptools_tpu_torch.ops.flow import I32_IDX_LIMIT
from descriptools_tpu_torch.utils import timing

# DEM dtypes the kernel reads as they are, and their codes in ``launch_d8``;
# any other dtype is cast to float32 first, as the plain version does.
DEM_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int16: 2}
# The kernel divides each diagonal drop by this step and takes a cardinal
# drop undivided: ``D8_STEP`` is 1 and float32 sqrt(2) in turn.
STEP_DIAG = float(D8_STEP[1])


def d8_successor_plain(dem, nodata=NODATA):
    """(fdr, succ), both int32 (rows, cols): ``d8.d8_flow_direction`` and
    its ``d8.sink_successor``."""
    fdr = d8_flow_direction(dem, nodata=nodata)
    return fdr, sink_successor(fdr)


def d8_successor(dem, nodata=NODATA):
    """(fdr, succ) of :func:`d8_successor_plain` for a 2-D DEM.

    CUDA tensors: one launch of the D8 kernel, the DEM read as it is if it
    is int16, int32 or float32 (another dtype is cast to float32 first),
    and it must be contiguous; counted in ``d8_successor.launches`` and as
    1 in the open span's counter ``fused``.  CPU tensors: the plain
    version.  Raises for grids of 2^31 cells or more."""
    if dem.dim() != 2:
        raise ValueError(f"d8_successor: expected a 2-D DEM, got shape {tuple(dem.shape)}")
    rows, cols = dem.shape
    if rows * cols >= I32_IDX_LIMIT:
        raise ValueError(f"{rows * cols} cells overflow flat int32 indices")
    if not dem.is_cuda:
        return d8_successor_plain(dem, nodata)
    if dem.dtype not in DEM_DTYPES:
        dem = dem.to(torch.float32)
    build.check_cuda_tensor(dem, "dem", dem.dtype, (rows, cols))
    dev = dem.device
    fdr = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    succ = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        build.launch(
            "launch_d8", dem.data_ptr(), DEM_DTYPES[dem.dtype], fdr.data_ptr(), succ.data_ptr(),
            rows, cols, float(np.float32(nodata)), STEP_DIAG, build.stream_handle(dev),
        )
    d8_successor.launches += 1
    timing.count("fused")
    return fdr, succ


d8_successor.launches = 0


def _check_succ(succ):
    """Raise unless ``succ`` is a contiguous int32 successor of fewer than
    2^31 cells."""
    if succ.numel() >= I32_IDX_LIMIT:
        raise ValueError(f"{succ.numel()} cells overflow flat int32 indices")
    if succ.dtype != torch.int32:
        raise ValueError(f"succ: expected torch.int32, got {succ.dtype}")
    if not succ.is_contiguous():
        raise ValueError("succ: expected a contiguous tensor")


def accumulation_plain(succ, levels):
    """(fac, live) of level doubling in torch: ``fac`` (int32, succ's shape
    flattened) each cell's strict upstream-cell count, ``live`` the cells
    still live entering each round run.  ``succ`` is each cell's flat
    successor, ``n`` (the sink) where it has none, as ``d8.sink_successor``
    gives it; the rounds jump it in place.  At most ``levels`` rounds, each
    over the cells whose successor is not the sink, a list whose length the
    host reads once to start and once a round (counted in the open span's
    ``host_reads``)."""
    _check_succ(succ)
    succ = succ.view(-1)
    n = succ.numel()
    f = torch.zeros(n, dtype=torch.int32, device=succ.device)
    live = torch.nonzero(succ != n).reshape(-1)  # the host reads its length
    timing.count("host_reads")
    to = succ[live]
    f.index_add_(0, to, torch.ones_like(to))
    counts = []
    while len(counts) < levels and live.numel():
        counts.append(live.numel())
        f.index_add_(0, to, f[live])
        to = succ[to]
        succ[live] = to
        keep = torch.nonzero(to != n).reshape(-1)  # the host reads its length
        live, to = live[keep], to[keep]
        timing.count("host_reads")
    return f, counts


def accumulation(succ, levels):
    """(fac, live) of :func:`accumulation_plain`, bitwise.

    CUDA tensors: one C entry, ``launch_accumulation``: memsets, the init
    pass and exactly ``levels`` rounds of two kernels, over every cell while
    more than half are live and then over a list of int32 pairs kept on the
    card; the live counts are read once, after the last round.  Counted in
    ``accumulation.launches`` and as 1 in the open span's counters
    ``fused`` and ``host_reads``.  CPU tensors: the plain version.
    ``succ`` must be int32 and contiguous, of fewer than 2^31 cells, on any
    device."""
    _check_succ(succ)
    if not succ.is_cuda:
        return accumulation_plain(succ, levels)
    n = succ.numel()
    dev = succ.device
    fac = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(2 * levels + 1, dtype=torch.int32, device=dev)  # zeroed by the launcher
    # v and the successor's twin (an int a cell each), then two lists of ceil(n / 2)
    # (cell, successor) pairs.
    scratch = torch.empty(2 * n + 4 * ((n + 1) // 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        build.launch(
            "launch_accumulation", succ.data_ptr(), fac.data_ptr(), counts.data_ptr(), counts.numel(),
            scratch.data_ptr(), 1, n, int(levels), build.stream_handle(dev),
        )
    accumulation.launches += 1
    timing.count("fused")
    live = [c for c in counts[:levels].tolist() if c]  # the one host read
    timing.count("host_reads")
    return fac, live


accumulation.launches = 0
