"""Terrain's D8 stencil on the card.

Wrapper of ``csrc/terrain.cu``: :func:`d8_successor` gives each cell of a
DEM its D8 code and its successor in one pass, for
``ops.terrain.derive_terrain``.  No TPU kernel corresponds: the JAX
package's D8 is ``jnp`` (``descriptools_tpu/d8.py:75``).  On a CUDA tensor
it launches ``d8_kernel``; on a CPU tensor it runs its plain version,
:func:`d8_successor_plain` (``d8.d8_flow_direction``, then
``d8.sink_successor``), which gives the same integers.  There is no other
fallback.
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
