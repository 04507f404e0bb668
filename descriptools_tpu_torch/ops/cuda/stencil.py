"""Stencil stage: slope, slope_rad, TWI and modified TWI in one pass.

Wrappers of ``csrc/stencil.cu``:

- :func:`stencil` (a whole grid) replaces the TPU kernel
  ``descriptools_tpu/ops/pallas/stencil.py::_fused_kernel``, extended to
  all four rasters of the stage; its plain version is :func:`stencil_plain`;
- :func:`stencil_padded` (the interior of a 1-ring-padded block, as a tile
  with its neighbours' ring) replaces ``stencil.py::_slope_kernel`` and
  emits the same four rasters; its plain version is
  :func:`stencil_padded_plain`.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version, the same function in torch ops.  There is no other
fallback.
"""

import ctypes

import numpy as np
import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.cuda import build
from descriptools_tpu_torch.ops.slope import slope, slope_divisors, slope_from_padded
from descriptools_tpu_torch.ops.topo import (
    modified_topographic_index,
    topographic_index,
)

NAMES = ("slope", "slope_rad", "twi", "mod_twi")


def _stage_tail(sl, dem_f, fac, px, n_topo):
    """(slope, slope_rad, twi, mod_twi) from the slope and its DEM."""
    sl_rad = torch.where(
        dem_f == NODATA, float(NODATA), torch.atan(sl / torch.tensor(100.0, device=sl.device))
    )
    twi = topographic_index(fac, sl_rad, px)
    mtwi = modified_topographic_index(fac, sl_rad, px, n_topo)
    return sl, sl_rad, twi, mtwi


def stencil_plain(dem_f, fac, px, n_topo):
    """The stage in torch ops: (slope, slope_rad, twi, mod_twi)."""
    return _stage_tail(slope(dem_f, px), dem_f, fac, px, n_topo)


def stencil_padded_plain(padded, fac, px, n_topo):
    """The stage in torch ops for the interior of a 1-ring-padded block."""
    return _stage_tail(slope_from_padded(padded, px), padded[1:-1, 1:-1], fac, px, n_topo)


def _launch(entry, dem_f, fac, shape, px, n_topo):
    fac = fac.to(torch.float32).contiguous()
    build.check_cuda_tensor(fac, "fac", torch.float32, shape)
    outs = [torch.empty(shape, dtype=torch.float32, device=dem_f.device) for _ in NAMES]
    divisors = (ctypes.c_float * 8)(*slope_divisors(px))
    with torch.cuda.device(dem_f.device):
        build.launch(
            entry, dem_f.data_ptr(), fac.data_ptr(), *(o.data_ptr() for o in outs),
            shape[0], shape[1], ctypes.cast(divisors, ctypes.c_void_p),
            float(np.float32(px * px)), float(np.float32(n_topo)),
            build.stream_handle(dem_f.device),
        )
    return tuple(outs)


def stencil(dem_f, fac, px, n_topo):
    """(slope, slope_rad, twi, mod_twi) of a float32 DEM and its fac.

    CUDA tensors: one launch of the stencil kernel.  CPU tensors: the plain
    torch version."""
    if not dem_f.is_cuda:
        return stencil_plain(dem_f, fac, px, n_topo)
    shape = tuple(dem_f.shape)
    build.check_cuda_tensor(dem_f, "dem_f", torch.float32, shape)
    outs = _launch("launch_stencil", dem_f, fac, shape, px, n_topo)
    stencil.launches += 1
    return outs


stencil.launches = 0


def stencil_padded(padded, fac, px, n_topo):
    """(slope, slope_rad, twi, mod_twi) of the R x C interior of a float32
    (R+2) x (C+2) block whose ring holds real neighbours or NoData; ``fac``
    is the interior's.

    CUDA tensors: one launch of the padded stencil kernel.  CPU tensors: the
    plain torch version."""
    if not padded.is_cuda:
        return stencil_padded_plain(padded, fac, px, n_topo)
    shape = (padded.shape[0] - 2, padded.shape[1] - 2)
    build.check_cuda_tensor(padded, "padded", torch.float32, (shape[0] + 2, shape[1] + 2))
    outs = _launch("launch_stencil_padded", padded, fac, shape, px, n_topo)
    stencil_padded.launches += 1
    return outs


stencil_padded.launches = 0
