"""Stencil stage: slope, slope_rad, TWI and modified TWI in one pass.

Wrapper of ``csrc/stencil.cu`` (replaces the TPU kernel
``descriptools_tpu/ops/pallas/stencil.py::_fused_kernel``, extended to all
four rasters of the stage).  On a CUDA tensor :func:`stencil` launches the
kernel; on a CPU tensor it runs :func:`stencil_plain`, the same function in
torch ops.  There is no other fallback.
"""

import ctypes

import numpy as np
import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.ops.cuda import build
from descriptools_tpu_torch.ops.slope import slope, slope_divisors
from descriptools_tpu_torch.ops.topo import (
    modified_topographic_index,
    topographic_index,
)

NAMES = ("slope", "slope_rad", "twi", "mod_twi")


def stencil_plain(dem_f, fac, px, n_topo):
    """The stage in torch ops: (slope, slope_rad, twi, mod_twi)."""
    sl = slope(dem_f, px)
    sl_rad = torch.where(
        dem_f == NODATA, float(NODATA), torch.atan(sl / torch.tensor(100.0, device=sl.device))
    )
    twi = topographic_index(fac, sl_rad, px)
    mtwi = modified_topographic_index(fac, sl_rad, px, n_topo)
    return sl, sl_rad, twi, mtwi


def stencil(dem_f, fac, px, n_topo):
    """(slope, slope_rad, twi, mod_twi) of a float32 DEM and its fac.

    CUDA tensors: one launch of the stencil kernel.  CPU tensors: the plain
    torch version."""
    if not dem_f.is_cuda:
        return stencil_plain(dem_f, fac, px, n_topo)
    shape = tuple(dem_f.shape)
    build.check_cuda_tensor(dem_f, "dem_f", torch.float32, shape)
    fac = fac.to(torch.float32).contiguous()
    build.check_cuda_tensor(fac, "fac", torch.float32, shape)
    outs = [torch.empty_like(dem_f) for _ in NAMES]
    divisors = (ctypes.c_float * 8)(*slope_divisors(px))
    with torch.cuda.device(dem_f.device):
        build.launch(
            "launch_stencil",
            dem_f.data_ptr(), fac.data_ptr(), *(o.data_ptr() for o in outs),
            shape[0], shape[1], ctypes.cast(divisors, ctypes.c_void_p),
            float(np.float32(px * px)), float(np.float32(n_topo)),
            build.stream_handle(dem_f.device),
        )
    stencil.launches += 1
    return tuple(outs)


stencil.launches = 0
