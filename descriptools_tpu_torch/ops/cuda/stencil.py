"""Stencil stage: slope, slope_rad, TWI and modified TWI in one pass.

Wrappers of ``csrc/stencil.cu``:

- :func:`stencil` (a whole grid) replaces the TPU kernel
  ``descriptools_tpu/ops/pallas/stencil.py::_fused_kernel``, extended to
  all four rasters of the stage; its plain version is :func:`stencil_plain`;
- :func:`stencil_padded` (the interior of a 1-ring-padded block, as a tile
  with its neighbours' ring) replaces ``stencil.py::_slope_kernel`` and
  emits the same four rasters; its plain version is
  :func:`stencil_padded_plain`.

Both launch one kernel body, ``stencil_tile_kernel``, which takes the
slope in two divisions (:func:`slope_divisor_pair`) and reads fac as int32
or float32 (:func:`fac_operand`).  On a CUDA tensor each wrapper launches
its kernel; on a CPU tensor it runs its plain version, the same function in
torch ops.  There is no other fallback.
"""

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
FAC_DTYPES = (torch.int32, torch.float32)  # the kernel reads these as they are


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


def slope_divisor_pair(px):
    """The slope's (cardinal, diagonal) divisors.  The kernel divides once
    per group, by the least valid neighbour, which is bitwise the 8
    divisions only if each group has one positive divisor: raises
    ``ValueError`` otherwise."""
    div = slope_divisors(px)
    card, diag = div[0], div[1]
    if not all(d == (card, diag)[k % 2] and d > 0 for k, d in enumerate(div)):
        raise ValueError(f"stencil: the slope divisors {div} are not one positive value for the "
                         "cardinal neighbours and one for the diagonal ones")
    return card, diag


def fac_operand(fac):
    """fac as the kernel reads it: int32 and float32 as they are, any other
    dtype cast to float32, as the plain version's ``fac.to(float32)``."""
    if fac.dtype not in FAC_DTYPES:
        fac = fac.to(torch.float32)
    return fac.contiguous()


def _launch(entry, dem_f, fac, shape, px, n_topo):
    d_card, d_diag = slope_divisor_pair(px)
    fac = fac_operand(fac)
    build.check_cuda_tensor(fac, "fac", fac.dtype, shape)
    outs = [torch.empty(shape, dtype=torch.float32, device=dem_f.device) for _ in NAMES]
    with torch.cuda.device(dem_f.device):
        build.launch(
            entry, dem_f.data_ptr(), fac.data_ptr(), int(fac.dtype == torch.int32),
            *(o.data_ptr() for o in outs), shape[0], shape[1], float(d_card), float(d_diag),
            float(np.float32(px * px)), float(np.float32(n_topo)),
            build.stream_handle(dem_f.device),
        )
    return tuple(outs)


def stencil(dem_f, fac, px, n_topo):
    """(slope, slope_rad, twi, mod_twi) of a float32 DEM and its fac.

    CUDA tensors: one launch of the stencil kernel.  CPU tensors: the plain
    torch version.  Either raises unless ``slope_divisor_pair(px)`` holds."""
    if not dem_f.is_cuda:
        slope_divisor_pair(px)
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
    plain torch version.  Either raises unless ``slope_divisor_pair(px)``
    holds."""
    if not padded.is_cuda:
        slope_divisor_pair(px)
        return stencil_padded_plain(padded, fac, px, n_topo)
    shape = (padded.shape[0] - 2, padded.shape[1] - 2)
    build.check_cuda_tensor(padded, "padded", torch.float32, (shape[0] + 2, shape[1] + 2))
    outs = _launch("launch_stencil_padded", padded, fac, shape, px, n_topo)
    stencil_padded.launches += 1
    return outs


stencil_padded.launches = 0

