"""The downslope and flow walks on the card.

Wrappers of ``csrc/walk.cu``, one serial walk per CUDA thread:

- :func:`downslope_walk` replaces ``descriptools_tpu/ops/pallas/walk_vmem.py
  ::_downslope_kernel``; its plain version is
  ``ops.downslope.jacobi_walk``.  The serial walk is exact for any fdr,
  so the JAX wrapper's monotone-descent probe and its fallback branch have
  no counterpart here.
- :func:`flow_walk` replaces ``walk_vmem.py::_walk2_kernel``; its plain
  version is ``ops.flow.doubling_walk``.  The step counts are two separate
  int32 rasters, so no path can overflow them and the JAX packed-count
  guard with its ``_walk3_kernel`` fallback has no counterpart here.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version.  There is no other fallback.  The operands are built and
the results finished in torch ops shared with the plain engines
(``walk_inputs`` before, ``*_from_state`` after), so every engine's output
is bitwise the same function of the walk state.
"""

import numpy as np
import torch

from descriptools_tpu_torch.ops import downslope as _down
from descriptools_tpu_torch.ops import flow as _flow
from descriptools_tpu_torch.ops.cuda import build


def downslope_walk(fdr_eff, z, zt0, elevation_difference, max_steps):
    """(pk int32, Zt f32) at each cell's downslope stop."""
    if not z.is_cuda:
        return _down.jacobi_walk(fdr_eff, z, zt0, elevation_difference, max_steps)
    _down.check_max_steps(max_steps)
    shape = tuple(z.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(z, "z", torch.float32, shape)
    build.check_cuda_tensor(zt0, "zt0", torch.float32, shape)
    pk = torch.empty(shape, dtype=torch.int32, device=z.device)
    zt = torch.empty_like(z)
    with torch.cuda.device(z.device):
        build.launch(
            "launch_downslope_walk",
            fdr_eff.data_ptr(), z.data_ptr(), zt0.data_ptr(), pk.data_ptr(),
            zt.data_ptr(), shape[0], shape[1],
            float(np.float32(elevation_difference)), int(max_steps),
            build.stream_handle(z.device),
        )
    downslope_walk.launches += 1
    return pk, zt


downslope_walk.launches = 0


def flow_walk(fdr_eff, code0, max_steps):
    """(code, a, b) int32: absorber code and cardinal/diagonal step counts."""
    if not code0.is_cuda:
        return _flow.doubling_walk(fdr_eff, code0, max_steps)
    shape = tuple(code0.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(code0, "code0", torch.int32, shape)
    code, a, b = (torch.empty_like(code0) for _ in range(3))
    with torch.cuda.device(code0.device):
        build.launch(
            "launch_flow_walk",
            fdr_eff.data_ptr(), code0.data_ptr(), code.data_ptr(), a.data_ptr(),
            b.data_ptr(), shape[0], shape[1], int(max_steps),
            build.stream_handle(code0.device),
        )
    flow_walk.launches += 1
    return code, a, b


flow_walk.launches = 0


def downslope_cuda(dem, fdr, px, elevation_difference, max_steps):
    """Downslope index through :func:`downslope_walk`."""
    fdr_eff, z, zt0 = _down.walk_inputs(dem, fdr, px)
    pk, zt = downslope_walk(fdr_eff, z, zt0, elevation_difference, max_steps)
    return _down.downslope_from_state(z, pk, zt, px)


def flow_cuda(fdr, river, px, max_steps):
    """(fdist, indices) through :func:`flow_walk`."""
    fdr_eff, code0 = _flow.walk_inputs(fdr, river)
    code, a, b = flow_walk(fdr_eff, code0, max_steps)
    return _flow.flow_from_state(code, a, b, px, max_steps)
