"""The downslope, flow and absorbing walks on the card.

Wrappers of ``csrc/walk.cu``, one serial walk per CUDA thread:

- :func:`downslope_walk` replaces ``descriptools_tpu/ops/pallas/walk_vmem.py
  ::_downslope_kernel``; its plain version is
  ``ops.downslope.jacobi_walk``.  The serial walk is exact for any fdr,
  so the JAX wrapper's monotone-descent probe and its fallback branch have
  no counterpart here.
- :func:`downslope_walk_tracked` replaces ``descriptools_tpu/ops/pallas/
  walk.py::_downslope_kernel`` (the blocked tier with truncation flags)
  and the ``trunc0`` mode of ``walk_vmem.py::_downslope_kernel``; its plain
  version is ``ops.downslope.jacobi_walk(..., trunc0=)``.
- :func:`flow_walk` replaces ``walk_vmem.py::_walk2_kernel``; its plain
  version is ``ops.flow.doubling_walk``.  The step counts are two separate
  int32 rasters, so no path can overflow them and the JAX packed-count
  guard with its ``_walk3_kernel`` fallback has no counterpart here.
- :func:`absorbing_walk` replaces the generic absorbing walks
  ``walk_vmem.py::_walk3_kernel`` and ``walk.py::_walk3_kernel`` (the
  local phase of ``parallel.boundary``); its plain version is
  ``ops.flow.doubling_walk`` on the same operands.
- :func:`flow_walk_blocked` (``csrc/flow_fold.cu``) replaces
  ``walk.py::_flow_kernel``, the JAX blocked flow tier; its plain version
  is ``ops.flow.fold_walk``.  It forms fdist as the right fold of the step
  lengths, as that tier does, where :func:`flow_walk` gives counts.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version.  There is no other fallback.  The operands are built and
the results finished in torch ops shared with the plain engines
(``walk_inputs`` before, ``*_from_state`` after), so every engine's output
is bitwise the same function of the walk state.
"""

import ctypes

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


def downslope_walk_tracked(fdr_eff, z, zt0, elevation_difference, max_steps, trunc0):
    """(pk int32, Zt f32, trunc bool) at each cell's downslope stop; trunc
    marks walks that stopped at a terminal ``trunc0`` (bool) marks."""
    if not z.is_cuda:
        return _down.jacobi_walk(fdr_eff, z, zt0, elevation_difference, max_steps, trunc0)
    _down.check_max_steps(max_steps)
    shape = tuple(z.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(z, "z", torch.float32, shape)
    build.check_cuda_tensor(zt0, "zt0", torch.float32, shape)
    build.check_cuda_tensor(trunc0, "trunc0", torch.bool, shape)
    pk = torch.empty(shape, dtype=torch.int32, device=z.device)
    zt = torch.empty_like(z)
    trunc = torch.empty_like(trunc0)  # bool: one byte, written 0 or 1
    with torch.cuda.device(z.device):
        build.launch(
            "launch_downslope_walk_tracked",
            fdr_eff.data_ptr(), z.data_ptr(), zt0.data_ptr(), trunc0.data_ptr(),
            pk.data_ptr(), zt.data_ptr(), trunc.data_ptr(), shape[0], shape[1],
            float(np.float32(elevation_difference)), int(max_steps),
            build.stream_handle(z.device),
        )
    downslope_walk_tracked.launches += 1
    return pk, zt, trunc


downslope_walk_tracked.launches = 0


def _absorber_walk(entry, counted, fdr_eff, code0, max_steps):
    """Launch ``entry`` (flow or absorbing walk): (code, a, b) int32."""
    shape = tuple(code0.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(code0, "code0", torch.int32, shape)
    code, a, b = (torch.empty_like(code0) for _ in range(3))
    with torch.cuda.device(code0.device):
        build.launch(
            entry, fdr_eff.data_ptr(), code0.data_ptr(), code.data_ptr(), a.data_ptr(),
            b.data_ptr(), shape[0], shape[1], int(max_steps),
            build.stream_handle(code0.device),
        )
    counted.launches += 1
    return code, a, b


def flow_walk(fdr_eff, code0, max_steps):
    """(code, a, b) int32: absorber code and cardinal/diagonal step counts."""
    if not code0.is_cuda:
        return _flow.doubling_walk(fdr_eff, code0, max_steps)
    return _absorber_walk("launch_flow_walk", flow_walk, fdr_eff, code0, max_steps)


flow_walk.launches = 0


def absorbing_walk(fdr_eff, code0, max_steps):
    """(code, a, b) int32 of a block's local walk: ``code0`` holds the
    absorber's local index at every absorbing cell, UNRES elsewhere; where
    no absorber is reached within ``max_steps``, (UNRES, 0, 0)."""
    if not code0.is_cuda:
        return _flow.doubling_walk(fdr_eff, code0, max_steps)
    return _absorber_walk("launch_absorbing_walk", absorbing_walk, fdr_eff, code0, max_steps)


absorbing_walk.launches = 0


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


FOLD_TILE = 64  # interior side of a flow_fold.cu block (kTile)


def flow_walk_blocked(fdr_eff, code0, c_card, c_diag, max_steps):
    """(code int32, dist f32) of the fold walk: the absorber's code and the
    right fold of the step lengths ``c_card`` / ``c_diag`` along the path;
    (UNRES, 0) where no absorber is reached within ``max_steps``.

    The kernel is launched once per 16 sweeps until a launch resolves
    nothing; ``flow_walk_blocked.rounds`` holds the number of launches of
    the last call."""
    if not code0.is_cuda:
        return _flow.fold_walk(fdr_eff, code0, c_card, c_diag, max_steps)
    shape = tuple(code0.shape)
    build.check_cuda_tensor(fdr_eff, "fdr_eff", torch.int32, shape)
    build.check_cuda_tensor(code0, "code0", torch.int32, shape)
    code, code_b = torch.empty_like(code0), torch.empty_like(code0)
    dist = torch.empty(shape, dtype=torch.float32, device=code0.device)
    dist_b = torch.empty_like(dist)
    blocks = -(-shape[0] // FOLD_TILE) * -(-shape[1] // FOLD_TILE)
    flags = torch.empty(2 * blocks + 1, dtype=torch.int32, device=code0.device)
    rounds = ctypes.c_int(0)
    with torch.cuda.device(code0.device):
        build.launch(
            "launch_flow_walk_blocked",
            fdr_eff.data_ptr(), code0.data_ptr(), code.data_ptr(), dist.data_ptr(),
            code_b.data_ptr(), dist_b.data_ptr(), flags.data_ptr(), flags.numel(),
            shape[0], shape[1], float(np.float32(c_card)), float(np.float32(c_diag)),
            int(max_steps), ctypes.byref(rounds), build.stream_handle(code0.device),
        )
    flow_walk_blocked.launches += 1
    flow_walk_blocked.rounds = rounds.value
    return code, dist


flow_walk_blocked.launches = 0
flow_walk_blocked.rounds = 0


def flow_blocked_cuda(fdr, river, px, max_steps):
    """(fdist, indices) through :func:`flow_walk_blocked`."""
    fdr_eff, code0 = _flow.walk_inputs(fdr, river)
    code, dist = flow_walk_blocked(fdr_eff, code0, *_flow.step_consts(px), max_steps)
    return _flow.flow_from_fold(code, dist)
