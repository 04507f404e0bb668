"""Drop-in API compatibility with the reference toolbox, over the port.

Counterpart of ``descriptools_tpu/compat.py``: every public entry point of
JVBSouza/descriptools with the reference signatures, NumPy in and NumPy
out, mapped onto the port's torch ops:

    reference                      here
    ---------                      ----
    helpers.divisor                divisor                (helpers.py:5)
    slope.sloper                   sloper                 (slope.py:96)
    topoindexes.topographic_index  topographic_index      (topoindexes.py:109)
    downslope.downsloper           downsloper             (downslope.py:317)
    flowhand.flow_hand_index       flow_hand_index        (flowhand.py:242)
    flowhand.hand_calculator       hand_calculator        (flowhand.py:414)
    flowhand.index_calculator      index_calculator       (flowhand.py:445)
    gfi.gfi_calculator             gfi_calculator         (gfi.py:150)
    gfi.ln_hl_H_calculator         ln_hl_H_calculator     (gfi.py:297)
    gfi.river_accumulation         river_accumulation     (gfi.py:118)
    evaluation.minMaxScale         minMaxScale            (evaluation.py:5)
    evaluation.calibration         calibration            (evaluation.py:12)
    evaluation.binary_map          binary_map             (evaluation.py:90)
    evaluation.avaliacao           avaliacao              (evaluation.py:126)
    evaluation.correctness         correctness            (evaluation.py:174)
    evaluation.fit                 fit                    (evaluation.py:194)

The raster entry points take a keyword-only ``device``: the card unless
the caller asks for ``"cpu"``; they raise where no CUDA device is
available.  On the card, ``downsloper`` runs the downslope kernel and
``flow_hand_index`` the jump-walk kernel.  The evaluation entry points,
``divisor`` and ``index_calculator`` run on the host in numpy (float64),
as the reference and the JAX ``compat`` run them, and take no device.

Rasters are computed in the dtypes the JAX ``compat`` computes them in
(64-bit inputs demoted to 32 bits, ``placement.as_jax_dtypes``), so the
values are JAX's; HAND is returned in the dem's numpy dtype, where JAX's
is 32-bit (a documented departure: ``compat`` keeps numpy's dtypes).

The ``division_column`` / ``division_row`` arguments exist in the reference
only to fit tiles in GPU memory; here the whole grid is device-resident,
so they are accepted and ignored (the reference's tiling is
result-invariant).
"""

import numpy as np
import torch

from descriptools_tpu_torch import evaluation as _ev
from descriptools_tpu_torch import oracle as _oracle
from descriptools_tpu_torch import ops as _ops
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.placement import as_jax_dtypes, check_device


def _t(a, device, dtype=None):
    return torch.as_tensor(as_jax_dtypes(np.asarray(a, dtype))[0], device=device)


def _np(*tensors):
    out = tuple(t.cpu().numpy() for t in tensors)
    return out if len(out) > 1 else out[0]


def divisor(row_length, column_length, row_division, column_division):
    """Interior tile-boundary rows/cols: floor((i+1)*len/(div+1))."""
    boundary_row = np.array(
        [(i + 1) * row_length // (row_division + 1) for i in range(row_division)],
        dtype=int,
    )
    boundary_column = np.array(
        [(i + 1) * column_length // (column_division + 1) for i in range(column_division)],
        dtype=int,
    )
    return boundary_row, boundary_column


def sloper(dem, px, division_column=0, division_row=0, *, device="cuda"):
    return _np(_ops.slope(_t(dem, check_device(device), np.float32), px))


def topographic_index(flow_accumulation, slope, px, n_top, div_col=0, div_row=0, *, device="cuda"):
    dev = check_device(device)
    fac, sl = _t(flow_accumulation, dev), _t(slope, dev, np.float32)
    return _np(_ops.topographic_index(fac, sl, px), _ops.modified_topographic_index(fac, sl, px, n_top))


def downsloper(dem, flow_direction, px, elevation_difference,
               column_division=0, row_division=0, *, device="cuda"):
    dev = check_device(device)
    return _np(_ops.downslope(_t(dem, dev, np.float32), _t(flow_direction, dev), px,
                              elevation_difference, engine="cuda" if dev.type == "cuda" else "torch"))


def flow_hand_index(dem_raster, flow_direction_matrix, river_matrix, px,
                    division_column=0, division_row=0, *, device="cuda"):
    dev = check_device(device)
    fdist, indices, hand = _np(*_ops.flow_hand_index(_t(dem_raster, dev), _t(flow_direction_matrix, dev),
                                                     _t(river_matrix, dev), px))
    return fdist, indices, hand.astype(np.asarray(dem_raster).dtype)


def hand_calculator(dem, indices, *, device="cuda"):
    dev = check_device(device)
    return _np(_ops.hand_calculator(_t(dem, dev), _t(indices, dev))).astype(np.asarray(dem).dtype)


def index_calculator(river_indices, row_start, column_start, column_size):
    """Sub-matrix -> whole-matrix river-index transform (flowhand.py:445-473;
    bypassed in the reference's own pipeline, kept for API parity)."""
    river_indices = np.asarray(river_indices)
    row, col = river_indices.shape
    return np.where(
        river_indices == NODATA,
        NODATA,
        (river_indices // col + row_start) * column_size
        + river_indices % col
        + column_start,
    )


def river_accumulation(flow_accumulation, indices, *, device="cuda"):
    dev = check_device(device)
    return _np(_ops.river_accumulation(_t(flow_accumulation, dev), _t(indices, dev)))


def gfi_calculator(hand, flow_accumulation, indices, n_gfi, scale_factor, size,
                   division_column=0, division_row=0, *, device="cuda"):
    dev = check_device(device)
    return _np(_ops.gfi_calculator(_t(hand, dev), _t(flow_accumulation, dev), _t(indices, dev),
                                   n_gfi, scale_factor, size))


def ln_hl_H_calculator(hand, flow_accumulation, n_gfi, scale_factor, size,
                       division_column=0, division_row=0, *, device="cuda"):
    dev = check_device(device)
    return _np(_ops.ln_hl_h(_t(hand, dev), _t(flow_accumulation, dev), n_gfi, scale_factor, size))


def minMaxScale(mat, mn, mx, nodata):
    return _oracle.min_max_scale_oracle(mat, mn, mx, nodata)


def calibration(descriptor_matrix, comparison_matrix, under):
    return _ev.calibration(descriptor_matrix, comparison_matrix, under, backend="numpy")


def binary_map(descriptor_matrix, threshold, under):
    return _oracle.binary_map_oracle(descriptor_matrix, threshold, under)


def avaliacao(descriptor_flood_map, comparison_flood_map):
    return _oracle.confusion_oracle(descriptor_flood_map, comparison_flood_map)


def correctness(count):
    return _oracle.correctness_oracle(count)


def fit(count):
    return _oracle.fit_oracle(count)
