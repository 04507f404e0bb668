"""Torch ops of the descriptor suite (counterpart of descriptools_tpu/ops).

The JAX package's exports, except ``build_downslope_tables``: it belongs to
the descent cross-check engine, which the port does not carry (ROADMAP,
queue 1, "Not ported").

As in JAX, ``ops.downslope``, ``ops.slope`` and ``ops.gfi`` are these
functions, and they hide the submodules of the same names: reach a
submodule by path (``from descriptools_tpu_torch.ops.downslope import
...`` or ``importlib.import_module``), never as an attribute of ``ops``
and never with ``import descriptools_tpu_torch.ops.downslope as m``,
which gives the function."""

from descriptools_tpu_torch.ops.downslope import downslope
from descriptools_tpu_torch.ops.flow import flow_distance_index, flow_hand_index, hand_calculator
from descriptools_tpu_torch.ops.gfi import gfi, gfi_calculator, ln_hl_h, river_accumulation
from descriptools_tpu_torch.ops.slope import slope, slope_from_padded
from descriptools_tpu_torch.ops.topo import modified_topographic_index, topographic_index

__all__ = [
    "slope",
    "slope_from_padded",
    "topographic_index",
    "modified_topographic_index",
    "downslope",
    "flow_distance_index",
    "flow_hand_index",
    "hand_calculator",
    "gfi",
    "gfi_calculator",
    "ln_hl_h",
    "river_accumulation",
]
