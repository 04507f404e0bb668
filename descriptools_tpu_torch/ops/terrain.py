"""Terrain derivation: D8 flow direction and flow accumulation (torch).

Counterpart of ``descriptools_tpu/ops/terrain.py``, which closes the loop
from a DEM alone (BASELINE.json config 3).  Flow accumulation is level
doubling with scatter-add over ``n + 1`` slots, slot ``n`` a virtual sink
that terminals chain to and that is zeroed after every round:

    F_{j+1} = F_j + scatter_add(F_j, by=succ_j);  succ_{j+1} = succ_j[succ_j]

The adds are int32, exact in any order, so every result is bitwise the JAX
one, truncated accumulations included: the rounds keep JAX's cap of
``d8.doubling_rounds(max_path)`` rounds and its exit once every cell's
successor is the sink.

A cell whose successor is the sink adds only to the sink, which is
zeroed, and keeps the sink for good.  So here the sink's adds are dropped
(``n`` slots), and each round scatters and jumps only the cells still
live, a list that shrinks every round.  On the card the rounds are one C
entry that keeps them there, read on the host once at the end
(``ops.cuda.terrain.accumulation``); on the CPU they are torch, the list's
length read on the host once a round
(``ops.cuda.terrain.accumulation_plain``).  (Scattering all ``n + 1``
slots every round, as JAX does, sends about ``n`` atomics a round to the
sink's one address on a card; PERF.md records that form's time.)
"""

import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.d8 import doubling_rounds, sink_successor
from descriptools_tpu_torch.ops.cuda.terrain import accumulation, accumulation_plain, d8_successor
from descriptools_tpu_torch.utils import timing


def _accumulate(rounds, fdr, max_path, stats, succ):
    rows, cols = fdr.shape
    levels = doubling_rounds(rows * cols if max_path is None else max_path)
    f, live = rounds(sink_successor(fdr) if succ is None else succ, levels)
    stats = {} if stats is None else stats
    stats["live"] = live
    stats["rounds"] = len(live)
    timing.count("rounds", len(live))
    timing.count("live_cells", sum(live))
    return f.reshape(rows, cols)


def flow_accumulation(fdr, max_path=None, stats=None, succ=None):
    """Strict upstream-cell count per cell (int32), on fdr's device.

    ``max_path`` bounds the longest resolvable drainage path (log2 levels
    of doubling); the default (None) is rows*cols, the bound for any
    acyclic D8 field.  Cells on flow cycles accumulate lap-multiplied
    counts, as in JAX.  ``succ``, where given, is fdr's
    ``d8.sink_successor`` (int32, contiguous; as ``d8_successor`` gives
    it), and fdr is not decoded again; the rounds jump it in place, so it
    is overwritten.  ``stats`` (a dict, filled in place) gets ``rounds``,
    the doubling rounds run, and ``live``, the cells still live entering
    each round.  The rounds are ``ops.cuda.terrain.accumulation``: one C
    entry on the card, the plain rounds on the CPU.  Counters of the open
    span (``utils.timing``): ``rounds``, ``live_cells`` (the sum of
    ``live``), ``host_reads`` (on the card 1, the live counts read after
    the last round; on the CPU 1 + 1 a round) and ``fused`` (1 a launch of
    the C entry).
    """
    return _accumulate(accumulation, fdr, max_path, stats, succ)


def flow_accumulation_plain(fdr, max_path=None, stats=None, succ=None):
    """:func:`flow_accumulation` through the plain rounds
    (``ops.cuda.terrain.accumulation_plain``) on any device: the version
    the card's entry is held to."""
    return _accumulate(accumulation_plain, fdr, max_path, stats, succ)


def derive_terrain(dem, nodata=NODATA, max_path=None, stats=None):
    """(fdr, fac) derived from a DEM: steepest-descent D8 + accumulation,
    fac NoData where the DEM is.  ``stats`` as for ``flow_accumulation``.
    D8 gives each cell's successor too (``ops.cuda.terrain.d8_successor``:
    one kernel on the card), and the accumulation takes it (one C entry on
    the card).  Spans (``utils.timing``): ``terrain`` and, inside it,
    ``terrain.d8`` (counter ``fused``: 1 a launch of the kernel) and
    ``terrain.accumulation`` (with the NoData mask; counters as for
    ``flow_accumulation``)."""
    with timing.span("terrain"):
        with timing.span("terrain.d8"):
            fdr, succ = d8_successor(dem.contiguous(), nodata=nodata)
        with timing.span("terrain.accumulation"):
            fac = flow_accumulation(fdr, max_path=max_path, stats=stats, succ=succ)
            fac = torch.where(dem == nodata, nodata, fac)
    return fdr, fac
