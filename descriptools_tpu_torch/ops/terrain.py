"""Terrain derivation: D8 flow direction and flow accumulation (torch).

Counterpart of ``descriptools_tpu/ops/terrain.py``, which closes the loop
from a DEM alone (BASELINE.json config 3).  Flow accumulation is level
doubling with scatter-add over ``n + 1`` slots, slot ``n`` a virtual sink
that terminals chain to and that is zeroed after every round:

    F_{j+1} = F_j + scatter_add(F_j, by=succ_j);  succ_{j+1} = succ_j[succ_j]

The adds are ``index_add_`` on int32, exact in any order, so every result
is bitwise the JAX one, truncated accumulations included: the loop keeps
JAX's cap of ``d8.doubling_rounds(max_path)`` rounds and its exit once
every cell's successor is the sink, read on the host once a round.

A cell whose successor is the sink adds only to the sink, which is
zeroed, and keeps the sink for good.  So here the sink's adds are dropped
(``n`` slots), and each round scatters and jumps only the cells still
live, a list that shrinks every round; its length is the round's exit
test.  (Scattering all ``n + 1`` slots every round, as JAX
does, sends about ``n`` atomics a round to the sink's one address on a
card; PERF.md records that form's time.)
"""

import torch

from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.d8 import doubling_rounds, sink_successor
from descriptools_tpu_torch.ops.cuda.terrain import d8_successor
from descriptools_tpu_torch.utils import timing


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
    each round.  Counters of the open span
    (``utils.timing``): ``rounds``, ``live_cells`` (the sum of ``live``) and
    ``host_reads``, 1 + 1 a round: the live list's length, read on the host
    once to start and once a round.
    """
    rows, cols = fdr.shape
    n = rows * cols
    levels = doubling_rounds(n if max_path is None else max_path)
    succ = (sink_successor(fdr) if succ is None else succ).view(-1)
    dev = succ.device
    f = torch.zeros(n, dtype=torch.int32, device=dev)
    stats = {} if stats is None else stats
    live = torch.nonzero(succ[:n] != n).reshape(-1)  # the host reads its length
    timing.count("host_reads")
    to = succ[live]
    f.index_add_(0, to, torch.ones_like(to))
    stats["live"] = []
    rounds = 0
    while rounds < levels and live.numel():
        stats["live"].append(live.numel())
        f.index_add_(0, to, f[live])
        to = succ[to]
        succ[live] = to
        keep = torch.nonzero(to != n).reshape(-1)  # the host reads its length
        live, to = live[keep], to[keep]
        timing.count("host_reads")
        rounds += 1
    stats["rounds"] = rounds
    timing.count("rounds", rounds)
    timing.count("live_cells", sum(stats["live"]))
    return f.reshape(rows, cols)


def derive_terrain(dem, nodata=NODATA, max_path=None, stats=None):
    """(fdr, fac) derived from a DEM: steepest-descent D8 + accumulation,
    fac NoData where the DEM is.  ``stats`` as for ``flow_accumulation``.
    D8 gives each cell's successor too (``ops.cuda.terrain.d8_successor``:
    one kernel on the card), and the accumulation takes it.  Spans
    (``utils.timing``): ``terrain`` and, inside it, ``terrain.d8``
    (counter ``fused``: 1 a launch of the kernel) and
    ``terrain.accumulation`` (with the NoData mask; counters as for
    ``flow_accumulation``)."""
    with timing.span("terrain"):
        with timing.span("terrain.d8"):
            fdr, succ = d8_successor(dem.contiguous(), nodata=nodata)
        with timing.span("terrain.accumulation"):
            fac = flow_accumulation(fdr, max_path=max_path, stats=stats, succ=succ)
            fac = torch.where(dem == nodata, nodata, fac)
    return fdr, fac
