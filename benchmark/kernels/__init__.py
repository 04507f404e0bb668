"""The bytes each of the port's own kernels needs for given inputs, one
file a kernel (``kernels/<kernel>.py``: ``NAMES``, the kernel names as the
profiler shows them, and ``bytes_moved(cells, operands)``), and the
roofline share they give.  Every file here is a kernel of the port's own:
``own_names`` reads them all.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again (the jump walk's rounds, a stencil's
halo): what these inputs need, not what the kernel does.  All three are
bound by bytes on an H100: their operations are few beside them
(``PERF.md``).
"""

from benchmark import found


def kernel(name, root=found.ROOT):
    return found.module("kernels", name, root)


def roofline_percent(ctx, name):
    """100 x (the kernel's bytes at the card's peak bandwidth) / (its
    device time), a job; None where the trace holds none of it or the
    card's peaks are not in the table."""
    k = kernel(name, ctx.spec.root)
    seconds = ctx.trace.device_s(names=k.NAMES) / ctx.jobs
    operands = ctx.probe.operands.get("suite")
    if not seconds or not ctx.peaks or not operands:
        return None
    return 100.0 * k.bytes_moved(ctx.cells, operands) / ctx.peaks["hbm_bytes_per_s"] / seconds


def own_names(root=found.ROOT):
    """Every kernel name of the port's own kernels (``kernels/*.py``)."""
    return tuple(n for k in found.names("kernels", root) for n in kernel(k, root).NAMES)
