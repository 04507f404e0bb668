"""classify_count_roofline (moves cells_per_s): the counting kernel's share
of its roofline in % (``kernels/classify_count.py``), through
``kernels.roofline_percent``; None where the trace holds no counting pass
(integer HAND, or a program without the kernel)."""

from benchmark.kernels import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "classify_count")
