"""d8_roofline (moves cells_per_s): terrain's D8 kernel's share of its
roofline in % (``kernels/d8.py``), through ``kernels.roofline_percent``;
None where the trace holds no D8 kernel (a program without it)."""

from benchmark.kernels import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "d8")
