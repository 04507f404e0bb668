"""stencil_roofline (moves cells_per_s): ``layers.stencil_roofline``."""

from benchmark.layers import stencil_roofline as read  # noqa: F401
