"""downslope_roofline (moves cells_per_s): ``layers.downslope_roofline``."""

from benchmark.layers import downslope_roofline as read  # noqa: F401
