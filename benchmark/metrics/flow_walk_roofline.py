"""flow_walk_roofline (moves cells_per_s): ``layers.flow_walk_roofline``."""

from benchmark.layers import flow_walk_roofline as read  # noqa: F401
