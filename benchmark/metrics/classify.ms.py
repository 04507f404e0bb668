"""classify.ms (moves cells_per_s): ``layers.classify_ms``."""

from benchmark.layers import classify_ms as read  # noqa: F401
