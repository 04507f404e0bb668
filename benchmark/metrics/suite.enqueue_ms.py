"""suite.enqueue_ms (moves cells_per_s): ``layers.suite_enqueue_ms``."""

from benchmark.layers import suite_enqueue_ms as read  # noqa: F401
