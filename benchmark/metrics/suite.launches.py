"""suite.launches (moves cells_per_s): ``layers.suite_launches``."""

from benchmark.layers import suite_launches as read  # noqa: F401
