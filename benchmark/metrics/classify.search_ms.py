"""classify.search_ms (moves cells_per_s): ``stages.classify_search_ms``."""

from benchmark.stages import classify_search_ms as read  # noqa: F401
