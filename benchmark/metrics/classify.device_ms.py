"""classify.device_ms (moves cells_per_s): ``stages.classify_device_ms``."""

from benchmark.stages import classify_device_ms as read  # noqa: F401
