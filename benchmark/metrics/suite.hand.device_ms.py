"""suite.hand.device_ms (moves cells_per_s): ``stages.suite_hand_device_ms``."""

from benchmark.stages import suite_hand_device_ms as read  # noqa: F401
