"""device.idle_share (moves cells_per_s): ``layers.device_idle_share``."""

from benchmark.layers import device_idle_share as read  # noqa: F401
