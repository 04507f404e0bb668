"""terrain.device_ms (moves cells_per_s): ``layers.terrain_device_ms``."""

from benchmark.layers import terrain_device_ms as read  # noqa: F401
