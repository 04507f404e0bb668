"""terrain.d8.device_ms (moves cells_per_s): ``stages.terrain_d8_device_ms``."""

from benchmark.stages import terrain_d8_device_ms as read  # noqa: F401
