"""terrain.accumulation.device_ms (moves cells_per_s): ``stages.terrain_accumulation_device_ms``."""

from benchmark.stages import terrain_accumulation_device_ms as read  # noqa: F401
