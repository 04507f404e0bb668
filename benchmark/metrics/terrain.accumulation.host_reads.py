"""terrain.accumulation.host_reads (moves cells_per_s): ``stages.terrain_accumulation_host_reads``."""

from benchmark.stages import terrain_accumulation_host_reads as read  # noqa: F401
