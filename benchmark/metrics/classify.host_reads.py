"""classify.host_reads (moves cells_per_s): ``stages.classify_host_reads``."""

from benchmark.stages import classify_host_reads as read  # noqa: F401
