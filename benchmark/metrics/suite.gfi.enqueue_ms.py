"""suite.gfi.enqueue_ms (moves cells_per_s): ``stages.suite_gfi_enqueue_ms``."""

from benchmark.stages import suite_gfi_enqueue_ms as read  # noqa: F401
