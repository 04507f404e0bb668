"""suite.flow.enqueue_ms (moves cells_per_s): ``stages.suite_flow_enqueue_ms``."""

from benchmark.stages import suite_flow_enqueue_ms as read  # noqa: F401
