"""torch_ops.device_ms (moves cells_per_s): ``layers.torch_ops_device_ms``."""

from benchmark.layers import torch_ops_device_ms as read  # noqa: F401
