"""NumPy float64 oracle of the flood-map classifier.

A copy of ``descriptools_tpu/oracle/evaluation.py`` (the port never imports
the JAX package); ``tests/test_torch_d8.py`` holds the copy to the original.
"""

from descriptools_tpu_torch.oracle.evaluation import (
    binary_map_oracle,
    calibration_oracle,
    confusion_oracle,
    correctness_oracle,
    fit_oracle,
    min_max_scale_oracle,
)

__all__ = [
    "min_max_scale_oracle",
    "binary_map_oracle",
    "confusion_oracle",
    "correctness_oracle",
    "fit_oracle",
    "calibration_oracle",
]
