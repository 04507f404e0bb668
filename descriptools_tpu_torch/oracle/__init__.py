"""NumPy oracles of every descriptor and of the flood-map classifier.

Copies of ``descriptools_tpu/oracle/core.py`` and
``descriptools_tpu/oracle/evaluation.py`` (the port never imports the JAX
package); ``tests/test_torch_oracle.py`` and ``tests/test_torch_d8.py`` hold
the copies to the originals.
"""

from descriptools_tpu_torch.oracle.core import (
    downslope_oracle,
    downslope_oracle_trunc,
    flow_distance_index_oracle,
    gfi_oracle,
    hand_oracle,
    ln_hl_h_oracle,
    modified_topographic_index_oracle,
    river_accumulation_oracle,
    slope_oracle,
    topographic_index_oracle,
)
from descriptools_tpu_torch.oracle.evaluation import (
    binary_map_oracle,
    calibration_oracle,
    confusion_oracle,
    correctness_oracle,
    fit_oracle,
    min_max_scale_oracle,
)

__all__ = [
    "slope_oracle",
    "topographic_index_oracle",
    "modified_topographic_index_oracle",
    "downslope_oracle",
    "downslope_oracle_trunc",
    "flow_distance_index_oracle",
    "hand_oracle",
    "river_accumulation_oracle",
    "gfi_oracle",
    "ln_hl_h_oracle",
    "min_max_scale_oracle",
    "binary_map_oracle",
    "confusion_oracle",
    "correctness_oracle",
    "fit_oracle",
    "calibration_oracle",
]
