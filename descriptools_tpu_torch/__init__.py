"""descriptools_tpu_torch — the terrain-descriptor suite in PyTorch.

The PyTorch counterpart of ``descriptools_tpu``: the same descriptors, the
same numbers, computed with torch ops on any device and, on an NVIDIA Hopper
card, through hand-written CUDA kernels (``ops/cuda`` wrappers over
``csrc/*.cu``).  It imports neither ``jax`` nor ``descriptools_tpu``; the
numpy-only layers it needs (constants, synthetic terrain, the float64
oracles, the streaming verifier) are copies, held bitwise to their
originals by the tests.

Entry points: :func:`descriptools_tpu_torch.pipeline.descriptor_suite`,
:func:`descriptools_tpu_torch.pipeline.classify_flood`,
:func:`descriptools_tpu_torch.ops.terrain.derive_terrain`,
:func:`descriptools_tpu_torch.parallel.classify.sharded_classify_flood`
and the reference's API in :mod:`descriptools_tpu_torch.compat`.
"""

__version__ = "0.1.0"

from descriptools_tpu_torch import constants, d8, evaluation, io, ops
from descriptools_tpu_torch.constants import NODATA

__all__ = ["constants", "d8", "evaluation", "io", "ops", "NODATA", "__version__"]
