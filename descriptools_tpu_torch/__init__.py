"""descriptools_tpu_torch — the terrain-descriptor suite in PyTorch.

The PyTorch counterpart of ``descriptools_tpu``: the same descriptors, the
same numbers, computed with torch ops on any device and, on an NVIDIA Hopper
card, through hand-written CUDA kernels (``ops/cuda`` wrappers over
``csrc/*.cu``).  It imports neither ``jax`` nor ``descriptools_tpu``; the
numpy-only layers it needs (constants, synthetic terrain, the float64
evaluation oracle) are copies, held bitwise to their originals by the tests.

Entry points: :func:`descriptools_tpu_torch.pipeline.descriptor_suite` and
:func:`descriptools_tpu_torch.pipeline.classify_flood`.
"""
