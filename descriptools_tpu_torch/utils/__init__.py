"""Numpy helpers (copies of descriptools_tpu/utils modules)."""
