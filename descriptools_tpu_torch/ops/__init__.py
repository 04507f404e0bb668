"""Torch ops of the descriptor suite (counterpart of descriptools_tpu/ops)."""
