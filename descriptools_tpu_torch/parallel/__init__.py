"""Blocked execution of the suite (torch): the boundary-graph reduction that
stitches D8 flow across block edges, and the exact integer cutoff of the
streaming calibration.  Counterpart of ``descriptools_tpu/parallel``; the
multi-card layer (torch.distributed) is not ported yet."""
