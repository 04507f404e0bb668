"""The calibration's counting pass over float HAND,
``csrc/classify.cu::cutoff_count_kernel`` (entry ``launch_cutoff_count``):
one launch a search stage, 5 a job on float HAND, none on integer HAND
(its histogram pass).

Read: HAND float32 (4 B a cell) and the flood map int32 (4 B), once a
pass.  Written: a few dozen counts.  5 x 8 = 40 B a cell a job."""

NAMES = ("cutoff_count_kernel",)
PASSES = 5  # one a search stage


def bytes_moved(cells, operands):
    return PASSES * (4 + 4) * cells
