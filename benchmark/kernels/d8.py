"""Terrain's D8 kernel, ``csrc/terrain.cu::d8_kernel`` (entry ``launch_d8``):
each cell's D8 code and its successor from the DEM, one launch a job in
``derive_terrain``.

Read: the DEM in its own type, 4 B a cell in both tile cells (int32 and
float32; int16 would be 2).  Written: fdr and succ, int32 (8 B).  12 B a
cell.  The halo's rereads of the DEM are not counted."""

NAMES = ("d8_kernel",)


def bytes_moved(cells, operands):
    return (4 + 4 + 4) * cells
