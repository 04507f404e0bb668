"""K3, ``csrc/walk.cu::downslope_kernel`` (entry ``launch_downslope``): the
whole downslope stage, one launch from the DEM and fdr.

Read: the float32 DEM (4 B a cell) and fdr in its own type where it is
uint8 (1 B) or int32 (4 B; the wrapper casts any other integer dtype to
int32).  Written: the float32 downslope raster (4 B).  9 B a cell for
uint8 fdr, 12 B for int32.  The walk's reads of the cells along each path
are rereads of these inputs and are not counted."""

NAMES = ("downslope_kernel",)


def bytes_moved(cells, operands):
    fdr = 1 if operands["fdr"] == "torch.uint8" else 4
    return (4 + fdr + 4) * cells
