"""K2, ``csrc/stencil.cu::stencil_tile_kernel`` (entry ``launch_stencil``):
slope, slope_rad, TWI and modified TWI of a whole grid.

Read: the float32 DEM (4 B a cell) and fac as int32 or float32 (4 B; the
wrapper casts any other dtype to float32 first).  Written: four float32
rasters (16 B).  24 B a cell (``PERF.md``, the port's kernel table)."""

NAMES = ("stencil_tile_kernel",)


def bytes_moved(cells, operands):
    return (4 + 4 + 4 * 4) * cells
