"""Raster I/O: GeoTIFF read/write (PIL-backed) and the reference's NoData
normalisation.

Copy of ``descriptools_tpu/io.py`` (numpy + PIL, no JAX).  Importing it
never needs PIL; only a read or a write raises without it.

The reference example driver reads GeoTIFFs with rasterio and fixes NoData by
probing the corner value (Example/example.py:33-52).  rasterio is not part of
this environment; PIL decodes the same TIFFs (incl. the bundled basin).  The
int-cast semantics of the reference (`float32 -3.4e38 -> astype(int16) -> 0`,
then corner-probe -> -100) are replicated host-side so device code only ever
sees the canonical -100 sentinel.
"""

import numpy as np

from descriptools_tpu_torch.constants import NODATA

try:  # pragma: no cover - import guard
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def read_raster(path):
    """Read band 1 of a (Geo)TIFF as a numpy array in native dtype."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is required for TIFF I/O")
    return np.array(Image.open(path))


# GeoTIFF tags worth carrying over from a template raster (pixel scale,
# tiepoints, CRS keys, GDAL nodata) — the reference copies georeferencing by
# reusing rasterio metadata of the input DEM (Example/example.py:201-204).
_GEO_TAGS = (33550, 33922, 34264, 34735, 34736, 34737, 42112, 42113)


def write_raster(path, array, template=None, nodata=None):
    """Write a single-band raster as TIFF.

    With ``template`` (path of a reference GeoTIFF, e.g. the input DEM), the
    georeferencing tags are copied over so GIS tools place the output
    correctly; ``nodata`` sets the GDAL nodata tag.
    """
    if not _HAS_PIL:
        raise RuntimeError("PIL is required for TIFF I/O")
    from PIL.TiffImagePlugin import ImageFileDirectory_v2

    im = Image.fromarray(np.asarray(array))
    tiffinfo = None
    if template is not None:
        src = Image.open(template)
        tiffinfo = ImageFileDirectory_v2()
        for tag in _GEO_TAGS:
            if tag in src.tag_v2:
                tiffinfo[tag] = src.tag_v2[tag]
        if nodata is not None:
            tiffinfo[42113] = str(nodata)
    if tiffinfo is not None:
        im.save(path, tiffinfo=tiffinfo)
    else:
        im.save(path)


def normalise_nodata(arr, cast=None, nodata=NODATA):
    """Replicate Example/example.py:33-43: optional dtype cast, then replace
    every cell equal to the corner value with the NoData sentinel."""
    if cast is not None:
        with np.errstate(invalid="ignore"):
            arr = arr.astype(cast)
    return np.where(arr == arr[0, 0], nodata, arr)


def load_example_inputs(example_dir):
    """Load the bundled basin exactly as Example/example.py:18-52 does.

    Returns dict with dem (int16, NoData -100), fdr (uint8), fac (int64,
    NoData -100), river (int8 mask, fac > 128000), flood (int8 benchmark),
    px (12.5).
    """
    dem = normalise_nodata(read_raster(f"{example_dir}/input/12_dem.tif"), cast="int16")
    fdr = read_raster(f"{example_dir}/input/12_fdr.tif")
    fac = normalise_nodata(read_raster(f"{example_dir}/input/12_fac.tif"), cast="int64")
    river = np.where(fac > 128000, 1, 0).astype("int8")
    flood = read_raster(f"{example_dir}/input/WB_12_100y.tif").astype("int8")
    return dict(dem=dem, fdr=fdr, fac=fac, river=river, flood=flood, px=12.5)
