"""Raster I/O, ``run_example`` and the CLI: the port against the JAX package.

Tolerances: the copied ``io`` reads and writes every raster bit for bit as
the original does, both ways; ``run_example`` and the CLI give the same
threshold, Correctness, Fit and class map as the JAX ``run_example`` on the
same basin directory (synthetic rasters written as TIFFs).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image
from PIL.TiffImagePlugin import ImageFileDirectory_v2

from descriptools_tpu import io as jio
from descriptools_tpu import pipeline as jpipe
from descriptools_tpu.utils.synthetic import synthetic_basin
from descriptools_tpu_torch import io as tio
from descriptools_tpu_torch import pipeline as tpipe
from descriptools_tpu_torch.__main__ import main as tmain

GEO = {33550: (12.5, 12.5, 0.0), 33922: (0.0, 0.0, 0.0, 500000.0, 7000000.0, 0.0)}


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32])
def test_write_read_roundtrip_both_ways(tmp_path, dtype):
    arr = (np.arange(-20, 40).reshape(6, 10) * 3).astype(dtype)
    if dtype == np.uint8:
        arr = np.arange(60, dtype=np.uint8).reshape(6, 10)
    for writer, reader, name in ((jio, tio, "jax"), (tio, jio, "port")):
        p = str(tmp_path / f"{name}.tif")
        writer.write_raster(p, arr)
        got, again = reader.read_raster(p), writer.read_raster(p)
        assert got.dtype == again.dtype  # PIL reads int16 back as int32
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(got, again)


def test_write_with_template_copies_the_same_tags(tmp_path):
    template = str(tmp_path / "template.tif")
    tags = ImageFileDirectory_v2()
    for tag, value in GEO.items():
        tags[tag] = value
    Image.fromarray(np.zeros((4, 5), np.float32)).save(template, tiffinfo=tags)
    arr = np.arange(20, dtype=np.uint8).reshape(4, 5)
    out = {}
    for mod, name in ((jio, "jax"), (tio, "port")):
        p = str(tmp_path / f"{name}.tif")
        mod.write_raster(p, arr, template=template, nodata=0)
        im = Image.open(p)
        out[name] = {t: im.tag_v2[t] for t in (*GEO, 42113)}
        assert tuple(out[name][33550]) == GEO[33550]
    assert out["jax"] == out["port"] and out["port"][42113] == "0"


def test_normalise_nodata_matches():
    a = np.full((4, 4), -3.4e38, np.float32)
    a[1:, 1:] = 345.0
    for cast in (None, "int16", "int64"):
        with np.errstate(invalid="ignore"):
            got, want = tio.normalise_nodata(a, cast=cast), jio.normalise_nodata(a, cast=cast)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def write_basin(root, rows=70, cols=110, seed=13):
    """A synthetic basin in the reference Example layout: float32 DEM with a
    -100 border, uint8 fdr, int32 fac (above 128000 exactly on the
    generator's river cells, so the loader's river mask is that network;
    -1 on the border, the corner the loader normalises) and a uint8 flood
    map."""
    dem, fdr, river, fac = synthetic_basin(rows, cols, seed=seed)
    fac = np.where(river == 1, 128001 + fac, np.minimum(fac, 128000))
    fac = np.where(dem == -100, -1, fac).astype(np.int32)
    valid = dem != -100
    flood = (valid & (dem <= np.percentile(dem[valid], 30))).astype(np.uint8)
    os.makedirs(os.path.join(root, "input"), exist_ok=True)
    for name, arr in (("12_dem", dem.astype(np.float32)), ("12_fdr", fdr), ("12_fac", fac),
                      ("WB_12_100y", flood)):
        tio.write_raster(os.path.join(root, "input", f"{name}.tif"), arr)
    return str(root)


def test_load_example_inputs_matches(tmp_path):
    root = write_basin(tmp_path / "basin")
    got, want = tio.load_example_inputs(root), jio.load_example_inputs(root)
    assert sorted(got) == sorted(want)
    for k in ("dem", "fdr", "fac", "river", "flood"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["px"] == want["px"]
    assert 0 < int(got["river"].sum()) < got["river"].size // 4


@pytest.fixture(scope="module")
def basin_dir(tmp_path_factory):
    root = write_basin(tmp_path_factory.mktemp("io") / "basin")
    return root, jpipe.run_example(root)


@pytest.mark.parametrize("engine", ["auto", "torch_blocked"])
def test_run_example_matches_jax(basin_dir, engine):
    root, want = basin_dir
    got = tpipe.run_example(root, tpipe.PipelineConfig(engine=engine), "cpu")
    assert np.isfinite(want["fit"]) and want["fit"] > 0
    assert len(np.unique(want["hand"])) > 10
    assert (got["threshold"], got["correctness"], got["fit"]) == (
        want["threshold"], want["correctness"], want["fit"])
    assert got["class_map"].dtype == want["class_map"].dtype == np.uint8
    np.testing.assert_array_equal(got["class_map"], want["class_map"])
    for k in ("indices", "hand"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_matches_jax(basin_dir, tmp_path, capsys):
    root, want = basin_dir
    out_tif = str(tmp_path / "class.tif")
    assert tmain([root, "-o", out_tif, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["cells", "correctness", "fit", "threshold", "wall_s"]
    assert line["threshold"] == want["threshold"]
    assert line["correctness"] == round(float(want["correctness"]), 4)
    assert line["fit"] == round(float(want["fit"]), 4)
    assert line["cells"] == want["hand"].size
    np.testing.assert_array_equal(tio.read_raster(out_tif), want["class_map"])


def test_run_example_defaults_to_the_card(basin_dir):
    """Called with no device, run_example runs on the card: without one it
    raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_example(basin_dir[0])


def test_cli_refuses_a_missing_card(basin_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain([basin_dir[0]])
    with pytest.raises(SystemExit):
        tmain([basin_dir[0], "--device", "cpu", "--engine", "pallas"])
