"""``staged_scale_torch.py`` (the staged suite at scale, and BASELINE config
5 domain-decomposed) on the CPU, over two gloo processes.

- default mode (one launch): ``windowed_basin(96, 80, seed=21)`` on mesh
  (2, 3), so the grid is padded to 81 columns and the downslope halo of 64
  reaches past the 27-column blocks; checkpoints kept in a temporary
  directory.  The script's line is ``ok``: every rank's blocks against the
  port's in-core suite (indices, HAND, river_fac, downslope, slope, fdist
  bitwise; the transcendental rasters within rtol 2e-5, atol 1e-4, the
  tolerances of ``tests/test_torch_multiprocess.py``), threshold, Fit and
  Correctness identical to the one-card classifier, the class map bitwise;
  the resume saved no stage again; the counted collective bytes equal the
  measured.
- parity with JAX: the blocks the two ranks wrote to their checkpoint files
  against JAX's ``sharded_suite_staged`` on a (2, 4) mesh of this process's
  virtual CPU devices, same inputs: indices, HAND, river_fac and downslope
  bitwise; slope within rtol 1e-6 and fdist within rtol 1e-6, atol 1e-4 (the
  JAX engine's float32 sums, ``tests/test_torch_pipeline.py``); the
  transcendental rasters within rtol 2e-5, atol 1e-4; threshold,
  Correctness and Fit identical.
- ``--config5`` (one launch) at 256^2 on mesh (2, 2) from
  ``config5_torch.prepare_inputs``: the shared memmaps and the window
  memmaps, 0 invariant violations over every cell, the sample windows
  within ``config5_torch.sample_checks``' limits, the mesh classifier
  identical to ``tiled_classify_flood`` and its class map bitwise, the
  counted bytes equal to the measured over two ranks.
- a corrupted ``indices`` block, planted here in the ranks' memmap, makes
  ``config5_checks`` report invariant violations over every cell and
  ``ok`` false (with one sample window: the invariants are under test).
- without a card the script raises for ``--device cuda`` (no fallback).
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

import staged_scale_torch as ss
from descriptools_tpu_torch.constants import NODATA

ROWS, COLS, MESH = 96, 80, (2, 3)
N5 = 256
PADDED_COLS = 81


def _run(args, out):
    """The script's ``main`` in this process (its ranks are processes of
    their own); its JSON line, which it also writes to ``out``."""
    assert ss.main(["--device", "cpu", "--cards", "2", *args, "--out-json", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("staged")
    res = _run(["--n", str(ROWS), str(COLS), "--mesh", *map(str, MESH), "--ckpt-dir", str(d / "ckpt"), "--iters",
                "1"], d / "staged.json")
    return res, d / "ckpt"


@pytest.fixture(scope="module")
def config5_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("config5")
    res = _run(["--config5", "--n", str(N5), "--mesh", "2", "2", "--input-cache", str(d / "inputs"), "--work-dir",
                str(d / "work"), "--iters", "1"], d / "staged.json")
    return res, d


def test_default_mode_ok_and_resumes_without_recomputing(default_run):
    res, ckpt = default_run
    assert res["ok"] and res["failures"] == [] and res["mode"] == "default"
    assert res["padded_grid"] == [ROWS, PADDED_COLS] and res["ranks"] == 2 and res["backend"] == "gloo"
    assert res["resume"]["stages_saved_again"] == []
    assert res["collective_bytes_match"] and res["collective_bytes"]["comm_calls"] > 0
    assert res["checkpoint"]["files"] == 10  # three stages: a file a rank and a marker each, and the manifest
    assert sorted(os.listdir(ckpt)) == sorted(
        [f"{s}.p{r}.npz" for s in ("flow", "downslope", "pointwise") for r in (0, 1)]
        + [f"{s}.DONE" for s in ("flow", "downslope", "pointwise")] + ["manifest.json"])
    assert set(res["warm_stage_ms"]) == {"flow", "downslope", "pointwise"}


def _port_blocks(ckpt):
    """{raster: {(ys, ye, xs, xe): block}} from the ranks' checkpoint files."""
    out = {}
    for f in glob.glob(os.path.join(ckpt, "*.p*.npz")):
        with np.load(f) as z:
            for key in z.files:
                name, win = key.split("@")
                out.setdefault(name, {})[tuple(map(int, win.split(":")))] = z[key]
    return out


def test_parity_with_jax_staged_suite(default_run):
    from descriptools_tpu.parallel import make_mesh as jax_mesh
    from descriptools_tpu.parallel import sharded_suite_staged as jax_staged
    from descriptools_tpu.pipeline import PipelineConfig as JaxConfig
    from descriptools_tpu.utils.synthetic import windowed_basin as jax_basin

    res, ckpt = default_run
    want = jax_staged(jax_mesh((2, 4)), (ROWS, COLS), jax_basin(ROWS, COLS, seed=21), JaxConfig(engine="xla"),
                      downslope_halo=64, crop=True)
    want = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in want.items()}
    assert res["classification"] == [want["threshold"], want["correctness"], want["fit"]]
    got = _port_blocks(ckpt)
    assert set(got) == {"fdist", "indices", "hand", "river_fac", "downslope", "slope", "slope_rad", "twi",
                        "mod_twi", "gfi", "ln_hl_h"}
    close = dict(slope=dict(rtol=1e-6, atol=0), fdist=dict(rtol=1e-6, atol=1e-4))
    for name, blocks in got.items():
        assert len(blocks) == MESH[0] * MESH[1], name
        for (ys, ye, xs, xe), blk in blocks.items():
            ye, xe = min(ye, ROWS), min(xe, COLS)  # the part inside the grid
            b, w = blk[: ye - ys, : xe - xs], want[name][ys:ye, xs:xe]
            if name == "indices":  # flat indices of the padded grid -> of the grid
                b = np.where(b == NODATA, NODATA, b // PADDED_COLS * COLS + b % PADDED_COLS)
            if name in ("indices", "hand", "river_fac", "downslope"):
                np.testing.assert_array_equal(b, w, err_msg=name)
            else:
                np.testing.assert_allclose(b, w, err_msg=name, equal_nan=True,
                                           **close.get(name, dict(rtol=2e-5, atol=1e-4)))


def test_config5_mode_checks_every_cell(config5_run):
    res, d = config5_run
    assert res["ok"] and res["failures"] == [] and res["mode"] == "config5"
    checks = res["checks"]
    inv = checks["invariants"]
    assert inv["ok"] and inv["invariant_violations"] == 0 and inv["cells_checked"] == N5 * N5
    assert len(checks["windows"]) == ss.N_WINDOWS and checks["ok"]
    cl = checks["classification"]
    assert cl["tiled"] == cl["mesh"] == res["classification"] and cl["class_map_bitwise"]
    assert res["collective_bytes_match"] and res["collective_bytes"]["comm_bytes"] > 0
    assert res["checkpoint"].startswith("none")
    assert res["max_fac"] < 1 << 24
    work = d / "work"
    for name, dt in ss.WHOLE:
        a = np.load(work / f"{name}.npy", mmap_mode="r")
        assert a.shape == (N5, N5) and a.dtype == dt
    for name in ss.WINDOWED:
        assert np.load(work / f"{name}_windows.npy", mmap_mode="r").shape == (ss.N_WINDOWS, N5 // 2, N5 // 2)


def test_config5_corrupted_indices_block_fails(config5_run, tmp_path, monkeypatch):
    res, d = config5_run
    work = tmp_path / "work"
    shutil.copytree(d / "work", work)
    idx = np.load(work / "indices.npy", mmap_mode="r+")
    blk = idx[: N5 // 2, N5 // 2 :]  # block 1 of mesh (2, 2): rank 0's second block
    landed = blk != NODATA
    assert landed.sum() > 100
    blk[landed] += 1
    idx.flush()
    del idx, blk
    monkeypatch.setattr(ss, "N_WINDOWS", 1)  # the first window of the ranks' files
    checks = ss.config5_checks(str(d / "inputs"), str(work), (N5, N5), res["classification"], N5, N5 // 2)
    assert not checks["ok"]
    inv = checks["invariants"]
    assert not inv["ok"] and inv["invariant_violations"] > 0 and inv["cells_checked"] == N5 * N5


def test_script_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ss.main(["--config5", "--n", "64", "--mesh", "2", "2", "--input-cache", str(tmp_path / "in"),
                 "--work-dir", str(tmp_path / "work")])
    assert not (tmp_path / "in").exists() and not (tmp_path / "work").exists()
