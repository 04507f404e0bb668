"""Stage checkpoints: the port's ``utils/checkpoint`` against the JAX
package's (its ``.npz`` branch), and ``run_suite_checkpointed``.

Tolerances: everything bitwise.  The copied module must write and read
the JAX package's ``.npz`` stages bit for bit both ways, and the
checkpointed suite must equal the one-call ``descriptor_suite`` (torch
runs eagerly, so the stage split changes no rounding), uninterrupted or
resumed after a kill in the same process or in a new one.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from descriptools_tpu.utils import checkpoint as jckpt
from descriptools_tpu.utils.synthetic import synthetic_basin
from descriptools_tpu_torch import pipeline as tpipe
from descriptools_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("slope", "slope_rad", "twi", "mod_twi", "downslope", "fdist", "indices", "hand",
        "river_fac", "gfi", "ln_hl_h")
STAGES = ("stencil", "walks", "flow", "pointwise")


@pytest.fixture(scope="module")
def basin():
    dem, fdr, river, fac = synthetic_basin(64, 96, seed=11)
    return tpipe.inputs_to_torch(dem, fdr, fac, river, "cpu")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        f32=rng.standard_normal((5, 7)).astype(np.float32),
        f64=rng.standard_normal((3, 4)),
        i32=rng.integers(-100, 1 << 30, (6, 2), dtype=np.int32),
        i16=rng.integers(-100, 500, (4, 4)).astype(np.int16),
        u8=rng.integers(0, 255, (2, 9)).astype(np.uint8),
        nan=np.array([np.nan, -np.inf, -0.0, 1e-45], np.float32),
    )


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].tobytes() == want[k].tobytes(), k


def test_checkpoint_copy_reads_and_writes_the_jax_stages(tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "_HAS_ORBAX", False)
    arrays = _arrays()
    for writer, reader, name in ((jckpt, tckpt, "jax"), (tckpt, jckpt, "port")):
        path = str(tmp_path / name)
        assert not writer.stage_exists(path) and not reader.stage_exists(path)
        writer.save_stage(path, arrays)
        assert writer.stage_exists(path) and reader.stage_exists(path)
        assert not os.path.exists(path + ".npz.tmp")
        _assert_same(reader.load_stage(path), arrays)
        _assert_same(writer.load_stage(path), arrays)


def test_check_manifest_behaves_as_the_original(tmp_path):
    manifest = dict(shape=[64, 96], dem_dtype="int32", px=12.5, engine="auto")
    other = dict(manifest, px=30.0)
    for mod, name in ((jckpt, "jax"), (tckpt, "port")):
        d = str(tmp_path / name / "ck")
        mod.check_manifest(d, manifest)  # writes
        mod.check_manifest(d, manifest)  # validates
        with pytest.raises(ValueError, match="different run"):
            mod.check_manifest(d, other)
    for name in ("jax", "port"):
        with open(tmp_path / name / "ck" / "manifest.json") as fh:
            assert json.load(fh) == manifest
    # Each validates the other's manifest.
    jckpt.check_manifest(str(tmp_path / "port" / "ck"), manifest)
    tckpt.check_manifest(str(tmp_path / "jax" / "ck"), manifest)
    with pytest.raises(ValueError, match="different run"):
        tckpt.check_manifest(str(tmp_path / "jax" / "ck"), other)


@pytest.mark.parametrize("engine", ["torch", "torch_blocked"])
def test_checkpointed_matches_fused(tmp_path, basin, engine):
    cfg = tpipe.PipelineConfig(engine=engine)
    stats = {}
    out = tpipe.run_suite_checkpointed(*basin, cfg, str(tmp_path / "ck"), stats=stats)
    fused = tpipe.descriptor_suite(*basin, cfg)
    assert sorted(out) == sorted(KEYS)
    for k in fused:
        assert out[k].dtype == fused[k].dtype, k
        assert torch.equal(out[k], fused[k]), k
    assert [stats[s]["resumed"] for s in STAGES] == [False] * 4
    assert all(stats[s]["saved_bytes"] > 0 and stats[s]["loaded_bytes"] == 0 for s in STAGES)
    with open(tmp_path / "ck" / "manifest.json") as fh:
        manifest = json.load(fh)
    assert manifest["shape"] == [64, 96] and manifest["dem_dtype"] == "int32"
    assert manifest["engine"] == engine


def test_kill_and_resume_bitwise(tmp_path, basin, monkeypatch):
    cfg = tpipe.PipelineConfig()
    ckdir = str(tmp_path / "ck")
    ref = tpipe.run_suite_checkpointed(*basin, cfg, str(tmp_path / "ref"))

    # The first attempt dies inside the flow stage: stencil and walks are
    # already committed (atomic save), flow is not.
    def dying_flow(*a, **k):
        raise RuntimeError("simulated preemption")

    monkeypatch.setattr(tpipe, "_engine_flow", dying_flow)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        tpipe.run_suite_checkpointed(*basin, cfg, ckdir)
    monkeypatch.undo()
    assert sorted(os.listdir(ckdir)) == ["manifest.json", "stencil.npz", "walks.npz"]

    # The resume must NOT recompute completed stages.
    def poisoned(*a, **k):
        raise AssertionError("resume recomputed a completed stage")

    monkeypatch.setattr(tpipe, "_engine_stencil", poisoned)
    monkeypatch.setattr(tpipe, "_engine_downslope", poisoned)
    stats = {}
    out = tpipe.run_suite_checkpointed(*basin, cfg, ckdir, stats=stats)
    assert [stats[s]["resumed"] for s in STAGES] == [True, True, False, False]
    assert stats["stencil"]["loaded_bytes"] == 4 * 4 * 64 * 96
    for k in KEYS:
        assert out[k].dtype == ref[k].dtype and out[k].device == basin[0].device, k
        assert torch.equal(out[k], ref[k]), k


_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import descriptools_tpu_torch.pipeline as pl
from descriptools_tpu_torch.utils.synthetic import synthetic_basin
dem, fdr, river, fac = synthetic_basin(64, 96, seed=11)
if os.environ.get("CKPT_DIE") == "1":
    pl._engine_flow = lambda *a, **k: os._exit(3)
out = pl.run_suite_checkpointed(
    *pl.inputs_to_torch(dem, fdr, fac, river, "cpu"), pl.PipelineConfig(), sys.argv[1],
)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "orbax", "descriptools_tpu")]
assert not bad, bad
np.savez(sys.argv[2], **{{k: v.numpy() for k, v in out.items()}})
"""


def test_real_process_kill_and_resume(tmp_path, basin):
    """A hard process death (os._exit, no clean-up) inside the flow stage
    leaves a resumable directory; a new process resumes it and reproduces
    the uninterrupted run bitwise.  The worker imports only the port."""
    code = _WORKER.format(repo=ROOT)
    ckdir = str(tmp_path / "ck")
    out_npz = str(tmp_path / "out.npz")
    env = dict(os.environ, CKPT_DIE="1")
    p = subprocess.run([sys.executable, "-c", code, ckdir, out_npz],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3, p.stderr[-2000:]
    assert not os.path.exists(out_npz)
    assert sorted(os.listdir(ckdir)) == ["manifest.json", "stencil.npz", "walks.npz"]
    env["CKPT_DIE"] = "0"
    p = subprocess.run([sys.executable, "-c", code, ckdir, out_npz],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]

    ref = tpipe.run_suite_checkpointed(*basin, tpipe.PipelineConfig(), str(tmp_path / "ref"))
    resumed = np.load(out_npz)
    for k in KEYS:
        assert resumed[k].dtype == ref[k].numpy().dtype, k
        np.testing.assert_array_equal(resumed[k], ref[k].numpy(), err_msg=k)


def test_manifest_guards_mismatched_resume(tmp_path, basin):
    cfg = tpipe.PipelineConfig()
    ckdir = str(tmp_path / "ck")
    tpipe.run_suite_checkpointed(*basin, cfg, ckdir)
    with pytest.raises(ValueError, match="different run"):
        tpipe.run_suite_checkpointed(*basin, dataclasses.replace(cfg, elevation_difference=7.0), ckdir)
    dem, fdr, fac, river = basin
    with pytest.raises(ValueError, match="different run"):
        tpipe.run_suite_checkpointed(dem[:-1], fdr[:-1], fac[:-1], river[:-1], cfg, ckdir)
