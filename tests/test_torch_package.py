"""Rules of the PyTorch port's package and of chip_smoke.py.

- the port imports neither jax, orbax nor descriptools_tpu;
- chip_smoke.py imports neither, fails fast without a GPU, and prints no
  result when it fails;
- the CUDA route refuses CPU tensors and a missing compiler.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from descriptools_tpu_torch import pipeline
from descriptools_tpu_torch.ops.cuda import build

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "chip_smoke.py"


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "orbax", "descriptools_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import descriptools_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'descriptools_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'descriptools_tpu')]\n"
        "need = {'descriptools_tpu_torch.' + m for m in ('tiled', 'parallel.boundary', 'parallel.classify',\n"
        "        'io', 'utils.checkpoint', '__main__', 'compat', 'verify', 'ops.terrain', 'oracle.core',\n"
        "        'utils.provenance', 'utils.timing', 'parallel.mesh', 'parallel.halo', 'parallel.sharded',\n"
        "        'parallel.multihost', 'parallel.ckpt')}\n"
        "print(len(mods), bad, need - set(mods))\n"
        "sys.exit(1 if bad or len(mods) < 25 or need - set(mods) else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", [SMOKE, *sorted((ROOT / "descriptools_tpu_torch").rglob("*.py"))],
                         ids=lambda p: str(Path(p).relative_to(ROOT)))
def test_sources_name_no_jax_import(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_chip_smoke_without_gpu_fails_fast_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_engine_cuda_on_cpu_tensors_raises():
    t = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pipeline.descriptor_suite(
            t, t.to(torch.uint8), t, t.to(torch.int8), pipeline.PipelineConfig(engine="cuda")
        )


def test_kernel_argument_checks_refuse_cpu_and_wrong_dtype():
    with pytest.raises(ValueError, match="CUDA"):
        build.check_cuda_tensor(torch.zeros(3, 4), "x", torch.float32, (3, 4))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_build_key_follows_the_sources():
    names = {p.name for p in build.sources()}
    assert names == {"flow_fold.cu", "stencil.cu", "walk.cu"}
    assert len(build.source_key()) == 16
    assert (build.CSRC / "d8.cuh").is_file()  # hashed with the sources
    assert str(build.BUILD_DIR.relative_to(ROOT)) == os.path.join("build", "torch_kernels")


def test_entry_points_match_the_sources_and_the_counters():
    """Every ``extern "C"`` launcher in csrc/ is declared for ctypes, and
    every kernel wrapper has a launch counter."""
    import re

    from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters

    declared = set()
    for src in build.sources():
        declared |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert declared == set(build.SIGNATURES)
    reset_launch_counters()
    assert launch_counters() == dict.fromkeys(
        ("stencil", "downslope_walk", "flow_walk", "stencil_padded", "absorbing_walk",
         "downslope_walk_tracked", "flow_walk_blocked"), 0)
    # Each launcher has a wrapper that names it.
    wrappers = "".join(p.read_text() for p in (ROOT / "descriptools_tpu_torch" / "ops" / "cuda").glob("*.py"))
    for name in declared:
        assert f'"{name}"' in wrappers, name


def test_build_compiles_each_source_and_links_them(monkeypatch, tmp_path):
    """With a stand-in nvcc (it writes its -o file): one compile per source
    and one link, the objects removed; a failing compile raises."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'while [ "$#" -gt 0 ]; do if [ "$1" = -o ]; then out=$2; fi; '
        'case "$1" in *walk.cu) [ -n "$FAIL_WALK" ] && { echo broken; exit 2; };; esac; shift; done\n'
        'echo "compiled $out"; : > "$out"\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    lib, _, log = build.build.__wrapped__()
    assert lib.is_file() and log.count("compiled") == len(build.sources()) + 1
    assert [p.name for p in (tmp_path / "out").iterdir() if p.suffix == ".o"] == []
    lib.unlink()
    monkeypatch.setenv("FAIL_WALK", "1")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build.__wrapped__()
