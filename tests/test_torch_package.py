"""Rules of the PyTorch port's package, of chip_smoke.py and of the
scripts at the root (config5_torch.py, weak_scaling_torch.py,
staged_scale_torch.py and their rank launcher ranks_torch.py).

- the port imports neither jax, orbax nor descriptools_tpu;
- chip_smoke.py and the scripts import neither, fail fast without a GPU,
  and print no result when they fail;
- make_north_star_reference.py (the JAX side of the parity reference)
  imports nothing of the port;
- the CUDA route refuses CPU tensors and a missing compiler;
- completeness: every public function and class of the JAX package outside
  ``ops/pallas/`` has a counterpart in the same module of the port, taking
  at least JAX's parameter names, but for the TPU-only exceptions listed
  with their reasons.
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
CONFIG5 = ROOT / "config5_torch.py"
WEAK = ROOT / "weak_scaling_torch.py"
STAGED = ROOT / "staged_scale_torch.py"
RANKS = ROOT / "ranks_torch.py"


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


@pytest.mark.parametrize("path", [SMOKE, CONFIG5, WEAK, STAGED, RANKS,
                                  *sorted((ROOT / "descriptools_tpu_torch").rglob("*.py"))],
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


def test_config5_imports_no_jax_at_run_time():
    code = (
        "import sys\n"
        "import config5_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'descriptools_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["weak_scaling_torch", "staged_scale_torch", "ranks_torch"])
def test_scale_scripts_import_no_jax_at_run_time(module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'descriptools_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reference_maker_imports_no_port():
    tree = ast.parse((ROOT / "make_north_star_reference.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "descriptools_tpu" in {n.split(".")[0] for n in names}
    assert not [n for n in names if n.split(".")[0] == "descriptools_tpu_torch"], names


def test_config5_without_gpu_fails_fast_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: config5_torch.py would run")
    proc = subprocess.run([sys.executable, str(CONFIG5), "--n", "64", "--tile", "32", "--out-dir",
                           str(tmp_path / "out"), "--input-cache", str(tmp_path / "in")],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CONFIG5" not in proc.stdout and '"ok"' not in proc.stdout
    assert not (tmp_path / "in").exists()  # it wrote nothing


@pytest.mark.parametrize("argv", [
    [str(WEAK), "--per-card", "64", "--cards", "1"],
    [str(STAGED), "--config5", "--n", "64", "--mesh", "2", "2"],
    [str(STAGED), "--n", "64", "--mesh", "2", "2"],
], ids=["weak_scaling", "staged_config5", "staged_default"])
def test_scale_scripts_without_gpu_fail_fast_and_print_no_result(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    proc = subprocess.run([sys.executable, *argv, "--input-cache", str(tmp_path / "in")]
                          + (["--work-dir", str(tmp_path / "work")] if argv[0] == str(STAGED) else []),
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "STAGED" not in proc.stdout
    assert not (tmp_path / "in").exists() and not (tmp_path / "work").exists()  # it wrote nothing


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


# What the port leaves out of the JAX package's API on purpose: (module,
# name) -> the JAX parameters it lacks (None: the whole function), with the
# reason (ROADMAP.md, "Not ported").
_INTERPRET = "Pallas interpret mode: the port's kernels run their plain versions on CPU tensors instead"
_MESH = "JAX-mesh arguments: the port's mesh is a block layout over the ranks of a torch.distributed group"
TPU_ONLY = {
    ("d8", "jax_slice"): (None, "a helper named for jnp slicing; the port slices tensors in place"),
    ("parallel/boundary", "local_flow_summary"): (
        {"px", "interpret"}, "the port carries step counts through the ring and forms fdist once a block; "
        + _INTERPRET),
    ("parallel/halo", "halo_exchange"): ({"block", "axis_names"}, "a shard_map block; " + _MESH),
    ("parallel/mesh", "make_mesh"): ({"devices", "axis_names"}, _MESH),
    ("parallel/multihost", "global_mesh"): ({"axis_names"}, _MESH),
    ("parallel/multihost", "initialize"): (
        {"coordinator_address", "num_processes", "process_id"},
        "jax.distributed's arguments; the port's process group takes init_method, world_size and rank"),
    ("parallel/sharded", "sharded_flow_hand"): ({"interpret"}, _INTERPRET),
    ("parallel/sharded", "sharded_downslope"): ({"interpret"}, _INTERPRET),
    ("tiled", "tiled_flow_hand"): ({"interpret"}, _INTERPRET),
    ("tiled", "tiled_suite"): ({"interpret"}, _INTERPRET),
    ("utils/checkpoint", "load_stage"): ({"like"}, "the orbax branch's restore template; the port reads "
                                         "and writes the .npz branch"),
}


def _public_api(path):
    """{name: parameter names (None for a class)} of a module's top level."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            if isinstance(node, ast.ClassDef):
                out[node.name] = None
            else:
                a = node.args
                out[node.name] = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    return out


def test_the_port_has_every_public_function_of_the_jax_package():
    jax_root, port_root = ROOT / "descriptools_tpu", ROOT / "descriptools_tpu_torch"
    missing, seen = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root)
        if rel.parts[:2] == ("ops", "pallas"):
            continue
        module = str(rel.with_suffix(""))
        port_path = port_root / rel
        assert port_path.is_file(), f"no port of {rel}"
        port = _public_api(port_path)
        for name, params in _public_api(path).items():
            exempt, _ = TPU_ONLY.get((module, name), (set(), ""))
            if exempt is None:
                seen.add((module, name))
                assert name not in port, f"{module}.{name} is ported: drop it from TPU_ONLY"
                continue
            if name not in port:
                missing.append(f"{module}.{name}")
                continue
            lacking = set() if params is None else params - port[name]
            if exempt:
                seen.add((module, name))
                assert exempt <= params, (module, name, exempt - params)
            if lacking - exempt:
                missing.append(f"{module}.{name}({', '.join(sorted(lacking - exempt))})")
            assert not exempt & (port[name] or set()), f"{module}.{name} takes {exempt & port[name]}: drop them"
    assert not missing, f"JAX API without a counterpart in the port: {missing}"
    assert seen == set(TPU_ONLY), set(TPU_ONLY) - seen
    assert all(reason for _, reason in TPU_ONLY.values())
