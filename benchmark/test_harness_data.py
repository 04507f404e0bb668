"""The harness on the CPU: driven by data, free of JAX, its last line, and
no run without a card."""

import ast
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness, kernels
from benchmark.conftest import HERE, ROOT

WORKLOADS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, workload, traced, seed=2**31 + 11, seconds=0.3):
    return harness.Run(harness.Spec(root, workload), seed, seconds, traced, device="cpu").execute()


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(tiny, workload, traced):
    r = run(tiny, workload, traced)
    assert list(r) == KEYS + (["breakdown"] if traced else []) + ["checked"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in r["checked"].values())
    spec = harness.Spec(tiny, workload)
    if not traced:
        assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end}
    json.dumps(r, allow_nan=False)


NEW_KIND = '''"""Terrain and the suite, no calibration: a job kind added as a file."""

import torch

from benchmark.reference import suite, terrain


def run(program, x, traffic, probe):
    from descriptools_tpu_torch.ops.terrain import derive_terrain
    from descriptools_tpu_torch.pipeline import descriptor_suite

    fdr, fac = derive_terrain(x["dem"])
    river = (fac > traffic["river"]["fac_above"]).to(torch.int8)
    with probe.span("suite"):
        out = descriptor_suite(x["dem"], fdr, fac, river, program.cfg)
    out.update(fdr=fdr, fac=fac, river=river)
    return out


def reference(x, pipeline, traffic, dtype=torch.float32, classify_dtype=torch.float64):
    fdr, fac = terrain.derive(x["dem"], dtype)
    river = (fac > traffic["river"]["fac_above"]).to(torch.int8)
    out, steps = suite.suite(x["dem"], fdr, fac, river, pipeline, dtype)
    out.update(fdr=fdr, fac=fac, river=river)
    return out, suite.walk_summary(steps, x["dem"], out["indices"])
'''

NEW_GENERATOR = '''"""synthetic_dem raised by ``lift``: a generator added as a file."""

from benchmark import found


def make(rows, cols, seed, device, lift=0, **params):
    x = found.module("generators", "synthetic_dem").make(rows, cols, seed, device, **params)
    x["dem"] = x["dem"] + lift * (x["dem"] != -100)
    return x
'''


def test_new_files_run_unedited(tiny):
    """A configuration, a generator, a mix, a job kind, a cell, its limits,
    a per-layer metric and a kernel added as files and entries are run and
    read; no file that was there changes."""
    before = {p: p.read_bytes() for p in tiny.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    b = tiny / "benchmark"
    cfg = json.loads((b / "configs" / "srtm_tile_10k.json").read_text())
    cfg.update(name="small_tile", rows=40, cols=32)
    (b / "configs" / "small_tile.json").write_text(json.dumps(cfg))
    (b / "generators" / "raised_dem.py").write_text(NEW_GENERATOR)
    (b / "jobs" / "terrain_suite.py").write_text(NEW_KIND)
    mix = dict(job="terrain_suite", pool=3, dem=dict(generator="raised_dem", smooth=5, amp=60, lift=500),
               river=dict(fac_above=8), sample_pairs=1, trace_jobs=3)
    (b / "traffic" / "terrain_only.json").write_text(json.dumps(mix))
    limits = json.loads((b / "limits" / "srtm_tile_10k.dem_to_classmap.json").read_text())["limits"]
    for k in ("class_map", "threshold", "correctness", "fit"):
        limits.pop(k)
    (b / "limits" / "small_tile.terrain_only.json").write_text(json.dumps(dict(limits=limits)))
    (b / "metrics" / "pool.inputs.py").write_text(
        '"""Inputs in the pool."""\n\n\ndef read(ctx):\n    return len(ctx.pool)\n')
    (b / "kernels" / "extra.py").write_text(
        'NAMES = ("extra_kernel",)\n\n\ndef bytes_moved(cells, operands):\n    return 4 * cells\n')
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="small_tile", source="https://example.org/small",
                                 file="benchmark/configs/small_tile.json", reduced=[], why="a test"))
    bench["workloads"].append(dict(name="small_tile.terrain_only", config="small_tile",
                                   traffic="terrain_only", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="pool.inputs", unit="inputs", better="higher",
                                   source="program_counter", layer="inputs", moves="setup_s",
                                   workloads=["small_tile.terrain_only"]))
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    timed = run(tiny, "small_tile.terrain_only", False)
    assert timed["correct"] is True
    assert set(timed["checked"]) == set(limits)
    traced = run(tiny, "small_tile.terrain_only", True)
    assert traced["correct"] is True
    assert traced["metrics"]["pool.inputs"] == dict(value=3, unit="inputs")
    assert "extra_kernel" in kernels.own_names(tiny)
    assert all(p.read_bytes() == data for p, data in before.items())


def _imports(path):
    """Top-level names and benchmark modules a source file imports."""
    names, local = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for m in mods:
            names.add(m.split(".")[0])
            if m.startswith("benchmark."):
                local.add(m)
    return names, local


def _tree(path, seen=None):
    """Top-level names imported by ``path`` and the benchmark modules it
    imports, followed through them."""
    seen = set() if seen is None else seen
    if path in seen:
        return set()
    seen.add(path)
    names, local = _imports(path)
    for m in local:
        parts = m.split(".")[1:]
        for cand in (HERE.joinpath(*parts).with_suffix(".py"), HERE.joinpath(*parts, "__init__.py")):
            if cand.is_file():
                names |= _tree(cand, seen)
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_import_tree_free_of_jax(path):
    found = _tree(path) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(HERE).parts:
        assert "descriptools_tpu_torch" not in _tree(path), f"{path} reaches the program"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "descriptools_tpu_torchx", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "descriptools_tpu.ops", types.ModuleType("ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("numpy"))
    assert harness.forbidden_modules() == ["descriptools_tpu", "jax"]


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", "7",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_meets_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    reported = {c: {m["name"] for m in bench["end_to_end"] if c in m.get("workloads", [c])} for c in cells}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells and any(
            (HERE / "metrics" / f"{n}.py").is_file() for n in (m["name"], m["name"].rsplit(".", 1)[0]))
        assert all(m["moves"] in reported[w] for w in m["workloads"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_card_run(card, workload):
    """One short run of each cell on the card: a result, and correct."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483999",
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
