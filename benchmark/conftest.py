"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
found by name, at tiny sizes, which the harness runs on the CPU with the program's plain
engines, and the card fixture of the tests marked ``cuda``."""

import json
import shutil
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
torch.set_num_threads(1)  # several test workers share this machine's cores
TINY = {"example_basin": (64, 48), "srtm_tile_10k": (80, 72)}


def tiny_copy(dst):
    """BENCHMARK.json and the benchmark's files found by name under ``dst``, the
    configurations cut to a few thousand cells and the long-drainage mix
    scaled to them."""
    dst = Path(dst)
    (dst / "benchmark").mkdir(parents=True)
    for d in ("configs", "traffic", "limits", "metrics", "jobs", "generators", "kernels"):
        shutil.copytree(HERE / d, dst / "benchmark" / d, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    for name, (rows, cols) in TINY.items():
        p = dst / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(rows=rows, cols=cols)
        p.write_text(json.dumps(cfg))
    for mix in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(mix.read_text())
        t["trace_jobs"] = 3
        if mix.stem == "long_drainage":
            t["dem"].update(smooth=31, amp=2000)
            t["river"]["fac_above"] = 30
            t["pipeline"]["elevation_difference"] = 100
        mix.write_text(json.dumps(t))
    return dst


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path / "checkout")


@pytest.fixture
def card():
    """The card, or a skip where this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
