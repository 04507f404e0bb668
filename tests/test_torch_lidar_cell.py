"""The benchmark's float-DEM cell on the CPU: ``lidar_3dep_1m
.float_dem_to_classmap`` (``benchmark/``) run by its own harness, the
program's plain engines against the benchmark's plain reference, every
output within the cell's limits file.

The configuration is 10000² cells of 1 m; here it runs at 256², its
lengths cut with it (the generator's hill and valley widths by 256/10000,
the river's contributing area by (256/10000)², so that the tile still
drains to rivers and HAND has a range to calibrate).  The job is the
cell's own: ``derive_terrain`` on a float32 DEM, the suite (exact terminal
elevations in the downslope walk), and ``sharded_classify_flood`` on float
HAND (a float32 cutoff a threshold, one counting pass a search stage).
"""

import importlib

import pytest
import torch

from benchmark import harness
from benchmark.conftest import ROOT

CELL = "lidar_3dep_1m.float_dem_to_classmap"
N = 256


def _spec():
    spec = harness.Spec(ROOT, CELL)
    scale = N / spec.rows
    spec.rows = spec.cols = N
    dem = spec.traffic["dem"]
    for key in ("hills", "valleys"):
        dem[key] = 2 * max(1, round(dem[key] * scale / 2)) + 1
    spec.traffic["river"]["fac_above"] = max(1, round(spec.traffic["river"]["fac_above"] * scale * scale))
    return spec


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [2**31 + 11, 3141592653])
def test_float_dem_cell_is_correct_on_the_cpu(seed):
    spec = _spec()
    run = harness.Run(spec, seed, 0.3, False, device="cpu")
    result = run.execute()
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["checked"]) == set(spec.limits)
    assert all(c["value"] <= c["limit"] for c in result["checked"].values())


def test_float_dem_cell_takes_the_float_paths():
    """The cell's inputs reach what it is for: a fractional DEM, float HAND
    (the float calibration path), and downslope walks that stop at a
    terminal of fractional elevation."""
    spec = _spec()
    x = harness.inputs.make_input(spec.traffic, N, N, 2**31 + 11, "cpu", spec.root)
    dem = x["dem"]
    assert dem.dtype == torch.float32 and bool((dem != torch.round(dem)).any())
    program = harness.jobs.Program(spec.pipeline)
    out = spec.kind.run(program, x, spec.traffic, harness.jobs.Probe())
    hand = out["hand"]
    assert bool(((hand != -100) & (hand != torch.round(hand))).any())
    assert 0.0 < out["fit"] <= 1.0
    down = importlib.import_module("descriptools_tpu_torch.ops.downslope")
    fdr_eff, z, term0 = down.walk_inputs(dem, out["fdr"], spec.pipeline["px"])
    pk, zs = down.jacobi_walk(fdr_eff, z, term0, spec.pipeline["elevation_difference"], 5000)
    terminal_stop = (pk > 0) & (z - zs < spec.pipeline["elevation_difference"]) & (z != -100)
    assert bool(terminal_stop.any())
    assert bool((zs[terminal_stop] * 16 != torch.round(zs[terminal_stop] * 16)).any())
