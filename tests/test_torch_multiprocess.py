"""The port's staged sharded suite across processes: worlds of 1 and 2 gloo
processes on the CPU, each rank owning 8 / world blocks of a (2, 4) mesh,
through ``staged_scale_torch.py``'s default mode (its ranks started by
``ranks_torch.run_ranks``).

Counterpart of ``tests/test_multiprocess.py``.  Each rank stages
``windowed_basin(45, 53, seed=21)`` through ``sharded_suite_staged`` with a
flood loader and checkpoints (no rank holds a global raster), checks each
of its blocks against the port's in-core suite on the identically padded
grid and the one-card classifier, then resumes from the checkpoints.
45x53 divides by no mesh, so the padding, the padded-grid downslope origin
and the renumbered indices are all exercised.  Tolerances (the script's):
indices, HAND, river_fac, downslope, slope, fdist, threshold, Fit,
Correctness and the class map bitwise; the transcendental rasters within
rtol 2e-5, atol 1e-4.  The ranks import no JAX; the in-core suite they
compare with is held to JAX by ``tests/test_torch_pipeline.py``.
"""

import json

import pytest

import staged_scale_torch as ss


@pytest.mark.parametrize("world", [1, 2])
def test_staged_suite_across_process_counts(world, tmp_path):
    out = tmp_path / "staged.json"
    rc = ss.main(["--device", "cpu", "--cards", str(world), "--n", "45", "53", "--mesh", "2", "4", "--iters", "1",
                  "--out-json", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and res["ok"] and res["failures"] == [], res["failures"]
    assert (res["ranks"], res["backend"], res["padded_grid"]) == (world, "gloo", [46, 56])
    assert res["rank_blocks"] == [list(range(r * 8 // world, (r + 1) * 8 // world)) for r in range(world)]
    assert res["resume"]["stages_saved_again"] == []
    assert res["collective_bytes_match"]
