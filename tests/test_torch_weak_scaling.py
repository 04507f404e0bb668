"""``weak_scaling_torch.py`` (weak scaling across cards) on the CPU.

- ``mesh_of`` gives each N its mesh: (1, 1), (1, 2), (2, 2) at 8192^2 a
  card, one block a rank; (2, 2), (2, 4), (4, 4) at 16384^2, four blocks a
  rank, so N = 4 holds 32768^2 = 2^30 cells;
- ``collective_volume_bytes``, the port's count, equals the halo bytes,
  the bytes handed to the group and its calls that ``sharded_suite``
  counts: a world of one in this process on meshes (1, 2) and (2, 2) of
  64^2 blocks, at a downslope halo of one block (64) and past it (100); a
  world of two in the script's run on mesh (1, 2), where the script
  checks it (``tests/test_torch_staged_scale.py`` checks two ranks on
  mesh (2, 2) through the staged script).  Where the halo fits a block
  the count is also the closed form of ``scripts/weak_scaling.py:75-98``
  for the port's item sizes (dem 4 B at halos 1 and d, fdr 1 B at d);
- the script's JSON line at ``--device cpu``, 64^2 a rank, N = 1 and 2
  (its ``main`` in this process, its ranks in processes of their own): a
  row per N, each rank's share of valid cells with every stage, efficiency 1.0 at N = 1,
  the counted bytes equal to the measured, the decomposition overhead
  against the in-core suite, a verdict at N = 2;
- without a card the script raises for ``--device cuda`` (no fallback).

Bytes and calls are compared exactly.  No time is compared: the CPU's
times are not a device measurement.
"""

import json

import pytest

import weak_scaling_torch as ws
from descriptools_tpu_torch import pipeline
from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite
from descriptools_tpu_torch.utils.synthetic import windowed_basin

B = 64  # the blocks' side


@pytest.fixture(scope="module", autouse=True)
def world():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


def test_meshes_hold_the_work_a_card_fixed():
    assert ws.world_sizes(4) == [1, 2, 4] and ws.world_sizes(1) == [1] and ws.world_sizes(3) == [1, 2]
    assert [ws.mesh_of(8192, n) for n in (1, 2, 4)] == [(8192, (1, 1)), (8192, (1, 2)), (8192, (2, 2))]
    assert [ws.mesh_of(16384, n) for n in (1, 2, 4)] == [(8192, (2, 2)), (8192, (2, 4)), (8192, (4, 4))]
    block, (ny, nx) = ws.mesh_of(16384, 4)
    assert ny * block * nx * block == 1 << 30
    assert ws.mesh_of(64, 2) == (64, (1, 2))
    with pytest.raises(ValueError):
        ws.mesh_of(12288, 1)


def _closed_form_cells(ny, nx, h, w, d):
    """scripts/weak_scaling.py's halo cells of one raster (row and column
    phases), for d no wider than a block."""
    return 2 * (ny - 1) * nx * d * w + 2 * (nx - 1) * ny * d * (h + 2 * d)


@pytest.mark.parametrize("halo", [64, 100])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_collective_volume_matches_the_suite_world_of_one(mesh_shape, halo):
    ny, nx = mesh_shape
    shape = (ny * B, nx * B)
    loaders = windowed_basin(*shape, seed=5)
    dem, fdr, river, fac = (loaders[k](0, shape[0], 0, shape[1]) for k in ("dem", "fdr", "river", "fac"))
    mesh = make_mesh(mesh_shape, device="cpu")
    stats = {}
    sharded_suite(dem, fdr, fac, river, pipeline.PipelineConfig(), mesh, downslope_halo=halo, crop=False,
                  stats=stats)
    halos = [a["halo"] for a in stats["downslope_attempts"]]
    measured = {k: stats.get(k, 0) for k in ("halo_bytes", "comm_bytes", "comm_calls")}
    counted = ws.collective_volume_bytes(mesh_shape, 1, B, B, halos)
    assert measured == counted
    assert counted["comm_calls"] == 1 + len(halos)  # one rank: the ring's all-gather and the flags' all-reduces
    if max(halos) <= B:
        cells = sum(_closed_form_cells(ny, nx, B, B, d) for d in halos)
        assert counted["halo_bytes"] == 5 * cells + 4 * _closed_form_cells(ny, nx, B, B, 1)


def test_counted_bytes_between_ranks():
    """Two ranks on mesh (2, 2): the strips between rows of blocks cross
    ranks, those within a row do not."""
    one = ws.collective_volume_bytes((2, 2), 1, B, B, [8])
    two = ws.collective_volume_bytes((2, 2), 2, B, B, [8])
    assert one["halo_bytes"] == two["halo_bytes"]
    # Row phase across the rank boundary: 2 block columns x 2 directions,
    # 8 rows of 64, dem 4 B + fdr 1 B, then 1 row of dem at the pointwise stage.
    cross = 2 * 2 * 8 * B * 5 + 2 * 2 * 1 * B * 4
    ring = 2 * 2 * 8 * 2 * (2 * B) * 4
    assert two["comm_bytes"] == cross + ring + 4 * 2
    assert two["comm_calls"] == 2 * 2 * 2 + 2 * 2 + 2 + 2


def test_script_json_line_one_and_two_ranks(tmp_path, capsys):
    rc = ws.main(["--device", "cpu", "--per-card", str(B), "--cards", "2", "--iters", "1", "--input-cache",
                  str(tmp_path / "inputs"), "--out-json", str(tmp_path / "ws.json")])
    stdout = capsys.readouterr().out
    assert rc == 0, stdout[-3000:]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line == json.loads((tmp_path / "ws.json").read_text())
    assert line["ok"] and line["device"] == "cpu" and line["card"] is None
    rows = line["weak_scaling"]
    assert [(r["devices"], r["mesh"], r["grid"]) for r in rows] == [(1, "1x1", [B, B]), (2, "1x2", [B, 2 * B])]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    for r in rows:
        assert set(r["phases"]) == set(ws.STAGES)
        assert r["collective_bytes_match"] and r["collective_bytes"] == r["collective_bytes_counted"]
        assert r["decomposition_overhead_vs_single_device"] > 0
        assert len(r["staging_s_per_rank"]) == r["devices"] and r["blocks_per_rank"] == 1
        assert r["cells"] == B * B * r["devices"]
        assert len(r["valid_share_per_rank"]) == r["devices"] and all(0 < v <= 1 for v in r["valid_share_per_rank"])
    assert rows[1]["collective_bytes"]["comm_calls"] > rows[0]["collective_bytes"]["comm_calls"]
    assert [v["devices"] for v in line["conclusion"]] == [2]
    assert "valid cells a rank" in line["conclusion"][0]["text"]
    assert "host_serialization_ceiling" not in rows[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["inputs", "ws.json"]  # it writes nothing else


def test_script_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.main(["--cards", "1", "--per-card", str(B), "--input-cache", str(tmp_path / "in")])
    assert not (tmp_path / "in").exists()


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_null_program_leaves_the_blocks(dtype):
    import torch

    t = torch.arange(12, dtype=getattr(torch, dtype)).reshape(3, 4)
    ws.null_program([t], sweeps=2)
    assert torch.equal(t, torch.arange(12, dtype=t.dtype).reshape(3, 4))
