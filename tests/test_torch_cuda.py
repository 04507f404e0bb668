"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere they skip.
They import no JAX, so on a machine without it run them without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.ops import downslope as down
from descriptools_tpu_torch.ops import flow
from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
from descriptools_tpu_torch.ops.cuda import stencil as st
from descriptools_tpu_torch.ops.cuda import walk
from descriptools_tpu_torch.utils.synthetic import windowed_basin

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def basin():
    loaders = windowed_basin(130, 257, seed=1)
    return {k: f(0, 130, 0, 257) for k, f in loaders.items()}


def test_stencil_kernel_matches_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fac = torch.as_tensor(basin["fac"], device=dev)
    got = st.stencil(dem_f, fac, 12.5, 0.1)
    want = st.stencil_plain(dem_f, fac, 12.5, 0.1)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4, equal_nan=True)


def test_walk_kernels_match_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fdr = torch.as_tensor(basin["fdr"], device=dev)
    ops = down.walk_inputs(dem_f, fdr, 12.5)
    for g, w in zip(walk.downslope_walk(*ops, 5.0, 5000), down.jacobi_walk(*ops, 5.0, 5000)):
        assert torch.equal(g, w)
    ops = flow.walk_inputs(fdr, torch.as_tensor(basin["river"], device=dev))
    for g, w in zip(walk.flow_walk(*ops, 20000), flow.doubling_walk(*ops, 20000)):
        assert torch.equal(g, w)


def test_suite_runs_every_kernel_and_matches_plain(dev, basin):
    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(*inputs)
    assert launch_counters() == dict(
        stencil=1, downslope_walk=1, flow_walk=1,
        stencil_padded=0, absorbing_walk=0, downslope_walk_tracked=0, flow_walk_blocked=0,
    )
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    for k in ("slope", "downslope", "fdist", "indices", "hand"):
        assert torch.equal(out[k], plain[k]), k
    for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        torch.testing.assert_close(out[k], plain[k], rtol=2e-5, atol=1e-4, equal_nan=True)
    got = pipeline.classify_flood(out["hand"], basin["flood"])
    want = pipeline.classify_flood(plain["hand"], basin["flood"])
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_kernel_wrappers_refuse_wrong_dtype(dev):
    z = torch.zeros((4, 5), device=dev)
    with pytest.raises(ValueError, match="int32"):
        walk.downslope_walk(z, z, z, 5.0, 10)


def test_stencil_padded_kernel_matches_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fac = torch.as_tensor(basin["fac"], device=dev)
    padded = dem_f[20:92, 30:201].contiguous()  # real halo on all four sides
    fac_in = fac[21:91, 31:200]
    got = st.stencil_padded(padded, fac_in, 12.5, 0.1)
    want = st.stencil_padded_plain(padded, fac_in, 12.5, 0.1)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4, equal_nan=True)
    # NoData ring around the whole grid: bitwise the in-core stencil's slope.
    whole = torch.full((132, 259), -100.0, device=dev)
    whole[1:-1, 1:-1] = dem_f
    assert torch.equal(st.stencil_padded(whole, fac, 12.5, 0.1)[0], st.stencil(dem_f, fac, 12.5, 0.1)[0])


def test_tracked_and_absorbing_walk_kernels_match_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)[10:90, 20:200].contiguous()
    fdr = torch.as_tensor(basin["fdr"], device=dev)[10:90, 20:200].contiguous()
    tr0 = down.trunc_cells(dem_f, fdr, 10, 20, 130, 257)
    ops = down.walk_inputs(dem_f, fdr, 12.5)
    got = walk.downslope_walk_tracked(*ops, 5.0, 5000, tr0)
    want = down.jacobi_walk(*ops, 5.0, 5000, tr0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any())  # some walks of this window are cut
    river = torch.as_tensor(basin["river"], device=dev)[10:90, 20:200].contiguous()
    loc_ops = flow.walk_inputs(fdr, river)
    for g, w in zip(walk.absorbing_walk(*loc_ops, 20000), flow.doubling_walk(*loc_ops, 20000)):
        assert torch.equal(g, w)


def test_tiled_suite_runs_the_tile_kernels_and_matches_incore(dev):
    rows, cols = 200, 230
    loaders = windowed_basin(rows, cols, seed=3)
    reset_launch_counters()
    stats = {}
    got = tiled.tiled_suite(loaders, (rows, cols), pipeline.PipelineConfig(), dev,
                            tile_rows=64, tile_cols=96, stats=stats)
    n = launch_counters()
    assert stats["tiles"] == 12 and n["absorbing_walk"] == 2 * 12
    assert n["stencil_padded"] == 12 and n["downslope_walk_tracked"] >= 12
    full = {k: f(0, rows, 0, cols) for k, f in loaders.items()}
    want = pipeline.descriptor_suite(
        *pipeline.inputs_to_torch(full["dem"], full["fdr"], full["fac"], full["river"], dev)
    )
    for k in ("indices", "hand", "downslope", "slope", "fdist"):
        np.testing.assert_array_equal(got[k], want[k].cpu().numpy(), err_msg=k)
    for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        np.testing.assert_allclose(got[k], want[k].cpu().numpy(), rtol=2e-5, atol=1e-4, err_msg=k)


def test_flow_walk_blocked_kernel_matches_fold_walk(dev, basin):
    def lateral(rows, cols):
        fdr = np.full((rows, cols), 1, np.uint8)
        fdr[:, -1] = 64
        river = np.zeros((rows, cols), np.int8)
        river[0, -1] = 1
        return fdr, river

    cases = [(basin["fdr"], basin["river"], 20000), (*lateral(150, 170), 20000), (*lateral(150, 170), 37)]
    for fdr, river, max_steps in cases:
        ops = flow.walk_inputs(torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev))
        consts = flow.step_consts(12.5)
        got = walk.flow_walk_blocked(*ops, *consts, max_steps)
        want = flow.fold_walk(*ops, *consts, max_steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        idx = flow.flow_from_state(*walk.flow_walk(*ops, max_steps), 12.5, max_steps)[1]
        assert torch.equal(flow.flow_from_fold(*got)[1], idx)


def test_checkpointed_cuda_blocked_matches_the_fused_suite(dev, basin, tmp_path):
    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    cfg = pipeline.PipelineConfig(engine="cuda_blocked")
    reset_launch_counters()
    out = pipeline.run_suite_checkpointed(*inputs, cfg, str(tmp_path / "ck"))
    n = launch_counters()
    assert n["flow_walk_blocked"] == 1 and n["stencil"] == 1 and n["downslope_walk"] == 1
    assert n["flow_walk"] == 0
    fused = pipeline.descriptor_suite(*inputs, cfg)
    for k in fused:
        assert out[k].device == fused[k].device and torch.equal(out[k], fused[k]), k
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch_blocked"))
    for k in ("slope", "downslope", "fdist", "indices", "hand"):
        assert torch.equal(fused[k], plain[k]), k
