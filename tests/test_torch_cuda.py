"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere they skip.
They import no JAX, so on a machine without it run them without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import importlib
import os

import numpy as np
import pytest
import torch

from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.ops import flow
from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
from descriptools_tpu_torch.ops.cuda import stencil as st
from descriptools_tpu_torch.ops.cuda import walk
from descriptools_tpu_torch.utils.synthetic import (
    accumulation_cases,
    adversarial_dem,
    d8_division_pin,
    d8_ties,
    downslope_cases,
    windowed_basin,
)
# The module: the package binds ops.downslope to the function of that name.
down = importlib.import_module("descriptools_tpu_torch.ops.downslope")

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


def _check_stage(got, want):
    assert torch.equal(got[0], want[0])  # slope, bitwise
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("fac_dtype", [torch.int32, torch.float32])
def test_stencil_kernels_match_plain_at_ragged_shapes(dev, fac_dtype):
    """K2 (whole grid) and K1 (padded block) against their plain versions at
    shapes that are not multiples of the kernel's 32 x 32 tile, on
    adversarial elevations, with fac read in its own type."""
    rng = np.random.default_rng(23)
    for rows, cols in ((1, 1), (3, 5), (17, 33), (2178, 1534), (4096, 4096)):
        fac = torch.as_tensor(rng.integers(-150, 5000, size=(rows, cols)), device=dev).to(fac_dtype)
        cases = [(st.stencil_padded, st.stencil_padded_plain, (rows + 2, cols + 2))]
        if rows < 4096:
            cases.append((st.stencil, st.stencil_plain, (rows, cols)))
        for fn, plain, shape in cases:
            src = torch.as_tensor(adversarial_dem(rng, shape), device=dev)
            before = fn.launches
            got = fn(src, fac, 12.5, 0.1)
            assert fn.launches == before + 1
            _check_stage(got, plain(src, fac, 12.5, 0.1))


def test_walk_kernels_match_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fdr = torch.as_tensor(basin["fdr"], device=dev)
    before = walk.downslope_walk.launches
    got = walk.downslope_walk(dem_f, fdr, 12.5, 5.0, 5000)
    assert walk.downslope_walk.launches == before + 1
    assert torch.equal(got, down._downslope_jacobi(dem_f, fdr, 12.5, 5.0, 5000))
    river = torch.as_tensor(basin["river"], device=dev)
    ops = flow.walk_inputs(fdr, river)
    want = flow.doubling_walk(*ops, 20000)
    for g, w in zip(walk.absorbing_walk(*ops, 20000), want):
        assert torch.equal(g, w)
    _assert_flow_bitwise(walk.flow_cuda(fdr, river, 12.5, 20000), flow.flow_from_state(*want, 12.5, 20000),
                         "basin")


def test_suite_runs_every_kernel_and_matches_plain(dev, basin):
    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(*inputs)
    assert launch_counters() == dict(
        stencil=1, downslope_walk=1, flow_walk=1,
        stencil_padded=0, absorbing_walk=0, downslope_walk_tracked=0, flow_walk_blocked=0,
        cutoff_count=0, d8_successor=0, accumulation=0,
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


@pytest.mark.parametrize("fdr_dtype", [torch.uint8, torch.int32, torch.int16, torch.int64])
def test_downslope_kernel_matches_plain_on_adversarial_cases(dev, fdr_dtype):
    """The fused kernel against its plain version on every fixture of
    ``downslope_cases``, with fdr in each dtype (257 and -1 stay invalid in
    the wider ones: int32 as the kernel reads it, int16 and int64 through
    the wrapper's mapping)."""
    for name, (dem, fdr, ed, max_steps) in downslope_cases().items():
        dem_f = torch.as_tensor(dem, device=dev)
        f = torch.as_tensor(fdr, device=dev)
        if fdr_dtype == torch.uint8:
            f = torch.where((f >= 0) & (f <= 255), f, 0)  # codes uint8 holds
        f = f.to(fdr_dtype)
        got = walk.downslope_walk(dem_f, f, 12.5, ed, max_steps)
        assert torch.equal(got, down._downslope_jacobi(dem_f, f, 12.5, ed, max_steps)), name


def test_tracked_kernel_matches_plain_on_the_interior(dev, basin):
    """The tracked kernel launched over a window's interior against the plain
    composition (trunc_cells, the tracked walk, the interior), at several
    halos, on a basin window, on the adversarial int16 window and on a
    fractional window whose walks all stop at its east edge (exact terminal
    elevations, bitwise in both)."""
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)[10:90, 20:200].contiguous()
    fdr = torch.as_tensor(basin["fdr"], device=dev)[10:90, 20:200].contiguous()
    dem_a, fdr_a, _, _ = downslope_cases()["fdr_int16"]
    dem_x, fdr_x, _, _ = downslope_cases()["fractional_terminal_stops"]
    windows = [(dem_f, fdr, (10, 20), (130, 257)),
               (torch.as_tensor(np.round(dem_a), device=dev), torch.as_tensor(fdr_a, device=dev),
                (0, 9), (40, 86)),
               (torch.as_tensor(dem_x, device=dev), torch.as_tensor(fdr_x, device=dev), (0, 0), (40, 112))]
    for d, f, origin, grid in windows:
        for halo in (0, 1, 6, 17):
            got = walk.downslope_walk_tracked(d, f, 12.5, 5.0, 5000, *origin, *grid, halo)
            want = down.downslope_window(d, f, 12.5, 5.0, 5000, *origin, *grid, halo)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (origin, halo)
    assert bool(walk.downslope_walk_tracked(dem_f, fdr, 12.5, 5.0, 5000, 10, 20, 130, 257, 0)[1].any())


def test_kernel_wrappers_refuse_wrong_dtype(dev):
    z = torch.zeros((4, 5), device=dev)
    u8 = torch.zeros((4, 5), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        walk.downslope_walk(z.to(torch.int32), u8, 12.5, 5.0, 10)
    with pytest.raises(ValueError, match="float32"):
        walk.downslope_walk_tracked(z.double(), u8, 12.5, 5.0, 10, 0, 0, 4, 5, 1)
    with pytest.raises(ValueError, match="integer dtype"):
        walk.downslope_walk(z, z, 12.5, 5.0, 10)
    i = torch.zeros((4, 5), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="2\\^30"):
        walk.absorbing_walk(i, i, 1 << 30)
    with pytest.raises(ValueError, match="2\\^30"):
        walk.flow_cuda(i, u8, 12.5, 1 << 30)


def _cycles(rows=96, cols=130, seed=3):
    """Random D8 field: 2-cycles, fdr-0 cells, border exits, river cells."""
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    fdr = codes[rng.integers(0, 8, size=(rows, cols))]
    fdr[5, 10], fdr[5, 11] = 1, 16
    fdr[rng.random((rows, cols)) < 0.03] = 0
    river = (rng.random((rows, cols)) < 0.05).astype(np.int8)
    return fdr, river


def _serpentine(rows=200, cols=200):
    fdr = np.zeros((rows, cols), np.uint8)
    for r in range(rows):
        fdr[r, :] = 1 if r % 2 == 0 else 16
        fdr[r, -1 if r % 2 == 0 else 0] = 4
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
    return fdr, river


def _b_boundary(delta, k=4):
    """Eastward rows of B * 2^k + 1 steps into a river column, at a cap of
    B * 2^k + delta (B = walk.jump_bound())."""
    bound = walk.jump_bound()
    steps = (bound << k) + 1
    fdr = np.ones((8, steps + 1), np.uint8)
    river = np.zeros((8, steps + 1), np.int8)
    river[:, -1] = 1
    return fdr, river, (bound << k) + delta


def test_jump_walk_kernel_matches_plain_without_a_sync(dev):
    """The jump walk, both entry points (over walk operands, and the
    in-core flow entry from the rasters to fdist and indices), bitwise the
    plain doubling engine on cycles, a serpentine over the cap and the
    B-boundary caps, with every host synchronisation an error."""
    cases = [(*_cycles(), 300), (*_serpentine(), 20000), (*_serpentine(), 60000),
             *(_b_boundary(d) for d in (-1, 0, 1))]
    for fdr, river, max_steps in cases:
        fdr_t, river_t = torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev)
        ops = flow.walk_inputs(fdr_t, river_t)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = walk.absorbing_walk(*ops, max_steps)
            fused = walk.flow_cuda(fdr_t, river_t, 12.5, max_steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = flow.doubling_walk(*ops, max_steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (fdr.shape, max_steps)
        _assert_flow_bitwise(fused, flow.flow_from_state(*want, 12.5, max_steps), (fdr.shape, max_steps))
    # the least R with B << R >= the last cap, B * 2^4 + 1
    assert walk.flow_walk.rounds == walk.absorbing_walk.rounds == 5


def _assert_flow_bitwise(got, want, what):
    """(fdist, indices) equal bit for bit: fdist compared as int32 bits."""
    for g, w, name in zip(got, want, ("fdist", "indices")):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, what)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (name, what)


def _adversarial_flow(fdr_dtype, rows=67, cols=131, seed=29):
    """fdr and river of every role and corner of the truth table: fdr 0, 3,
    255 and every D8 code (and, wider than uint8, 257 and -1); river 0, 1
    and 2; river cells with fdr 0, with an invalid code and pointing off
    the grid; non-river cells pointing off the grid; two-cell cycles."""
    rng = np.random.default_rng(seed)
    wide = fdr_dtype != torch.uint8
    fdr = rng.choice(np.array([0, 3, 255, 1, 2, 4, 8, 16, 32, 64, 128] + [257, -1] * wide), size=(rows, cols))
    d8 = np.array([1, 2, 4, 8, 16, 32, 64, 128])
    mostly = rng.random((rows, cols)) < 0.8  # long enough walks: mostly D8 codes
    fdr[mostly] = d8[rng.integers(0, 8, size=int(mostly.sum()))]
    river = rng.choice(np.array([0, 1, 2], np.int8), size=(rows, cols), p=[0.9, 0.07, 0.03])
    fdr[0, :], river[0, :] = 64, 1           # river cells pointing off the top edge
    fdr[-1, :] = 4                           # non-river cells pointing off the bottom edge
    river[-1, ::2] = 0
    fdr[1:, 0], river[1:, 0] = 16, 0         # and off the left edge
    fdr[5, 10:14], river[5, 10:14] = (0, 3, 255, 0), 1  # rivers with fdr 0 or an invalid code
    fdr[9, 20], fdr[9, 21], river[9, 20:22] = 1, 16, 0  # a two-cell cycle
    fdr[12, 30], fdr[13, 30], river[12:14, 30] = 4, 64, 2
    if wide:
        fdr[20, 40:44], river[20, 40:44] = (257, -1, 257, -1), (1, 1, 0, 2)
    return torch.as_tensor(fdr).to(fdr_dtype), torch.as_tensor(river)


def _long_drainage(dev):
    """fdr and river of the long-drainage set at 2178 x 1534, made on the
    card from ``tests/data/long_drainage_reference.npz``'s parameters
    (walks of up to 1409 steps)."""
    from descriptools_tpu_torch.utils import parity

    ref = parity.load(os.path.join(os.path.dirname(__file__), "data", "long_drainage_reference.npz"))
    _, (_, fdr, _, river) = parity.long_drainage_inputs(ref, 2178, 1534, dev)
    return fdr, river


@pytest.mark.parametrize("case", ["basin", "long_drainage", "ragged", "adversarial_uint8",
                                  "adversarial_int32", "adversarial_int16", "serpentine"])
def test_flow_entry_matches_the_walk_operand_path(dev, basin, case):
    """``flow_cuda``, one C entry from fdr and river to fdist and indices,
    bit for bit ``walk_inputs`` -> ``doubling_walk`` -> ``flow_from_state``
    (and the jump walk over the same operands, ``absorbing_walk``) at the
    caps 1, B, B + 1 and 20000, counted as one flow walk launch."""
    bound = walk.jump_bound()
    if case == "basin":
        grids = [(torch.as_tensor(basin["fdr"]), torch.as_tensor(basin["river"]))]
    elif case == "long_drainage":
        grids = [_long_drainage(dev)]
    elif case == "ragged":
        rng = np.random.default_rng(5)
        grids = []
        for rows, cols in ((1, 1), (1, 300), (300, 1), (17, 33), (255, 257), (3, 1000)):
            fdr = np.array([1, 2, 4, 8, 16, 32, 64, 128, 0], np.uint8)[rng.integers(0, 9, size=(rows, cols))]
            river = (rng.random((rows, cols)) < 0.1).astype(np.int8)
            grids.append((torch.as_tensor(fdr), torch.as_tensor(river)))
    elif case == "serpentine":
        grids = [tuple(map(torch.as_tensor, _serpentine(40, 60)))]
    else:
        grids = [_adversarial_flow(getattr(torch, case.split("_")[1]))]
    for fdr, river in grids:
        fdr, river = fdr.to(dev), river.to(dev)
        ops = flow.walk_inputs(fdr, river)
        for max_steps in (1, bound, bound + 1, 20000):
            before = walk.flow_walk.launches
            got = walk.flow_cuda(fdr, river, 12.5, max_steps)
            assert walk.flow_walk.launches == before + 1
            state = flow.doubling_walk(*ops, max_steps)
            what = (case, tuple(fdr.shape), max_steps)
            _assert_flow_bitwise(got, flow.flow_from_state(*state, 12.5, max_steps), what)
            _assert_flow_bitwise(got, flow.flow_from_state(*walk.absorbing_walk(*ops, max_steps), 12.5, max_steps),
                                 what)


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
    got = walk.downslope_walk_tracked(dem_f, fdr, 12.5, 5.0, 5000, 10, 20, 130, 257, 0)
    want = down.downslope_window(dem_f, fdr, 12.5, 5.0, 5000, 10, 20, 130, 257, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any())  # some walks of this window are cut
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

    def band_edge(width, k, rows=6):
        """Eastward rows whose longest walks are width*k + 1, width*k and
        width*k - 1 steps (behind 0, 1 and 2 NaN absorbers)."""
        fdr = np.ones((rows, width * k + 2), np.uint8)
        fdr[1::3, :1] = 0
        fdr[2::3, :2] = 0
        river = np.zeros(fdr.shape, np.int8)
        river[:, -1] = 1
        return fdr, river

    width = walk.fold_width()
    cases = [(basin["fdr"], basin["river"], 20000), (*lateral(150, 170), 20000), (*lateral(150, 170), 37),
             *((*band_edge(width, 3), width * 3 + d) for d in (-1, 0, 1))]
    for fdr, river, max_steps in cases:
        ops = flow.walk_inputs(torch.as_tensor(fdr, device=dev), torch.as_tensor(river, device=dev))
        consts = flow.step_consts(12.5)
        got = walk.flow_walk_blocked(*ops, *consts, max_steps)
        want = flow.fold_walk(*ops, *consts, max_steps)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        state = walk.absorbing_walk(*ops, max_steps)
        idx = flow.flow_from_state(*state, 12.5, max_steps)[1]
        assert torch.equal(flow.flow_from_fold(*got)[1], idx)
        # P and K follow from the depths.
        depth = state[1] + state[2]
        assert walk.flow_walk_blocked.pending == int((depth > width).sum())
        assert walk.flow_walk_blocked.rounds == max(int(depth.max()) - 1, 0) // width


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


def test_terrain_on_the_card_matches_the_cpu(dev):
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    dem = synthetic_dem(300, 257, seed=2).astype(np.int32)
    got = terrain.derive_terrain(torch.as_tensor(dem, device=dev))
    want = terrain.derive_terrain(torch.as_tensor(dem))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _d8_dems(rng, rows, cols, integer):
    """DEMs for the D8 kernel: small integers (plateaus, equal drops, pits),
    the tie blocks of ``d8_ties`` (rounded where ``integer``) and a random
    walk, with NoData cells scattered, so that -100 neighbours are many."""
    dems = [rng.integers(0, 4, size=(rows, cols)).astype(np.float32), d8_ties(rows, cols),
            np.cumsum(rng.normal(size=(rows, cols)), axis=1).astype(np.float32)]
    out = []
    for dem in dems:
        dem = np.round(dem * 4) if integer else dem.copy()
        dem[rng.random(dem.shape) < 0.05] = -100
        out.append(dem)
    return out


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.float32])
def test_d8_kernel_matches_plain(dev, dtype):
    """The D8 kernel bitwise ``d8_successor_plain`` (fdr and succ) on int16,
    int32 and float32 DEMs: plateaus, equal drops won in every ESRI
    position, NoData cells and -100 neighbours, at ragged shapes, 1 x N and
    N x 1 (one tall enough that the kernel loops over its tile rows)."""
    from descriptools_tpu_torch.ops.cuda import terrain as ct

    rng = np.random.default_rng(31)
    for rows, cols in ((1, 1), (1, 5), (5, 1), (3, 3), (31, 33), (33, 31), (67, 131), (257, 129),
                       (1, 70001), (70001, 1), (65535 * 32 + 77, 1), (2178, 1534)):
        for dem in _d8_dems(rng, rows, cols, dtype != torch.float32):
            d = torch.as_tensor(dem, device=dev).to(dtype)
            before = ct.d8_successor.launches
            got = ct.d8_successor(d)
            assert ct.d8_successor.launches == before + 1
            want = ct.d8_successor_plain(d)
            for g, w, name in zip(got, want, ("fdr", "succ")):
                assert g.dtype == w.dtype == torch.int32 and g.is_cuda
                assert torch.equal(g, w), (rows, cols, name)
    # The ties are won where d8_ties places them, and the division is IEEE:
    # a multiplication by the reciprocal of sqrt 2 picks S here, not SE.
    ties = torch.as_tensor(d8_ties(30, 30), device=dev)
    centres = ct.d8_successor(ties)[0][1::3, 1::3].reshape(-1).cpu()
    assert centres.tolist() == [[1, 2, 4, 8, 16, 32, 64, 128, 0][b % 9] for b in range(100)]
    pin = ct.d8_successor(torch.as_tensor(d8_division_pin(), device=dev))
    assert int(pin[0][1, 1]) == 2 and int(pin[1][1, 1]) == 2 * 3 + 2


def test_d8_wrapper_refuses_wrong_shape_and_strides(dev):
    from descriptools_tpu_torch.ops.cuda import terrain as ct

    z = torch.zeros((6, 7), device=dev)
    for bad in (z.reshape(-1), z.reshape(1, 6, 7)):
        with pytest.raises(ValueError, match="2-D"):
            ct.d8_successor(bad)
    with pytest.raises(ValueError, match="contiguous"):
        ct.d8_successor(z.t())
    with pytest.raises(ValueError, match="contiguous"):
        ct.d8_successor(z.to(torch.int16)[:, ::2])
    fdr, succ = ct.d8_successor(z.double())  # another dtype: cast to float32 first
    assert torch.equal(fdr, torch.zeros_like(fdr)) and torch.equal(succ, torch.full_like(succ, 42))


def _stage_activities(path, stage):
    """Names of the device activities launched while the program span
    ``stage`` was open, from a Chrome trace of torch.profiler."""
    import json

    events = [e for e in json.load(open(path))["traceEvents"] if e.get("ph") == "X"]
    (span,) = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation" and e["name"] == "dt." + stage]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
                and span[0] <= e["ts"] <= span[1]}
    return [e["name"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in launched]


def test_derive_terrain_launches_one_d8_kernel(dev, tmp_path):
    """``terrain.d8`` on the card is one launch of the D8 kernel and no
    PyTorch ``where``; ``launch_counters`` and the span's ``fused`` count it."""
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.utils import timing
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    dem = torch.as_tensor(synthetic_dem(300, 257, seed=4).astype(np.int32), device=dev)
    terrain.derive_terrain(dem)  # warm: the build and the first launch
    torch.cuda.synchronize()
    reset_launch_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with timing.recording() as rec:
            terrain.derive_terrain(dem)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = _stage_activities(tmp_path / "trace.json", "terrain.d8")
    assert len(names) == 1 and "d8_kernel" in names[0], names
    assert launch_counters()["d8_successor"] == 1
    assert {s.name: s.counters for s in rec.spans}["terrain.d8"] == {"fused": 1}


# The accumulation's cases: utils.synthetic's edge cases (fdr given), and
# DEMs whose D8 and successor the D8 kernel gives on the card.
ACCUMULATION_DEMS = ("int32_300x257_seed_4", "int32_300x257_seed_9", "int32_2178x1534_seed_0", "float_dem")


def _accumulation_case(case, dev):
    """(fdr, succ, max_path) on the card for a name of ACCUMULATION_DEMS,
    ``accumulation_cases()`` or the long lines ``row_70001`` and
    ``column_70001``."""
    from descriptools_tpu_torch import d8
    from descriptools_tpu_torch.ops.cuda import terrain as ct
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    if case == "float_dem":
        from benchmark.generators import float_dem

        dem = float_dem.make(512, 640, 2147507200, dev, hills=101, valleys=21)["dem"]
        assert dem.dtype == torch.float32 and bool((dem != torch.round(dem)).any())
        return (*ct.d8_successor(dem), None)
    if case.startswith("int32_"):
        shape, seed = case.split("_")[1], int(case.split("_")[-1])
        rows, cols = map(int, shape.split("x"))
        dem = torch.as_tensor(synthetic_dem(rows, cols, seed=seed).astype(np.int32), device=dev)
        return (*ct.d8_successor(dem), None)
    if case in ("row_70001", "column_70001"):
        fdr = np.ones((1, 70001), np.int32) if case == "row_70001" else np.full((70001, 1), 4, np.int32)
        max_path = None
    else:
        fdr, max_path = accumulation_cases()[case]
    fdr = torch.as_tensor(fdr, device=dev)
    return fdr, d8.sink_successor(fdr), max_path


@pytest.mark.parametrize("case", [*ACCUMULATION_DEMS, *accumulation_cases(), "row_70001", "column_70001"])
def test_accumulation_entry_matches_plain(dev, case):
    """The accumulation's C entry bitwise ``flow_accumulation_plain`` on the
    card: fac, stats (the live list's lengths and the rounds) and the
    successor jumped in place, on seeded int32 DEMs, a float32 DEM of the
    LiDAR cell's generator, the long line truncated at several caps,
    cycles (lap-multiplied counts, wrapping int32 at 40 rounds), a grid of
    sinks (no round, fac 0), and 1 x N and N x 1 lines; one launch a call."""
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.ops.cuda import terrain as ct

    fdr, succ, max_path = _accumulation_case(case, dev)
    got_succ, want_succ = succ.clone(), succ.clone()
    stats_g, stats_w = {}, {}
    before = ct.accumulation.launches
    got = terrain.flow_accumulation(fdr, max_path=max_path, stats=stats_g, succ=got_succ)
    assert ct.accumulation.launches == before + 1
    want = terrain.flow_accumulation_plain(fdr, max_path=max_path, stats=stats_w, succ=want_succ)
    assert got.is_cuda and got.dtype == want.dtype == torch.int32 and got.shape == fdr.shape
    assert torch.equal(got, want), case
    assert stats_g == stats_w, (stats_g, stats_w)
    assert torch.equal(got_succ, want_succ), case
    live = stats_g["live"]
    assert all(a >= b for a, b in zip(live, live[1:])) and all(c > 0 for c in live)


def test_derive_terrain_accumulates_in_one_entry(dev, tmp_path):
    """``terrain.accumulation`` on the card is the C entry's memsets,
    ``init_kernel``, a gather and an apply a round for every round of the
    cap and ``finish_kernel``, the NoData mask's ``where`` and the one read
    of the live counts: no torch indexing, ``index_add_`` or ``nonzero``;
    its counters read ``fused`` 1 and ``host_reads`` 1."""
    from descriptools_tpu_torch import d8
    from descriptools_tpu_torch.ops import terrain
    from descriptools_tpu_torch.utils import timing
    from descriptools_tpu_torch.utils.synthetic import synthetic_dem

    dem = torch.as_tensor(synthetic_dem(300, 257, seed=4).astype(np.int32), device=dev)
    terrain.derive_terrain(dem)  # warm: the build and the first launch
    torch.cuda.synchronize()
    reset_launch_counters()
    stats = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with timing.recording() as rec:
            terrain.derive_terrain(dem, stats=stats)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = _stage_activities(tmp_path / "trace.json", "terrain.accumulation")
    levels = d8.doubling_rounds(dem.numel())
    assert sum("gather_kernel" in k for k in names) == sum("apply_kernel" in k for k in names) == levels, names
    assert sum("init_kernel" in k for k in names) == sum("finish_kernel" in k for k in names) == 1, names
    assert not [k for k in names if "index" in k.lower() or "select" in k.lower() or "nonzero" in k.lower()], names
    others = [k for k in names if not any(x in k for x in ("init_kernel", "gather_kernel", "apply_kernel",
                                                            "finish_kernel"))]
    assert sum("Memset" in k for k in others) == 2 and len(others) <= 6, others  # the mask's, the read
    assert launch_counters()["accumulation"] == 1
    counters = {s.name: s.counters for s in rec.spans}["terrain.accumulation"]
    assert counters == {"fused": 1, "host_reads": 1, "rounds": stats["rounds"],
                        "live_cells": sum(stats["live"])}, counters
    assert stats["rounds"] >= 1


def test_calibration_on_the_card_matches_the_host(dev, basin):
    from descriptools_tpu_torch import evaluation
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    hand = pipeline.descriptor_suite(*inputs)["hand"]
    want = pipeline.classify_flood(hand, basin["flood"])
    for got in (sharded_classify_flood(hand, torch.as_tensor(basin["flood"], device=dev)),
                sharded_classify_flood(hand.cpu().numpy(), basin["flood"])):
        assert got[:3] == want[:3] and got[3].is_cuda
        assert np.array_equal(got[3].cpu().numpy(), want[3])
    desc = evaluation.min_max_scale(hand, 0, int(hand.max()))
    flood = torch.as_tensor(basin["flood"], device=dev)
    assert (evaluation.calibration(desc, flood, backend="torch")
            == evaluation.calibration(desc.cpu(), flood.cpu(), backend="torch"))


@pytest.mark.parametrize("under", ["under", "over"])
def test_cutoff_count_kernel_matches_plain(dev, under):
    """The counting kernel bitwise its plain version (bucketize, scatter-add):
    1 to 32 cutoffs, unsorted with repeats and infinities, NaN and NoData
    HAND, the corner probe (data and NoData), flood 1, 2 and NoData; sizes
    whose cells are and are not a multiple of 4, a view that starts off the
    16-byte grid, and 4096² (the vector path over many blocks)."""
    from descriptools_tpu_torch.ops.cuda import classify as cc

    rng = np.random.default_rng(19)
    for rows, cols in ((1, 1), (3, 5), (64, 64), (257, 129), (4096, 4096)):
        hand = (rng.gamma(1.5, 4.0, (rows, cols + 1))).astype(np.float32)
        hand[rng.random(hand.shape) < 0.05] = -100
        hand[rng.random(hand.shape) < 0.01] = np.nan
        hand[rng.random(hand.shape) < 0.01] = hand[0, 0]
        flood = rng.choice(np.array([0, 1, 2, -100, 3], np.int32), hand.shape, p=[0.5, 0.3, 0.1, 0.05, 0.05])
        for offset in (0, 1):
            h = torch.as_tensor(hand, device=dev).reshape(-1)[offset : offset + rows * cols].reshape(rows, cols)
            f = torch.as_tensor(flood, device=dev).reshape(-1)[offset : offset + rows * cols].reshape(rows, cols)
            for probe in (h.reshape(-1)[0], torch.tensor(-100.0, device=dev)):
                for k in (1, 3, 5, 11, 21, 32):
                    cuts = np.sort(rng.gamma(1.5, 4.0, k)).astype(np.float32)
                    if k >= 5:
                        cuts[1], cuts[3], cuts[-1] = cuts[0], -np.inf, np.inf
                    rng.shuffle(cuts)
                    before = cc.cutoff_count.launches
                    got = cc.cutoff_count(h, f, probe, cuts, under)
                    assert cc.cutoff_count.launches == before + 1 and got.is_cuda
                    want = cc.cutoff_count_plain(h.cpu(), f.cpu(), probe.cpu(), cuts, under)
                    assert torch.equal(got.cpu(), want), (rows, cols, offset, k)


def test_float_calibration_on_the_card_matches_the_host(dev, basin):
    """A fractional DEM's suite on the card, then the float path of the
    one-card calibration (5 counting passes) against the port's host float64
    path (the JAX package is not on the card; the CPU tests hold the port's
    host path to the JAX package's on float HAND); K3 on that DEM bitwise its
    plain engine."""
    from descriptools_tpu_torch.ops.cuda import classify as cc
    from descriptools_tpu_torch.parallel.classify import sharded_classify_flood

    frac = np.random.default_rng(8).uniform(0.0, 0.99, basin["dem"].shape)
    dem = np.where(basin["dem"] == -100, -100.0, basin["dem"] + frac).astype(np.float32)
    inputs = [torch.as_tensor(a, device=dev) for a in (dem, basin["fdr"], basin["fac"].astype(np.int32),
                                                       basin["river"])]
    out = pipeline.descriptor_suite(*inputs)
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    assert torch.equal(out["downslope"], plain["downslope"]) and torch.equal(out["hand"], plain["hand"])
    hand = out["hand"]
    assert bool((hand != torch.round(hand)).any())
    for under in ("under", "over"):
        flood = torch.as_tensor(basin["flood"], device=dev)
        want = pipeline.classify_flood(hand, basin["flood"], under=under)
        before = cc.cutoff_count.launches
        got = sharded_classify_flood(hand, flood, under=under)
        assert cc.cutoff_count.launches == before + 5
        assert got[:3] == want[:3] and got[3].is_cuda
        assert np.array_equal(got[3].cpu().numpy(), want[3])


def test_compat_on_the_card_matches_the_cpu(dev, basin):
    from descriptools_tpu_torch import compat

    dem = basin["dem"].astype(np.int16)
    calls = (
        lambda **d: compat.sloper(dem, 12.5, **d),
        lambda **d: compat.downsloper(dem, basin["fdr"], 12.5, 5, **d),
        lambda **d: compat.flow_hand_index(dem, basin["fdr"], basin["river"], 12.5, **d),
    )
    for call in calls:
        got, want = call(), call(device="cpu")
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
