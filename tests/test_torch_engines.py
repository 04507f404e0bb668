"""PyTorch port vs the JAX package: the cross-check engines, on the CPU.

- ``ops.downslope.build_downslope_tables`` and ``downslope(method=
  "descent")`` (the binary descent over doubling tables);
- ``ops.flow.flow_distance_index(method="doubling" | "hybrid")`` and
  ``resolve_absorbing_walk``'s five outputs, with and without a tag, at
  JAX's cap and at a small one that leaves phase 2 most of the walk;
- ``d8.successor`` with block offsets (a block of a larger grid);
- a ``method`` with a kernel engine raises; ``ops`` exports JAX's names.

Tolerance: bitwise everywhere.  The port runs the same gathers, selects and
f32 adds in the same order as the JAX engines, on the same values.  The
fixtures: the synthetic basin, long walks (a northward ramp, a lateral
channel, a serpentine whose path is longer than the cap, 2-cycles) and
``utils.synthetic.downslope_cases``.  The port's descent is also held to
its jacobi engine at JAX's own tolerance (``tests/test_downslope.py:64``),
on fractional elevations too.  The fixtures share a few shapes and
step caps, so that the JAX package compiles each of its programs a few
times only (``WALK_SHAPE`` for the flow walks, ``downslope_cases``' shape
for the downslope ones).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from descriptools_tpu import d8 as jd8
from descriptools_tpu import ops as jops
from descriptools_tpu.ops import flow as jflow
from descriptools_tpu.utils.synthetic import synthetic_basin
from descriptools_tpu_torch import d8 as td8
from descriptools_tpu_torch import ops as tops
from descriptools_tpu_torch.ops import flow as tflow
from descriptools_tpu_torch.utils.synthetic import downslope_cases

# The modules: the packages bind ops.downslope to the function of that name.
jdown = importlib.import_module("descriptools_tpu.ops.downslope")
tdown = importlib.import_module("descriptools_tpu_torch.ops.downslope")

PX = 12.5


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


# One shape and one step cap for the flow walks (the capped basin apart):
# 8192 cells, so JAX's hybrid cap is 1024 cells.
WALK_SHAPE, WALK_STEPS = (64, 128), 300


def _north_ramp(rows=WALK_SHAPE[0], cols=WALK_SHAPE[1]):
    fdr = np.full((rows, cols), 64, np.uint8)  # north, into the river row
    river = np.zeros((rows, cols), np.int8)
    river[0] = 1
    return fdr, river


def _lateral_channel(rows=WALK_SHAPE[0], cols=WALK_SHAPE[1]):
    fdr = np.full((rows, cols), 1, np.uint8)  # east, then north along the last column
    fdr[:, -1] = 64
    river = np.zeros((rows, cols), np.int8)
    river[0, -1] = 1
    return fdr, river


def _serpentine(rows=WALK_SHAPE[0], cols=WALK_SHAPE[1]):
    """One boustrophedon path of rows * cols steps to a river corner."""
    fdr = np.zeros((rows, cols), np.uint8)
    for r in range(rows):
        fdr[r, :] = 1 if r % 2 == 0 else 16
        fdr[r, -1 if r % 2 == 0 else 0] = 4
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
    return fdr, river


def _cycles(rows=WALK_SHAPE[0], cols=WALK_SHAPE[1], seed=3):
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    fdr = codes[rng.integers(0, 8, size=(rows, cols))]
    fdr[5, 10], fdr[5, 11] = 1, 16
    fdr[rng.random((rows, cols)) < 0.03] = 0
    river = (rng.random((rows, cols)) < 0.05).astype(np.int8)
    fdr[7, 7], river[7, 7] = 0, 1
    return fdr, river


def _basin(shape=WALK_SHAPE):
    dem, fdr, river, _ = synthetic_basin(*shape, seed=13)
    return dem, fdr, river


FLOW_CASES = {
    "basin": lambda: (*_basin()[1:], WALK_STEPS),
    "basin_capped": lambda: (*_basin()[1:], 5),
    "north_ramp": lambda: (*_north_ramp(), WALK_STEPS),
    # Up to 190 steps: phase 1 stops with more than JAX's cap still walking.
    "lateral_channel": lambda: (*_lateral_channel(), WALK_STEPS),
    # 8192 steps on one path, capped at 300: both phases and the cap.
    "serpentine_over_cap": lambda: (*_serpentine(), WALK_STEPS),
    "cycles": lambda: (*_cycles(), WALK_STEPS),
}


def _tall_ramp(drop, rows=40, cols=56):
    """Northward walks down a ramp falling ``drop`` m a row."""
    dem = (np.arange(rows, dtype=np.float32)[:, None] * np.float32(drop)) * np.ones((1, cols), np.float32)
    return dem, np.full((rows, cols), 64, np.uint8)


def _downslope_cases():
    """``downslope_cases`` and the basin and ramps at their shape (40x56)."""
    cases = {}
    dem, fdr, _ = _basin((40, 56))
    for ed in (5.0, 1.0):
        cases[f"basin_ed{ed:g}"] = (dem, fdr, ed, 5000)
    # 5 m within 25 steps; and 50 steps, which the cap of 30 cuts.
    cases["tall_ramp"] = (*_tall_ramp(0.2), 5.0, 5000)
    cases["tall_ramp_capped"] = (*_tall_ramp(0.1), 5.0, 30)
    for name, case in downslope_cases().items():
        cases[name] = case
    return cases


DOWN_CASES = _downslope_cases()

@pytest.mark.parametrize("case", sorted(DOWN_CASES))
def test_downslope_tables_and_descent_bitwise_vs_jax(case):
    dem, fdr, ed, max_steps = DOWN_CASES[case]
    tdem, tfdr = torch.from_numpy(np.asarray(dem)), torch.from_numpy(np.asarray(fdr))
    got = tdown.build_downslope_tables(tdem, tfdr, PX, max_steps=max_steps)
    want = jdown.build_downslope_tables(dem, fdr, PX, max_steps=max_steps)
    for name, g, w in zip(("succs", "dists", "minkeys"), got, want):
        _assert_bitwise(g, w, f"{case}/{name}")
    out = tops.downslope(tdem, tfdr, PX, ed, max_steps=max_steps, method="descent")
    _assert_bitwise(out, jops.downslope(dem, fdr, PX, ed, max_steps=max_steps, method="descent"),
                    f"{case}/descent")
    # The port's two methods agree at JAX's own tolerance
    # (tests/test_downslope.py:60-64), on fractional elevations too: both
    # read the elevation at a terminal stop as it is (JAX's jacobi walk
    # rounds it to 1/16 m there, so JAX's agree on integer DEMs alone).
    jacobi = tops.downslope(tdem, tfdr, PX, ed, max_steps=max_steps, method="jacobi")
    np.testing.assert_allclose(out.numpy(), jacobi.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["doubling", "hybrid"])
@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_methods_bitwise_vs_jax(case, method):
    fdr, river, max_steps = FLOW_CASES[case]()
    fd, idx = tops.flow_distance_index(torch.from_numpy(fdr), torch.from_numpy(river), PX,
                                       max_steps=max_steps, method=method)
    wfd, widx = jops.flow_distance_index(fdr, river, PX, max_steps=max_steps, method=method)
    _assert_bitwise(idx, widx, f"{case}/{method}/indices")
    _assert_bitwise(fd, wfd, f"{case}/{method}/fdist")
    # Indices are every engine's: the count engine's too.
    _, idx_count = tops.flow_distance_index(torch.from_numpy(fdr), torch.from_numpy(river), PX,
                                            max_steps=max_steps)
    np.testing.assert_array_equal(idx.numpy(), idx_count.numpy())


def _walk_operands(fdr, river, px, pkg):
    """``_flow_hybrid``'s operands of resolve_absorbing_walk, as numpy."""
    rows, cols = fdr.shape
    if pkg == "jax":
        succ, step, absorbing, _, is_river = jflow.flow_states(fdr, river, rows, cols)
        stepd = np.where(absorbing, 0.0, np.asarray(step) * np.float32(px)).astype(np.float32)
        return [np.asarray(a) for a in (absorbing, stepd, succ, is_river)]
    succ, step, absorbing, _, is_river = tflow.flow_states(torch.from_numpy(fdr), torch.from_numpy(river),
                                                           rows, cols)
    stepd = torch.where(absorbing, 0.0, step * float(np.float32(px)))
    return [a.numpy() for a in (absorbing, stepd, succ, is_river)]


# Jitted as JAX's flow engine jits it (``_flow_hybrid``): one program for
# each shape, cap and tag.
_jax_resolve = jax.jit(jflow.resolve_absorbing_walk, static_argnames=("max_steps", "cap"))


@pytest.mark.parametrize("case", ["basin", "serpentine_over_cap", "cycles"])
def test_resolve_absorbing_walk_outputs_bitwise_vs_jax(case):
    """(resolved, dist, steps, absorber, tag), tagged at JAX's cap, and
    tagged and untagged at 64, where phase 1 stops early and phase 2 holds
    most walks (or, on the cycles, cannot hold all the cells still
    walking)."""
    fdr, river, max_steps = FLOW_CASES[case]()
    ops_t = _walk_operands(fdr, river, PX, "torch")
    ops_j = _walk_operands(fdr, river, PX, "jax")
    for a, b in zip(ops_t, ops_j):
        _assert_bitwise(a, b, f"{case}/operands")
    absorbing, stepd, succ, is_river = ops_t
    n = fdr.size
    for cap, tagged in [(min(n, max(1024, n // 8)), True), (64, True), (64, False)]:
        tag0 = is_river.astype(np.float32) if tagged else None
        got = tflow.resolve_absorbing_walk(
            torch.from_numpy(fdr), torch.from_numpy(absorbing), torch.from_numpy(stepd), torch.from_numpy(succ),
            max_steps, cap, tag0=None if tag0 is None else torch.from_numpy(tag0))
        want = _jax_resolve(
            jnp.asarray(fdr), jnp.asarray(absorbing), jnp.asarray(stepd), jnp.asarray(succ), max_steps=max_steps,
            cap=cap, tag0=None if tag0 is None else jnp.asarray(tag0))
        for name, g, w in zip(("resolved", "dist", "steps", "absorber", "tag"), got, want):
            _assert_bitwise(g, w, f"{case}/cap {cap}/tagged {tagged}/{name}")


@pytest.mark.parametrize("origin", [(0, 0), (0, 37), (19, 0), (25, 40), (44, 77)])
def test_successor_with_block_offsets_bitwise_vs_jax(origin):
    """Blocks of a 64x96 grid (the last one at its south-east corner): a
    step off the block inside the grid keeps succ = self but its step and
    ``in_bounds``; a step off the grid loses both."""
    rng = np.random.default_rng(sum(origin))
    grid = rng.choice(np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 3, 255], np.int32), size=(64, 96))
    y0, x0 = origin
    block = grid[y0 : y0 + 20, x0 : x0 + 19]
    got = td8.successor(torch.from_numpy(block), *block.shape, row0=y0, col0=x0, grid_rows=64, grid_cols=96)
    want = jd8.successor(block, *block.shape, row0=y0, col0=x0, grid_rows=64, grid_cols=96)
    for name, g, w in zip(("succ", "step", "in_bounds", "valid"), got, want):
        _assert_bitwise(g, w, f"{origin}/{name}")
    # The defaults: the block is the grid.
    for g, w in zip(td8.successor(torch.from_numpy(block), *block.shape), jd8.successor(block, *block.shape)):
        _assert_bitwise(g, w, f"{origin}/defaults")


@pytest.mark.parametrize("engine", ["cuda", "cuda_blocked", "torch_blocked", "auto"])
def test_a_method_with_another_engine_raises(engine):
    fdr, river = (torch.from_numpy(a) for a in _north_ramp(8, 8))
    for method in ("doubling", "hybrid"):
        with pytest.raises(ValueError, match="no kernel"):
            tops.flow_distance_index(fdr, river, PX, method=method, engine=engine)
    dem = torch.zeros((8, 8), dtype=torch.float32)
    if engine == "cuda":
        with pytest.raises(ValueError, match="no CUDA kernel"):
            tops.downslope(dem, fdr, PX, 5.0, method="descent", engine=engine)


def test_unknown_methods_raise_and_ops_exports_jaxs_names():
    fdr, river = (torch.from_numpy(a) for a in _north_ramp(8, 8))
    with pytest.raises(ValueError, match="method"):
        tops.flow_distance_index(fdr, river, PX, method="serial")
    with pytest.raises(ValueError, match="method"):
        tops.downslope(torch.zeros((8, 8)), fdr, PX, 5.0, method="doubling")
    assert set(tops.__all__) == set(jops.__all__)
    assert tops.build_downslope_tables is tdown.build_downslope_tables
