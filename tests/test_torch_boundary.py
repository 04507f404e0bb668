"""PyTorch port vs the JAX package: truncation tracking and the boundary
graph of the tiled path.

Tolerances: everything here is integer or bitwise.
- ``trunc_cells``, and ``jacobi_walk(trunc0=)``'s downslope and flags,
  bitwise against the JAX ``_downslope_jacobi(trunc0=)`` and against the
  blocked TPU kernel ``downslope_pallas`` (interpret mode);
- a numpy serial walk with the flag rule of ``csrc/walk.cu``'s tracked
  kernel, bitwise against the port's plain engine;
- ``local_flow_summary`` (status, step count, exit target, river index,
  payloads) bitwise against the JAX local phase through the VMEM absorbing
  kernel ``absorbing_walk_pallas_vmem`` (interpret mode);
- ``solve_ring`` + ``combine`` (landed, river index, payloads) bitwise
  against the JAX ring phase on the same records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from descriptools_tpu.ops.downslope import _downslope_jacobi as j_jacobi
from descriptools_tpu.ops.downslope import trunc_cells as j_trunc_cells
from descriptools_tpu.ops.pallas.walk import downslope_pallas
from descriptools_tpu.parallel import boundary as jb
from descriptools_tpu.utils.synthetic import synthetic_basin, windowed_basin
from descriptools_tpu_torch.ops import downslope as tdown
from descriptools_tpu_torch.parallel import boundary as tb

PX = 12.5


def _flat_east(bump, rows=64, cols=128):
    dem = np.broadcast_to((1000.0 - 0.01 * np.arange(cols)).astype(np.float32), (rows, cols)).copy()
    if bump:
        dem[:, bump] += 3.0
    return dem, np.full((rows, cols), 1, np.uint8)


def _tall_north_window():
    rows, cols = 200, 48
    dem = np.broadcast_to(
        np.round(np.arange(rows, dtype=np.float64) * 0.5 + 100.0)[:, None].astype(np.float32), (rows, cols)
    ).copy()
    return dem[120:184], np.full((64, cols), 64, np.uint8), (120, 0), (rows, cols)


# (dem, fdr, origin, grid, ed, max_steps): windows of larger grids
TRUNC_CASES = {
    "flat_east": lambda: (*_flat_east(None), (0, 0), (64, 4 * 128), 5.0, 5000),
    "flat_east_bump": lambda: (*_flat_east(40), (0, 0), (64, 4 * 128), 5.0, 5000),
    "basin_window": lambda: (
        synthetic_basin(90, 120, seed=3)[0][10:74, 20:116].astype(np.float32),
        synthetic_basin(90, 120, seed=3)[1][10:74, 20:116], (10, 20), (90, 120), 5.0, 200,
    ),
    "tall_north_cut": lambda: (*_tall_north_window(), 50.0, 600),
}


def _port_tracked(dem, fdr, origin, grid, ed, max_steps):
    d, f = torch.from_numpy(dem), torch.from_numpy(fdr)
    tr0 = tdown.trunc_cells(d, f, *origin, *grid)
    out, tr = tdown._downslope_jacobi(d, f, PX, ed, max_steps, trunc0=tr0)
    return tr0.numpy(), out.numpy(), tr.numpy()


@pytest.mark.parametrize("case", sorted(TRUNC_CASES))
def test_trunc_cells_bitwise_vs_jax(case):
    dem, fdr, origin, grid, _, _ = TRUNC_CASES[case]()
    want = np.asarray(j_trunc_cells(jnp.asarray(dem), jnp.asarray(fdr), *origin, *grid))
    got = tdown.trunc_cells(torch.from_numpy(dem), torch.from_numpy(fdr), *origin, *grid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("case", sorted(TRUNC_CASES))
def test_tracked_jacobi_bitwise_vs_jax_jacobi(case):
    dem, fdr, origin, grid, ed, max_steps = TRUNC_CASES[case]()
    tr0, got, gtr = _port_tracked(dem, fdr, origin, grid, ed, max_steps)
    want, wtr = j_jacobi(jnp.asarray(dem), jnp.asarray(fdr), PX, ed, max_steps, trunc0=jnp.asarray(tr0))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(gtr, np.asarray(wtr))
    assert gtr.any()  # the window's edge really cuts walks


@pytest.mark.parametrize("case", ["flat_east", "flat_east_bump", "basin_window"])
def test_tracked_jacobi_bitwise_vs_blocked_pallas_kernel(case):
    """The blocked TPU kernel (K6) the tracked CUDA walk replaces, in
    interpret mode, on the fixtures of tests/test_pallas_blocked_trunc.py."""
    dem, fdr, origin, grid, ed, max_steps = TRUNC_CASES[case]()
    tr0, got, gtr = _port_tracked(dem, fdr, origin, grid, ed, max_steps)
    want, wtr = downslope_pallas(jnp.asarray(dem), jnp.asarray(fdr), PX, ed, max_steps=max_steps,
                                 h=8, trunc0=jnp.asarray(tr0), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(gtr, np.asarray(wtr))


def serial_tracked_walk(fdr_eff, z, zt0, trunc0, ed, max_steps):
    """numpy form of csrc/walk.cu::downslope_walk_kernel<true>: one lane per
    start cell follows its D8 path; the flag is read at the stop cell."""
    rows, cols = z.shape
    fe, zt0, t0 = fdr_eff.reshape(-1), zt0.reshape(-1), trunc0.reshape(-1)
    thresh = (z.reshape(-1) - np.float32(ed)).astype(np.float32)
    valid = np.zeros(256, bool)
    move = np.zeros(256, np.int64)
    inc = np.zeros(256, np.int32)
    for code, dy, dx in zip((1, 2, 4, 8, 16, 32, 64, 128),
                            (0, 1, 1, 1, 0, -1, -1, -1), (1, 1, 0, -1, -1, -1, 0, 1)):
        valid[code], move[code] = True, dy * cols + dx
        inc[code] = 1 << 16 if dy and dx else 1
    cur = np.arange(rows * cols)
    pk = np.zeros(rows * cols, np.int32)
    zt = zt0.copy()
    walking = ~(zt <= thresh)
    for _ in range(max_steps):
        lanes = np.flatnonzero(walking)
        if lanes.size == 0:
            break
        d = fe[cur[lanes]]
        walking[lanes[~valid[d]]] = False
        lanes, d = lanes[valid[d]], d[valid[d]]
        pk[lanes] += inc[d]
        cur[lanes] += move[d]
        zt[lanes] = zt0[cur[lanes]]
        walking[lanes[zt[lanes] <= thresh[lanes]]] = False
    trunc = (zt <= thresh) & (zt < -tdown._HALF) & t0[cur]
    return pk.reshape(rows, cols), zt.reshape(rows, cols), trunc.reshape(rows, cols)


@pytest.mark.parametrize("case", sorted(TRUNC_CASES))
def test_serial_tracked_walk_reference_bitwise(case):
    dem, fdr, origin, grid, ed, max_steps = TRUNC_CASES[case]()
    d, f = torch.from_numpy(dem), torch.from_numpy(fdr)
    tr0 = tdown.trunc_cells(d, f, *origin, *grid)
    fdr_eff, z, zt0 = tdown.walk_inputs(d, f, PX)
    want = tdown.jacobi_walk(fdr_eff, z, zt0, ed, max_steps, tr0)
    got = serial_tracked_walk(fdr_eff.numpy(), z.numpy(), zt0.numpy(), tr0.numpy(), ed, max_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_tracked_walk_wrapper_on_cpu_runs_the_plain_engine():
    from descriptools_tpu_torch.ops.cuda import walk as twalk

    dem, fdr, origin, grid, ed, max_steps = TRUNC_CASES["basin_window"]()
    d, f = torch.from_numpy(dem), torch.from_numpy(fdr)
    tr0 = tdown.trunc_cells(d, f, *origin, *grid)
    ops = tdown.walk_inputs(d, f, PX)
    before = twalk.downslope_walk_tracked.launches
    got = twalk.downslope_walk_tracked(*ops, ed, max_steps, tr0)
    assert twalk.downslope_walk_tracked.launches == before
    for g, w in zip(got, tdown.jacobi_walk(*ops, ed, max_steps, tr0)):
        assert torch.equal(g, w)


def test_capped_walks_are_not_flagged():
    """A walk cut by the cap is exact: no flag.  With a cap of 3 steps only
    the walks that reach the window's east edge within 3 steps (the last 4
    columns, the edge column itself stopping at its start) are flagged."""
    dem, fdr, origin, grid, _, _ = TRUNC_CASES["flat_east"]()
    _, _, tr = _port_tracked(dem, fdr, origin, grid, 5.0, 3)
    want = np.zeros_like(tr)
    want[:, -4:] = True
    np.testing.assert_array_equal(tr, want)


# ---------------------------------------------------------------------------
# Boundary graph
# ---------------------------------------------------------------------------

H, W = 32, 28


def _grid(seed=52, rows=75, cols=83):
    dem, fdr, river, fac = synthetic_basin(rows, cols, seed=seed)
    ny, nx = -(-rows // H), -(-cols // W)
    R, C = ny * H, nx * W

    def pad(a, fill):
        out = np.full((R, C), fill, a.dtype)
        out[:rows, :cols] = a
        return out

    return (pad(dem.astype(np.int32), -100), pad(fdr, 0), pad(river, 0),
            pad(fac.astype(np.int32), -100), ny, nx, R, C)


def _tile(a, iy, ix):
    return a[iy * H : (iy + 1) * H, ix * W : (ix + 1) * W]


@pytest.fixture(scope="module")
def locals_both():
    """Every tile's local records from both packages (JAX through the VMEM
    absorbing kernel, interpret mode)."""
    dem, fdr, river, fac, ny, nx, R, C = _grid()
    out = {}
    for iy in range(ny):
        for ix in range(nx):
            args = [_tile(a, iy, ix) for a in (dem, fdr, river, fac)]
            j = jb.local_flow_summary(*map(jnp.asarray, args), jnp.int32(iy), jnp.int32(ix), H, W, R, C,
                                      PX, max_steps=20000, engine="pallas", interpret=True)
            t = tb.local_flow_summary(*map(torch.from_numpy, args), iy, ix, H, W, R, C, max_steps=20000)
            out[iy, ix] = ({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()})
    return out, nx


@pytest.mark.parametrize("key", ["status", "steps", "tgy", "tgx", "ridx", "rz", "rfac"])
def test_local_flow_summary_bitwise_vs_jax_absorbing_kernel(locals_both, key):
    out, _ = locals_both
    for (iy, ix), (j, t) in out.items():
        got = t["a"] + t["b"] if key == "steps" else t[key]
        np.testing.assert_array_equal(got, j[key], err_msg=f"{key} tile {iy},{ix}")
    assert any((t["status"] == tb.EXIT).any() for _, t in out.values())


def test_local_counts_rebuild_the_jax_distance(locals_both):
    """a cardinal + b diagonal steps give the JAX local f32 distance within
    its serial-sum rounding (rtol 1e-6)."""
    from descriptools_tpu_torch.ops.flow import dist_from_counts

    out, _ = locals_both
    for j, t in out.values():
        d = dist_from_counts(torch.from_numpy(t["a"]), torch.from_numpy(t["b"]), PX).numpy()
        ok = j["status"] == jb.RIVER
        np.testing.assert_allclose(d[ok], j["dist"][ok], rtol=1e-6)


def test_ring_indices_and_slots_match_jax():
    for h, w in ((H, W), (5, 7), (4096, 4096)):
        np.testing.assert_array_equal(tb.ring_indices(h, w), jb.ring_indices(h, w))
    rng = np.random.default_rng(0)
    gy = rng.integers(0, 4 * H, 500).astype(np.int32)
    gx = rng.integers(0, 3 * W, 500).astype(np.int32)
    want = np.asarray(jb.slot_of(jnp.asarray(gy), jnp.asarray(gx), H, W, 3, 2 * (H + W)))
    got = tb.slot_of(torch.from_numpy(gy), torch.from_numpy(gx), H, W, 3, 2 * (H + W)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["landed", "ridx", "rz", "rfac"])
def test_solve_ring_and_combine_bitwise_vs_jax(locals_both, key):
    out, nx = locals_both
    sel = jb.ring_indices(H, W)
    order = sorted(out)
    jring = {k: jnp.asarray(np.concatenate([out[t][0][k][sel] for t in order])) for k in out[order[0]][0]}
    tring = {k: torch.from_numpy(np.concatenate([out[t][1][k][sel] for t in order])) for k in out[order[0]][1]}
    jsolved = jb.solve_ring(jring, H, W, nx, 20000)
    tsolved = tb.solve_ring(tring, H, W, nx, 20000)
    for t in order:
        jl = jb.combine({k: jnp.asarray(v) for k, v in out[t][0].items()}, jsolved, H, W, nx, 20000)
        tl = tb.combine({k: torch.from_numpy(v) for k, v in out[t][1].items()}, tsolved, H, W, nx, 20000)
        j = dict(zip(("landed", "dist", "ridx", "rz", "rfac"), jl))
        g = dict(zip(("landed", "a", "b", "ridx", "rz", "rfac"), tl))
        landed = np.asarray(j["landed"])
        got, want = g[key].numpy(), np.asarray(j[key])
        if key == "landed":
            np.testing.assert_array_equal(got, want)
        else:  # payloads are defined where the walk landed
            np.testing.assert_array_equal(got[landed], want[landed])


def test_ring_counts_are_capped_on_a_ring_cycle():
    """Two blocks whose perimeters exit into each other forever: the ring
    doubles its accumulators ~log2(G) times; the counts stay at the cap
    instead of overflowing int32, and nothing lands."""
    h, w, nx = 4, 4, 2
    fdr = np.zeros((h, 2 * w), np.uint8)
    fdr[:, :w], fdr[:, w:] = 1, 16  # left block east, right block west
    fdr[:, w - 2] = 1
    river = np.zeros_like(fdr, np.int8)
    recs = [
        tb.local_flow_summary(torch.zeros(h, w), torch.from_numpy(fdr[:, ix * w : (ix + 1) * w].copy()),
                              torch.from_numpy(river[:, ix * w : (ix + 1) * w].copy()), torch.zeros(h, w),
                              0, ix, h, w, h, 2 * w, max_steps=100)
        for ix in range(nx)
    ]
    sel = torch.from_numpy(tb.ring_indices(h, w)).long()
    ring = {k: torch.cat([r[k][sel] for r in recs]) for k in recs[0]}
    ring["a"] = ring["a"] * 50  # long local walks: the cycle's length explodes
    solved = tb.solve_ring(ring, h, w, nx, 100)
    assert int(solved["a"].max()) == 101 and int(solved["b"].max()) <= 101
    assert (solved["status"] == tb.NAN).all()


def test_ridx_int32_exact_at_corner_of_2pow30_grid():
    """int32 global river indices stay exact at the far corner of a 32768^2
    (2^30-cell) grid, where iy*h+fy ~ 32767 and ridx ~ 2^30."""
    R = C = 32768
    h = w = 64
    iy = ix = R // h - 1
    loaders = windowed_basin(R, C, seed=2)
    fdr = loaders["fdr"](R - h, R, C - w, C)
    river = np.ones((h, w), np.int8)  # all river: ridx = own cell
    loc = tb.local_flow_summary(
        torch.from_numpy(loaders["dem"](R - h, R, C - w, C)), torch.from_numpy(fdr),
        torch.from_numpy(river), torch.from_numpy(loaders["fac"](R - h, R, C - w, C)),
        iy, ix, h, w, R, C,
    )
    got = loc["ridx"].numpy().reshape(h, w)
    assert got.dtype == np.int32
    want = np.arange(R - h, R, dtype=np.int64)[:, None] * C + np.arange(C - w, C, dtype=np.int64)[None, :]
    assert want.max() == R * C - 1 == 2**30 - 1
    valid = fdr != 0  # fdr == 0 cells are NaN absorbers, not river
    np.testing.assert_array_equal(got[valid], want[valid].astype(np.int32))
