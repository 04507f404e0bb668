"""PyTorch port vs the JAX package: the flow walk, HAND, GFI and ln(hl/H).

Tolerances:
- indices, HAND (and its integer dtype): bitwise everywhere;
- fdist bitwise against the TPU kernel the walk replaces
  (``walk_vmem.flow_pallas_vmem``, interpret mode), which rebuilds it from
  integer step counts with the same expression; within rtol 1e-6, atol 1e-4
  of the XLA hybrid engine, which sums f32 steps serially (rtol 1e-5,
  atol 1e-2 on the 40000-step serpentine);
- GFI and ln(hl/H) within rtol 2e-5 (log/pow differ by a few ulp).

A numpy serial walk, the function the CUDA jump walk computes, is held
bitwise against the port's plain engine state (code, a, b); a numpy model
of the jump walk itself (bounded walk, pending list, jump rounds) is held
bitwise against both, and its fdist and indices against the TPU kernel.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from descriptools_tpu.ops.flow import flow_distance_index as j_flow
from descriptools_tpu.ops.flow import hand_and_river_fac as j_hand_fac
from descriptools_tpu.ops.gfi import gfi as j_gfi
from descriptools_tpu.ops.gfi import ln_hl_h as j_ln_hl_h
from descriptools_tpu.ops.pallas.walk_vmem import flow_pallas_vmem
from descriptools_tpu.utils.synthetic import synthetic_basin
from descriptools_tpu_torch.ops import flow as tflow
from descriptools_tpu_torch.ops.cuda import walk as twalk
# The module: the package binds ops.gfi to the function of that name.
tgfi = importlib.import_module("descriptools_tpu_torch.ops.gfi")

PX = 12.5


def _lateral_channel(rows=384, cols=128):
    fdr = np.full((rows, cols), 1, np.uint8)  # east
    fdr[:, -1] = 64  # last column: north
    river = np.zeros((rows, cols), np.int8)
    river[0, -1] = 1
    return fdr, river


def _serpentine(rows, cols):
    fdr = np.zeros((rows, cols), np.uint8)
    for r in range(rows):
        fdr[r, :] = 1 if r % 2 == 0 else 16
        fdr[r, -1 if r % 2 == 0 else 0] = 4
    river = np.zeros((rows, cols), np.int8)
    river[-1, 0] = 1
    return fdr, river


def _cycles(rows=24, cols=40, seed=3):
    """Random D8 field with 2-cycles (E<->W pairs), a few river cells (one
    with fdr 0: a NaN absorber, not a river) and every absorber kind."""
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    fdr = codes[rng.integers(0, 8, size=(rows, cols))]
    fdr[5, 10], fdr[5, 11] = 1, 16
    fdr[rng.random((rows, cols)) < 0.03] = 0
    river = (rng.random((rows, cols)) < 0.05).astype(np.int8)
    fdr[7, 7], river[7, 7] = 0, 1
    return fdr, river


def _basin():
    _, fdr, river, _ = synthetic_basin(70, 110, seed=13)
    return fdr, river


CASES = {
    "basin": lambda: (*_basin(), 400),
    "basin_capped": lambda: (*_basin(), 5),
    "lateral_channel": lambda: (*_lateral_channel(), 1000),
    "cycles": lambda: (*_cycles(), 300),
}


def _port(fdr, river, max_steps):
    fd, idx = tflow.flow_distance_index(
        torch.from_numpy(fdr), torch.from_numpy(river), PX, max_steps=max_steps
    )
    return fd.numpy(), idx.numpy()


def _d8_tables(cols):
    """(flat move, diagonal?, valid?) of each D8 code, indexed by code."""
    move = np.zeros(256, np.int64)
    diag = np.zeros(256, bool)
    valid = np.zeros(256, bool)
    for code, dy, dx in zip((1, 2, 4, 8, 16, 32, 64, 128),
                            (0, 1, 1, 1, 0, -1, -1, -1), (1, 1, 0, -1, -1, -1, 0, 1)):
        move[code], diag[code], valid[code] = dy * cols + dx, bool(dy and dx), True
    return move, diag, valid


def serial_walk_state(fdr_eff, code0, max_steps):
    """numpy form of the serial walk (each lane one start cell walking to
    its absorber; lanes advance together): the function the jump walk of
    csrc/walk.cu computes."""
    rows, cols = code0.shape
    fe, c0 = fdr_eff.reshape(-1), code0.reshape(-1)
    move, diag, _ = _d8_tables(cols)
    cur = np.arange(rows * cols)
    code = c0.copy()
    a = np.zeros(rows * cols, np.int32)
    b = np.zeros(rows * cols, np.int32)
    for _ in range(max_steps):
        lanes = np.flatnonzero(code == tflow.UNRES)
        if lanes.size == 0:
            break
        d = fe[cur[lanes]]
        a[lanes] += ~diag[d]
        b[lanes] += diag[d]
        cur[lanes] += move[d]
        code[lanes] = c0[cur[lanes]]
    un = code == tflow.UNRES
    a[un], b[un] = 0, 0
    return tuple(x.reshape(rows, cols) for x in (code, a, b))


GARBAGE = 0x5A5A5A5A  # what an output the walk never wrote holds (torch.empty)
DONE_PENDING = (1 << 31) - 1
WARP = 32


def jump_walk_state(fdr_eff, code0, max_steps, B, same_round=False, epilogue=True):
    """numpy model of csrc/walk.cu's jump walk: (code, a, b) int32.

    Phase 1 walks each lane at most min(B, max_steps) steps; a lane that
    lands or is stuck is final (done -1), one that walked B < max_steps
    steps is pending: its state (ptr, a, b) goes to X and it joins the
    pending list in cell order.  Then R rounds (the least R with
    B * 2^R >= max_steps): round k runs the list in warps of 32, in order.
    A lane whose target q was final before the round (done[q] < k) lands on
    q's absorber if the summed steps stay within max_steps, else gives up;
    otherwise it jumps to X[q]'s target, gives up past max_steps, or joins
    the next list with its state in Y.  The outputs a round writes become
    visible only when it ends (a kernel boundary); ``done`` at once.  The
    epilogue gives up on the lanes still listed after round R - 1.

    ``same_round`` lets a lane trust a final of its own round (done[q] <=
    k); ``epilogue=False`` skips the epilogue.  Both are faults."""
    rows, cols = code0.shape
    n = rows * cols
    fe, c0 = fdr_eff.reshape(-1), code0.reshape(-1).astype(np.int64)
    move, diag, valid = _d8_tables(cols)
    out = np.full((3, n), GARBAGE, np.int64)  # code, a, b
    done = np.empty(n, np.int64)

    # Phase 1.
    cur, code = np.arange(n), c0.copy()
    a, b, steps = (np.zeros(n, np.int64) for _ in range(3))
    stuck = np.zeros(n, bool)
    for _ in range(min(B, max_steps)):
        lanes = np.flatnonzero((code == tflow.UNRES) & ~stuck)
        if lanes.size == 0:
            break
        d = fe[cur[lanes]]
        stuck[lanes[~valid[d]]] = True
        lanes, d = lanes[valid[d]], d[valid[d]]
        a[lanes] += ~diag[d]
        b[lanes] += diag[d]
        steps[lanes] += 1
        cur[lanes] += move[d]
        code[lanes] = c0[cur[lanes]]
    pending = (code == tflow.UNRES) & ~stuck & (steps == B) & (B < max_steps)
    final = ~pending
    landed = final & (code != tflow.UNRES)
    out[:, final] = np.where(landed[final], [code[final], a[final], b[final]], [[tflow.UNRES], [0], [0]])
    done[final] = -1
    done[pending] = DONE_PENDING
    x = np.stack([cur, a, b])  # (ptr, a, b) of the pending lanes
    listed = np.flatnonzero(pending)

    rounds = 0
    while (B << rounds) < max_steps:
        rounds += 1
    for k in range(rounds):
        visible = out.copy()  # finals of earlier launches
        y = x.copy()
        nxt = []
        for w in range(0, listed.size, WARP):
            c = listed[w : w + WARP]
            q = x[0, c]
            trust = done[q] <= k if same_round else done[q] < k
            ct, qt = c[trust], q[trust]
            t = x[1, ct] + x[2, ct] + visible[1, qt] + visible[2, qt]
            land = (visible[0, qt] != tflow.UNRES) & (t <= max_steps)
            out[0, ct] = np.where(land, visible[0, qt], tflow.UNRES)
            out[1, ct] = np.where(land, x[1, ct] + visible[1, qt], 0)
            out[2, ct] = np.where(land, x[2, ct] + visible[2, qt], 0)
            done[ct] = k
            cj, qj = c[~trust], q[~trust]
            na, nb = x[1, cj] + x[1, qj], x[2, cj] + x[2, qj]
            over = na + nb > max_steps
            out[:, cj[over]] = [[tflow.UNRES], [0], [0]]
            done[cj[over]] = k
            keep = ~over
            y[:, cj[keep]] = [x[0, qj[keep]], na[keep], nb[keep]]
            nxt.append(cj[keep])
        x = y
        listed = np.concatenate(nxt) if nxt else listed[:0]
    if epilogue:
        out[:, listed] = [[tflow.UNRES], [0], [0]]
        done[listed] = rounds
    return tuple(v.astype(np.int32).reshape(rows, cols) for v in out)


@functools.cache
def _pallas_vmem(case):
    """(fdist, indices) of the TPU kernel the walk replaces, interpret mode."""
    fdr, river, max_steps = CASES[case]()
    wfd, widx = flow_pallas_vmem(fdr, river, PX, max_steps=max_steps, interpret=True)
    return np.asarray(wfd), np.asarray(widx)


@pytest.mark.parametrize("case", ["basin", "basin_capped", "lateral_channel"])
def test_flow_bitwise_vs_pallas_vmem_kernel(case):
    fdr, river, max_steps = CASES[case]()
    wfd, widx = _pallas_vmem(case)
    fd, idx = _port(fdr, river, max_steps)
    assert idx.dtype == np.int32 and fd.dtype == np.float32
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_array_equal(fd, wfd)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_vs_xla_hybrid_engine(case):
    fdr, river, max_steps = CASES[case]()
    wfd, widx = j_flow(fdr, river, PX, max_steps=max_steps)
    fd, idx = _port(fdr, river, max_steps)
    np.testing.assert_array_equal(idx, np.asarray(widx))
    np.testing.assert_allclose(fd, np.asarray(wfd), rtol=1e-6, atol=1e-4)


def test_flow_serpentine_vs_xla_hybrid_engine():
    """One ~40000-step path: counts past 2^15, where the TPU packed kernel
    needs its fallback; the port's separate int32 counts need none."""
    fdr, river = _serpentine(200, 200)
    wfd, widx = j_flow(fdr, river, PX, max_steps=60000)
    fd, idx = _port(fdr, river, 60000)
    np.testing.assert_array_equal(idx, np.asarray(widx))
    np.testing.assert_allclose(fd, np.asarray(wfd), rtol=1e-5, atol=1e-2)
    assert int((idx != -100).sum()) == 200 * 200


@pytest.mark.parametrize(
    "fixture",
    [CASES["basin"], CASES["basin_capped"], CASES["cycles"],
     lambda: (*_serpentine(24, 30), 500), lambda: (*_serpentine(24, 30), 719)],
)
def test_serial_walk_reference_bitwise(fixture):
    fdr, river, max_steps = fixture()
    fdr_eff, code0 = tflow.walk_inputs(torch.from_numpy(fdr), torch.from_numpy(river))
    want = serial_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps)
    got = tflow.doubling_walk(fdr_eff, code0, max_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _b_boundary(B, delta, k=3):
    """Eastward rows of B * 2^k + 1 steps into a river column, at a cap of
    B * 2^k + delta: the first cell lands only when delta > 0."""
    steps = (B << k) + 1
    fdr = np.ones((3, steps + 1), np.uint8)
    river = np.zeros((3, steps + 1), np.int8)
    river[:, -1] = 1
    return fdr, river, (B << k) + delta


def _north_rivers(rows=70, cols=5, spacing=23):
    """Northward flow into a river row every ``spacing`` rows: walks of 0 to
    spacing - 1 steps."""
    fdr = np.full((rows, cols), 64, np.uint8)
    river = np.zeros((rows, cols), np.int8)
    river[::spacing] = 1
    return fdr, river


JUMP_FIXTURES = {
    "basin": lambda B: CASES["basin"](),
    "basin_capped": lambda B: CASES["basin_capped"](),
    "cycles": lambda B: CASES["cycles"](),
    "serpentine_500": lambda B: (*_serpentine(24, 30), 500),
    "serpentine_719": lambda B: (*_serpentine(24, 30), 719),
    "b_boundary-1": lambda B: _b_boundary(B, -1),
    "b_boundary+0": lambda B: _b_boundary(B, 0),
    "b_boundary+1": lambda B: _b_boundary(B, 1),
    "north_rivers": lambda B: (*_north_rivers(), 400),
}


def _walk_operands(fdr, river):
    fdr_eff, code0 = tflow.walk_inputs(torch.from_numpy(fdr), torch.from_numpy(river))
    return fdr_eff, code0


@pytest.mark.parametrize("fixture", sorted(JUMP_FIXTURES))
@pytest.mark.parametrize("B", [1, 2, 7, 32, 64])
def test_jump_walk_model_bitwise(B, fixture):
    """The jump walk's model is the serial walk and the plain doubling
    engine, bitwise (code, a, b), at every B and cap."""
    fdr, river, max_steps = JUMP_FIXTURES[fixture](B)
    fdr_eff, code0 = _walk_operands(fdr, river)
    got = jump_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps, B)
    want = serial_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps)
    plain = tflow.doubling_walk(fdr_eff, code0, max_steps)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.numpy())
    if fixture.startswith("b_boundary"):
        assert (got[0][0, 0] != tflow.UNRES) == fixture.endswith("+1")


@pytest.mark.parametrize("case", ["basin", "basin_capped", "lateral_channel"])
@pytest.mark.parametrize("B", [1, 2, 7, 32, 64])
def test_jump_walk_model_vs_pallas_vmem_kernel(B, case):
    fdr, river, max_steps = CASES[case]()
    fdr_eff, code0 = _walk_operands(fdr, river)
    state = jump_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps, B)
    fd, idx = tflow.flow_from_state(*map(torch.from_numpy, state), PX, max_steps)
    wfd, widx = _pallas_vmem(case)
    np.testing.assert_array_equal(idx.numpy(), widx)
    np.testing.assert_array_equal(fd.numpy(), wfd)


@pytest.mark.parametrize(
    "fault,fixture",
    [(dict(same_round=True), lambda: CASES["lateral_channel"]()),
     (dict(epilogue=False), lambda: _b_boundary(2, 0))],
    ids=["trusts_a_final_of_its_own_round", "skips_the_epilogue"],
)
def test_jump_walk_rules_matter(fault, fixture):
    """Each rule of the jump walk is needed: a lane that trusts a final
    written in its own round reads a triple not yet visible, and without
    the epilogue the lanes that reach the cap exactly are never written."""
    fdr, river, max_steps = fixture()
    fdr_eff, code0 = _walk_operands(fdr, river)
    want = serial_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps)
    got = jump_walk_state(fdr_eff.numpy(), code0.numpy(), max_steps, 2, **fault)
    assert any((g != w).any() for g, w in zip(got, want))


def d8_decode(f):
    """csrc/d8.cuh::d8_decode on a 32-bit int: (valid, dy, dx, diagonal)."""
    u = f & 0xFFFFFFFF
    k = ((u & -u).bit_length() - 1) & 7  # __ffs(code) - 1, as unsigned, & 7
    dy = ((0x01A9 >> (2 * k)) & 3) - 1
    dx = ((0x901A >> (2 * k)) & 3) - 1
    return ((u - 1) & 0xFFFFFFFF) < 128 and (u & (u - 1)) == 0, dy, dx, bool(k & 1)


def raw_cell_role(f, river, r, c, rows, cols):
    """csrc/walk.cu ``RawCells::visit``, the role phase 1 of the in-core
    flow walk gives cell (r, c) of a rows x cols grid from its fdr ``f`` and
    its river byte: (UNRES, True) where it steps, else (its absorber code,
    False): its flat index for a river, -index-1 for a NaN absorber."""
    idx = r * cols + c
    valid, dy, dx, _ = d8_decode(f)
    inside = valid and 0 <= r + dy < rows and 0 <= c + dx < cols
    if f != 0 and river != 1 and inside:
        return tflow.UNRES, True
    return (idx if f != 0 and river == 1 else -idx - 1), False


def _roles_of_walk_inputs(fdr, river):
    """[(code0, fdr_eff)] of every cell, row-major, from ``walk_inputs``."""
    fdr_eff, code0 = tflow.walk_inputs(fdr, river)
    return list(zip(code0.reshape(-1).tolist(), fdr_eff.reshape(-1).tolist()))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=str)
def test_raw_cell_role_is_the_truth_table_of_walk_inputs(dtype):
    """The kernel's per-cell rule against ``walk_inputs``' code0 and
    fdr_eff for every fdr value the dtype holds from -1 to 257, river 0, 1
    and 2, at the corners, edges and interior of a 3 x 4 grid."""
    rows, cols = 3, 4
    values = range(256) if dtype == torch.uint8 else range(-1, 258)
    for f in values:
        for rv in (0, 1, 2):
            got = _roles_of_walk_inputs(torch.full((rows, cols), f, dtype=dtype),
                                        torch.full((rows, cols), rv, dtype=torch.int8))
            for idx, (code0, fdr_eff) in enumerate(got):
                code, moves = raw_cell_role(f, rv, idx // cols, idx % cols, rows, cols)
                assert (code0, fdr_eff) == (code, f if moves else 0), (f, rv, idx)


FDR_VALUES = (-2**40, -2**31 - 1, -2**31, -129, -1, 0, 1, 2, 3, 16, 64, 128, 255, 256, 257,
              2**31 - 1, 2**31, 2**32 + 1, 2**32 + 64)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int64, torch.uint8, torch.int32],
                         ids=str)
def test_flow_operands_keep_every_cells_role(dtype):
    """``flow_operands`` gives the kernel fdr and a river byte under which
    every cell has the role ``walk_inputs`` gives it from the rasters as
    they were: values int32 cannot hold stay invalid, a river of 257 stays
    no river."""
    info = torch.iinfo(dtype)
    values = [v for v in FDR_VALUES if info.min <= v <= info.max]
    rows, cols = 3, len(values)
    fdr = torch.tensor([values] * rows, dtype=dtype)
    river = torch.tensor([[[0, 1, 2, 257][(r + c) % 4] for c in range(cols)] for r in range(rows)])
    f_op, r_op = twalk.flow_operands(fdr, river)
    assert f_op.dtype in twalk.FDR_DTYPES and r_op.dtype in twalk.RIVER_DTYPES
    assert f_op.is_contiguous() and r_op.is_contiguous()
    want = _roles_of_walk_inputs(fdr, river)
    f_l, r_l = f_op.reshape(-1).tolist(), r_op.reshape(-1).tolist()
    for idx, (code0, fdr_eff) in enumerate(want):
        code, moves = raw_cell_role(f_l[idx], r_l[idx], idx // cols, idx % cols, rows, cols)
        assert code == code0 and (fdr_eff != 0) == moves, (values[idx % cols], idx)
    with pytest.raises(ValueError, match="integer dtype"):
        twalk.flow_operands(fdr.to(torch.float32), river)


@pytest.mark.parametrize("dem_dtype", [np.int32, np.int16])
def test_hand_and_river_fac_bitwise(dem_dtype):
    dem, fdr, river, fac = synthetic_basin(70, 110, seed=13)
    dem = dem.astype(dem_dtype)
    fac = fac.astype(np.int32)
    _, idx = _port(fdr, river, 400)
    wh, wrf = j_hand_fac(dem, fac, idx)
    h, rf = tflow.hand_and_river_fac(torch.from_numpy(dem), torch.from_numpy(fac), torch.from_numpy(idx))
    assert h.numpy().dtype == np.asarray(wh).dtype == dem_dtype
    np.testing.assert_array_equal(h.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(rf.numpy(), np.asarray(wrf))
    np.testing.assert_array_equal(
        tflow.hand_calculator(torch.from_numpy(dem), torch.from_numpy(idx)).numpy(),
        np.asarray(wh),
    )
    np.testing.assert_array_equal(
        tgfi.river_accumulation(torch.from_numpy(fac), torch.from_numpy(idx)).numpy(),
        np.asarray(wrf),
    )


@pytest.mark.parametrize("px,n,b", [(12.5, 0.4, 0.1), (30.0, 0.3, 0.2)])
def test_gfi_and_ln_hl_h_vs_jax(px, n, b):
    dem, fdr, river, fac = synthetic_basin(70, 110, seed=13)
    dem, fac = dem.astype(np.int32), fac.astype(np.int32)
    _, idx = _port(fdr, river, 400)
    hand, rfac = j_hand_fac(dem, fac, idx)
    hand, rfac = np.array(hand), np.array(rfac)
    got = tgfi.gfi(torch.from_numpy(hand), torch.from_numpy(rfac), n, b, px).numpy()
    np.testing.assert_allclose(got, np.asarray(j_gfi(hand, rfac, n, b, px)), rtol=2e-5)
    got = tgfi.ln_hl_h(torch.from_numpy(hand), torch.from_numpy(fac), n, b, px).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ln_hl_h(hand, fac, n, b, px)), rtol=2e-5)


@pytest.mark.parametrize("entry", ["flow_cuda", "absorbing_walk"])
def test_jump_walk_wrappers_refuse_max_steps_past_2pow30_on_cpu(entry):
    """The wrappers refuse a cap whose sums could overflow on any device, as
    they do on the card, and run the plain engine under it."""
    fdr, river = _north_rivers()
    fdr_eff, code0 = _walk_operands(fdr, river)
    state = tflow.doubling_walk(fdr_eff, code0, (1 << 30) - 1)
    if entry == "flow_cuda":
        raster = torch.from_numpy(fdr), torch.from_numpy(river)
        run = lambda cap: twalk.flow_cuda(*raster, PX, cap)
        want = tflow.flow_from_state(*state, PX, (1 << 30) - 1)
    else:
        run = lambda cap: twalk.absorbing_walk(fdr_eff, code0, cap)
        want = state
    with pytest.raises(ValueError, match="2\\^30"):
        run(1 << 30)
    assert all(g.equal(w) for g, w in zip(run((1 << 30) - 1), want))


def test_flow_wrapper_on_cpu_runs_the_plain_engine():
    fdr, river, max_steps = CASES["basin"]()
    before = twalk.flow_walk.launches
    fd, idx = twalk.flow_cuda(torch.from_numpy(fdr), torch.from_numpy(river), PX, max_steps)
    assert twalk.flow_walk.launches == before
    wfd, widx = _port(fdr, river, max_steps)
    np.testing.assert_array_equal(idx.numpy(), widx)
    np.testing.assert_array_equal(fd.numpy(), wfd)
