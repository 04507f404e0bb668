"""PyTorch port vs the JAX package: the downslope walk.

The port's downslope (plain engine on the CPU) is held against the JAX
jacobi engine and against the TPU kernel it replaces
(``walk_vmem.downslope_pallas_vmem``, interpret mode), on a synthetic basin,
on long northward walks with and without ascending bumps (non-monotone
descent), on fractional elevations with a low cap, and on the fixtures of
``utils.synthetic.downslope_cases``: NoData starts and targets, border
exits, invalid codes, fdr as int16 and int64 with 257 and -1, terminals
more than 2^20 m above the walk's threshold, fractional terminal stops.

Bitwise everywhere on integer elevations.  On fractional ones the JAX
engines encode a terminal as ``z - 2^20``, which rounds the elevation at a
terminal stop to 1/16 m; the port carries the terminal flag apart and is
exact there: ``assert_jax_or_exact`` holds it bitwise to JAX at every other
cell and to ``oracle.downslope_oracle`` (its vectorized twin) at terminal
stops, within float32's rounding of the ratio.

Two numpy models, each held bitwise to the port:
- ``serial_walk_state``, one walk per start on the plain engine's operands,
  against the port's ``jacobi_walk`` state;
- ``fused_downslope_model``, the CUDA kernel's algorithm
  (``csrc/walk.cu::downslope_kernel``: raw dem and fdr in, the terminal
  test formed on the fly, a one-step lookahead, the ratio in the kernel's
  order in float32), against the port's plain engine, the JAX jacobi
  engine and the VMEM kernel.  ``tests/test_torch_boundary.py`` holds its
  tracked form.
"""

import importlib

import numpy as np
import pytest
import torch

from descriptools_tpu.ops.downslope import _downslope_jacobi as j_jacobi
from descriptools_tpu.ops.pallas.walk_vmem import downslope_pallas_vmem
from descriptools_tpu.utils.synthetic import d8_from_dem, synthetic_basin
from descriptools_tpu_torch.constants import D8_STEP
from descriptools_tpu_torch.d8 import decode, successor
from descriptools_tpu_torch.ops.cuda import walk as twalk
from descriptools_tpu_torch.oracle.core import downslope_oracle_trunc
from descriptools_tpu_torch.utils.synthetic import downslope_cases
# The module: the package binds ops.downslope to the function of that name.
tdown = importlib.import_module("descriptools_tpu_torch.ops.downslope")

PX = 12.5


def _tall_north(rows, cols, bump_every):
    dem = np.broadcast_to(
        np.round(np.arange(rows, dtype=np.float64) * 0.5 + 100.0)[:, None].astype(np.float32),
        (rows, cols),
    ).copy()
    if bump_every:
        dem[::bump_every, :] += 3.0  # the step from the row below ascends
    return dem, np.full((rows, cols), 64, np.uint8)


def _fractional(rows=48, cols=64, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols]
    dem = (300.0 - 0.37 * yy - 0.21 * xx + rng.random((rows, cols)) * 2.3).astype(np.float32)
    dem[:4, :5] = -100.0
    return dem, d8_from_dem(dem)


CASES = {
    "basin": lambda: (synthetic_basin(70, 110, seed=13)[0].astype(np.float32),
                      synthetic_basin(70, 110, seed=13)[1], 5.0, 200),
    "tall_north": lambda: (*_tall_north(320, 128, None), 50.0, 600),
    "tall_north_bumps": lambda: (*_tall_north(320, 128, 37), 50.0, 600),
    "fractional_capped": lambda: (*_fractional(), 5.0, 7),
    **{name: (lambda name=name: downslope_cases()[name]) for name in downslope_cases()},
}


def _port(dem, fdr, ed, max_steps):
    return tdown.downslope(
        torch.from_numpy(dem), torch.from_numpy(fdr), PX, ed, max_steps=max_steps
    ).numpy()


def serial_walk_state(fdr_eff, z, term0, ed, max_steps):
    """numpy form of csrc/walk.cu::downslope_kernel on the plain engine's
    operands: every lane is one start cell following its own D8 path (lanes
    advance together) to a terminal or an elevation at or below z - ed.
    Returns (pk, the elevation at the stop)."""
    rows, cols = z.shape
    fe, zf, t0 = fdr_eff.reshape(-1), z.reshape(-1), term0.reshape(-1)
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
    walking = ~t0 & ~(zf <= thresh)
    for _ in range(max_steps):
        lanes = np.flatnonzero(walking)
        if lanes.size == 0:
            break
        d = fe[cur[lanes]]
        pk[lanes] += inc[d]
        cur[lanes] += move[d]
        p = cur[lanes]
        walking[lanes[t0[p] | (zf[p] <= thresh[lanes])]] = False
    return pk.reshape(rows, cols), zf[cur].reshape(rows, cols)


# The JAX engines' terminal offset: z - 2^20 rounds a fractional z to 1/16 m.
_OFF = np.float32(1 << 20)
_NODATA = np.float32(-100.0)
# csrc/d8.cuh::d8_decode's tables, by the code's bit (E, SE, S, SW, W, NW, N, NE).
_DY = np.array([0, 1, 1, 1, 0, -1, -1, -1])
_DX = np.array([1, 1, 0, -1, -1, -1, 0, 1])


def _decode(code):
    """(dy, dx, diag, valid) of int64 codes, by the code's bit: valid where
    the code is a power of two from 1 to 128."""
    valid = (code >= 1) & (code <= 128) & ((code & (code - 1)) == 0)
    k = np.where(valid, np.log2(np.where(valid, code, 1)).round().astype(np.int64), 0)
    return _DY[k], _DX[k], (k & 1) == 1, valid


def fused_downslope_model(dem_f, fdr, px, ed, max_steps, halo=0, origin=None, grid=None,
                          terminal_stops=False):
    """numpy form of csrc/walk.cu::downslope_kernel: every lane is one start
    of the interior ``[halo, -halo)`` of ``dem_f`` (lanes advance together).

    At each cell p the lane holds p's decoded code and, where p's step stays
    inside the raster, z and fdr of p's successor, loaded together: they
    complete p's terminal test (invalid code, exit, z -100 at p or at its
    target), and they are the next step's operand.  The walk stops at a
    terminal or at an elevation at or below z - ed.  Then the ratio, in the
    kernel's order, in float32, from the elevation at the stop as it is.
    With ``origin`` and ``grid`` (the raster's origin and the global grid's
    shape) it also returns the truncation flag read at the stop cell; with
    ``terminal_stops`` (and no ``origin``) the walks that stopped at a
    terminal after a step instead.  Returns the interior's rasters."""
    z = np.asarray(dem_f, np.float32)
    rows_w, cols_w = z.shape
    zf, cf = z.reshape(-1), np.asarray(fdr).astype(np.int64).reshape(-1)
    ii, jj = np.mgrid[halo : rows_w - halo, halo : cols_w - halo]
    shape = ii.shape
    r, c = ii.reshape(-1).copy(), jj.reshape(-1).copy()
    z0 = zf[r * cols_w + c]
    thresh = z0 - np.float32(ed)
    c_card, c_diag = np.float32(D8_STEP[0]) * np.float32(px), np.float32(D8_STEP[1]) * np.float32(px)

    def look_ahead(r, c, code):
        dy, dx, diag, valid = _decode(code)
        ty, tx = r + dy, c + dx
        inside = valid & (ty >= 0) & (ty < rows_w) & (tx >= 0) & (tx < cols_w)
        nxt = np.where(inside, ty * cols_w + tx, 0)
        zn = np.where(inside, zf[nxt], np.float32(0.0))
        fn = np.where(inside, cf[nxt], 0)
        return dy, dx, diag, valid, inside, zn, fn

    zc = z0.copy()
    dy, dx, diag, valid, inside, zn, fn = look_ahead(r, c, cf[r * cols_w + c])
    terminal = ~inside | (zn == _NODATA) | (zc == _NODATA)
    pk = np.zeros(r.shape, np.int32)
    walking = ~(zc <= thresh) & ~terminal
    for _ in range(max_steps):
        lanes = np.flatnonzero(walking)
        if lanes.size == 0:
            break
        pk[lanes] += np.where(diag[lanes], 1 << 16, 1).astype(np.int32)
        r[lanes] += dy[lanes]
        c[lanes] += dx[lanes]
        zc[lanes] = zn[lanes]
        ahead = look_ahead(r[lanes], c[lanes], fn[lanes])
        for arr, new in zip((dy, dx, diag, valid, inside, zn, fn), ahead):
            arr[lanes] = new
        terminal[lanes] = ~inside[lanes] | (zn[lanes] == _NODATA) | (zc[lanes] == _NODATA)
        walking[lanes] = ~(zc[lanes] <= thresh[lanes]) & ~terminal[lanes]
    dist = (pk & 0xFFFF).astype(np.float32) * c_card + (pk >> 16).astype(np.float32) * c_diag
    with np.errstate(divide="ignore", invalid="ignore"):
        down = np.where(pk == 0, np.float32(0.0), (z0 - zc) / dist)
    out = np.where(z0 == _NODATA, _NODATA, down).reshape(shape)
    assert out.dtype == np.float32
    if terminal_stops:
        # descriptools' own ratio at the stop, in float64 (oracle/core.py).
        steps = np.stack([pk & 0xFFFF, pk >> 16]).astype(np.float64)
        dist64 = px * float(D8_STEP[0]) * steps[0] + px * float(D8_STEP[1]) * steps[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            exact = (z0.astype(np.float64) - zc.astype(np.float64)) / dist64
        return out, (terminal & (pk > 0)).reshape(shape), exact.reshape(shape)
    if origin is None:
        return out
    gy, gx = r + dy + origin[0], c + dx + origin[1]
    in_grid = (gy >= 0) & (gy < grid[0]) & (gx >= 0) & (gx < grid[1])
    cut = valid & ~inside & in_grid & (zc != _NODATA)
    return out, (terminal & cut).reshape(shape)


# float32's rounding of (z0 - z_stop) / dist against the float64 oracle: the
# subtraction, the two step lengths, their products and sum, the division.
EXACT_RTOL = 4e-7


def assert_jax_or_exact(got, want, dem, fdr, ed, max_steps, halo=0):
    """``got`` (a raster of the interior ``[halo, -halo)``) bitwise ``want``
    (a JAX engine's, of the same interior) at every cell but the walks that
    stopped at a terminal after a step, where the JAX engines round a
    fractional elevation to 1/16 m; there ``got`` is descriptools' own
    ``(z0 - z_stop) / dist`` in float64 (``oracle.downslope_oracle``'s
    formula; ``test_model_exact_ratio_is_the_oracle`` holds the two equal)
    within float32's rounding.  Bitwise everywhere on integer elevations.
    Returns the terminal stops."""
    _, stops, exact = fused_downslope_model(dem, fdr, PX, ed, max_steps, halo, terminal_stops=True)
    np.testing.assert_array_equal(got[~stops], want[~stops])
    np.testing.assert_allclose(got[stops], exact[stops], rtol=EXACT_RTOL, atol=0)
    if np.array_equal(dem, np.round(dem)):
        np.testing.assert_array_equal(got, want)
    return stops


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_exact_ratio_is_the_oracle(case):
    """The float64 ratio ``assert_jax_or_exact`` holds terminal stops to is
    ``oracle.downslope_oracle``'s (its vectorized twin's), and the walks
    stop where the oracle's do."""
    dem, fdr, ed, max_steps = CASES[case]()
    out, stops, exact = fused_downslope_model(dem, fdr, PX, ed, max_steps, terminal_stops=True)
    want = downslope_oracle_trunc(dem, fdr, PX, ed, max_steps)[0]
    np.testing.assert_allclose(exact[stops], want[stops], rtol=1e-12, atol=0)
    np.testing.assert_allclose(out, want, rtol=EXACT_RTOL, atol=1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_model_bitwise_vs_jax_jacobi(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    assert_jax_or_exact(fused_downslope_model(dem, fdr, PX, ed, max_steps), want, dem, fdr, ed,
                        max_steps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_model_bitwise_vs_pallas_vmem_kernel(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(
        downslope_pallas_vmem(dem, fdr, PX, ed, max_steps=max_steps, interpret=True)
    )
    assert_jax_or_exact(fused_downslope_model(dem, fdr, PX, ed, max_steps), want, dem, fdr, ed,
                        max_steps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_model_bitwise_vs_port(case):
    """The kernel's algorithm is the port's plain engine bit for bit, at
    terminal stops too (the card tests hold the kernel to the plain engine)."""
    dem, fdr, ed, max_steps = CASES[case]()
    np.testing.assert_array_equal(fused_downslope_model(dem, fdr, PX, ed, max_steps),
                                  _port(dem, fdr, ed, max_steps))


@pytest.mark.parametrize("case", ["fdr_int16", "fdr_int64"])
def test_fdr_operand_keeps_out_of_range_codes_invalid(case):
    """The kernel wrapper reads a wider fdr as int32 with every value outside
    0-255 set to 0: 257 stays invalid (it would wrap onto 1 as uint8), and
    the kernel's function, the model's, does not change."""
    dem, fdr, ed, max_steps = CASES[case]()
    assert (fdr == 257).any() and (fdr == -1).any()
    op = twalk.fdr_operand(torch.from_numpy(fdr))
    assert op.dtype == torch.int32 and not bool(((op == 257) | (op == -1)).any())
    np.testing.assert_array_equal(op.numpy(), np.where((fdr >= 0) & (fdr <= 255), fdr, 0))
    np.testing.assert_array_equal(fused_downslope_model(dem, op.numpy(), PX, ed, max_steps),
                                  fused_downslope_model(dem, fdr, PX, ed, max_steps))


def test_fdr_operand_passes_the_kernel_dtypes_and_refuses_floats():
    for dtype in (torch.uint8, torch.int32):
        f = torch.arange(12, dtype=dtype).reshape(3, 4)
        assert twalk.fdr_operand(f).dtype == dtype
        assert torch.equal(twalk.fdr_operand(f), f)
    for dtype in (torch.float32, torch.bool):
        with pytest.raises(ValueError, match="integer dtype"):
            twalk.fdr_operand(torch.zeros((3, 4), dtype=dtype))


def test_adversarial_cases_reach_their_branches():
    """Each fixture of ``downslope_cases`` reaches what it is named for."""
    cases = downslope_cases()
    dem, fdr, ed, max_steps = cases["nodata"]
    succ = successor(torch.from_numpy(fdr), *dem.shape)[0].numpy().reshape(-1)
    assert ((dem == -100) & (fdr != 0)).any() and ((dem == -100) & (fdr == 0)).any()
    assert ((dem != -100) & (dem.reshape(-1)[succ].reshape(dem.shape) == -100)).any()
    dem, fdr, _, _ = cases["border_exits"]
    rows, cols = dem.shape
    _, _, _, valid = decode(torch.from_numpy(fdr))
    ok = successor(torch.from_numpy(fdr), rows, cols)[2]
    assert int((valid & ~ok).sum()) >= 2 * (rows + cols) - 4
    for name in ("invalid_codes", "fdr_int16"):
        assert set(np.unique(cases[name][1])) >= {0, 3, 255}
    # Terminals more than 2^20 m above the threshold: the JAX engines'
    # offset does not stop the walks there (they hold still to the cap);
    # the port stops them, at the terminal's own elevation, as descriptools
    # does.  Other walks reach the cap.
    dem, fdr, ed, max_steps = cases["terminal_holds_still"]
    pk, zs = tdown.jacobi_walk(*tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX),
                               ed, max_steps)
    high = (zs == float(np.float32(1.2e6))) & (pk > 0)
    assert bool(high.any())
    assert np.float32(1.2e6) - _OFF > dem[dem < 1e6].max() - ed  # the JAX encoding does not stop them
    assert bool(((pk & 0xFFFF) == max_steps).any())
    # Fractional stops at the east border: read exactly, where the JAX
    # engines' offset rounds them to 1/16.
    dem, fdr, ed, max_steps = cases["fractional_terminal_stops"]
    pk, zs = tdown.jacobi_walk(*tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX),
                               ed, max_steps)
    assert bool((pk > 0)[:, :-1].all())  # every walk reaches the border
    zs = zs.numpy()
    assert (zs[:, :-1] == dem[:, -1:]).all()
    assert ((dem[:, -1] - _OFF) + _OFF != dem[:, -1]).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_downslope_bitwise_vs_jax_jacobi(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    got = _port(dem, fdr, ed, max_steps)
    assert got.dtype == want.dtype
    assert_jax_or_exact(got, want, dem, fdr, ed, max_steps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_downslope_bitwise_vs_pallas_vmem_kernel(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(
        downslope_pallas_vmem(dem, fdr, PX, ed, max_steps=max_steps, interpret=True)
    )
    assert_jax_or_exact(_port(dem, fdr, ed, max_steps), want, dem, fdr, ed, max_steps)


@pytest.mark.parametrize("case", sorted(CASES))
def test_serial_walk_reference_bitwise(case):
    """The kernel's algorithm (numpy serial walk) gives the port's plain
    engine state bitwise, and through the shared post-pass the port's
    output (JAX's but at terminal stops, see ``assert_jax_or_exact``)."""
    dem, fdr, ed, max_steps = CASES[case]()
    fdr_eff, z, term0 = tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX)
    pk, zs = serial_walk_state(fdr_eff.numpy(), z.numpy(), term0.numpy(), ed, max_steps)
    wpk, wzs = tdown.jacobi_walk(fdr_eff, z, term0, ed, max_steps)
    np.testing.assert_array_equal(pk, wpk.numpy())
    np.testing.assert_array_equal(zs, wzs.numpy())
    got = tdown.downslope_from_state(z, torch.from_numpy(pk), torch.from_numpy(zs), PX).numpy()
    np.testing.assert_array_equal(got, _port(dem, fdr, ed, max_steps))
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    assert_jax_or_exact(got, want, dem, fdr, ed, max_steps)


def test_fractional_case_hits_the_cap_and_the_rounding():
    """The fixture reaches what it is meant to: capped walks, and terminal
    stops whose elevation the JAX engines' -2^20 offset rounds (to 1/16
    below 2^19 m), where the port reads it exactly and JAX departs from
    descriptools by far more than float32's rounding."""
    dem, fdr, ed, max_steps = CASES["fractional_capped"]()
    fdr_eff, z, term0 = tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX)
    pk, zs = tdown.jacobi_walk(fdr_eff, z, term0, ed, max_steps)
    steps = (pk & 0xFFFF) + (pk >> 16)
    assert bool((steps == max_steps).any())
    own = z[(fdr_eff == 0) & (z != -100)]
    assert bool((own * 16 != torch.round(own * 16)).any())
    got = _port(dem, fdr, ed, max_steps)
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    stops = assert_jax_or_exact(got, want, dem, fdr, ed, max_steps)
    assert stops.any() and bool(np.isin(zs.numpy()[stops], own.numpy()).all())
    exact = downslope_oracle_trunc(dem, fdr, PX, ed, max_steps)[0]
    assert (np.abs(want - exact)[stops] > 1e3 * EXACT_RTOL * np.abs(exact)[stops]).any()


def test_downslope_wrapper_on_cpu_runs_the_plain_engine():
    dem, fdr, ed, max_steps = CASES["basin"]()
    before = twalk.downslope_walk.launches
    got = twalk.downslope_cuda(torch.from_numpy(dem), torch.from_numpy(fdr), PX, ed, max_steps)
    direct = twalk.downslope_walk(torch.from_numpy(dem), torch.from_numpy(fdr), PX, ed, max_steps)
    assert twalk.downslope_walk.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(dem, fdr, ed, max_steps))
    np.testing.assert_array_equal(direct.numpy(), got.numpy())


@pytest.mark.parametrize("max_steps", [-1, 1 << 16])
def test_cap_beyond_the_packed_counts_raises(max_steps):
    """pk packs 16-bit cardinal/diagonal counts: a cap of 2^16 or more could
    carry one field into the other, so it is refused."""
    dem, fdr, ed, _ = CASES["basin"]()
    with pytest.raises(ValueError, match="max_steps"):
        _port(dem, fdr, ed, max_steps)
