"""PyTorch port vs the JAX package: the flow walk, HAND, GFI and ln(hl/H).

Tolerances:
- indices, HAND (and its integer dtype): bitwise everywhere;
- fdist bitwise against the TPU kernel the walk replaces
  (``walk_vmem.flow_pallas_vmem``, interpret mode), which rebuilds it from
  integer step counts with the same expression; within rtol 1e-6, atol 1e-4
  of the XLA hybrid engine, which sums f32 steps serially (rtol 1e-5,
  atol 1e-2 on the 40000-step serpentine);
- GFI and ln(hl/H) within rtol 2e-5 (log/pow differ by a few ulp).

A numpy serial walk, the plain form of the CUDA kernel's algorithm, is held
bitwise against the port's plain engine state (code, a, b).
"""

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
from descriptools_tpu_torch.ops import gfi as tgfi
from descriptools_tpu_torch.ops.cuda import walk as twalk

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


def serial_walk_state(fdr_eff, code0, max_steps):
    """numpy form of csrc/walk.cu::flow_walk_kernel: every lane is one start
    cell walking to its absorber (lanes advance together)."""
    rows, cols = code0.shape
    fe, c0 = fdr_eff.reshape(-1), code0.reshape(-1)
    move = np.zeros(256, np.int64)
    diag = np.zeros(256, bool)
    for code, dy, dx in zip((1, 2, 4, 8, 16, 32, 64, 128),
                            (0, 1, 1, 1, 0, -1, -1, -1), (1, 1, 0, -1, -1, -1, 0, 1)):
        move[code], diag[code] = dy * cols + dx, bool(dy and dx)
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


@pytest.mark.parametrize("case", ["basin", "basin_capped", "lateral_channel"])
def test_flow_bitwise_vs_pallas_vmem_kernel(case):
    fdr, river, max_steps = CASES[case]()
    wfd, widx = flow_pallas_vmem(fdr, river, PX, max_steps=max_steps, interpret=True)
    fd, idx = _port(fdr, river, max_steps)
    assert idx.dtype == np.int32 and fd.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(widx))
    np.testing.assert_array_equal(fd, np.asarray(wfd))


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


def test_flow_wrapper_on_cpu_runs_the_plain_engine():
    fdr, river, max_steps = CASES["basin"]()
    before = twalk.flow_walk.launches
    fd, idx = twalk.flow_cuda(torch.from_numpy(fdr), torch.from_numpy(river), PX, max_steps)
    assert twalk.flow_walk.launches == before
    wfd, widx = _port(fdr, river, max_steps)
    np.testing.assert_array_equal(idx.numpy(), widx)
    np.testing.assert_array_equal(fd.numpy(), wfd)
