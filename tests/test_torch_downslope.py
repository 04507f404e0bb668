"""PyTorch port vs the JAX package: the downslope walk.

The port's downslope (plain engine on the CPU) is held bitwise against the
JAX jacobi engine and against the TPU kernel it replaces
(``walk_vmem.downslope_pallas_vmem``, interpret mode), on a synthetic basin,
on long northward walks with and without ascending bumps (non-monotone
descent) and on fractional elevations with a low cap.  A numpy serial walk,
the plain form of the CUDA kernel's algorithm (one walk per start cell),
is held bitwise against both the port's walk state and the JAX output.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu.ops.downslope import _downslope_jacobi as j_jacobi
from descriptools_tpu.ops.pallas.walk_vmem import downslope_pallas_vmem
from descriptools_tpu.utils.synthetic import d8_from_dem, synthetic_basin
from descriptools_tpu_torch.ops import downslope as tdown
from descriptools_tpu_torch.ops.cuda import walk as twalk

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
}


def _port(dem, fdr, ed, max_steps):
    return tdown.downslope(
        torch.from_numpy(dem), torch.from_numpy(fdr), PX, ed, max_steps=max_steps
    ).numpy()


def serial_walk_state(fdr_eff, z, zt0, ed, max_steps):
    """numpy form of csrc/walk.cu::downslope_walk_kernel: every lane is one
    start cell following its own D8 path (lanes advance together)."""
    rows, cols = z.shape
    fe, zt0 = fdr_eff.reshape(-1), zt0.reshape(-1)
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
    return pk.reshape(rows, cols), zt.reshape(rows, cols)


@pytest.mark.parametrize("case", sorted(CASES))
def test_downslope_bitwise_vs_jax_jacobi(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    got = _port(dem, fdr, ed, max_steps)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_downslope_bitwise_vs_pallas_vmem_kernel(case):
    dem, fdr, ed, max_steps = CASES[case]()
    want = np.asarray(
        downslope_pallas_vmem(dem, fdr, PX, ed, max_steps=max_steps, interpret=True)
    )
    np.testing.assert_array_equal(_port(dem, fdr, ed, max_steps), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_serial_walk_reference_bitwise(case):
    """The kernel's algorithm (numpy serial walk) gives the port's plain
    engine state bitwise, and through the shared post-pass the JAX output."""
    dem, fdr, ed, max_steps = CASES[case]()
    fdr_eff, z, zt0 = tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX)
    pk, zt = serial_walk_state(fdr_eff.numpy(), z.numpy(), zt0.numpy(), ed, max_steps)
    wpk, wzt = tdown.jacobi_walk(fdr_eff, z, zt0, ed, max_steps)
    np.testing.assert_array_equal(pk, wpk.numpy())
    np.testing.assert_array_equal(zt, wzt.numpy())
    got = tdown.downslope_from_state(z, torch.from_numpy(pk), torch.from_numpy(zt), PX)
    want = np.asarray(j_jacobi(dem, fdr, PX, ed, max_steps))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fractional_case_hits_the_cap_and_the_rounding():
    """The fixture reaches what it is meant to: capped walks, and terminal
    stops whose elevation the -2^20 offset rounds (to 1/16 below 2^19 m)."""
    dem, fdr, ed, max_steps = CASES["fractional_capped"]()
    fdr_eff, z, zt0 = tdown.walk_inputs(torch.from_numpy(dem), torch.from_numpy(fdr), PX)
    pk, zt = tdown.jacobi_walk(fdr_eff, z, zt0, ed, max_steps)
    steps = (pk & 0xFFFF) + (pk >> 16)
    assert bool((steps == max_steps).any())
    terminal_stop = (zt < -tdown._HALF) & (pk > 0)
    assert bool(terminal_stop.any())
    decoded = zt[terminal_stop] + tdown._OFF
    assert bool((decoded * 16 == torch.round(decoded * 16)).all())
    own = z[(fdr_eff == 0) & (z != -100)]
    assert bool((own * 16 != torch.round(own * 16)).any())


def test_downslope_wrapper_on_cpu_runs_the_plain_engine():
    dem, fdr, ed, max_steps = CASES["basin"]()
    before = twalk.downslope_walk.launches
    got = twalk.downslope_cuda(torch.from_numpy(dem), torch.from_numpy(fdr), PX, ed, max_steps)
    assert twalk.downslope_walk.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(dem, fdr, ed, max_steps))


@pytest.mark.parametrize("max_steps", [-1, 1 << 16])
def test_cap_beyond_the_packed_counts_raises(max_steps):
    """pk packs 16-bit cardinal/diagonal counts: a cap of 2^16 or more could
    carry one field into the other, so it is refused."""
    dem, fdr, ed, _ = CASES["basin"]()
    with pytest.raises(ValueError, match="max_steps"):
        _port(dem, fdr, ed, max_steps)
