"""The fold engines (the JAX blocked flow tier) against the JAX package.

Tolerances:
- ``fold_walk`` through ``flow_from_fold``: fdist and indices bitwise
  ``walk.py::flow_pallas`` (interpret mode), which folds the f32 step
  lengths from the river back up each path; the count engine
  (``engine="torch"``) gives another summation order and differs;
- indices bitwise the count engine's (K4's) on every fixture;
- a numpy form of ``csrc/flow_fold.cu``'s blocks, launches and skips is
  bitwise ``fold_walk`` (code and dist);
- the whole suite with ``engine="torch_blocked"`` against JAX's
  ``descriptor_suite(engine="pallas")`` on its blocked tier
  (``walk_vmem.fits_vmem`` patched to False, Pallas in interpret mode):
  indices, HAND, downslope and fdist bitwise; slope within rtol 1e-6 (the
  jitted suite multiplies by a reciprocal); the transcendental rasters
  within the tolerances of ``tests/test_basin_parity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from descriptools_tpu import pipeline as jpipe
from descriptools_tpu.ops.pallas import walk_vmem
from descriptools_tpu.ops.pallas.walk import flow_pallas
from descriptools_tpu.utils.synthetic import synthetic_basin
from descriptools_tpu_torch import pipeline as tpipe
from descriptools_tpu_torch import tiled
from descriptools_tpu_torch.ops import flow as tflow
from descriptools_tpu_torch.ops.cuda import walk as twalk
from descriptools_tpu_torch.utils.synthetic import windowed_basin

PX = 12.5
BASIN_TOLS = dict(rtol=1e-5, atol=1e-4)  # tests/test_basin_parity.py TOLS


def _basin300():
    _, fdr, river, _ = synthetic_basin(300, 200, seed=0)
    return fdr, river


def _lateral_channel(rows=100, cols=101):
    """East along each row, north up the last column: walks of up to 199
    steps."""
    fdr = np.full((rows, cols), 1, np.uint8)
    fdr[:, -1] = 64
    river = np.zeros((rows, cols), np.int8)
    river[0, -1] = 1
    return fdr, river


def _two_cell_cycle(rows=40, cols=60):
    """Eastward rows into a river column, cut by an E<->W and an S<->N pair:
    the cells upstream of either pair never land."""
    fdr = np.full((rows, cols), 1, np.uint8)
    river = np.zeros((rows, cols), np.int8)
    river[:, -1] = 1
    fdr[10, 20], fdr[10, 21] = 1, 16
    fdr[30, 45], fdr[31, 45] = 4, 64
    return fdr, river


def _nan_absorbers(rows=48, cols=70, seed=5):
    """Random D8 field: fdr-0 cells, border exits, a river cell with fdr 0
    (a NaN absorber, not a river) and a few river cells."""
    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8)
    fdr = codes[rng.integers(0, 8, size=(rows, cols))]
    fdr[rng.random((rows, cols)) < 0.04] = 0
    river = (rng.random((rows, cols)) < 0.04).astype(np.int8)
    fdr[7, 7], river[7, 7] = 0, 1
    return fdr, river


FIXTURES = {
    "basin300": _basin300,
    "lateral_channel": _lateral_channel,
    "two_cell_cycle": _two_cell_cycle,
    "nan_absorbers": _nan_absorbers,
}
CASES = [
    ("basin300", 20000), ("basin300", 7), ("basin300", 13),
    ("lateral_channel", 1000), ("lateral_channel", 7), ("lateral_channel", 13),
    ("two_cell_cycle", 300), ("nan_absorbers", 300), ("nan_absorbers", 7),
]


def _fold(fdr, river, max_steps):
    fdr_eff, code0 = tflow.walk_inputs(torch.from_numpy(fdr), torch.from_numpy(river))
    return fdr_eff, code0, tflow.fold_walk(fdr_eff, code0, *tflow.step_consts(PX), max_steps)


@pytest.mark.parametrize("name,max_steps", CASES)
def test_fold_walk_bitwise_vs_flow_pallas(name, max_steps):
    fdr, river = FIXTURES[name]()
    wfd, widx = flow_pallas(fdr, river, PX, max_steps=max_steps, h=8, interpret=True)
    _, _, (code, dist) = _fold(fdr, river, max_steps)
    fd, idx = tflow.flow_from_fold(code, dist)
    assert fd.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(fd.numpy(), np.asarray(wfd))
    # The same indices as the count engine (K4's); the engine switch goes
    # through flow_distance_index.
    cfd, cidx = tflow.flow_distance_index(torch.from_numpy(fdr), torch.from_numpy(river), PX,
                                          max_steps=max_steps)
    np.testing.assert_array_equal(cidx.numpy(), idx.numpy())
    bfd, bidx = tflow.flow_distance_index(torch.from_numpy(fdr), torch.from_numpy(river), PX,
                                          max_steps=max_steps, engine="torch_blocked")
    assert torch.equal(bfd, fd) and torch.equal(bidx, idx)
    if name == "basin300" and max_steps == 20000:
        # The gap this engine closes: counts sum in another order.
        assert int((cfd != fd).sum()) > 0
    if name == "two_cell_cycle":
        assert int((idx == -100).sum()) > 20  # the cells upstream of the pairs


def blocked_fold_state(fdr_eff, code0, c_card, c_diag, max_steps, tile, halo):
    """numpy form of csrc/flow_fold.cu: tile x tile blocks with a halo-cell
    window, ping-pong state buffers, up to ``halo`` synchronous sweeps per
    launch with the early stop, and the 3x3 neighbourhood activity skip.
    The second buffer starts as garbage, so a block that should have
    written and did not shows.  Returns (code, dist, launches)."""
    rows, cols = code0.shape
    nby, nbx = -(-rows // tile), -(-cols // tile)
    win = tile + 2 * halo
    step = {1: (0, 1), 2: (1, 1), 4: (1, 0), 8: (1, -1),
            16: (0, -1), 32: (-1, -1), 64: (-1, 0), 128: (-1, 1)}
    codes = [code0.copy(), np.full_like(code0, 12345)]
    dists = [np.zeros(code0.shape, np.float32), np.full(code0.shape, np.nan, np.float32)]
    changed = [np.zeros((nby, nbx), bool), np.zeros((nby, nbx), bool)]
    count, t0 = 0, 0
    while t0 < max_steps:
        src, dst = count % 2, 1 - count % 2
        n_changed = 0
        for by in range(nby):
            for bx in range(nbx):
                near = changed[src][max(by - 1, 0):by + 2, max(bx - 1, 0):bx + 2]
                if count > 0 and not near.any():
                    changed[dst][by, bx] = False
                    continue
                r0, c0 = by * tile - halo, bx * tile - halo
                code = np.full((win, win), -1, np.int32)
                dist = np.zeros((win, win), np.float32)
                nxt = np.full((win, win), -1, np.int64)
                stepd = np.zeros((win, win), np.float32)
                for wr in range(win):
                    for wc in range(win):
                        r, c = r0 + wr, c0 + wc
                        if not (0 <= r < rows and 0 <= c < cols):
                            continue
                        code[wr, wc], dist[wr, wc] = codes[src][r, c], dists[src][r, c]
                        d = int(fdr_eff[r, c])
                        if d in step:
                            nr, nc = wr + step[d][0], wc + step[d][1]
                            if 0 <= nr < win and 0 <= nc < win:
                                nxt[wr, wc] = nr * win + nc
                                stepd[wr, wc] = c_diag if step[d][0] and step[d][1] else c_card
                interior = np.zeros((win, win), bool)
                interior[halo:halo + tile, halo:halo + tile] = True
                hit_interior = False
                code, dist, nxt, stepd, interior = (a.reshape(-1) for a in (code, dist, nxt, stepd, interior))
                for k in range(halo):
                    if t0 + k >= max_steps:
                        break
                    hits = (code == tflow.UNRES) & (nxt >= 0)
                    hits[hits] = code[nxt[hits]] != tflow.UNRES
                    dist[hits] = stepd[hits] + dist[nxt[hits]]
                    code[hits] = code[nxt[hits]]
                    hit_interior |= bool((hits & interior).any())
                    if not hits.any():
                        break
                code, dist = code.reshape(win, win), dist.reshape(win, win)
                ye, xe = min((by + 1) * tile, rows), min((bx + 1) * tile, cols)
                inner = np.s_[halo:halo + ye - by * tile, halo:halo + xe - bx * tile]
                codes[dst][by * tile:ye, bx * tile:xe] = code[inner]
                dists[dst][by * tile:ye, bx * tile:xe] = dist[inner]
                changed[dst][by, bx] = hit_interior
                n_changed += hit_interior
        count += 1
        t0 += halo
        if n_changed == 0:
            break
    return codes[count % 2], dists[count % 2], count


@pytest.mark.parametrize("name,max_steps,tile,halo", [
    ("basin300", 20000, 16, 5), ("basin300", 13, 8, 3), ("lateral_channel", 1000, 8, 3),
    ("lateral_channel", 13, 16, 7), ("two_cell_cycle", 300, 8, 3), ("nan_absorbers", 7, 8, 2),
    ("lateral_channel", 1000, 64, 16),
])
def test_kernel_blocking_is_bitwise_fold_walk(name, max_steps, tile, halo):
    fdr, river = FIXTURES[name]()
    fdr_eff, code0, (code, dist) = _fold(fdr, river, max_steps)
    c_card, c_diag = tflow.step_consts(PX)
    got_code, got_dist, launches = blocked_fold_state(
        fdr_eff.numpy(), code0.numpy(), np.float32(c_card), np.float32(c_diag), max_steps, tile, halo
    )
    np.testing.assert_array_equal(got_code, code.numpy())
    np.testing.assert_array_equal(got_dist, dist.numpy())
    assert launches <= -(-max_steps // halo)


def test_fold_wrapper_on_cpu_runs_the_plain_engine():
    fdr, river = _basin300()
    before = twalk.flow_walk_blocked.launches
    fd, idx = twalk.flow_blocked_cuda(torch.from_numpy(fdr), torch.from_numpy(river), PX, 20000)
    assert twalk.flow_walk_blocked.launches == before
    _, _, (code, dist) = _fold(fdr, river, 20000)
    wfd, widx = tflow.flow_from_fold(code, dist)
    assert torch.equal(fd, wfd) and torch.equal(idx, widx)


def test_suite_torch_blocked_matches_jax_blocked_tier(monkeypatch):
    dem, fdr, river, fac = synthetic_basin(70, 110, seed=13)
    dem, fac = dem.astype(np.int32), fac.astype(np.int32)
    monkeypatch.setattr(walk_vmem, "fits_vmem", lambda *a, **k: False)
    # A fresh jit, so the blocked tier is traced under the patch.
    suite = jax.jit(jpipe.descriptor_suite.__wrapped__, static_argnames=("cfg",))
    with pltpu.force_tpu_interpret_mode():
        want = suite(jnp.asarray(dem), jnp.asarray(fdr), jnp.asarray(fac), jnp.asarray(river),
                     jpipe.PipelineConfig(engine="pallas"))
    want = {k: np.asarray(v) for k, v in want.items()}
    inputs = tpipe.inputs_to_torch(dem, fdr, fac, river, "cpu")
    got = {k: v.numpy() for k, v in
           tpipe.descriptor_suite(*inputs, tpipe.PipelineConfig(engine="torch_blocked")).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    for k in ("indices", "hand", "downslope", "fdist"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=1e-6, err_msg="slope")
    for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BASIN_TOLS)
    # The count engine's suite differs from the blocked tier only in fdist.
    plain = tpipe.descriptor_suite(*inputs, tpipe.PipelineConfig(engine="torch"))
    for k in ("indices", "hand", "downslope", "slope"):
        np.testing.assert_array_equal(plain[k].numpy(), got[k], err_msg=k)


def test_engine_names():
    assert tpipe.ENGINES == ("auto", "cuda", "torch", "cuda_blocked", "torch_blocked")
    cpu = torch.device("cpu")
    assert tpipe.resolve_engine("torch_blocked", cpu) == "torch_blocked"
    assert tpipe.resolve_engine("cuda_blocked", torch.device("cuda", 0)) == "cuda_blocked"
    with pytest.raises(ValueError, match="cuda_blocked"):
        tpipe.resolve_engine("cuda_blocked", cpu)


def test_cuda_blocked_on_cpu_tensors_raises():
    d = {k: f(0, 20, 0, 30) for k, f in windowed_basin(20, 30, seed=0).items()}
    inputs = tpipe.inputs_to_torch(d["dem"], d["fdr"], d["fac"], d["river"], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tpipe.descriptor_suite(*inputs, tpipe.PipelineConfig(engine="cuda_blocked"))


@pytest.mark.parametrize("engine", ["torch_blocked", "cuda_blocked"])
def test_tiled_path_refuses_blocked_engines(engine):
    loaders = windowed_basin(40, 50, seed=0)
    with pytest.raises(ValueError, match=engine):
        tiled.tiled_suite(loaders, (40, 50), tpipe.PipelineConfig(engine=engine), "cpu",
                          tile_rows=32, tile_cols=32)
    d = {k: f(0, 40, 0, 50) for k, f in loaders.items()}
    with pytest.raises(ValueError, match=engine):
        tiled.tiled_flow_hand(d["dem"], d["fdr"], d["river"], d["fac"], PX, "cpu",
                              tile_rows=32, tile_cols=32, engine=engine)
