"""The fold engines (the JAX blocked flow tier) against the JAX package.

Tolerances:
- ``fold_walk`` through ``flow_from_fold``: fdist and indices bitwise
  ``walk.py::flow_pallas`` (interpret mode), which folds the f32 step
  lengths from the river back up each path; the count engine
  (``engine="torch"``) gives another summation order and differs;
- indices bitwise the count engine's (K4's) on every fixture;
- a numpy model of ``csrc/flow_fold.cu``'s anchored fold (the jump
  walk's depths, the fold start, the counting sort by band, rounds whose
  writes show at their end) is bitwise ``fold_walk`` (code and dist) at
  band widths 1, 2, 7 and 64, and at band edges bitwise ``flow_pallas``;
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
from descriptools_tpu_torch import placement
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


def _band_edge(w, k, rows=6):
    """Eastward rows into a river column (the last): the rows' longest walks
    are w*k + 1, w*k and w*k - 1 steps (rows 1 and 2 of each three start
    behind one and two NaN absorbers, fdr 0)."""
    longest = w * k + 1
    fdr = np.ones((rows, longest + 1), np.uint8)
    fdr[1::3, :1] = 0
    fdr[2::3, :2] = 0
    river = np.zeros((rows, longest + 1), np.int8)
    river[:, -1] = 1
    return fdr, river


def _d8_tables(cols):
    """(flat move, diagonal?) of each D8 code, indexed by code."""
    move = np.zeros(256, np.int64)
    diag = np.zeros(256, bool)
    for code, dy, dx in zip((1, 2, 4, 8, 16, 32, 64, 128),
                            (0, 1, 1, 1, 0, -1, -1, -1), (1, 1, 0, -1, -1, -1, 0, 1)):
        move[code], diag[code] = dy * cols + dx, bool(dy and dx)
    return move, diag


def _fold_bits(bits, m, acc, c_card, c_diag):
    """For j = m - 1 down to 0: acc = (bit j of bits ? c_diag : c_card) +
    acc, in f32, lane by lane."""
    acc = acc.astype(np.float32)
    for j in range(int(m.max(initial=0)) - 1, -1, -1):
        on = j < m
        kind = ((bits[on] >> np.uint64(j)) & np.uint64(1)).astype(bool)
        acc[on] = np.where(kind, c_diag, c_card) + acc[on]
    return acc


def anchored_fold_state(fdr_eff, code0, c_card, c_diag, max_steps, w, sort=True):
    """numpy model of csrc/flow_fold.cu's anchored fold: (code, dist, P, K).

    The jump walk's (code, a, b) come from ``doubling_walk`` (bitwise the
    same).  Fold start, from (code, t = a + b) alone: an absorber (t = 0)
    keeps (code0, 0), a cell the walk left UNRES gets (UNRES, 0); any other
    cell walks m = ((t - 1) mod w) + 1 steps, recording their kinds in a uint64, to its anchor q.
    At t <= w dist is the fold onto 0; otherwise the cell joins the pending
    list (P cells) in band (t - 1) // w, K being the largest.  A counting
    sort orders the list by band: histogram, exclusive scan, scatter through
    cursors.  Round k folds band k's segment onto dist[q]; its writes show
    only when it ends (a kernel boundary), and every anchor it reads must
    have been written by an earlier round (the fold start is round 0).  A
    pending cell holds NaN until its round, so a missed write shows.
    ``sort=False`` folds the whole list in one round: a fault the anchor
    assertion must catch."""
    rows, cols = code0.shape
    code, a, b = (x.numpy().reshape(-1) for x in tflow.doubling_walk(
        torch.from_numpy(fdr_eff), torch.from_numpy(code0), max_steps))
    fe, c0 = fdr_eff.reshape(-1), code0.reshape(-1)
    move, diag = _d8_tables(cols)
    c_card, c_diag = np.float32(c_card), np.float32(c_diag)
    dist = np.full(rows * cols, np.nan, np.float32)
    written = np.full(rows * cols, -1)  # the round that wrote dist; -1: none
    t = a.astype(np.int64) + b

    # Fold start.
    final = (code == tflow.UNRES) | (t == 0)
    assert (final == ((c0 != tflow.UNRES) | (code == tflow.UNRES))).all()
    dist[final], written[final] = 0.0, 0
    cells = np.flatnonzero(~final)
    m = (t[cells] - 1) % w + 1
    q, bits = cells.copy(), np.zeros(cells.size, np.uint64)
    for j in range(int(m.max(initial=0))):
        on = j < m
        d = fe[q[on]]
        bits[on] |= diag[d].astype(np.uint64) << np.uint64(j)
        q[on] += move[d]
    shallow = t[cells] <= w
    assert (c0[q[shallow]] != tflow.UNRES).all()  # q is the absorber
    dist[cells[shallow]] = _fold_bits(bits[shallow], m[shallow], np.zeros(int(shallow.sum())),
                                      c_card, c_diag)
    written[cells[shallow]] = 0
    deep = ~shallow  # the pending list, in cell order
    cells, q, bits, m = cells[deep], q[deep], bits[deep], m[deep]
    band = (t[cells] - 1) // w
    pending, k_max = cells.size, int(band.max(initial=0))

    # Counting sort by band.
    if sort:
        hist = np.zeros(k_max, np.int64)
        np.add.at(hist, band - 1, 1)
        offsets = np.concatenate([[0], np.cumsum(hist)])
        cursor = offsets[:-1].copy()
        order = np.empty(pending, np.int64)
        for i, k in enumerate(band):
            order[cursor[k - 1]] = i
            cursor[k - 1] += 1
        segments = [order[offsets[k - 1]:offsets[k]] for k in range(1, k_max + 1)]
    else:
        segments = [np.arange(pending)] if pending else []

    # Rounds.
    for k, seg in enumerate(segments, 1):
        visible = dist.copy()
        assert ((written[q[seg]] >= 0) & (written[q[seg]] < k)).all(), \
            f"round {k} reads an anchor no earlier round wrote"
        dist[cells[seg]] = _fold_bits(bits[seg], m[seg], visible[q[seg]], c_card, c_diag)
        written[cells[seg]] = k
    return code.reshape(rows, cols), dist.reshape(rows, cols), pending, k_max


def _model_vs_fold_walk(fdr, river, max_steps, w):
    fdr_eff, code0, (code, dist) = _fold(fdr, river, max_steps)
    got_code, got_dist, pending, rounds = anchored_fold_state(
        fdr_eff.numpy(), code0.numpy(), *tflow.step_consts(PX), max_steps, w)
    np.testing.assert_array_equal(got_code, code.numpy())
    np.testing.assert_array_equal(got_dist, dist.numpy())
    _, a, b = tflow.doubling_walk(fdr_eff, code0, max_steps)
    depth = (a + b).numpy()
    assert pending == int((depth > w).sum())
    assert rounds == ((int(depth.max()) - 1) // w if pending else 0)
    return got_code, pending, rounds


@pytest.mark.parametrize("w", [1, 2, 7, 64])
@pytest.mark.parametrize("name,max_steps", [
    ("basin300", 20000), ("lateral_channel", 1000), ("lateral_channel", 13),
    ("lateral_channel", 7), ("two_cell_cycle", 300), ("nan_absorbers", 300),
])
def test_anchored_fold_model_is_bitwise_fold_walk(name, max_steps, w):
    _, pending, _ = _model_vs_fold_walk(*FIXTURES[name](), max_steps, w)
    if name == "lateral_channel" and max_steps == 1000:
        assert pending > 0  # the rounds ran


@pytest.mark.parametrize("w", [1, 2, 7, 64])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_anchored_fold_model_band_edges(w, delta):
    """Walks of w*k - 1, w*k and w*k + 1 steps at caps w*k - 1, w*k and
    w*k + 1: the longest row's first cell lands only at the last cap."""
    k = 2
    fdr, river = _band_edge(w, k)
    code, _, rounds = _model_vs_fold_walk(fdr, river, w * k + delta, w)
    assert (code[0, 0] != tflow.UNRES) == (delta == 1)
    assert rounds == (w * k + delta - 1) // w  # the longest landed walk is w*k + delta


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_band_edges_bitwise_vs_flow_pallas(delta):
    w, k = 7, 2
    fdr, river = _band_edge(w, k)
    max_steps = w * k + delta
    wfd, widx = flow_pallas(fdr, river, PX, max_steps=max_steps, h=8, interpret=True)
    fdr_eff, code0, _ = _fold(fdr, river, max_steps)
    code, dist, _, _ = anchored_fold_state(fdr_eff.numpy(), code0.numpy(), *tflow.step_consts(PX),
                                           max_steps, w)
    fd, idx = tflow.flow_from_fold(torch.from_numpy(code), torch.from_numpy(dist))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(fd.numpy(), np.asarray(wfd))


def test_anchored_fold_model_catches_a_round_reading_its_own_band():
    fdr, river = FIXTURES["lateral_channel"]()
    fdr_eff, code0, _ = _fold(fdr, river, 1000)
    with pytest.raises(AssertionError, match="no earlier round"):
        anchored_fold_state(fdr_eff.numpy(), code0.numpy(), *tflow.step_consts(PX), 1000, 7,
                            sort=False)


def test_fold_wrapper_refuses_max_steps_past_2pow30_on_cpu():
    i = torch.zeros((4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^30"):
        twalk.flow_walk_blocked(i, i, 1.0, 1.5, 1 << 30)


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
    assert placement.ENGINES == ("auto", "cuda", "torch", "cuda_blocked", "torch_blocked")
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
