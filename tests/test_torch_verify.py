"""The port's copy of the streaming flow verifier (``verify.py``): zero
violations on the port's suite outputs, in whole and from the tiled
suite; on copies corrupted one cell per check, the check fires and the
report equals the JAX package's verifier's, count for count."""

import numpy as np
import pytest

from descriptools_tpu import verify as jverify
from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch import verify as tverify
from descriptools_tpu_torch.constants import NODATA
from descriptools_tpu_torch.utils.synthetic import synthetic_basin, windowed_basin

CFG = pipeline.PipelineConfig()


def _run(verify, loaders, out, shape):
    return verify.streaming_flow_invariants(
        loaders, out, shape, CFG.px, CFG.flow_max_steps, tile_rows=40, tile_cols=48
    )


@pytest.fixture(scope="module")
def suite():
    dem, fdr, river, fac = synthetic_basin(96, 112, seed=9)
    dem = dem.astype(np.int32)
    inputs = pipeline.inputs_to_torch(dem, fdr, fac, river, "cpu")
    out = {k: v.numpy() for k, v in pipeline.descriptor_suite(*inputs, CFG).items()}
    loaders = {
        k: (lambda ys, ye, xs, xe, a=v: a[ys:ye, xs:xe])
        for k, v in dict(dem=dem, fdr=fdr, river=river).items()
    }
    return loaders, out, dem.shape, dict(dem=dem, fdr=fdr, river=river)


def test_clean_outputs_verify_zero_violations(suite):
    loaders, out, shape, _ = suite
    rep = _run(tverify, loaders, out, shape)
    assert rep["ok"] and rep["invariant_violations"] == 0, rep
    assert rep["cells_checked"] == shape[0] * shape[1] and rep["landed_cells"] > 0
    assert rep == _run(jverify, loaders, out, shape)


def test_tiled_suite_outputs_verify_clean():
    rows, cols = 96, 112
    loaders = windowed_basin(rows, cols, seed=13)
    out = tiled.tiled_suite(loaders, (rows, cols), CFG, "cpu", tile_rows=48, tile_cols=32)
    rep = _run(tverify, loaders, out, (rows, cols))
    assert rep["ok"] and rep["cells_checked"] == rows * cols, rep


def _cells(inp, out, shape):
    """Named cells to corrupt: a river cell, a landed walker whose
    successor is a landed walker, that successor, and an fdr-0 cell."""
    rows, cols = shape
    own = np.arange(rows * cols).reshape(shape)
    idx, fdr, river = out["indices"], inp["fdr"], inp["river"]
    walker = (fdr != 0) & (river != 1)
    river_c = np.argwhere((fdr != 0) & (river == 1) & (inp["dem"] != NODATA))[0]
    from descriptools_tpu_torch.d8 import successor
    import torch

    succ = successor(torch.from_numpy(fdr), rows, cols)[0].numpy()
    lw = walker & (idx != NODATA)
    chained = lw & lw.reshape(-1)[succ]
    w = np.argwhere(chained & (idx != own))[len(np.argwhere(chained)) // 2]
    s = np.unravel_index(succ[tuple(w)], shape)
    zero = np.argwhere(fdr == 0)[0]
    return tuple(river_c), tuple(w), s, tuple(zero), own


MUTATIONS = {
    "fdr0_not_nodata": lambda o, c: o["indices"].__setitem__(c["zero"], 0),
    "river_self_index": lambda o, c: o["indices"].__setitem__(c["river"], o["indices"][c["river"]] + 1),
    "river_fdist_zero": lambda o, c: o["fdist"].__setitem__(c["river"], 5.0),
    "river_hand_zero": lambda o, c: o["hand"].__setitem__(c["river"], 3),
    "landed_succ_unlanded": lambda o, c: o["indices"].__setitem__(c["succ"], NODATA),
    "index_fixed_point": lambda o, c: o["indices"].__setitem__(c["walker"], o["indices"][c["walker"]] + 1),
    "fdist_fixed_point": lambda o, c: o["fdist"].__setitem__(c["walker"], o["fdist"][c["walker"]] + 7.0),
    "hand_identity": lambda o, c: o["hand"].__setitem__(c["walker"], o["hand"][c["walker"]] + 3),
    "hand_nodata_rule": lambda o, c: o["hand"].__setitem__(c["walker"], NODATA),
    "index_targets_non_river": lambda o, c: o["indices"].__setitem__(c["river"], c["own"][c["walker"]]),
    "unlanded_but_succ_short": lambda o, c: o["indices"].__setitem__(c["walker"], NODATA),
}


@pytest.mark.parametrize("check", sorted(MUTATIONS))
def test_single_cell_corruption_caught_like_jax(suite, check):
    loaders, out, shape, inp = suite
    river_c, w, s, zero, own = _cells(inp, out, shape)
    bad = {k: v.copy() for k, v in out.items()}
    MUTATIONS[check](bad, dict(river=river_c, walker=w, succ=s, zero=zero, own=own))
    rep = _run(tverify, loaders, bad, shape)
    assert not rep["ok"] and rep["per_check"][check] >= 1, rep["per_check"]
    assert rep == _run(jverify, loaders, bad, shape)
