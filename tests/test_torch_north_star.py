"""The North star's parity at 2178x1534 on the CPU: the port's suite and
``classify_flood``, and the JAX package's, held to the committed reference
``tests/data/north_star_reference.npz`` (``make_north_star_reference.py``)
by ``descriptools_tpu_torch.utils.parity.check``:

- inputs, indices, HAND, downslope and the class map by sha256;
- threshold, Correctness and Fit identical;
- slope within rtol 1e-6; fdist within rtol 1e-6, atol 1e-4; slope_rad,
  TWI, mod-TWI, GFI, ln(hl/H) within rtol 2e-5, atol 1e-4, at the sampled
  cells; the -100, NaN and inf counts exact; the sums within the bound the
  per-cell tolerance implies.

Holding the JAX package's current output to the file keeps the file from
going stale silently.  The 4096x4096 entry is checked on the card only
(``chip_smoke.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from descriptools_tpu import pipeline as jpipe
from descriptools_tpu.utils.synthetic import windowed_basin
from descriptools_tpu_torch import pipeline as tpipe
from descriptools_tpu_torch.utils import parity

REFERENCE = os.path.join(os.path.dirname(__file__), "data", "north_star_reference.npz")
ROWS, COLS = 2178, 1534


@pytest.fixture(scope="module")
def ref():
    return parity.load(REFERENCE)


@pytest.fixture(scope="module")
def basin():
    return {k: f(0, ROWS, 0, COLS) for k, f in windowed_basin(ROWS, COLS, seed=0).items()}


def _port(d):
    inputs = tpipe.inputs_to_torch(d["dem"], d["fdr"], d["fac"], d["river"], "cpu")
    out = {k: v.numpy() for k, v in tpipe.descriptor_suite(*inputs, tpipe.PipelineConfig()).items()}
    return out, tpipe.classify_flood(torch.from_numpy(out["hand"]), d["flood"])


def _jax(d):
    out = jpipe.descriptor_suite(
        jnp.asarray(d["dem"], jnp.int32), jnp.asarray(d["fdr"]),
        jnp.asarray(d["fac"], jnp.int32), jnp.asarray(d["river"]),
        jpipe.PipelineConfig(engine="xla"),
    )
    out = {k: np.asarray(v) for k, v in out.items()}
    return out, jpipe.classify_flood(out["hand"], d["flood"])


def test_reference_holds_both_sizes_in_the_checkers_terms(ref):
    assert parity.sizes(ref) == [(2178, 1534), (4096, 4096)]
    assert set(parity.hash_dtypes(ref)) == {*parity.INPUTS, *parity.HASHED}
    assert tuple(ref["meta.floats"].tolist()) == parity.FLOATS
    for rows, cols in parity.sizes(ref):
        tag = f"{rows}x{cols}"
        for where in ("all", "landed"):
            assert ref[f"{tag}.pos.{where}"].shape == (int(ref["meta.samples"]),)
        assert np.isfinite(ref[f"{tag}.classify"]).all()


@pytest.fixture(scope="module")
def port_run(basin):
    return _port(basin)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_suite_and_classifier_match_the_reference(ref, basin, port_run, side):
    out, classified = port_run if side == "port" else _jax(basin)
    report = parity.check(ref, ROWS, COLS, basin, out, classified)
    assert set(report) == set(parity.FLOATS)
    for k, r in report.items():
        assert r["sum_bound_used"] <= 1.0, k


def test_check_names_a_drifted_raster(ref, basin, port_run):
    out, classified = dict(port_run[0]), port_run[1]
    out["slope"] = out["slope"].copy()
    out["slope"].reshape(-1)[ref["2178x1534.pos.landed"][0]] += 1e-3
    hand = out["hand"].copy()
    hand[hand > 0] += 1
    out["hand"] = hand
    with pytest.raises(AssertionError, match="hand: sha256 differs.*slope: 1 of 2048 sampled cells"):
        parity.check(ref, ROWS, COLS, basin, out, classified)
