"""64-bit inputs against the JAX package, on the CPU.

JAX runs with x64 off, so ``jnp.asarray`` demotes int64 to int32 and
float64 to float32 on entry.  The port demotes the same way
(``pipeline.as_jax_dtypes``), so on an int64 dem, a float64 dem with
fractional elevations, and an int64 fac, ``descriptor_suite`` under
``engine="torch"`` and ``"torch_blocked"`` gives every raster JAX's dtype
(``engine="xla"``) and:

- indices and HAND bitwise, and downslope bitwise but at the walks that
  stop at a terminal on the fractional dem, where JAX rounds the elevation
  to 1/16 m and the port is exact (``test_torch_downslope
  .assert_jax_or_exact``);
- slope within rtol 1e-6, fdist within rtol 1e-6, atol 1e-4, slope_rad,
  TWI, mod-TWI, GFI and ln(hl/H) within rtol 2e-5, atol 1e-4
  (``tests/test_torch_pipeline.py``'s tolerances).

``compat`` keeps numpy's dtypes (a documented departure) and JAX's values:
on the float64 dem, ``flow_hand_index`` and ``hand_calculator`` give HAND
as float64 holding JAX's float32 values exactly.  ``tiled_suite`` and
``sharded_suite`` on the same dems are bitwise the in-core suite, their
HAND values JAX's, ``tiled_suite``'s HAND in the loader's dtype as the JAX
package's ``tiled_suite`` allocates it.
"""

import numpy as np
import pytest
import torch

from descriptools_tpu import compat as jcompat
from descriptools_tpu import pipeline as jpipe
from descriptools_tpu_torch import compat as tcompat
from descriptools_tpu_torch import pipeline, tiled
from descriptools_tpu_torch.parallel import make_mesh, multihost, sharded_suite
from descriptools_tpu_torch.constants import DOWNSLOPE_MAX_STEPS
from descriptools_tpu_torch.utils.synthetic import synthetic_basin
from test_torch_downslope import assert_jax_or_exact

ROWS, COLS, SEED = 48, 40, 2
PX = 12.5
TRANSC = dict(rtol=2e-5, atol=1e-4)
BITWISE = ("indices", "hand", "downslope")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")
EXACT = ("indices", "hand", "downslope", "slope", "fdist")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU ops beside other test processes: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name):
    """(dem, fdr, fac, river) numpy with one 64-bit raster."""
    dem, fdr, river, fac = synthetic_basin(ROWS, COLS, seed=SEED)
    dem, fac = dem.astype(np.int32), fac.astype(np.int32)
    if name == "int64_dem":
        dem = dem.astype(np.int64)
    elif name == "float64_dem":
        frac = np.random.default_rng(SEED).uniform(0.0, 0.37, dem.shape)
        dem = np.where(dem == -100, -100.0, dem + frac)
    elif name == "int64_fac":
        fac = fac.astype(np.int64)
    return dem, fdr, fac, river


CASES = ("int64_dem", "float64_dem", "int64_fac")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's suite on each case's numpy rasters, as a user passes them."""
    cfg = jpipe.PipelineConfig(engine="xla")
    return {c: {k: np.asarray(v) for k, v in jpipe.descriptor_suite(*_case(c), cfg).items()} for c in CASES}


def _port(case, engine):
    tensors = [torch.as_tensor(a) for a in _case(case)]
    out = pipeline.descriptor_suite(*tensors, pipeline.PipelineConfig(engine=engine))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("engine", ["torch", "torch_blocked"])
@pytest.mark.parametrize("case", CASES)
def test_suite_on_64_bit_inputs_is_jaxs(jax_runs, case, engine):
    want = jax_runs[case]
    got = _port(case, engine)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, k
    for k in BITWISE:
        if k == "downslope":
            dem, fdr, _, _ = _case(case)
            assert_jax_or_exact(got[k], want[k], dem.astype(np.float32), fdr, 5.0, DOWNSLOPE_MAX_STEPS)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=1e-6, err_msg="slope")
    np.testing.assert_allclose(got["fdist"], want["fdist"], rtol=1e-6, atol=1e-4, err_msg="fdist")
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRANSC)


def test_as_jax_dtypes_demotes_64_bit_only():
    a64, f64, i16 = np.arange(3, dtype=np.int64), np.ones(2), np.zeros(2, np.int16)
    got = pipeline.as_jax_dtypes(torch.from_numpy(a64), torch.from_numpy(f64), torch.from_numpy(i16), a64, f64, i16)
    assert [g.dtype for g in got] == [torch.int32, torch.float32, torch.int16, np.int32, np.float32, np.int16]
    assert pipeline.as_jax_dtypes(np.array([0.1]))[0].item() == np.float32(0.1)


def test_compat_keeps_numpys_dtype_with_jaxs_values():
    dem, fdr, _, river = _case("float64_dem")
    got = tcompat.flow_hand_index(dem, fdr, river, PX, device="cpu")
    want = [np.asarray(a) for a in jcompat.flow_hand_index(dem, fdr, river, PX)]
    assert got[2].dtype == np.float64 and want[2].dtype == np.float32
    assert np.array_equal(got[2], want[2].astype(np.float64))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-4)
    again = tcompat.hand_calculator(dem, got[1], device="cpu")
    assert again.dtype == np.float64 and np.array_equal(again, got[2])


@pytest.fixture(scope="module")
def world():
    multihost.initialize(device="cpu")
    yield
    multihost.shutdown()


@pytest.mark.parametrize("case", ["int64_dem", "float64_dem"])
@pytest.mark.parametrize("path", ["tiled", "sharded"])
def test_out_of_core_paths_on_64_bit_dems_are_the_in_core_suite(jax_runs, world, case, path):
    dem, fdr, fac, river = _case(case)
    want = _port(case, "torch")
    cfg = pipeline.PipelineConfig()
    if path == "tiled":
        arrays = dict(dem=dem, fdr=fdr, fac=fac, river=river)
        loaders = {k: tiled._array_loader(a) for k, a in arrays.items()}
        out = tiled.tiled_suite(loaders, (ROWS, COLS), cfg, "cpu", tile_rows=32, tile_cols=32)
        assert out["hand"].dtype == dem.dtype  # JAX's tiled_suite allocates HAND in the loader's dtype
    else:
        out = {k: v.numpy() for k, v in sharded_suite(dem, fdr, fac, river, cfg, make_mesh((2, 2), device="cpu")).items()}
        assert out["hand"].dtype == want["hand"].dtype
    for k in EXACT:
        assert np.array_equal(np.asarray(out[k]).astype(want[k].dtype), want[k], equal_nan=True), k
    assert np.array_equal(np.asarray(out["hand"]), jax_runs[case]["hand"])
