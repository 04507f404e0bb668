"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere they skip.
They import no JAX, so on a machine without it run them without the
repository's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from descriptools_tpu_torch import pipeline
from descriptools_tpu_torch.ops import downslope as down
from descriptools_tpu_torch.ops import flow
from descriptools_tpu_torch.ops.cuda import launch_counters, reset_launch_counters
from descriptools_tpu_torch.ops.cuda import stencil as st
from descriptools_tpu_torch.ops.cuda import walk
from descriptools_tpu_torch.utils.synthetic import windowed_basin

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def basin():
    loaders = windowed_basin(130, 257, seed=1)
    return {k: f(0, 130, 0, 257) for k, f in loaders.items()}


def test_stencil_kernel_matches_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fac = torch.as_tensor(basin["fac"], device=dev)
    got = st.stencil(dem_f, fac, 12.5, 0.1)
    want = st.stencil_plain(dem_f, fac, 12.5, 0.1)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4, equal_nan=True)


def test_walk_kernels_match_plain(dev, basin):
    dem_f = torch.as_tensor(basin["dem"].astype(np.float32), device=dev)
    fdr = torch.as_tensor(basin["fdr"], device=dev)
    ops = down.walk_inputs(dem_f, fdr, 12.5)
    for g, w in zip(walk.downslope_walk(*ops, 5.0, 5000), down.jacobi_walk(*ops, 5.0, 5000)):
        assert torch.equal(g, w)
    ops = flow.walk_inputs(fdr, torch.as_tensor(basin["river"], device=dev))
    for g, w in zip(walk.flow_walk(*ops, 20000), flow.doubling_walk(*ops, 20000)):
        assert torch.equal(g, w)


def test_suite_runs_every_kernel_and_matches_plain(dev, basin):
    inputs = pipeline.inputs_to_torch(basin["dem"], basin["fdr"], basin["fac"], basin["river"], dev)
    reset_launch_counters()
    out = pipeline.descriptor_suite(*inputs)
    assert all(n == 1 for n in launch_counters().values())
    plain = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig(engine="torch"))
    for k in ("slope", "downslope", "fdist", "indices", "hand"):
        assert torch.equal(out[k], plain[k]), k
    for k in ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h"):
        torch.testing.assert_close(out[k], plain[k], rtol=2e-5, atol=1e-4, equal_nan=True)
    got = pipeline.classify_flood(out["hand"], basin["flood"])
    want = pipeline.classify_flood(plain["hand"], basin["flood"])
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])


def test_kernel_wrappers_refuse_wrong_dtype(dev):
    z = torch.zeros((4, 5), device=dev)
    with pytest.raises(ValueError, match="int32"):
        walk.downslope_walk(z, z, z, 5.0, 10)
