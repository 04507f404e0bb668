"""The whole slice: the port's descriptor_suite + classify_flood against the
JAX package's (``PipelineConfig(engine="xla")``) on windowed synthetic
basins, one of them not aligned to any tile size.

Tolerances per raster:
- indices, HAND, downslope: bitwise;
- slope within rtol 1e-6: the port divides by f32(px * step) exactly as the
  eager JAX op does (bitwise, tests/test_torch_stencil.py), but XLA's jit of
  the whole suite multiplies by the reciprocal instead, 1 ulp apart;
- fdist within rtol 1e-6, atol 1e-4 (the XLA engine sums f32 steps
  serially; the port rebuilds them from integer counts);
- slope_rad, TWI, mod-TWI, GFI, ln(hl/H) within rtol 2e-5, atol 1e-4;
- threshold, Fit, Correctness and the class map: identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from descriptools_tpu import pipeline as jpipe
from descriptools_tpu.utils.synthetic import windowed_basin
from descriptools_tpu_torch import pipeline as tpipe

TRANSC = dict(rtol=2e-5, atol=1e-4)
BITWISE = ("indices", "hand", "downslope")
CLOSE = ("slope_rad", "twi", "mod_twi", "gfi", "ln_hl_h")


def _inputs(rows, cols, seed):
    loaders = windowed_basin(rows, cols, seed=seed)
    return {k: f(0, rows, 0, cols) for k, f in loaders.items()}


def _jax_suite(d, cfg):
    out = jpipe.descriptor_suite(
        jnp.asarray(d["dem"], jnp.int32), jnp.asarray(d["fdr"]),
        jnp.asarray(d["fac"], jnp.int32), jnp.asarray(d["river"]), cfg,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _port_suite(d, cfg):
    inputs = tpipe.inputs_to_torch(d["dem"], d["fdr"], d["fac"], d["river"], "cpu")
    return {k: v.numpy() for k, v in tpipe.descriptor_suite(*inputs, cfg).items()}


def _assert_suites_agree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    for k in BITWISE:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["slope"], want["slope"], rtol=1e-6, err_msg="slope")
    np.testing.assert_allclose(got["fdist"], want["fdist"], rtol=1e-6, atol=1e-4, err_msg="fdist")
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TRANSC)


@pytest.mark.parametrize("rows,cols,seed", [(96, 128, 0), (130, 257, 1)])
def test_slice_matches_jax(rows, cols, seed):
    d = _inputs(rows, cols, seed)
    want = _jax_suite(d, jpipe.PipelineConfig(engine="xla"))
    got = _port_suite(d, tpipe.PipelineConfig())
    _assert_suites_agree(got, want)
    th_w, c_w, f_w, cm_w = jpipe.classify_flood(want["hand"], d["flood"])
    th_g, c_g, f_g, cm_g = tpipe.classify_flood(torch.from_numpy(got["hand"]), d["flood"])
    assert np.isfinite(f_w)
    assert (th_g, c_g, f_g) == (th_w, c_w, f_w)
    assert cm_g.dtype == cm_w.dtype == np.uint8
    np.testing.assert_array_equal(cm_g, cm_w)


def test_config_from_jax_non_default_physics():
    jcfg = jpipe.PipelineConfig(px=30.0, elevation_difference=3.0, n_topo=0.2, engine="xla")
    cfg = tpipe.config_from_jax(jcfg)
    assert cfg.engine == "torch"
    assert (cfg.px, cfg.elevation_difference, cfg.n_topo) == (30.0, 3.0, 0.2)
    fields = dataclasses.asdict(jcfg)
    fields.pop("engine")
    assert {k: getattr(cfg, k) for k in fields} == fields
    d = _inputs(72, 90, 3)
    _assert_suites_agree(_port_suite(d, cfg), _jax_suite(d, jcfg))


@pytest.mark.parametrize("jax_engine,engine", [("pallas", "cuda"), ("xla", "torch"), ("auto", "auto")])
def test_config_from_jax_engine_map(jax_engine, engine):
    cfg = jpipe.PipelineConfig(engine=jax_engine)
    assert tpipe.config_from_jax(cfg).engine == engine
    assert tpipe.config_from_jax(dataclasses.asdict(cfg)).engine == engine


def test_engine_resolution():
    cpu = torch.device("cpu")
    assert tpipe.PipelineConfig().resolve_engine(cpu) == "torch"
    assert tpipe.PipelineConfig(engine="torch").resolve_engine(cpu) == "torch"
    assert tpipe.PipelineConfig().resolve_engine(torch.device("cuda", 0)) == "cuda"
    assert tpipe.PipelineConfig(engine="torch").resolve_engine("cuda") == "torch"
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(engine="cuda").resolve_engine(cpu)
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(engine="pallas").resolve_engine(cpu)


def test_inputs_to_torch_dtypes():
    d = _inputs(20, 30, 0)
    dem, fdr, fac, river = tpipe.inputs_to_torch(d["dem"], d["fdr"], d["fac"], d["river"], "cpu")
    assert (dem.dtype, fdr.dtype, fac.dtype, river.dtype) == (
        torch.int32, torch.uint8, torch.int32, torch.int8
    )
