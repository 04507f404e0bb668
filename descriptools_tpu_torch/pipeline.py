"""End-to-end descriptor pipeline (torch): the port's entry point.

Counterpart of ``descriptools_tpu/pipeline.py``: the descriptor suite in
dependency order, then calibration of a flood map on HAND.

    slope -> slope_rad -> TWI/mod-TWI       (stencil kernel)
    fdr -> downslope                        (downslope walk kernel)
    fdr + river -> fdist, indices           (flow walk kernel)
    indices -> HAND, river-fac (one gather) -> GFI, ln(hl/H)
    HAND -> float64 calibration -> class map (host, numpy)

``PipelineConfig.engine`` picks the walk and stencil engines: ``"cuda"``
runs the hand-written kernels (CUDA tensors only), ``"torch"`` their plain
torch versions on any device, ``"auto"`` = cuda iff the inputs are on a
CUDA device.  ``"cuda_blocked"`` and ``"torch_blocked"`` run the same
stencil and downslope, and the flow through the fold engines
(``ops.flow.fold_walk``), whose fdist is bitwise the JAX package's blocked
tier (``walk.py::flow_pallas``, which it runs above its VMEM budget); the
count engines give fdist in another summation order.
"""

import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from descriptools_tpu_torch import evaluation, oracle
from descriptools_tpu_torch.constants import DOWNSLOPE_MAX_STEPS, FLOW_MAX_STEPS
from descriptools_tpu_torch.ops.cuda.stencil import stencil, stencil_plain
from descriptools_tpu_torch.ops.downslope import downslope
from descriptools_tpu_torch.ops.flow import flow_distance_index, hand_and_river_fac
from descriptools_tpu_torch.ops.gfi import gfi as _gfi
from descriptools_tpu_torch.ops.gfi import ln_hl_h

ENGINES = ("auto", "cuda", "torch", "cuda_blocked", "torch_blocked")
_ON_CUDA = ("cuda", "cuda_blocked")


@dataclass(frozen=True)
class PipelineConfig:
    """Physics constants of the suite (reference call-site values,
    Example/example.py:45-91) and the engine choice."""

    px: float = 12.5
    elevation_difference: float = 5.0  # downslope potential-energy drop [m]
    n_topo: float = 0.1  # modified-TWI exponent
    n_gfi: float = 0.4  # GFI / ln(hl/H) exponent
    b_gfi: float = 0.1  # GFI / ln(hl/H) scale factor
    river_threshold: int = 128000  # fac cells above this are river
    downslope_max_steps: int = DOWNSLOPE_MAX_STEPS
    flow_max_steps: int = FLOW_MAX_STEPS
    engine: str = "auto"

    def resolve_engine(self, device):
        """"cuda" or "torch" for inputs on ``device``."""
        return resolve_engine(self.engine, device)


def resolve_engine(engine, device):
    """``engine`` (one of ENGINES) for inputs on ``device``, "auto" resolved
    to "cuda" or "torch"."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    is_cuda = torch.device(device).type == "cuda"
    if engine == "auto":
        return "cuda" if is_cuda else "torch"
    if engine in _ON_CUDA and not is_cuda:
        raise ValueError(f"engine={engine!r} needs CUDA tensors, got device {device}")
    return engine


_JAX_ENGINES = {"pallas": "cuda", "xla": "torch", "auto": "auto"}


def config_from_jax(cfg):
    """The port's config for a ``descriptools_tpu.pipeline.PipelineConfig``
    (or its ``dataclasses.asdict``): same physics, engine mapped
    pallas -> cuda, xla -> torch, auto -> auto."""
    fields = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    fields["engine"] = _JAX_ENGINES[fields.get("engine", "auto")]
    return PipelineConfig(**fields)


def inputs_to_torch(dem, fdr, fac, river, device):
    """numpy rasters -> tensors with ``run_example``'s dtypes: dem and fac
    int32, fdr and river as given."""
    return (
        torch.as_tensor(np.asarray(dem, np.int32), device=device),
        torch.as_tensor(np.asarray(fdr), device=device),
        torch.as_tensor(np.asarray(fac, np.int32), device=device),
        torch.as_tensor(np.asarray(river), device=device),
    )


def _engine_stencil(dem_f, fac, cfg, engine):
    """(slope, slope_rad, twi, mod_twi) through the engine's stencil."""
    run_stencil = stencil if engine in _ON_CUDA else stencil_plain
    return run_stencil(dem_f, fac, cfg.px, cfg.n_topo)


def _engine_downslope(dem_f, fdr, cfg, engine):
    """Downslope through the engine's walk.  The blocked engines use the
    serial walk or the Jacobi engine, both bitwise the JAX blocked
    downslope tier (``walk.py::downslope_pallas``)."""
    return downslope(
        dem_f, fdr, cfg.px, cfg.elevation_difference,
        max_steps=cfg.downslope_max_steps,
        engine="cuda" if engine in _ON_CUDA else "torch",
    )


def _engine_flow(fdr, river, cfg, engine):
    """(fdist, indices) through the engine's flow walk."""
    return flow_distance_index(fdr, river, cfg.px, max_steps=cfg.flow_max_steps, engine=engine)


def descriptor_suite(dem, fdr, fac, river, cfg: PipelineConfig = PipelineConfig()):
    """All descriptors of one grid, as a dict of tensors on the inputs' device.

    dem should be an integer dtype for bitwise HAND parity with the
    reference golden (the example feeds int16)."""
    engine = cfg.resolve_engine(dem.device)
    dem_f = dem.to(torch.float32).contiguous()
    sl, sl_rad, twi, mtwi = _engine_stencil(dem_f, fac, cfg, engine)
    down = _engine_downslope(dem_f, fdr, cfg, engine)
    fdist, indices = _engine_flow(fdr, river, cfg, engine)
    hand, river_fac = hand_and_river_fac(dem, fac, indices)
    geofi = _gfi(hand, river_fac, cfg.n_gfi, cfg.b_gfi, cfg.px)
    lnhlh = ln_hl_h(hand, fac, cfg.n_gfi, cfg.b_gfi, cfg.px)
    return dict(
        slope=sl,
        slope_rad=sl_rad,
        twi=twi,
        mod_twi=mtwi,
        downslope=down,
        fdist=fdist,
        indices=indices,
        hand=hand,
        gfi=geofi,
        ln_hl_h=lnhlh,
    )


def run_suite_checkpointed(dem, fdr, fac, river, cfg: PipelineConfig, ckpt_dir, stats=None):
    """Descriptor suite with durable stage-boundary checkpoints.

    Four stages (stencil, walks, flow, pointwise) each save their rasters
    to ``ckpt_dir`` as an atomic ``.npz``; a rerun after a kill resumes
    after the last COMPLETE stage, with the saved rasters back on the
    inputs' device in the dtypes they were saved with, and reproduces the
    uninterrupted outputs bitwise.  A manifest guards against resuming
    with a different grid or config.  Returns the stage rasters as a dict
    of tensors (the suite's keys plus ``river_fac``).

    ``descriptor_suite`` stays the fast path; this driver is for runs
    long enough that a restart from zero hurts.  ``stats`` (a dict, filled
    in place) gets one entry per stage: ``resumed`` (loaded, not
    computed), ``seconds`` (host clock, compute and save, or load) and
    ``saved_bytes`` / ``loaded_bytes`` (the rasters' bytes).
    """
    from descriptools_tpu_torch.utils import checkpoint as ckpt

    engine = cfg.resolve_engine(dem.device)
    device = dem.device
    manifest = dict(
        shape=[int(s) for s in dem.shape], dem_dtype=str(dem.dtype).removeprefix("torch."),
        **{k: (v if isinstance(v, (int, float, str)) else str(v))
           for k, v in dataclasses.asdict(cfg).items()},
    )
    ckpt.check_manifest(ckpt_dir, manifest)
    stats = {} if stats is None else stats
    state = {}

    def stage(name, fn):
        path = os.path.join(ckpt_dir, name)
        t0 = time.perf_counter()
        if ckpt.stage_exists(path):
            loaded = ckpt.load_stage(path)
            state.update({k: torch.from_numpy(v).to(device) for k, v in loaded.items()})
            nbytes = sum(v.nbytes for v in loaded.values())
            stats[name] = dict(resumed=True, seconds=time.perf_counter() - t0,
                               saved_bytes=0, loaded_bytes=nbytes)
            return
        out = fn()
        host = {k: v.cpu().numpy() for k, v in out.items()}
        ckpt.save_stage(path, host)
        state.update(out)
        stats[name] = dict(resumed=False, seconds=time.perf_counter() - t0,
                           saved_bytes=sum(v.nbytes for v in host.values()), loaded_bytes=0)

    dem_f = dem.to(torch.float32).contiguous()

    def _stencil():
        return dict(zip(("slope", "slope_rad", "twi", "mod_twi"),
                        _engine_stencil(dem_f, fac, cfg, engine)))

    def _walks():
        return dict(downslope=_engine_downslope(dem_f, fdr, cfg, engine))

    def _flow():
        fdist, indices = _engine_flow(fdr, river, cfg, engine)
        hand, river_fac = hand_and_river_fac(dem, fac, indices)
        return dict(fdist=fdist, indices=indices, hand=hand, river_fac=river_fac)

    def _pointwise():
        return dict(
            gfi=_gfi(state["hand"], state["river_fac"], cfg.n_gfi, cfg.b_gfi, cfg.px),
            ln_hl_h=ln_hl_h(state["hand"], fac, cfg.n_gfi, cfg.b_gfi, cfg.px),
        )

    stage("stencil", _stencil)
    stage("walks", _walks)
    stage("flow", _flow)
    stage("pointwise", _pointwise)
    return state


def classify_flood(hand, flood, under="under"):
    """Calibrate a threshold on HAND and classify, exactly like
    Example/example.py:106-147.  Returns (threshold, correctness, fit,
    class_map uint8).  Runs on the host in float64."""
    if isinstance(hand, torch.Tensor):
        hand = hand.cpu().numpy()
    hand = np.asarray(hand)
    elements = np.unique(hand)
    mx = elements[-1]
    mn = elements[1]  # elements[0] is the -100 NoData sentinel
    desc = oracle.min_max_scale_oracle(hand, mn, mx)
    th = evaluation.calibration(desc, flood, under, backend="numpy")
    binary = oracle.binary_map_oracle(desc, th, under)
    c, f, class_map = oracle.confusion_oracle(binary, flood)
    return th, c, f, class_map.astype(np.uint8)


def run_example(example_dir, cfg: PipelineConfig = PipelineConfig(), device="cpu"):
    """Full pipeline on a basin directory (the reference Example layout):
    descriptors on ``device``, then the classification.  Returns numpy
    descriptors plus threshold, correctness, fit and class_map."""
    from descriptools_tpu_torch.io import load_example_inputs

    data = load_example_inputs(example_dir)
    inputs = inputs_to_torch(data["dem"], data["fdr"], data["fac"], data["river"], device)
    out = {k: v.cpu().numpy() for k, v in descriptor_suite(*inputs, cfg).items()}
    th, c, f, class_map = classify_flood(out["hand"], data["flood"])
    out.update(threshold=th, correctness=c, fit=f, class_map=class_map)
    return out
