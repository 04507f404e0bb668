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
CUDA device.
"""

import dataclasses
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

ENGINES = ("auto", "cuda", "torch")


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
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        is_cuda = torch.device(device).type == "cuda"
        if self.engine == "auto":
            return "cuda" if is_cuda else "torch"
        if self.engine == "cuda" and not is_cuda:
            raise ValueError(f"engine='cuda' needs CUDA tensors, got device {device}")
        return self.engine


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


def descriptor_suite(dem, fdr, fac, river, cfg: PipelineConfig = PipelineConfig()):
    """All descriptors of one grid, as a dict of tensors on the inputs' device.

    dem should be an integer dtype for bitwise HAND parity with the
    reference golden (the example feeds int16)."""
    engine = cfg.resolve_engine(dem.device)
    dem_f = dem.to(torch.float32).contiguous()
    run_stencil = stencil if engine == "cuda" else stencil_plain
    sl, sl_rad, twi, mtwi = run_stencil(dem_f, fac, cfg.px, cfg.n_topo)
    down = downslope(
        dem_f, fdr, cfg.px, cfg.elevation_difference,
        max_steps=cfg.downslope_max_steps, engine=engine,
    )
    fdist, indices = flow_distance_index(
        fdr, river, cfg.px, max_steps=cfg.flow_max_steps, engine=engine
    )
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
