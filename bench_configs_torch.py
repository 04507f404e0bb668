#!/usr/bin/env python3
"""Benchmark BASELINE configs 2-4 on one NVIDIA card with the PyTorch port
(``descriptools_tpu_torch``) and write them to a JSON file.  The
counterpart of ``scripts/bench_configs.py``; it imports torch, numpy and
the port only.

  config 2 - synthetic 4096^2: the full suite, and the stencil alone (one
             launch of K2: slope, slope_rad, TWI, mod-TWI from dem float32
             and fac = |dem| int32) beside its byte bound, 24 B a cell at
             3.35 TB/s.
  config 3 - synthetic 10000^2 (1e8 cells): the full suite, and
             ``derive_terrain`` (D8 + flow accumulation) from the DEM.
  config 4 - ``calibration(backend="torch")`` on the card, on the HAND of
             ``windowed_basin(2178, 1534, seed=0)`` and its flood map (the
             bundled basin of the JAX script is not shipped).

    python3 bench_configs_torch.py [--out build/bench_configs_torch.json]

Times are ``utils.timing.timeit`` on the card (CUDA events), the median of
the JAX script's iteration counts after one warm-up, in seconds, not
rounded (the card's times are far below the JAX script's fixed decimals).
The file keeps entries other writers own and gains the JAX script's keys,
``rev`` and ``device`` (the card's name and power limit); the merged JSON
is the last line printed.  Each config is a function with the JAX
script's sizes as defaults.  Without a card the script raises and writes
nothing.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from config5_torch import card_line  # noqa: E402
from descriptools_tpu_torch import evaluation, oracle, pipeline  # noqa: E402
from descriptools_tpu_torch.ops.cuda.stencil import stencil  # noqa: E402
from descriptools_tpu_torch.ops.terrain import derive_terrain  # noqa: E402
from descriptools_tpu_torch.utils import provenance  # noqa: E402
from descriptools_tpu_torch.utils.synthetic import synthetic_basin, synthetic_dem, windowed_basin  # noqa: E402
from descriptools_tpu_torch.utils.timing import timeit  # noqa: E402

OUT = os.path.join(ROOT, "build", "bench_configs_torch.json")
# The stencil's bytes a cell (PERF.md section 6): dem float32 and fac int32
# read, four float32 rasters written; over the H100's 3.35 TB/s.
STENCIL_BYTES_PER_CELL = 24
HBM_BYTES_PER_S = 3.35e12


def suite_time(size, iters, device):
    """The suite on ``synthetic_basin(size, size, seed=0)``; its host
    generation time apart."""
    t0 = time.perf_counter()
    dem, fdr, river, fac = synthetic_basin(size, size, seed=0)
    gen_s = time.perf_counter() - t0
    args = pipeline.inputs_to_torch(dem, fdr, fac, river, device)
    cfg = pipeline.PipelineConfig()
    t = timeit(lambda: pipeline.descriptor_suite(*args, cfg), warmup=1, iters=iters, device=device)
    return dict(cells=size * size, seconds=t, grid_points_per_s=size * size / t, host_gen_s=gen_s)


def config2_full_suite_4096(size=4096, iters=3, device="cuda"):
    return suite_time(size, iters, device)


def config2_stencil_slope_twi_4096(size=4096, iters=5, device="cuda"):
    """The stencil alone: one launch of K2 on a CUDA device (its plain
    version on the CPU)."""
    cfg = pipeline.PipelineConfig()
    dem = synthetic_dem(size, size, seed=0)  # synthetic_basin's dem
    dem_t = torch.as_tensor(dem.astype(np.float32), device=device)
    fac_t = torch.as_tensor(np.abs(dem).astype(np.int32), device=device)
    t = timeit(lambda: stencil(dem_t, fac_t, cfg.px, cfg.n_topo), warmup=1, iters=iters, device=device)
    cells = size * size
    return dict(cells=cells, seconds=t, grid_points_per_s=cells / t,
                bound_s=cells * STENCIL_BYTES_PER_CELL / HBM_BYTES_PER_S, bound_by="bytes")


def config3_full_suite_10000(size=10000, iters=2, device="cuda"):
    return suite_time(size, iters, device)


def config3_derive_terrain_10000(size=10000, iters=2, device="cuda"):
    """BASELINE config 3's derivation leg: fdr and fac from the DEM alone."""
    dem = synthetic_dem(size, size, seed=0)  # synthetic_basin's dem
    dem_t = torch.as_tensor(dem.astype(np.int32), device=device)
    t = timeit(lambda: derive_terrain(dem_t)[1], warmup=1, iters=iters, device=device)
    return dict(cells=size * size, seconds=t, grid_points_per_s=size * size / t,
                note="d8_flow_direction + flow_accumulation(auto max_path) from DEM")


def config4_calibration_basin(rows=2178, cols=1534, iters=3, device="cuda"):
    """The full coarse-to-fine search on the card, on the suite's HAND
    scaled as the reference scales it."""
    data = {k: f(0, rows, 0, cols) for k, f in windowed_basin(rows, cols, seed=0).items()}
    inputs = pipeline.inputs_to_torch(data["dem"], data["fdr"], data["fac"], data["river"], device)
    hand = pipeline.descriptor_suite(*inputs, pipeline.PipelineConfig())["hand"].cpu().numpy()
    elements = np.unique(hand)
    desc = oracle.min_max_scale_oracle(hand, elements[1], elements[-1])
    desc_t = torch.as_tensor(desc, dtype=torch.float32, device=device)
    flood_t = torch.as_tensor(data["flood"], device=device)

    def calib():
        return evaluation.calibration(desc_t, flood_t, "under", backend="torch")

    th = calib()  # warm + value check
    t = timeit(calib, warmup=1, iters=iters, device=device)
    return dict(cells=int(hand.size), seconds=t, threshold=float(th), grid_points_per_s=hand.size / t,
                note=f"full coarse-to-fine search, ~100 thresholds over {hand.size / 1e6:.1f}M cells")


CONFIGS = (config2_full_suite_4096, config2_stencil_slope_twi_4096, config3_full_suite_10000,
           config3_derive_terrain_10000, config4_calibration_basin)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="the JSON file to merge the results into")
    args = ap.parse_args(argv)
    device = pipeline.check_device("cuda")  # raises without a card, before any work
    card = card_line()
    results = {"backend": device.type, "engine": pipeline.PipelineConfig().resolve_engine(device)}
    for config in CONFIGS:
        r = results[config.__name__] = config(device=device)
        print(f"{config.__name__}: {r['seconds'] * 1e3:.4f} ms, {r['grid_points_per_s']:.6g} grid-points/s"
              + (f", bound {r['bound_s'] * 1e3:.4f} ms ({r['bound_by']})" if "bound_s" in r else "")
              + f"  [{card}]", flush=True)
    results["rev"] = provenance.git_rev(ROOT)
    results["device"] = card
    # Merge: keep entries other writers own.
    try:
        with open(args.out) as fh:
            merged = json.load(fh)
    except FileNotFoundError:
        merged = {}
    merged.update(results)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(merged, fh, indent=1)
    print(json.dumps(merged))


if __name__ == "__main__":
    main()
