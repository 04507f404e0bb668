"""CLI driver: full descriptor pipeline on a basin directory.

Counterpart of ``python -m descriptools_tpu``: read rasters, compute every
descriptor, calibrate a flood threshold on HAND, write the classified map,
as ``python -m descriptools_tpu_torch <basin_dir> [-o out.tif]``.  It takes
the same arguments, plus ``--device`` (default ``cuda``; without a CUDA
device it raises) and ``--engine`` (one of ``pipeline.ENGINES``), and prints
the same one-line JSON.

The basin directory must follow the reference layout:
  input/12_dem.tif  input/12_fdr.tif  input/12_fac.tif  input/WB_12_100y.tif
"""

import argparse
import json
import sys
import time


def main(argv=None):
    from descriptools_tpu_torch.pipeline import ENGINES

    ap = argparse.ArgumentParser(prog="descriptools_tpu_torch")
    ap.add_argument("basin", help="basin directory (reference Example layout)")
    ap.add_argument("-o", "--output", default=None, help="classified map TIFF path")
    ap.add_argument("--px", type=float, default=12.5)
    ap.add_argument("--elevation-difference", type=float, default=5.0)
    ap.add_argument("--n-topo", type=float, default=0.1)
    ap.add_argument("--n-gfi", type=float, default=0.4)
    ap.add_argument("--b-gfi", type=float, default=0.1)
    ap.add_argument("--device", default="cuda", help="torch device of the descriptors")
    ap.add_argument("--engine", default="auto", choices=ENGINES)
    args = ap.parse_args(argv)

    import torch

    from descriptools_tpu_torch.io import write_raster
    from descriptools_tpu_torch.pipeline import PipelineConfig, run_example

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available")
    cfg = PipelineConfig(
        px=args.px,
        elevation_difference=args.elevation_difference,
        n_topo=args.n_topo,
        n_gfi=args.n_gfi,
        b_gfi=args.b_gfi,
        engine=args.engine,
    )
    t0 = time.time()
    out = run_example(args.basin, cfg, device)
    wall = time.time() - t0
    print(
        json.dumps(
            {
                "threshold": out["threshold"],
                "correctness": round(float(out["correctness"]), 4),
                "fit": round(float(out["fit"]), 4),
                "cells": int(out["hand"].size),
                "wall_s": round(wall, 1),
            }
        )
    )
    if args.output:
        write_raster(args.output, out["class_map"])
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
