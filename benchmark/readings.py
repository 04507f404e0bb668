"""The readings that the limits of ``limits/<workload>.json`` are set
from: the numbers compared, in runs of the program over many seeds and in
runs of the control (``control.py``) over a few, all in one process.

    python3 benchmark/readings.py --workload <cell> --seconds 2 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--out readings.json]

Each run is the benchmark's own (``harness.Run``: set-up, a short window
at the cell's load, the check).  Prints one JSON line a run, then the
lower reading (the largest over the program's runs) and the upper one (the
smallest over the control's) of every number.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from benchmark import control, harness

    runs = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            spec = harness.Spec(args.root, args.workload)
            job = control.control_job(spec) if side == "control" else None
            r = harness.Run(spec, seed, args.seconds, False, device=args.device, job=job).execute()
            line = dict(side=side, seed=seed, correct=r["correct"],
                        numbers={k: c["value"] for k, c in r["checked"].items()},
                        metrics={k: m["value"] for k, m in r["metrics"].items()})
            print(json.dumps(line), flush=True)
            runs.append(line)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        vals = [r["numbers"] for r in runs if r["side"] == side]
        if vals:
            summary[side] = {k: pick(v[k] for v in vals) for k in vals[0]}
    print(json.dumps(dict(summary=summary)), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(runs=runs, summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not this folder, whose modules are the package's
    sys.exit(main())
