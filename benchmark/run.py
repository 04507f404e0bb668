"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer metrics are found by name from ``BENCHMARK.json``.
The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number compared with its limit);
the numbers compared are also the last lines of standard error.  Exits
with 2, printing no result, without a CUDA card or with fewer cards than
the cell asks for, and with 3 if a module of JAX or of the JAX package
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import harness

    t_import = time.perf_counter()
    spec = harness.Spec(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 2
    chips = spec.workload["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = harness.Run(spec, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    run.setup.update(torch_import_s=t_import - T0, cuda_query_s=time.perf_counter() - t_import)
    result = run.execute()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules the benchmark may not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not this folder, whose modules are the package's
    sys.exit(main())
