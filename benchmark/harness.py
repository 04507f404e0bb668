"""One run of one cell: set-up, the window (or the traced stretches), the
check, and the result line's contents.

Everything that belongs to one configuration, mix, cell or per-layer
metric is a file found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<mix>.json``, ``limits/<workload>.json``, the job kind and the
generator the mix names (``jobs/<kind>.py``, ``generators/<name>.py``),
and ``metrics/<metric>.py``; ``kernels/`` holds one file a kernel of the
port's own.
"""

import json
import random
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from benchmark import check, found, inputs, jobs, peaks, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "descriptools_tpu")


class Spec:
    """A cell's entries and files, read from the checkout at ``root``."""

    def __init__(self, root, workload):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == workload]
        if not found:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = next(c for c in bench["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((self.root / entry["file"]).read_text())
        here = self.root / "benchmark"
        self.traffic = json.loads((here / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{workload}.json").read_text())["limits"]
        self.per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
        self.end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        self.kind = self.module("jobs", self.traffic["job"])
        self.pipeline = {**self.config["pipeline"], **self.traffic.get("pipeline", {})}
        self.rows, self.cols = self.config["rows"], self.config["cols"]

    @property
    def cells(self):
        return self.rows * self.cols

    def module(self, folder, name):
        """``benchmark/<folder>/<name>.py`` of this checkout."""
        return found.module(folder, name, self.root)

    def reader(self, name):
        """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``.
        A name with a suffix for its cells (``stencil_roofline.basin``) and
        no file of its own reads with the file of the name without it."""
        if not (self.root / "benchmark" / "metrics" / f"{name}.py").is_file():
            name = name.rsplit(".", 1)[0]
        return self.module("metrics", name).read


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def to_host(out):
    """A job's outputs with every tensor copied to the host."""
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line(device):
    """The card's name, count and power limit."""
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                power_limit=smi[0].split(",")[-1].strip() if smi else "not read")


def say(obj, stream=sys.stdout):
    print(json.dumps(obj), file=stream, flush=True)


class Run:
    """One run of a cell on ``device``: ``job`` replaces the program's job
    (the control puts the reference there)."""

    def __init__(self, spec, seed, seconds, traced, device="cuda", t0=None, job=None):
        self.spec, self.seed, self.seconds, self.traced = spec, seed, seconds, traced
        self.device = device
        self.t0 = time.perf_counter() if t0 is None else t0
        self.job_fn = job
        self.on_cuda = torch.device(device).type == "cuda"
        self.setup = {}
        self.setup_peak = 0

    def _stage(self, name, fn):
        t = time.perf_counter()
        out = fn()
        sync(self.device)
        self.setup[name] = time.perf_counter() - t
        return out

    def prepare(self):
        """Set-up: the program, its kernels, the input pool, the warm-up."""
        spec = self.spec
        self._stage("cuda_init_s", lambda: torch.empty(1, device=self.device))
        self.program = self._stage("import_s", lambda: jobs.Program(spec.pipeline))
        if self.on_cuda:  # the kernels' build (the first run of a checkout) apart from their load
            from descriptools_tpu_torch.ops.cuda import build

            t = time.perf_counter()
            _, compile_s, _ = build.build()
            build.library()
            self.setup["compile_s"] = compile_s
            self.setup["library_s"] = time.perf_counter() - t - compile_s
        job = self.job_fn or spec.kind.run
        self.job = lambda x, probe=jobs.Probe(): job(self.program, x, spec.traffic, probe)
        self.pool = self._stage("inputs_s", lambda: inputs.make_pool(
            spec.traffic, spec.rows, spec.cols, self.seed, self.device, spec.root))
        t = time.perf_counter()
        for x in self.pool:
            w0 = time.perf_counter()
            self.job(x)
            sync(self.device)
        self.warm_job_s = time.perf_counter() - w0
        self.setup["warmup_s"] = time.perf_counter() - t
        if self.on_cuda:
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    def samples(self, n_est):
        """Jobs whose outputs the check compares: pairs of consecutive jobs
        (two inputs of the pool), the first of each drawn from the seed
        among the first ``n_est``; the last job of the window is compared
        too."""
        rng = random.Random(self.seed)
        first = [rng.randrange(max(1, n_est - 1)) for _ in range(self.spec.traffic["sample_pairs"])]
        return {j + d for j in first for d in (0, 1)}

    def loop(self, n_jobs=None, seconds=None, probe=None, sample=()):
        """The closed loop, one job in flight: ``n_jobs`` jobs or jobs until
        ``seconds`` have passed.  Returns (latencies s, window s, {job
        index: (pool index, host outputs)} of the sampled jobs, failures,
        (pool index, device outputs) of the last job).  The host copies of
        the sampled jobs' outputs are the harness's, and their time is left
        out of the window."""
        probe = probe or jobs.Probe()
        lat, kept, failed, paused = [], {}, 0, 0.0
        start = time.perf_counter()
        i = 0
        while True:
            x = self.pool[i % len(self.pool)]
            out = None
            t = time.perf_counter()
            try:
                out = self.job(x, probe)
                sync(self.device)
            except RuntimeError as err:  # a job the program could not do counts as failed
                failed += 1
                print(f"job {i} failed: {err}", file=sys.stderr)
            end = time.perf_counter()
            lat.append(end - t)
            window = end - start - paused
            done = (n_jobs is not None and i + 1 >= n_jobs) or (
                seconds is not None and window >= seconds and i >= 1)  # a tail needs two jobs
            if i in sample and out is not None:
                kept[i] = (i % len(self.pool), to_host(out))
                paused += time.perf_counter() - end
            i += 1
            if done:
                break
        last = None if out is None or i - 1 in kept else ((i - 1) % len(self.pool), out)
        return lat, window, kept, failed, last

    def counters(self):
        """The program's own counters: launches a kernel wrapper made, and
        the last flow walk's rounds and cells pending after phase 1."""
        if not self.on_cuda:
            return {}
        from descriptools_tpu_torch.ops.cuda import launch_counters, walk

        pending = walk.flow_walk.pending
        return dict(launches=launch_counters(), jump_rounds=walk.flow_walk.rounds,
                    pending_after_phase1=int(pending[0]) if pending is not None and pending.numel() else None)

    def check(self, kept):
        """(numbers, the reference's walk statistics by pool input)."""
        spec = self.spec
        refs, stats, per_job = {}, {}, []
        for k, got in kept:
            if k not in refs:
                refs[k], stats[k] = spec.kind.reference(self.pool[k], spec.pipeline, spec.traffic)
            per_job.append(check.compare(got, refs[k]))
        return check.worst(per_job), stats

    def _timed(self, result, setup_s):
        """The window of ``seconds``: the end-to-end metrics.  Returns the
        kept jobs, the failures and the jobs attempted."""
        spec = self.spec
        n_est = int(0.5 * self.seconds / max(self.warm_job_s, 1e-6))
        lat, window, kept, failed, last = self.loop(seconds=self.seconds, sample=self.samples(n_est))
        peak = torch.cuda.max_memory_allocated() if self.on_cuda else 0
        values = dict(
            cells_per_s=len(lat) * spec.cells / window,
            job_p95_ms=1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94],
            setup_s=setup_s,
        )
        for m in spec.end_to_end:  # a name may carry a suffix, ".<cells>", for a bound of its own
            result["metrics"][m["name"]] = dict(value=values[m["name"].split(".")[0]], unit=m["unit"])
        say(dict(window=dict(jobs=len(lat), window_s=window, median_ms=1e3 * statistics.median(lat),
                             peak_bytes_per_cell=peak / spec.cells)), sys.stderr)
        return kept, failed, len(lat), last, peak

    def _traced(self, result):
        """An unprofiled stretch and a profiled one of ``trace_jobs`` jobs
        each: the per-layer metrics, the device's busy time and the
        breakdown.  Returns as ``_timed`` does."""
        spec = self.spec
        n = spec.traffic["trace_jobs"]
        probe = jobs.RecordingProbe(self.device, spans=False)
        lat, _, kept, failed, last = self.loop(n_jobs=n, probe=probe, sample=self.samples(n))
        del last  # the unprofiled stretch's last outputs: not held through the profiled one
        held = {}

        def profiled():  # no sampled copies under the profiler: they would read as device work
            held["run"] = self.loop(n_jobs=n, probe=jobs.RecordingProbe(self.device))

        tr = trace.profile(profiled, self.device)
        lat2, _, _, failed2, last = held["run"]
        peak = torch.cuda.max_memory_allocated() if self.on_cuda else 0
        ctx = types.SimpleNamespace(spec=spec, trace=tr, jobs=n, mean_job_s=statistics.mean(lat), probe=probe,
                                    cells=spec.cells, pool=self.pool,
                                    peaks=peaks.for_card(result["device"]["kind"]))
        for m in spec.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
        busy = tr.busy_s()
        result["device"].update(busy_s=busy, window_s=tr.window_s())
        result["breakdown"] = tr.breakdown()
        say(dict(profiled=dict(raw_idle_share=1.0 - busy / tr.window_s(), jobs=n,
                               profiled_job_s=statistics.mean(lat2), unprofiled_job_s=ctx.mean_job_s)), sys.stderr)
        return kept, failed + failed2, 2 * n, last, peak

    def execute(self):
        """Set-up, the window or the traced stretches, the check: the
        result line's contents, ``checked`` last."""
        self.prepare()
        before = self.counters()
        setup_s = time.perf_counter() - self.t0
        result = dict(correct=False, attempted=0, failed=0, metrics={}, device=card_line(self.device))
        kept, failed, attempted, last, peak = (self._traced(result) if self.traced
                                               else self._timed(result, setup_s))
        result["device"]["memory_peak_bytes"] = max(peak, self.setup_peak)
        if last is not None:
            kept[attempted - 1] = (last[0], to_host(last[1]))
        del last, self.program
        say(dict(compared_jobs=sorted(kept)), sys.stderr)
        say(dict(setup=dict(setup_s=setup_s, **self.setup)), sys.stderr)
        say(dict(counters=dict(before=before, after=self.counters())), sys.stderr)
        numbers, stats = self.check(kept.values())
        say(dict(walks={f"seed+{k}": v for k, v in sorted(stats.items())}), sys.stderr)
        del self.job, self.pool  # the job's closure refers to this run
        checked = {k: dict(value=v, limit=self.spec.limits.get(k)) for k, v in numbers.items()}
        ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checked.values())
        result.update(correct=bool(ok and failed == 0 and kept), attempted=attempted, failed=failed,
                      checked=checked)
        return result
