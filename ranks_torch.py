"""Start a group of rank processes and time the stages of a sharded run.

The scale scripts at the repository's root (``weak_scaling_torch.py``,
``staged_scale_torch.py``) run one process a rank: the parent builds the
kernel library once, then starts every rank of a group with ``run_ranks``
and reads the result line each printed (``print_result``); ``launch``
alone starts them and returns their exit codes and output.  Inside a rank,
``stage_timer`` gives a ``stage_hook`` for ``sharded_suite`` that times
each stage with CUDA events (the host clock on the CPU), and
``barrier_start`` lines the ranks up before a timed run, so no stage waits
on a rank that started late.  It imports torch and nothing of the port.
"""

import json
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

RESULT_TAG = "RANK_RESULT "


def free_port():
    """A TCP port on localhost that was free a moment ago (the group's
    rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch(argv_of_rank, world, timeout, cwd=None, env=None):
    """Start ``world`` processes ``[sys.executable, *argv_of_rank(rank)]``
    together and wait at most ``timeout`` s for all of them; stop any left.
    Returns [(exit code, combined stdout and stderr)] by rank."""
    procs = [
        subprocess.Popen([sys.executable, *argv_of_rank(r)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=cwd, env=env)
        for r in range(world)
    ]
    outs = []
    t0 = time.perf_counter()
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_ranks(argv_of_rank, world, timeout, cwd=None, env=None):
    """``launch`` the ranks of a group.  Returns [(output, result)] by rank:
    the process's output and the JSON object it printed after
    ``RESULT_TAG``.  Raises, with the end of its output, when a rank exits
    non-zero or prints no result."""
    res = []
    for r, (rc, out) in enumerate(launch(argv_of_rank, world, timeout, cwd, env)):
        lines = [ln[len(RESULT_TAG):] for ln in out.splitlines() if ln.startswith(RESULT_TAG)]
        if rc != 0 or not lines:
            raise RuntimeError(f"rank {r} of {world}: exit code {rc}\n{out[-6000:]}")
        res.append((out, json.loads(lines[-1])))
    return res


def print_result(obj):
    """Print a rank's result for ``run_ranks`` (one line)."""
    print(RESULT_TAG + json.dumps(obj), flush=True)


def sync(device):
    """Wait for ``device``'s work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier_start(mesh):
    """Every rank's earlier work done, then a barrier: the next timed run
    starts together on every rank."""
    sync(mesh.device)
    dist.barrier(group=mesh.group)
    sync(mesh.device)


def stage_timer(device):
    """(hook, read): ``hook`` is a ``stage_hook`` that records each stage's
    start and end (CUDA events on a card, the host clock on the CPU) and the
    host time of the first stage's start; ``read()``, after the device is
    synchronised, gives ({stage: ms}, first stage's host start)."""
    records = []
    first = []

    def hook(name, compute):
        if not first:
            first.append(time.perf_counter())
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = compute()
            stop.record()
            records.append((name, start, stop))
        else:
            t0 = time.perf_counter()
            out = compute()
            records.append((name, t0, time.perf_counter()))
        return out

    def read():
        if device.type == "cuda":
            ms = {name: start.elapsed_time(stop) for name, start, stop in records}
        else:
            ms = {name: (stop - start) * 1e3 for name, start, stop in records}
        return ms, (first[0] if first else None)

    return hook, read


def rank_device(device, rank, cards):
    """The device of ``rank`` when ranks share ``cards`` cards in turn
    (``"cpu"``: the host)."""
    return torch.device("cuda", rank % cards) if device == "cuda" else torch.device("cpu")


def child_env(root):
    """The environment of a rank process: the repository on the path and
    one host thread a rank (the ranks share the host's cores)."""
    return dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
