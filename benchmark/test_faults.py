"""The comparison fails what it must: the control (the reference in the
precision below the configurations') and the program with its timed path
broken underneath, run through the harness on the CPU at tiny sizes."""

import json

import pytest
import torch

from benchmark import control, harness, readings
from benchmark.test_harness_data import WORKLOADS


def _run(root, workload, job=None, traced=False):
    spec = harness.Spec(root, workload)
    job = job(spec) if job is not None else None
    return harness.Run(spec, 2**31 + 3, 0.3, traced, device="cpu", job=job).execute()


def _broken(fault):
    """The program's job with ``fault`` applied to its outputs."""

    def make(spec):
        real = spec.kind.run
        state = {}

        def job(program, x, traffic, probe):
            return fault(real(program, x, traffic, probe), state)

        return job

    return make


def _unchanged(out, state):
    """A step that returns its state unchanged: every job gives the first
    job's outputs."""
    return state.setdefault("first", out)


def _half(out, state):
    """Half of the work left out: the second half of every raster's rows
    is never computed."""
    out = dict(out)
    for k, v in out.items():
        if isinstance(v, torch.Tensor) and v.dim() == 2:
            v = v.clone()
            v[v.shape[0] // 2:] = 0
            out[k] = v
    return out


def _altered(name):
    def alter(out, state):
        """One answer altered where it is produced: one cell of one raster."""
        out = dict(out)
        v = out[name].clone()
        flat = v.reshape(-1)
        i = int(torch.argmax(flat.abs().to(torch.float64)))
        flat[i] = flat[i] + 1 if not v.is_floating_point() else flat[i] * 1.001
        out[name] = v
        return out

    return alter


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_program_is_correct(tiny, workload):
    assert _run(tiny, workload)["correct"] is True


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny, workload):
    r = _run(tiny, workload, control.control_job)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checked"].values())


FAULTS = {"unchanged": _unchanged, "half": _half, "altered_hand": _altered("hand"),
          "altered_fdist": _altered("fdist"), "altered_slope": _altered("slope")}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, workload, fault):
    assert _run(tiny, workload, _broken(FAULTS[fault]))["correct"] is False


def test_fault_in_traced_run_is_not_correct(tiny):
    assert _run(tiny, WORKLOADS[0], _broken(_half), traced=True)["correct"] is False


def test_readings_bracket_the_limits(tiny, capsys):
    """The readings script: the program's numbers at or under each limit,
    the control's over one of them."""
    readings.main(["--workload", WORKLOADS[0], "--seconds", "0.3", "--seeds", "5", "--control-seeds", "6",
                   "--device", "cpu", "--root", str(tiny)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    limits = harness.Spec(tiny, WORKLOADS[0]).limits
    assert all(v <= limits[k] for k, v in summary["program"].items())
    assert any(v > limits[k] for k, v in summary["control"].items())
