"""The kernels' byte counts and the roofline share they give, on small
shapes and a hand-made trace."""

import types

import pytest

from benchmark import kernels, peaks
from benchmark.conftest import ROOT
from benchmark.trace import Trace


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 5), (64, 48), (2178, 1534)])
def test_bytes_a_cell(rows, cols):
    n = rows * cols
    assert kernels.kernel("stencil").bytes_moved(n, {"fdr": "torch.int32", "fac": "torch.int32"}) == 24 * n
    assert kernels.kernel("downslope").bytes_moved(n, {"fdr": "torch.uint8"}) == 9 * n
    assert kernels.kernel("downslope").bytes_moved(n, {"fdr": "torch.int32"}) == 12 * n
    assert kernels.kernel("flow_walk").bytes_moved(n, {"fdr": "torch.uint8"}) == 20 * n


def _event(name, cat, ts, dur, corr):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=dict(correlation=corr))


def _trace():
    ev = [dict(ph="X", cat="user_annotation", name="bench.window", ts=0.0, dur=1000.0),
          dict(ph="X", cat="user_annotation", name="bench.suite", ts=10.0, dur=100.0),
          _event("cudaLaunchKernel", "cuda_runtime", 20.0, 1.0, 1),
          _event("cudaLaunchKernel", "cuda_runtime", 30.0, 1.0, 2),
          _event("cudaLaunchKernel", "cuda_runtime", 500.0, 1.0, 3),
          _event("void stencil_tile_kernel<false, int>(float const*)", "kernel", 100.0, 50.0, 1),
          _event("void at::native::elementwise_kernel<128, 2>", "kernel", 140.0, 60.0, 2),
          _event("void downslope_kernel<false, unsigned char>", "kernel", 600.0, 100.0, 3)]
    return Trace(ev)


def test_trace_attributes_device_time_to_spans():
    tr = _trace()
    assert tr.count("suite") == 2
    assert tr.busy_s() == pytest.approx((100 + 100) * 1e-6)
    assert tr.device_s(span="suite", exclude=kernels.own_names()) == pytest.approx(60e-6)
    gaps = dict((n, s) for n, s in tr.idle_gaps() if n == "suite")
    assert gaps["suite"] == pytest.approx(100e-6)
    b = tr.breakdown()
    assert b["device_ops"][0][0].startswith("void downslope_kernel")
    assert max(s for _, s in b["idle_gaps"]) == pytest.approx(400e-6)


def test_roofline_percent():
    cells = 1000
    ctx = types.SimpleNamespace(spec=types.SimpleNamespace(root=ROOT), trace=_trace(), jobs=1, cells=cells,
                                peaks=peaks.for_card("NVIDIA H100 80GB HBM3"),
                                probe=types.SimpleNamespace(operands={"suite": {"fdr": "torch.uint8"}}))
    want = 100 * 24 * cells / 3.35e12 / 50e-6
    assert kernels.roofline_percent(ctx, "stencil") == pytest.approx(want)
    assert kernels.roofline_percent(ctx, "flow_walk") is None
    ctx.peaks = None
    assert kernels.roofline_percent(ctx, "stencil") is None
