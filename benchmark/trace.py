"""The traced stretch: torch.profiler over a run of jobs, read back from
its Chrome trace into device activities, host spans and idle gaps.

Every device activity (kernel, memset, copy) is tied to the host call
that launched it through the runtime event of the same ``correlation``,
and so to the benchmark's span (``bench.<name>``) around that call.  The
window is the span ``bench.window`` around the whole stretch.
"""

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Trace:
    """Device activities and host spans of one profiled stretch (seconds,
    the trace's clock)."""

    def __init__(self, events):
        spans, launches, device = [], {}, []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
            if cat == "user_annotation" and name.startswith("bench."):
                if name == WINDOW:
                    self.window = (ts, ts + dur)
                else:
                    spans.append((ts, ts + dur, name[len("bench."):]))
            elif cat in HOST_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = ts
            elif cat in DEVICE_CATS:
                device.append(dict(name=name, cat=cat, start=ts, end=ts + dur,
                                   launch=e.get("args", {}).get("correlation"),
                                   device=e.get("args", {}).get("device", 0)))
        self.spans = sorted(spans)
        for d in device:
            d["span"] = self.span_at(launches.get(d["launch"]))
        if self.window is not None:
            lo, hi = self.window
            device = [d for d in device if d["end"] > lo and d["start"] < hi]
        self.device = sorted(device, key=lambda d: d["start"])

    def span_at(self, t):
        """The benchmark's span open at host time ``t``, or None."""
        if t is None:
            return None
        for lo, hi, name in self.spans:
            if lo <= t <= hi:
                return name
        return None

    def busy_intervals(self):
        """The union of the device activities' intervals, clipped to the
        window, for each device."""
        out = {}
        lo, hi = self.window
        for d in self.device:
            iv = out.setdefault(d["device"], [])
            s, e = max(d["start"], lo), min(d["end"], hi)
            if iv and s <= iv[-1][1]:
                iv[-1][1] = max(iv[-1][1], e)
            else:
                iv.append([s, e])
        return out

    def busy_s(self):
        """Seconds in which an activity ran, averaged over the devices."""
        per = [sum(e - s for s, e in iv) for iv in self.busy_intervals().values()]
        return sum(per) / len(per) if per else 0.0

    def window_s(self):
        return self.window[1] - self.window[0]

    def idle_gaps(self):
        """[(host span open at the gap's middle or "between calls", s)] of
        every gap between device activities in the window."""
        lo, hi = self.window
        gaps = []
        for iv in self.busy_intervals().values():
            edges = [lo] + [t for s, e in iv for t in (s, e)] + [hi]
            for s, e in zip(edges[::2], edges[1::2]):
                if e > s:
                    gaps.append((self.span_at((s + e) / 2) or "between calls", e - s))
        return gaps

    def device_s(self, span=None, names=None, exclude=()):
        """Seconds of device activity launched under ``span`` (any span if
        None) whose name holds one of ``names`` (any if None) and none of
        ``exclude``."""
        total = 0.0
        for d in self.device:
            if span is not None and d["span"] != span:
                continue
            if names is not None and not any(n in d["name"] for n in names):
                continue
            if any(n in d["name"] for n in exclude):
                continue
            total += d["end"] - d["start"]
        return total

    def count(self, span):
        return sum(1 for d in self.device if d["span"] == span)

    def breakdown(self, top=10):
        """The device operations that took most time and the longest idle
        gaps, by name: at most ``top`` of each."""
        by_name = {}
        for d in self.device:
            by_name[d["name"]] = by_name.get(d["name"], 0.0) + d["end"] - d["start"]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return dict(device_ops=[[n, s] for n, s in ops], idle_gaps=[[n, s] for n, s in gaps])


def profile(run, device):
    """Run ``run()`` under torch.profiler inside the window span; returns
    its Trace."""
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW):
            run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
