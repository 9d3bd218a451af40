"""The traced run: a torch.profiler window over a few steps of the measured
loop, reduced to device intervals, the device's busy time and idle share,
and a breakdown.

The profiler's schedule skips ``skip`` steps, warms up one and records
``steps``; the loop calls ``Tracer.step()`` at the start of every step, so
each recorded step is one ``ProfilerStep#k`` span on the host.  The traced
window runs from the first recorded span's start to the last one's end,
and every device operation (kernels, copies, sets) is clipped to it.  The
trace is read from the profiler's Chrome-trace export (a file under the
temporary directory, deleted once read).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

__all__ = ["Tracer", "TraceData", "union_length", "reduce_events", "top_breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


def union_length(intervals):
    """Total length covered by [start, end) intervals (any order, overlaps
    counted once)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi) between the union of ``intervals``."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class TraceData:
    """Device operations (name, start, end) in seconds on the trace's clock,
    clipped to the window; host operations likewise; the window."""

    window: tuple
    steps: int
    device_ops: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return union_length([(s, e) for _, s, e in self.device_ops])

    def breakdown(self, top=10):
        return top_breakdown(self, top)


def reduce_events(events) -> TraceData | None:
    """TraceData from Chrome-trace events (``ts``/``dur`` in microseconds),
    or None where no step was recorded."""
    steps = [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("ProfilerStep#")
             and e.get("cat") == "user_annotation"]
    if not steps:
        return None
    lo = min(float(e["ts"]) for e in steps)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in steps)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((str(e.get("name", "")), s * 1e-6, t * 1e-6))
        elif cat in ("cpu_op", "cuda_runtime", "python_function"):
            host.append((str(e.get("name", "")), s * 1e-6, t * 1e-6))
    return TraceData((lo * 1e-6, hi * 1e-6), len(steps), dev, host)


def top_breakdown(data: TraceData, top=10):
    """{"device_ops": the operations with most device time, "idle_gaps": the
    idle time by the innermost host operation running at each gap's middle
    ("no host op" where none), each [[name, seconds], ...], largest first."""
    by_op = {}
    for name, s, e in data.device_ops:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    host = sorted(data.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host = {}
    for s, e in _gaps([(a, b) for _, a, b in data.device_ops], *data.window):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host op"
        for j in range(i, max(i - 200, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        by_host[name] = by_host.get(name, 0.0) + (e - s)
    # kernel names are whole C++ signatures: their first NAME_CHARS characters name them
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


class Tracer:
    """A profiler over steps ``skip + 1 .. skip + 1 + steps`` of a loop (one
    warm-up step between), or a no-op when ``enabled`` is false."""

    def __init__(self, enabled: bool, skip: int, steps: int):
        self.enabled = enabled
        self.data = None
        self._prof = None
        if enabled:
            import torch
            import torch.profiler as tp

            self._path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
            self._prof = tp.profile(
                activities=[tp.ProfilerActivity.CPU]
                + ([tp.ProfilerActivity.CUDA] if torch.cuda.is_available() else []),
                schedule=tp.schedule(wait=skip, warmup=1, active=steps, repeat=1),
                on_trace_ready=self._ready)

    def _ready(self, prof):
        prof.export_chrome_trace(self._path)
        try:
            with open(self._path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(self._path)
        self.data = reduce_events(events)

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def step(self):
        if self._prof is not None:
            self._prof.step()
