"""Spans around the benchmark's calls into the program, and the reading of
a profiled slice of the window.

A span is a ``torch.profiler.record_function`` range that the benchmark's
own files open around a call into one layer (``dispatch.spmv``, ``fold``,
``cg.solve``, ...); with tracing off, ``span`` is a null context. The slice
is a bounded stretch of the window run under ``torch.profiler`` (the
profiler can drop device events late in a long profile), after a warm-up
step whose events are dropped, inside the span ``window.slice`` that ends
with a synchronize. Its Chrome trace is read back:

* device operations: events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``, each tied to the host call that launched it by its
  ``correlation`` (events of category ``cuda_runtime`` or
  ``cuda_driver``), and so to the innermost span open at that call;
* the slice's wall time is the ``window.slice`` span's, and the device's
  busy time is the union of the device operations clipped to it;
* an idle gap is a stretch of the slice that no device operation covers,
  named by the innermost span open on the host at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from . import metrics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "window.slice"


def span(cell, name: str):
    """A span named ``name`` while ``cell`` traces, else a null context."""
    if cell.tracing:
        from torch.profiler import record_function
        return record_function(name)
    return contextlib.nullcontext()


class TraceSlice:
    """A parsed slice: ``ops`` (name, start µs, end µs, span or None),
    ``spans`` (name, start µs, end µs) and the slice's (start, end)."""

    def __init__(self, ops, spans, window):
        self.ops: List[Tuple[str, float, float, Optional[str]]] = ops
        self.spans: List[Tuple[str, float, float]] = spans
        self.window: Tuple[float, float] = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return metrics.union_length(((s, e) for _, s, e, _ in self.ops),
                                    *self.window) * 1e-6

    def idle_frac(self) -> Optional[float]:
        """1 − the union of the device operations over the slice's wall
        time; None for an empty slice."""
        if self.window_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s

    def count(self, name: str) -> int:
        """Spans named ``name`` in the slice."""
        return sum(1 for n, _, _ in self.spans if n == name)

    def ops_of(self, name: str):
        return [o for o in self.ops if o[3] == name]

    def per_span(self, name: str) -> Optional[Tuple[float, float]]:
        """(device operations, device seconds) per span ``name``: the
        operations launched inside those spans over their number; None
        where the slice holds no such span or none of them launched any."""
        n, ops = self.count(name), self.ops_of(name)
        if n == 0 or not ops:
            return None
        return len(ops) / n, sum(e - s for _, s, e, _ in ops) * 1e-6 / n

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (name, seconds) and
        the longest idle gaps (the host's span at each, seconds)."""
        by_name: Dict[str, float] = {}
        for name, s, e, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = metrics.gaps([(s, e) for _, s, e, _ in self.ops], *self.window)
        idle.sort(key=lambda g: g[0] - g[1])
        named = [[self.host_span_at((s + e) / 2) or "host", (e - s) * 1e-6]
                 for s, e in idle[:top]]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": named}

    def host_span_at(self, t: float) -> Optional[str]:
        inner = None
        for name, s, e in self.spans:
            if name != SLICE and s <= t <= e and (
                    inner is None or e - s < inner[2] - inner[1]):
                inner = (name, s, e)
        return inner[0] if inner else None


def parse(trace: dict) -> TraceSlice:
    """A ``TraceSlice`` from a Chrome trace (``export_chrome_trace``)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e.get("tid")) for e in events
             if e.get("cat") == "user_annotation"]
    slices = [s for s in spans if s[0] == SLICE]
    if not slices:
        raise ValueError(f"the trace holds no {SLICE!r} span")
    window = slices[-1][1:3]
    launch_at = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_at[e["args"]["correlation"]] = (float(e["ts"]),
                                                   e.get("tid"))
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        owner = None
        at = launch_at.get(e.get("args", {}).get("correlation"))
        if at is not None:
            best = None
            for name, s0, e0, tid in spans:
                if name != SLICE and tid == at[1] and s0 <= at[0] <= e0 and (
                        best is None or e0 - s0 < best[1]):
                    best = (name, e0 - s0)
            owner = best[0] if best else None
        ops.append((e["name"], s, s + float(e["dur"]), owner))
    ops = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    inside = [(n, s, e) for n, s, e, _ in spans
              if s >= window[0] and e <= window[1]]
    return TraceSlice(ops, inside, window)


def profile_slice(cell, warm, body) -> TraceSlice:
    """Run ``warm()`` under the profiler's warm-up step, whose events are
    dropped (it takes the profiler's own start, a buffer request of
    milliseconds), then ``body()`` under its active step inside the
    ``window.slice`` span, synchronizing before, between and at its end;
    the parsed slice."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    activities = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slice.json")
        cell.sync()
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            warm()
            cell.sync()
            prof.step()
            with record_function(SLICE):
                body()
                cell.sync()
            prof.step()
        with open(path) as f:
            return parse(json.load(f))
