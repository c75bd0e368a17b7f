"""Trace regions and profiling hooks.

Counterpart of ``spmv_research_tpu/utils/trace.py``: the reference's SDV
tracing (``bench_spmv.cpp:321-363``: ``trace_begin_region("COMPUTATION-SpMV")``
brackets exactly the kernel invocation) mapped onto ``torch.profiler``::

    with profile("/tmp/tb"):                    # a Chrome trace lands there
        with trace_region("COMPUTATION-SpMV"):
            y = spmv(A, x)

A region is a ``torch.profiler.record_function`` (a host event; the
profiler ties the kernels launched inside it to it by correlation) while a
profiler records. Otherwise it is one shared null context after a single
read of the profiler's enabled flag: no ``record_function`` and no
allocation, so the program's hot loops (the solvers') may open regions on
every iteration.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_active = []  # (profiler, logdir) of each start_profiler, until its stop
_NULL = contextlib.nullcontext()


def trace_region(name: str):
    """``with trace_region(name):`` a named region in torch.profiler traces
    while a profiler records; the shared null context otherwise (a
    profiler's warm-up steps record nothing either)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def start_profiler(logdir: str) -> torch.profiler.profile:
    """Start a profiler over CPU activity and, where CUDA is available,
    CUDA activity; :func:`stop_profiler` writes its Chrome trace into
    ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _active.append((prof, logdir))
    return prof


def stop_profiler() -> str:
    """Stop the profiler :func:`start_profiler` started and write its trace
    as ``<logdir>/trace_<ns>.json``; returns that path."""
    prof, logdir = _active.pop()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile(logdir: str):
    """``with profile(logdir) as prof:`` — the started profiler; its events
    are readable (``prof.events()``) after the block, and the Chrome trace
    is in ``logdir``."""
    prof = start_profiler(logdir)
    try:
        yield prof
    finally:
        stop_profiler()
