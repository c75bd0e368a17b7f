"""Discovery by name and the run of one cell.

Everything that belongs to one configuration, traffic mix, op or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the matrix (its twin line and transform) and
  the format (the port's builder, cache key, impl);
* ``traffic/<traffic>.json``: the mix's parameters; its ``op`` names the
  op module;
* ``ops/<op>.py``: the op module (``setup``, ``warm``, ``window``,
  ``after_window``, ``end_to_end``, ``check``, ``counts``, and optionally
  ``notes``: lines for standard error);
* ``layer_metrics/<metric>.py``: a reader, ``read(cell)`` → a number or
  None (nothing to read: the metric is left out of the line);
* ``limits/<workload>.json``: the limit of each number the cell compares.

So a later change adds a cell or a metric by adding files and entries to
``BENCHMARK.json``, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from typing import Callable, Optional

import numpy as np

from . import matrices

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")
FORMAT_CACHE = os.path.join(HERE, ".cache", "formats")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spmv_research_tpu"})


def use_format_cache() -> None:
    """Point the port's format cache at the benchmark's fixed directory in
    the checkout, so that only a checkout's first run builds."""
    os.environ["SPARSE_FORMAT_CACHE_TORCH"] = FORMAT_CACHE


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at ``path`` as a module (names may hold dots)."""
    rel = os.path.relpath(path, HERE)
    name = "_benchmark_file_" + re.sub(r"\W", "_", rel)
    if name in sys.modules:
        return sys.modules[name]
    if not os.path.exists(path):
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``base``."""

    def __init__(self, spec_path: str = SPEC, base: str = HERE):
        self.spec = load_json(spec_path)
        self.base = base

    def path(self, *parts: str) -> str:
        return os.path.join(self.base, *parts)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str):
        path = self.path("configs", f"{name}.json")
        return load_json(path), path

    def traffic(self, name: str) -> dict:
        return load_json(self.path("traffic", f"{name}.json"))

    def op(self, name: str):
        return load_module(self.path("ops", f"{name}.py"))

    def reader(self, metric: str):
        return load_module(self.path("layer_metrics", f"{metric}.py"))

    def limits(self, workload: str) -> dict:
        return load_json(self.path("limits", f"{workload}.json"))

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics a cell reports."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics a cell reports: those that list it, and
        those with no list whose end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


class Cell:
    """One cell's state through a run: its entries and files, the matrix,
    the program, and what the op module records."""

    def __init__(self, bench: Bench, workload: str, device, trace: bool):
        import torch
        self.bench = bench
        self.name = workload
        self.entry = bench.workload(workload)
        self.config, self.config_file = bench.config(self.entry["config"])
        self.traffic = bench.traffic(self.entry["traffic"])
        self.op = bench.op(self.traffic["op"])
        self.device = torch.device(device)
        self.trace = trace
        self.tracing = False     # True inside the profiled slice
        self.csr = None
        self.program = None
        self.build_info = None
        self.seed = None
        self.state: dict = {}
        self.window: dict = {}
        self.extra: dict = {}
        self.slice = None
        self.setup_spans: list = []   # (name, host seconds) of set-up

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generator(self):
        """A torch generator on the device, seeded from ``--seed``."""
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed % (1 << 64))
        return g

    def sample(self, within: int, count: int) -> set:
        """``count`` answer indices below ``within``, drawn from the seed."""
        rng = np.random.Generator(np.random.PCG64(self.seed % (1 << 64)))
        return set(int(i) for i in rng.choice(within, size=min(count, within),
                                              replace=False))


def prepare(bench: Bench, workload: str, device, trace: bool,
            program_factory: Optional[Callable] = None) -> Cell:
    """The cell with its matrix loaded and its program built."""
    from .program import PortProgram
    cell = Cell(bench, workload, device, trace)
    t0 = time.perf_counter()
    cell.csr = matrices.load_matrix(cell.config, cell.config_file)
    t1 = time.perf_counter()
    factory = program_factory or PortProgram
    cell.program = factory(cell.config, cell.device)
    cell.build_info = cell.program.build(cell.csr)
    cell.setup_spans = [("matrix", t1 - t0),
                        ("program.build", time.perf_counter() - t1)]
    return cell


def device_info(cell: Cell, peak_bytes: int) -> dict:
    import torch
    if cell.device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(
            cell.device), "count": 1, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def memory_peak(cell: Cell) -> int:
    import torch
    if cell.device.type == "cuda":
        return torch.cuda.max_memory_allocated(cell.device)
    return 0


def run_seed(cell: Cell, seed: int, seconds: float, t_start: float,
             release: bool = True) -> dict:
    """Set up, warm, measure and check one run of ``cell`` with ``seed``;
    ``t_start`` is the process's start on ``time.perf_counter``'s clock.
    The result line's dict, its ``checks`` last."""
    import torch
    op = cell.op
    cell.seed = int(seed)
    cell.state, cell.window, cell.extra, cell.slice = {}, {}, {}, None
    t0 = time.perf_counter()
    op.setup(cell)
    t1 = time.perf_counter()
    op.warm(cell)
    cell.sync()
    t2 = time.perf_counter()
    cell.setup_spans += [("op.setup", t1 - t0), ("op.warm", t2 - t1)]
    setup_s = t2 - t_start
    op.window(cell, seconds)
    peak = memory_peak(cell)
    metrics, units = {}, {}
    if cell.trace:
        op.after_window(cell)
        for m in cell.bench.per_layer(cell.name):
            v = cell.bench.reader(m["name"]).read(cell)
            if v is not None:
                metrics[m["name"]] = float(v)
                units[m["name"]] = m["unit"]
    else:
        values = dict(op.end_to_end(cell), setup_s=setup_s)
        for m in cell.bench.end_to_end(cell.name):
            metrics[m["name"]] = float(values[m["name"]])
            units[m["name"]] = m["unit"]
    attempted, failed = op.counts(cell)
    if release:
        cell.program.release()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
    readings = op.check(cell)
    limits = cell.bench.limits(cell.name)
    checks = {k: {"value": float(readings.get(k, float("inf"))),
                  "limit": float(limits[k])} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = device_info(cell, peak)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if cell.trace and cell.slice is not None:
        device["busy_s"] = cell.slice.busy_s
        device["window_s"] = cell.slice.window_s
        out["breakdown"] = cell.slice.breakdown()
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
