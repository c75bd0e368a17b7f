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

A workload whose ``chips`` is k > 1 runs as k rank processes (``ranks.py``
starts them); each prepares its own ``Cell`` with ``control``, and
``run_seed`` keeps every rank's calls in step and gathers their results
to rank 0, which alone reports and judges. At one chip nothing of that
runs: no process is started and no process group is made.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
import types
from typing import Callable, Optional

import numpy as np

from . import matrices, trace
from .ranks import GO, SLICE, STOP

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
        # over k > 1 ranks: this process's rank, k, the ``ranks.Ranks``
        # that carries the host-side control, and on rank 0 each rank's
        # summary once the window has closed (None at one chip)
        self.rank = 0
        self.ranks = 1
        self.control = None
        self.rank_info = None

    def agree(self, decision: int) -> int:
        """The decision (``ranks.GO``, ``SLICE`` or ``STOP``) that every
        rank follows now: at one chip ``decision`` itself; over k ranks
        rank 0's of ``ranks.AGREE_LAG`` calls ago, ``decision`` posted in
        its place, in the span ``window.agree``."""
        if self.control is None:
            return decision
        with trace.span(self, "window.agree"):
            return self.control.agree(decision)

    def barrier(self) -> None:
        """Wait for every rank (nothing at one chip)."""
        if self.control is not None:
            self.control.barrier()

    def block(self, x):
        """This rank's block of the global vector ``x`` (``x`` at one
        chip)."""
        return x if self.control is None else self.program.block(x)

    def whole(self, v):
        """The global vector from every rank's block ``v`` of it (``v`` at
        one chip); a collective."""
        return v if self.control is None else self.program.whole(v)

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
            program_factory: Optional[Callable] = None,
            control=None) -> Cell:
    """The cell with its matrix loaded and its program built; over k ranks
    (``control``, a ``ranks.Ranks``) this rank's cell and shard."""
    from .program import PortProgram
    cell = Cell(bench, workload, device, trace)
    if control is not None:
        return _prepare_rank(cell, control, program_factory)
    t0 = time.perf_counter()
    cell.csr = matrices.load_matrix(cell.config, cell.config_file)
    t1 = time.perf_counter()
    factory = program_factory or PortProgram
    cell.program = factory(cell.config, cell.device)
    cell.build_info = cell.program.build(cell.csr)
    cell.setup_spans = [("matrix", t1 - t0),
                        ("program.build", time.perf_counter() - t1)]
    return cell


def _prepare_rank(cell: Cell, control, program_factory) -> Cell:
    """This rank's cell: the process group first (``program.join``), then
    rank 0 makes or loads the matrix and builds the plan through the
    port's format cache while the other ranks wait at a barrier, so that
    they load both from the caches; each rank keeps its own shard. On the
    other ranks ``cell.csr`` keeps only ``m``, ``n`` and ``nnz``."""
    from .program import RankProgram, join
    if cell.entry["chips"] != control.k:
        raise ValueError(f"{cell.name} asks for {cell.entry['chips']} "
                         f"chips, the run has {control.k} ranks")
    cell.control, cell.rank, cell.ranks = control, control.rank, control.k
    t0 = time.perf_counter()
    join(control, cell.config["format"].get("mesh_axis", "rows"))
    cell.device = control.device
    t1 = time.perf_counter()
    if cell.rank:
        control.barrier()    # rank 0's matrix and plan are in the caches
    t2 = time.perf_counter()
    cell.csr = matrices.load_matrix(cell.config, cell.config_file)
    t3 = time.perf_counter()
    factory = program_factory or RankProgram
    cell.program = factory(cell.config, cell.device, control)
    cell.build_info = cell.program.build(cell.csr)
    t4 = time.perf_counter()
    if cell.rank:
        c = cell.csr
        cell.csr = types.SimpleNamespace(m=c.m, n=c.n, nnz=c.nnz)
    else:
        control.barrier()
    cell.setup_spans = [("ranks.join", t1 - t0), ("ranks.wait", t2 - t1),
                        ("matrix", t3 - t2), ("program.build", t4 - t3)]
    return cell


def paced(cell: Cell, seconds: float, step: Callable, warm_steps: int,
          slice_steps: int):
    """The measured window: ``step()`` back to back for ``seconds`` on
    rank 0's clock; with ``--trace 1``, half way, ``warm_steps`` calls in
    the profiler's warm-up step and ``slice_steps`` in its traced slice
    (``cell.tracing``). After every call rank 0's clock decides whether to
    go on, take the slice or stop, and every rank follows its decisions in
    order (``Cell.agree``; over k ranks each is followed
    ``ranks.AGREE_LAG`` calls after it was made), so that every rank runs
    the same calls. The window closes once every rank's device has
    finished: a synchronize, then a barrier. Its seconds, and the indices
    of the calls run under the profiler."""
    calls = 0

    def run(n: int, tracing: bool) -> None:
        nonlocal calls
        cell.tracing = tracing
        try:
            for _ in range(n):
                step()
                calls += 1
                cell.agree(GO)
        finally:
            cell.tracing = False

    profiled = range(0)
    asked = taken = not cell.trace     # the slice, by rank 0's clock
    cell.sync()
    if cell.control is not None and cell.rank == 0:
        print("# window: open", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    deadline, slice_at = t0 + seconds, t0 + seconds / 2
    while True:
        step()
        calls += 1
        now = time.perf_counter()
        if not asked and now >= slice_at:
            decision, asked = SLICE, True
        else:
            decision = STOP if taken and now >= deadline else GO
        decision = cell.agree(decision)
        if decision == STOP:
            break
        if decision == SLICE:
            first = calls
            cell.slice = trace.profile_slice(
                cell, lambda: run(warm_steps, False),
                lambda: run(slice_steps, True))
            profiled = range(first, calls)
            taken = True
    if cell.control is not None:
        cell.control.settle()
    cell.sync()
    cell.barrier()
    return time.perf_counter() - t0, profiled


RANK_KEYS = ("rank", "device", "memory_peak_bytes", "attempted", "failed",
             "busy_s", "window_s")


def device_info(cell: Cell, peak_bytes: int) -> dict:
    """The result's ``device``; over k ranks ``count`` = k,
    ``memory_peak_bytes`` the largest rank's, and under ``ranks`` each
    rank's device, peak, counts and, traced, its slice's ``busy_s`` and
    ``window_s``."""
    import torch
    count, ranks = 1, None
    if cell.control is not None:
        ranks = [{k: r[k] for k in RANK_KEYS if k in r}
                 for r in cell.rank_info]
        count = cell.ranks
        peak_bytes = max(r["memory_peak_bytes"] for r in ranks)
    if cell.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(
            cell.device), "count": count, "memory_peak_bytes": int(peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    if ranks is not None:
        info["ranks"] = ranks
    return info


def _rank_summary(cell: Cell, peak: int, attempted: int,
                  failed: int) -> dict:
    """What rank 0 gathers of each rank once the window has closed."""
    s = {"rank": cell.rank, "device": str(cell.device),
         "memory_peak_bytes": int(peak), "attempted": int(attempted),
         "failed": int(failed), "forbidden": forbidden_modules()}
    if cell.slice is not None:
        s.update(busy_s=cell.slice.busy_s, window_s=cell.slice.window_s)
    return s


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
    cell.barrier()
    t2 = time.perf_counter()
    cell.setup_spans += [("op.setup", t1 - t0), ("op.warm", t2 - t1)]
    setup_s = t2 - t_start
    op.window(cell, seconds)
    peak = memory_peak(cell)
    if cell.trace:
        op.after_window(cell)
    attempted, failed = op.counts(cell)
    if cell.control is not None:
        if not _gather_ranks(cell, peak, attempted, failed, release):
            return None
        attempted = sum(r["attempted"] for r in cell.rank_info)
        failed = sum(r["failed"] for r in cell.rank_info)
    metrics, units = {}, {}
    if cell.trace:
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
    if release:
        _release(cell)
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
        if cell.control is None:
            device["busy_s"] = cell.slice.busy_s
            device["window_s"] = cell.slice.window_s
        else:   # averaged over the ranks' cards
            device["busy_s"] = float(np.mean([r["busy_s"] for r in
                                              cell.rank_info]))
            device["window_s"] = float(np.mean([r["window_s"] for r in
                                                cell.rank_info]))
        out["breakdown"] = cell.slice.breakdown()
    out["checks"] = checks
    return out


def _gather_ranks(cell: Cell, peak: int, attempted: int, failed: int,
                  release: bool) -> bool:
    """Over k ranks, on every rank once the window has closed: the kept
    answers made whole on rank 0 (the op's ``gather``, a collective), each
    rank's summary gathered to rank 0 (``cell.rank_info``), then the
    process group left. False on the other ranks, which release their
    shard and are done."""
    cell.op.gather(cell)
    cell.rank_info = cell.control.gather(
        _rank_summary(cell, peak, attempted, failed))
    cell.control.done()
    if cell.rank == 0:
        return True
    cell.state["kept"] = []
    if release:
        _release(cell)
    return False


def _release(cell: Cell) -> None:
    """Free the program's state, so that the reference's check does not
    add to the device's peak."""
    import torch
    cell.program.release()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
