"""The CG mix: Jacobi CG solves through the program's ``solvers.cg.cg``,
back to back, one caller at a time (a closed loop).

Each solve starts from x = 0 with a new right-hand side b drawn in [0, 1)
from the seed's stream, made and synchronized before the solve's clock
starts; a solve's time runs from the call to its x being ready on the
device. A solve that stops short of ``rtol`` counts as failed. The solves
compared are those drawn from the seed among the first ``sample_within``,
and the window's last. Over k ranks each rank holds its block of b
(``Cell.block``) and of x, and the program's ``cg`` is its rank-local
solver.
"""

import time

import torch

from benchmark import harness, metrics, reference, trace


def setup(cell):
    t = cell.traffic
    cell.state["gen"] = cell.generator()
    cell.state["sample"] = cell.sample(t["sample_within"], t["sample_answers"])


def _rhs(cell):
    return cell.block(torch.rand(cell.csr.m, generator=cell.state["gen"],
                                 device=cell.device))


def warm(cell):
    t = cell.traffic
    for _ in range(t["warm_solves"]):
        cell.program.cg(_rhs(cell), t["rtol"], t["max_iters"])
    cell.sync()


def window(cell, seconds):
    """Solves for ``seconds`` (``harness.paced``); with ``--trace 1`` a
    slice of ``trace_solves`` of them, half way through, under the
    profiler, after one solve in its warm-up step."""
    t = cell.traffic
    rec = {"times": [], "iters": [], "loops": [], "converged": []}
    sample, kept, last = cell.state["sample"], [], []

    def solve() -> None:
        with trace.span(cell, "rhs"):
            b = _rhs(cell)
            cell.sync()
        t0 = time.perf_counter()
        with trace.span(cell, "cg.solve"):
            x, info = cell.program.cg(b, t["rtol"], t["max_iters"])
        with trace.span(cell, "cg.sync"):
            cell.sync()
        rec["times"].append(time.perf_counter() - t0)
        rec["iters"].append(int(info["iterations"]))
        rec["loops"].append(int(info["loop_iterations"]))
        rec["converged"].append(bool(info["converged"]))
        if len(rec["times"]) - 1 in sample:
            kept.append((b, x))
        last[:] = [(b, x)]

    rec["seconds"], rec["profiled"] = harness.paced(cell, seconds, solve, 1,
                                                    t["trace_solves"])
    cell.window = rec
    cell.state["kept"] = kept + last


def gather(cell):
    """Over k ranks: the kept b and x made whole on rank 0 (a
    collective)."""
    cell.state["kept"] = [(cell.whole(b), cell.whole(x))
                          for b, x in cell.state["kept"]]


def after_window(cell):
    pass


def end_to_end(cell):
    return {"cg_solve_ms_p95": metrics.percentile(cell.window["times"], 95)
            * 1e3}


def counts(cell):
    conv = cell.window["converged"]
    return len(conv), sum(1 for c in conv if not c)


def notes(cell):
    """Each solve's time, apart for those under the profiler: whether the
    traced slice's gaps inside ``cg.solve`` show without it."""
    w = cell.window
    plain = [t for i, t in enumerate(w["times"]) if i not in w["profiled"]]
    med = metrics.percentile(plain, 50)
    lines = [f"cg solves {len(plain)} unprofiled, ms: min {min(plain) * 1e3:.3f}"
             f" median {med * 1e3:.3f} p95 "
             f"{metrics.percentile(plain, 95) * 1e3:.3f} max "
             f"{max(plain) * 1e3:.3f}; over median + 1 ms: "
             f"{sum(1 for t in plain if t > med + 1e-3)}"]
    if w["profiled"]:
        lines.append("cg solves profiled, ms: " + " ".join(
            f"{w['times'][i] * 1e3:.3f}" for i in w["profiled"]))
    return lines


def check(cell):
    """``cg_rel_residual``: the largest ‖b − A·x‖ / ‖b‖ over the kept
    solves, A in float64 by the reference; ``cg_unconverged``: the
    window's solves that stopped short of ``rtol`` (``failed``)."""
    A = reference.RefMatrix(cell.csr, cell.device)
    return {"cg_rel_residual": max(reference.rel_residual(A, b, x)
                                   for b, x in cell.state["kept"]),
            "cg_unconverged": counts(cell)[1]}
