"""The dependent chain that the SpMV and SpMM mixes drive.

Each call's output is folded into its input, x ← x + y·1e-30 (the suite's
chain, the port's ``utils/timing.py:fold``, copied here so that the
yardstick stays fixed), so no call is independent of the one before. The
window runs from the first call to the synchronize after the last; the
host enqueues ahead and the device paces the chain.

The answers compared are the outputs of calls drawn from the seed among
the first ``sample_within`` and the window's last, each kept with the
input that produced it.

Over k ranks each rank holds its block of x (``Cell.block``) and the
program's call gives its block of the product; the fold works block by
block, and the kept blocks are made whole on rank 0 (:func:`gather`)
before the check.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, reference, trace


def fold(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y·1e-30, y resized to x's shape: the next input depends on y."""
    n = x.numel()
    y = y.reshape(-1).to(x.dtype)
    if y.numel() < n:
        y = y.repeat(-(-n // y.numel()))
    return x + y[:n].view(x.shape) * 1e-30


def setup(cell, shape) -> None:
    cell.state["x0"] = cell.block(torch.rand(
        shape, generator=cell.generator(), device=cell.device))
    t = cell.traffic
    cell.state["sample"] = cell.sample(t["sample_within"], t["sample_answers"])


def warm(cell, call) -> None:
    x = cell.state["x0"]
    for _ in range(cell.traffic["warm_calls"]):
        x = fold(x, call(x))
    cell.sync()


def window(cell, call, span_name: str, seconds: float) -> None:
    """Calls back to back for ``seconds`` (``harness.paced``); with
    ``--trace 1`` a slice of ``trace_calls`` of them, half way through,
    under the profiler, after 3 calls in its warm-up step."""
    st = {"x": cell.state["x0"], "calls": 0, "last": None}
    sample, kept = cell.state["sample"], []

    def step() -> None:
        x_in = st["x"]
        with trace.span(cell, span_name):
            y = call(x_in)
        with trace.span(cell, "fold"):
            st["x"] = fold(x_in, y)
        if st["calls"] in sample:
            kept.append((x_in, y))
        st["last"] = (x_in, y)
        st["calls"] += 1

    seconds, _ = harness.paced(cell, seconds, step, 3,
                               cell.traffic["trace_calls"])
    cell.window = {"calls": st["calls"], "seconds": seconds}
    cell.state["kept"] = kept + [st["last"]]
    cell.state["x0"] = None


def gather(cell) -> None:
    """Over k ranks: the kept inputs and outputs made whole on rank 0 (a
    collective: every rank calls it)."""
    cell.state["kept"] = [(cell.whole(x), cell.whole(y))
                          for x, y in cell.state["kept"]]


def host_us(cell, call) -> float:
    """Host µs a call enqueued, on bursts of ``host_burst`` calls after a
    synchronize, short enough that the launch queue never fills."""
    x, total, n = cell.state["kept"][-1][0], 0.0, 0
    for _ in range(cell.traffic["host_bursts"]):
        cell.sync()
        t0 = time.perf_counter()
        for _ in range(cell.traffic["host_burst"]):
            call(x)
        total += time.perf_counter() - t0
        n += cell.traffic["host_burst"]
    cell.sync()
    return total / n * 1e6


def check(cell, product, name: str) -> dict:
    """``name``: the largest |y − A·x| / (|A|·|x|) over the kept answers,
    A·x and |A|·|x| in float64 by the reference's ``product`` (``"spmv"``
    or ``"spmm"``)."""
    A = reference.RefMatrix(cell.csr, cell.device)
    Aabs = reference.RefMatrix(cell.csr, cell.device, absolute=True)
    worst = 0.0
    for x, y in cell.state["kept"]:
        want = getattr(A, product)(x)
        if tuple(y.shape) != tuple(want.shape):
            return {name: float("inf")}
        scale = getattr(Aabs, product)(x.abs())
        worst = max(worst, reference.rel_err(y, want, scale))
    return {name: worst}
