"""The solver layer's readers (``launches.cg``, ``solve_idle_us.cg``,
``poll_idle_us.cg``) on hand-made slices: the values worked out by hand,
the same values when the device's clock is offset from the host's, and
None where the slice holds no solver spans or no device operations."""

import types

import pytest

from benchmark import harness, trace

READERS = ("launches.cg", "solve_idle_us.cg", "poll_idle_us.cg")


def _read(metric, slice_):
    cell = types.SimpleNamespace(slice=slice_, traffic={"op": "cg"})
    return harness.Bench().reader(metric).read(cell)


def _two_solves(offset=0.0):
    """Two solves back to back in a slice of [-500, 1500] µs, the device's
    timestamps ``offset`` µs from the host's. Solve 1 (10–400): start, a
    step, a poll, a step and the poll that ends the loop, then the
    converged flag's kernel. Solve 2 (500–900): start, two steps, two
    polls; a step's kernel still runs when the first poll starts."""
    spans = [("solver.cg", 10, 400), ("solver.start", 10, 50),
             ("solver.step", 50, 150), ("solver.poll", 150, 170),
             ("solver.step", 170, 300), ("solver.poll", 300, 320),
             ("solver.cg", 500, 900), ("solver.start", 500, 505),
             ("solver.step", 505, 690), ("solver.poll", 700, 760),
             ("solver.step", 760, 840), ("solver.poll", 850, 870)]
    ops = [("r0", 20, 60, "solver.start"),
           ("b1", 60, 140, "solver.step"), ("c1", 140, 145, "solver.step"),
           ("d2h", 160, 165, "solver.poll"),
           ("b1", 190, 280, "solver.step"), ("c1", 285, 290, "solver.step"),
           ("d2h", 310, 312, "solver.poll"),
           ("le", 395, 398, "solver.cg"),
           ("r0", 502, 508, "solver.start"),
           ("b1", 510, 690, "solver.step"), ("c1", 695, 702, "solver.step"),
           ("d2h", 705, 706, "solver.poll"),
           ("b1", 800, 845, "solver.step"),
           ("d2h", 855, 858, "solver.poll"),
           ("le", 862, 864, "solver.cg")]
    ops = [(n, a + offset, b + offset, o) for n, a, b, o in ops]
    return trace.TraceSlice(ops, spans, (-500.0, 1500.0))


def test_launches_are_the_step_spans_operations_over_their_number():
    # b1, c1, b1, c1 in solve 1 and b1, c1, b1 in solve 2 over 4 steps;
    # the start's, the poll's copies and the solve's own kernel are not
    # counted
    assert _read("launches.cg", _two_solves()) == pytest.approx(7 / 4)


def test_solve_idle_is_each_solves_device_stretch_less_its_busy_union():
    # solve 1: 20 to 398, 378 µs less 230 busy = 148; solve 2: 502 to 864,
    # 362 less 244 = 118
    assert _read("solve_idle_us.cg", _two_solves()) == pytest.approx(133.0)


def test_poll_idle_sums_the_gaps_after_the_polls_copies():
    # solve 1: (165, 190) and (312, 395); solve 2: (706, 800) and
    # (858, 862). The gaps after a step's kernel are not the polls', (702,
    # 705) either, though it starts inside the poll (700, 760): the device
    # still had the step's work queued.
    want = (25 + 83 + 94 + 4) / 2
    assert _read("poll_idle_us.cg", _two_solves()) == pytest.approx(want)
    assert want <= _read("solve_idle_us.cg", _two_solves())


@pytest.mark.parametrize("metric", READERS)
def test_an_offset_device_clock_reads_the_same(metric):
    # the device's timestamps run ahead of or behind the host's
    want = _read(metric, _two_solves())
    for offset in (-300.0, 45.0):
        assert _read(metric, _two_solves(offset)) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_nothing_to_read_gives_none(metric):
    s = _two_solves()
    chain = trace.TraceSlice([("b1", 0, 5, "dispatch.spmv")],
                             [("dispatch.spmv", 0, 4)], (0.0, 10.0))
    assert _read(metric, None) is None
    assert _read(metric, chain) is None                      # no solver spans
    assert _read(metric, trace.TraceSlice([], s.spans, s.window)) is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_parse_gives_operations_and_gaps_to_the_innermost_solver_span():
    """Under the benchmark's ``cg.solve`` span, an operation launched in
    a step belongs to ``solver.step``, the poll's copy to ``solver.poll``,
    and the gaps inside the solve are named by the solver's spans."""
    events = [
        _ev("user_annotation", "window.slice", 0, 200),
        _ev("user_annotation", "cg.solve", 1, 150),
        _ev("user_annotation", "solver.cg", 2, 148),
        _ev("user_annotation", "solver.step", 3, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=1),
        _ev("user_annotation", "solver.poll", 30, 40),
        _ev("cuda_runtime", "cudaMemcpyAsync", 31, 1, correlation=2),
        _ev("user_annotation", "solver.step", 71, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 72, 1, correlation=3),
        _ev("kernel", "b1", 5, 20, tid=7, correlation=1),
        _ev("gpu_memcpy", "d2h", 32, 1, tid=7, correlation=2),
        _ev("kernel", "b1", 100, 40, tid=7, correlation=3),
    ]
    s = trace.parse({"traceEvents": events})
    assert [o[3] for o in s.ops] == ["solver.step", "solver.poll",
                                     "solver.step"]
    assert _read("launches.cg", s) == 1.0
    # (33, 100) follows the poll's copy; (25, 32) before it does not
    assert _read("poll_idle_us.cg", s) == pytest.approx(67.0)
    # the device's stretch 5 to 140 less 61 busy
    assert _read("solve_idle_us.cg", s) == pytest.approx(135 - 61)
    names = sorted(g[0] for g in s.breakdown()["idle_gaps"])
    assert names == ["host", "solver.cg", "solver.cg", "solver.poll"]
