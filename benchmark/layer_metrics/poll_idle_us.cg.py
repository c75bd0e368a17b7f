"""poll_idle_us.cg (us, solver, moves cg_solve_ms_p95): the device's idle
microseconds a solve that the solver's polls force: the slice's idle gaps
(``metrics.gaps`` over all its device operations) that begin at the end of
an operation launched in a ``solver.poll`` span (the copy of ``active`` to
the host), while the drained device waits for the host's next launch;
their sum over the number of ``solver.cg`` spans. A gap is picked by the
operation's owner, set on the host's clock, and measured on the device's:
the two clocks drift apart by up to hundreds of microseconds over a slice,
so a gap's device start is not compared with a host span."""

from benchmark import metrics


def read(cell):
    s = cell.slice
    if s is None or not s.ops or not s.count("solver.cg"):
        return None
    copied = {b for _, _, b, owner in s.ops if owner == "solver.poll"}
    gaps = metrics.gaps([(a, b) for _, a, b, _ in s.ops], *s.window)
    return sum(g1 - g0 for g0, g1 in gaps if g0 in copied) / s.count(
        "solver.cg")
