"""solve_idle_us.cg (us, solver, moves cg_solve_ms_p95): the device's idle
microseconds a solve while the solver runs: the profiled slice's device
operations launched in the solver's spans (``solver.*``), in device order,
split into solves (a solve begins at an operation of ``solver.start`` that
follows one of another span, or at the first such operation after one
launched outside the solver); for each, the stretch from its first
operation's start to its last one's end less their union; the mean over
the solves. The most a host-side change to the solver could save a solve,
less the first launch's latency. Read on the device's clock alone: the
trace's device timestamps drift against the host's by up to hundreds of
microseconds over a slice, so a host span's ends would clip the wrong
stretch of device time."""

from benchmark import metrics


def read(cell):
    s = cell.slice
    if s is None or not s.count("solver.cg"):
        return None
    solves, cur, prev = [], None, None
    for _, a, b, owner in sorted(s.ops, key=lambda o: o[1]):
        if not (owner or "").startswith("solver."):
            cur = None
        elif cur is None or (owner == "solver.start"
                             and prev != "solver.start"):
            cur = [(a, b)]
            solves.append(cur)
        else:
            cur.append((a, b))
        prev = owner
    if not solves:
        return None
    return sum(max(b for _, b in ops) - min(a for a, _ in ops)
               - metrics.union_length(ops) for ops in solves) / len(solves)
