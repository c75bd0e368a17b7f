"""launches.cg (count, solver, moves cg_solve_ms_p95): device operations
(kernels, copies, memsets) one loop iteration of the solver launched in
the profiled slice, over its ``solver.step`` spans; the poll's read of
``active`` is in ``solver.poll`` and not counted."""


def read(cell):
    per = cell.slice.per_span("solver.step") if cell.slice else None
    return per[0] if per else None
