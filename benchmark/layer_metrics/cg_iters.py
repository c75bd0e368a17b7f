"""cg_iters (count, solver, moves cg_solve_ms_p95): the mean of the
solver's ``info["iterations"]`` over the window's solves."""


def read(cell):
    it = cell.window.get("iters") if cell.traffic["op"] == "cg" else None
    return sum(it) / len(it) if it else None
