"""cg_iter_us (us, solver, moves cg_solve_ms_p95): the window's solve time
over the loop iterations the host ran (``info["loop_iterations"]``: the
counted iterations rounded up to the solver's poll)."""


def read(cell):
    w = cell.window if cell.traffic["op"] == "cg" else {}
    if not w.get("loops") or sum(w["loops"]) == 0:
        return None
    return sum(w["times"]) / sum(w["loops"]) * 1e6
