"""The SpMM mix: the dependent chain of Y = A·X, X of ``k`` columns,
through the program's ``ops.dispatch.spmm``."""

from benchmark import chain


def setup(cell):
    chain.setup(cell, (cell.csr.n, cell.traffic["k"]))


def warm(cell):
    chain.warm(cell, cell.program.spmm)


def window(cell, seconds):
    chain.window(cell, cell.program.spmm, "dispatch.spmm", seconds)


def after_window(cell):
    pass


def end_to_end(cell):
    w, k = cell.window, cell.traffic["k"]
    return {"spmm_gflops": 2 * cell.csr.nnz * k * w["calls"] / w["seconds"]
            / 1e9}


def gather(cell):
    chain.gather(cell)


def counts(cell):
    return cell.window["calls"], 0


def check(cell):
    return chain.check(cell, "spmm", "spmm_rel_err")
