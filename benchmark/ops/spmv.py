"""The SpMV mix: the dependent chain of y = A·x through the program's
``ops.dispatch.spmv``."""

from benchmark import chain


def setup(cell):
    chain.setup(cell, (cell.csr.n,))


def warm(cell):
    chain.warm(cell, cell.program.spmv)


def window(cell, seconds):
    chain.window(cell, cell.program.spmv, "dispatch.spmv", seconds)


def after_window(cell):
    cell.extra["host_us"] = chain.host_us(cell, cell.program.spmv)


def end_to_end(cell):
    w = cell.window
    return {"spmv_gnnz_s": cell.csr.nnz * w["calls"] / w["seconds"] / 1e9}


def gather(cell):
    chain.gather(cell)


def counts(cell):
    return cell.window["calls"], 0


def check(cell):
    return chain.check(cell, "spmv", "spmv_rel_err")
