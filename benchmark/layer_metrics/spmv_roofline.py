"""spmv_roofline (%, kernels, moves spmv_gnnz_s): the least time of one
SpMV, its CSR-storage bytes over the card's HBM rate, over the device time
of one SpMV's operations in the profiled slice. The same work is counted
whatever format computes it."""

from benchmark import metrics


def read(cell):
    per = cell.slice.per_span("dispatch.spmv") if cell.slice else None
    peak = metrics.card_peaks(cell.device)
    if not per or peak is None:
        return None
    c = cell.csr
    return 100.0 * metrics.spmv_least_s(c.nnz, c.m, c.n, peak[0]) / per[1]
