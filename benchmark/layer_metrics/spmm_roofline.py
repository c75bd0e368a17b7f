"""spmm_roofline (%, kernels, moves spmm_gflops): the least time of one
SpMM, the larger of its bytes (A's CSR storage, X and Y) over the card's
HBM rate and its 2·nnz·k operations over the fp32 rate, over the device
time of one SpMM's operations in the profiled slice."""

from benchmark import metrics


def read(cell):
    per = cell.slice.per_span("dispatch.spmm") if cell.slice else None
    peak = metrics.card_peaks(cell.device)
    if not per or peak is None:
        return None
    c = cell.csr
    least = metrics.spmm_least_s(c.nnz, c.m, c.n, cell.traffic["k"], *peak)
    return 100.0 * least / per[1]
