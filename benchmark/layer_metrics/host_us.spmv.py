"""host_us.spmv (us, dispatch, moves spmv_gnnz_s): host microseconds a
SpMV enqueued, on bursts short enough that the launch queue never fills
(``chain.host_us``)."""


def read(cell):
    return cell.extra.get("host_us") if cell.traffic["op"] == "spmv" else None
