"""idle_frac.spmm (fraction, device): the profiled slice's idle share
(``TraceSlice.idle_frac``) in the spmm cells."""


def read(cell):
    if cell.traffic["op"] != "spmm" or cell.slice is None:
        return None
    return cell.slice.idle_frac()
