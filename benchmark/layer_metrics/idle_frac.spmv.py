"""idle_frac.spmv (fraction, device): the profiled slice's idle share
(``TraceSlice.idle_frac``) in the spmv cells."""


def read(cell):
    if cell.traffic["op"] != "spmv" or cell.slice is None:
        return None
    return cell.slice.idle_frac()
