"""idle_frac.cg (fraction, device): the profiled slice's idle share
(``TraceSlice.idle_frac``) in the cg cells."""


def read(cell):
    if cell.traffic["op"] != "cg" or cell.slice is None:
        return None
    return cell.slice.idle_frac()
