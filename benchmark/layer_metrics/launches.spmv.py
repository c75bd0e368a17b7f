"""launches.spmv (count, dispatch, moves spmv_gnnz_s): device operations
(kernels, copies, memsets) a SpMV launched in the profiled slice, over
the ``dispatch.spmv`` spans."""


def read(cell):
    per = cell.slice.per_span("dispatch.spmv") if cell.slice else None
    return per[0] if per else None
