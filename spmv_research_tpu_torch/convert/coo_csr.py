"""COO↔CSR conversion and the row permutation (numpy).

Counterpart of ``spmv_research_tpu/convert/coo_csr.py``, carried over
unchanged for the functions the port uses: ``coo_to_csr``
(``lib/storage_formats/csr/csr_gen.c:182``), ``csr_to_coo``,
``csr_row_permute`` (RCM's reorder) and the transforms the sweep's
``load_matrix`` applies (``fix_diagonal_zeros``, ``make_spd``,
``make_diag_dominant``), and the symmetric expand/drop
(``csr_expand_symmetric``, ``csr_drop_upper``) that CSR_SYM's builder
uses.
"""

from __future__ import annotations

import numpy as np

from ..core.host import HostCOO, HostCSR, INDEX_DTYPE, VALUE_DTYPE_REF


def coo_to_csr(coo: HostCOO, sort_columns: bool = True, sum_duplicates: bool = False) -> HostCSR:
    """Build CSR from COO triplets (stable sort by (row, col)).

    Uses the native counting-sort (native/sparse_host.cpp coo_to_csr) when
    available and applicable."""
    from ..io import native as _native

    if sort_columns and not sum_duplicates and _native.have_native() and coo.nnz:
        ia, ja, a = _native.coo_to_csr_native(coo.rows, coo.cols, coo.vals, coo.m)
        csr = HostCSR(a=a, ia=ia, ja=ja, m=coo.m, n=coo.n,
                      symmetric_storage=coo.symmetric, nnz_expanded=None)
        if coo.symmetric:
            diag = int(np.count_nonzero(
                np.asarray(coo.cols) == np.asarray(coo.rows)))
            csr.nnz_expanded = 2 * csr.nnz - diag
        return csr

    rows = np.asarray(coo.rows, dtype=np.int64)
    cols = np.asarray(coo.cols, dtype=np.int64)
    vals = np.asarray(coo.vals, dtype=VALUE_DTYPE_REF)

    if sort_columns:
        order = np.lexsort((cols, rows))
    else:
        order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]

    if sum_duplicates and rows.size:
        key_change = np.empty(rows.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group = np.cumsum(key_change) - 1
        newvals = np.zeros(int(group[-1]) + 1, dtype=vals.dtype)
        np.add.at(newvals, group, vals)
        rows = rows[key_change]
        cols = cols[key_change]
        vals = newvals

    ia = np.zeros(coo.m + 1, dtype=np.int64)
    np.add.at(ia, rows + 1, 1)
    ia = np.cumsum(ia)

    csr = HostCSR(
        a=vals,
        ia=ia.astype(INDEX_DTYPE),
        ja=cols.astype(INDEX_DTYPE),
        m=coo.m,
        n=coo.n,
        symmetric_storage=coo.symmetric,
        nnz_expanded=None,
    )
    if coo.symmetric:
        # stored lower triangle: expanded nnz counts off-diagonals twice
        diag = int(np.count_nonzero(cols == rows))
        csr.nnz_expanded = 2 * csr.nnz - diag
    return csr


def csr_to_coo(csr: HostCSR) -> HostCOO:
    rows = np.repeat(np.arange(csr.m, dtype=INDEX_DTYPE), csr.row_lengths())
    return HostCOO(
        rows=rows,
        cols=csr.ja.copy(),
        vals=csr.a.copy(),
        m=csr.m,
        n=csr.n,
        symmetric=csr.symmetric_storage,
    )


def csr_row_permute(csr: HostCSR, perm: np.ndarray, permute_columns: bool = True) -> HostCSR:
    """Apply a symmetric permutation: rows reordered by `perm` (new_row i takes
    old row perm[i]); columns relabelled by inverse permutation when
    ``permute_columns`` (reference reorder-by-permutation in ``csr_reorder/``)."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    lengths = csr.row_lengths()[perm]
    ia = np.zeros(csr.m + 1, dtype=np.int64)
    np.cumsum(lengths, out=ia[1:])
    # gather each permuted row's slice
    idx = np.concatenate(
        [np.arange(csr.ia[p], csr.ia[p + 1]) for p in perm]
    ) if csr.nnz else np.zeros(0, dtype=np.int64)
    ja = csr.ja[idx]
    a = csr.a[idx]
    if permute_columns:
        ja = inv[ja].astype(INDEX_DTYPE)
        # re-sort columns within each row
        rows = np.repeat(np.arange(csr.m), lengths)
        order = np.lexsort((ja, rows))
        ja, a = ja[order], a[order]
    return HostCSR(a=a, ia=ia.astype(INDEX_DTYPE), ja=np.asarray(ja, dtype=INDEX_DTYPE),
                   m=csr.m, n=csr.n, nnz_expanded=csr.nnz_expanded,
                   symmetric_storage=False)


def csr_expand_symmetric(csr: HostCSR) -> HostCSR:
    """Expand lower-triangle-stored symmetric CSR to full storage
    (reference ``csr_expand_symmetric`` — ``csr_gen.c:262``)."""
    coo = csr_to_coo(csr)
    off = coo.rows != coo.cols
    rows = np.concatenate([coo.rows, coo.cols[off]])
    cols = np.concatenate([coo.cols, coo.rows[off]])
    vals = np.concatenate([coo.vals, coo.vals[off]])
    return coo_to_csr(HostCOO(rows, cols, vals, csr.m, csr.n, symmetric=False))


def csr_drop_upper(csr: HostCSR, keep_diagonal: bool = True) -> HostCSR:
    """Keep the lower triangle (reference ``csr_drop_upper`` —
    ``csr_gen.c:357``); the result is marked as symmetric storage."""
    coo = csr_to_coo(csr)
    mask = coo.rows >= coo.cols if keep_diagonal else coo.rows > coo.cols
    out = coo_to_csr(
        HostCOO(coo.rows[mask], coo.cols[mask], coo.vals[mask], csr.m, csr.n))
    out.symmetric_storage = True
    diag = int(np.count_nonzero(
        out.ja == np.repeat(np.arange(out.m), out.row_lengths())))
    out.nnz_expanded = 2 * out.nnz - diag
    return out


def fix_diagonal_zeros(csr: HostCSR, value: float = 1e-7) -> HostCSR:
    """Insert missing/zero diagonal entries — required by the solver benchmarks
    (reference ``fix_diagonal_zeros`` — ``bench.cpp:362-462``; builds with
    ``-DFIX_DIAGONAL_ZEROS``). Returns a new CSR with every diagonal present
    and nonzero (zeros replaced by ``value``)."""
    if csr.m != csr.n:
        raise ValueError("fix_diagonal_zeros requires a square matrix")
    coo = csr_to_coo(csr)
    on_diag = coo.rows == coo.cols
    have = np.zeros(csr.m, dtype=bool)
    have[coo.rows[on_diag]] = True
    vals = coo.vals.copy()
    dmask = on_diag & (vals == 0.0)
    vals[dmask] = value
    missing = np.nonzero(~have)[0].astype(INDEX_DTYPE)
    rows = np.concatenate([coo.rows, missing])
    cols = np.concatenate([coo.cols, missing])
    vals = np.concatenate([vals, np.full(missing.shape, value)])
    out = coo_to_csr(HostCOO(rows, cols, vals, csr.m, csr.n))
    out.symmetric_storage = csr.symmetric_storage
    if csr.symmetric_storage:
        # all m diagonals now present; off-diagonals of the stored (lower)
        # triangle still count twice in the expanded matrix
        out.nnz_expanded = 2 * out.nnz - csr.m
    return out


def make_spd(csr: HostCSR) -> HostCSR:
    """SPD analog of a matrix: (A+Aᵀ)/2 off-diagonals with the diagonal set
    to the off-diag row 1-norm + 1 (strictly diagonally dominant symmetric
    ⇒ SPD) — the solver dataset's role for CG (``bench_cg.cpp:93``)."""
    import scipy.sparse as sp
    S = csr.to_scipy().tocsr()
    B = ((S + S.T) * 0.5).tocsr()
    B.setdiag(0)
    B.eliminate_zeros()
    d = np.asarray(np.abs(B).sum(axis=1)).ravel() + 1.0
    return HostCSR.from_scipy((B + sp.diags(d)).tocsr())


def make_diag_dominant(csr: HostCSR) -> HostCSR:
    """Strictly row-diagonally-dominant variant (keeps the off-diagonal
    pattern/values; diagonal = off-diag row 1-norm + 1). The nonsymmetric
    solver-dataset analog: Jacobi-BiCGStab provably converges."""
    import scipy.sparse as sp
    S = csr.to_scipy().tocsr()
    S.setdiag(0)
    S.eliminate_zeros()
    d = np.asarray(np.abs(S).sum(axis=1)).ravel() + 1.0
    return HostCSR.from_scipy((S + sp.diags(d)).tocsr())
