"""Builders: canonical host CSR → padded device formats.

Counterpart of ``spmv_research_tpu/convert/build.py``: CSR and the classic
formats (COO, ELL, SELL-C-σ, BSR, DIA, LDU, CSC, CSR_SYM), each giving the
JAX builder's arrays. Conversion is host-side numpy; the returned format
holds CPU tensors until the caller moves it with ``.to(device)``.

Where the JAX builders refuse a matrix with a plain ``ValueError``, these
raise a subclass of it (``BSRBuildError``, ``DIABuildError``,
``LDUBuildError``, ``CSRSymBuildError``), so that the sweep can skip the
format as unsuitable and let any other error through.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.host import HostCSR, INDEX_DTYPE
from ..core import formats as F
from .coo_csr import csr_drop_upper, csr_row_permute
from .reorder import sigma_sort_rows


class BSRBuildError(ValueError):
    """The dense blocks would take far more memory than CSR (fill guard)."""


class DIABuildError(ValueError):
    """More distinct diagonals than ``max_diags``."""


class LDUBuildError(ValueError):
    """Not square, or an off-diagonal pattern that is not symmetric."""


class CSRSymBuildError(ValueError):
    """Not square, or not numerically symmetric."""


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def round_up_vec(x: np.ndarray, mult: int) -> np.ndarray:
    return ((x + mult - 1) // mult) * mult


def _pad1(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr))


def _row_ids(csr: HostCSR, dtype=INDEX_DTYPE) -> np.ndarray:
    return np.repeat(np.arange(csr.m, dtype=dtype), csr.row_lengths())


def build_csr(csr: HostCSR, dtype=torch.float32, nnz_align: int = 1024) -> F.CSR:
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.CSR(
        data=_t(_pad1(csr.a.astype(_np_dtype(dtype)), nnz_pad, 0)),
        indices=_t(_pad1(csr.ja.astype(INDEX_DTYPE), nnz_pad, 0)),
        rows=_t(_pad1(_row_ids(csr), nnz_pad, csr.m)),
        indptr=_t(np.asarray(csr.ia, dtype=INDEX_DTYPE).copy()),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_coo(csr: HostCSR, dtype=torch.float32, nnz_align: int = 1024) -> F.COO:
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.COO(
        data=_t(_pad1(csr.a.astype(_np_dtype(dtype)), nnz_pad, 0)),
        rows=_t(_pad1(_row_ids(csr), nnz_pad, csr.m)),
        cols=_t(_pad1(csr.ja.astype(INDEX_DTYPE), nnz_pad, 0)),
        shape=(csr.m, csr.n),
        nnz=csr.nnz,
        nnz_expanded=csr.nnz_expanded,
    )


def build_ell(csr: HostCSR, dtype=torch.float32, row_align: int = 8,
              width_align: int = 1) -> F.ELL:
    lengths = csr.row_lengths()
    width = max(round_up(int(lengths.max()) if csr.m else 1, width_align), 1)
    m_pad = max(round_up(csr.m, row_align), row_align)
    vals = np.zeros((m_pad, width), dtype=_np_dtype(dtype))
    cols = np.zeros((m_pad, width), dtype=INDEX_DTYPE)
    # scatter row slices into the padded 2-D layout
    pos = np.arange(csr.nnz) - np.repeat(csr.ia[:-1].astype(np.int64), lengths)
    rows = np.repeat(np.arange(csr.m), lengths)
    vals[rows, pos] = csr.a
    cols[rows, pos] = csr.ja
    return F.ELL(data=_t(vals), cols=_t(cols), shape=(csr.m, csr.n),
                 nnz=csr.nnz, nnz_expanded=csr.nnz_expanded, width=width)


def build_sellcs(csr: HostCSR, C: int = 8, sigma: int = 4096,
                 dtype=torch.float32, width_align: int = 128) -> F.SellCS:
    """SELL-C-σ slab layout (see :class:`..core.formats.SellCS`).

    σ-sorting (reference ``sell_sorted.cpp:184``) bounds padding waste; the
    slab width of each slice is rounded to `width_align` (the JAX package's
    TPU lane tile, kept so that the arrays stay identical).
    """
    perm = sigma_sort_rows(csr, sigma)
    p = csr_row_permute(csr, perm, permute_columns=False)
    lengths = p.row_lengths()
    m = csr.m
    n_slices = max((m + C - 1) // C, 1)
    lengths_pad = np.zeros(n_slices * C, dtype=np.int64)
    lengths_pad[:m] = lengths
    slice_len = lengths_pad.reshape(n_slices, C).max(axis=1)
    slice_len = np.maximum(round_up_vec(slice_len, width_align), width_align)
    offsets = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(slice_len, out=offsets[1:])
    total_width = int(offsets[-1])

    vals = np.zeros((C, total_width), dtype=_np_dtype(dtype))
    cols = np.zeros((C, total_width), dtype=INDEX_DTYPE)
    # permuted row r (slice r // C, lane r % C) goes to slab row r % C,
    # columns [offsets[slice], offsets[slice] + len)
    rows_of_nnz = np.repeat(np.arange(m), lengths)
    pos = np.arange(p.nnz) - np.repeat(p.ia[:-1].astype(np.int64), lengths)
    slab_col = offsets[rows_of_nnz // C] + pos
    vals[rows_of_nnz % C, slab_col] = p.a
    cols[rows_of_nnz % C, slab_col] = p.ja

    slice_of_col = np.repeat(np.arange(n_slices, dtype=INDEX_DTYPE), slice_len)
    lane_rows = np.full(n_slices * C, m, dtype=INDEX_DTYPE)
    lane_rows[:m] = perm.astype(INDEX_DTYPE)   # (slice s, lane c) ↦ perm[s*C+c]
    return F.SellCS(
        data=_t(vals), cols=_t(cols), perm=_t(perm.astype(INDEX_DTYPE)),
        slice_of_col=_t(slice_of_col), lane_rows=_t(lane_rows),
        shape=(csr.m, csr.n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded,
        C=C, sigma=sigma, n_slices=n_slices, total_width=total_width)


def build_bsr(csr: HostCSR, br: int = 8, bc: int = 128, dtype=torch.float32,
              block_align: int = 8) -> F.BSR:
    """Blocked rows: every (br × bc) tile holding ≥ 1 nonzero is stored
    dense. Refuses (``BSRBuildError``) where the blocks would take more
    than 16× CSR's bytes and more than 64 MiB."""
    mb = (csr.m + br - 1) // br
    rows = _row_ids(csr, np.int64)
    bcol = csr.ja.astype(np.int64) // bc
    nbc = (csr.n + bc - 1) // bc
    key = (rows // br) * nbc + bcol
    uniq = np.unique(key)
    n_blocks = uniq.size
    block_of_nnz = np.searchsorted(uniq, key)
    nb_pad = max(round_up(max(n_blocks, 1), block_align), block_align)
    itemsize = _np_dtype(dtype).itemsize
    dense_bytes = nb_pad * br * bc * itemsize
    csr_bytes = max(csr.mem_footprint_bytes(itemsize), 1)
    if dense_bytes > 16 * csr_bytes and dense_bytes > 64 * 2**20:
        raise BSRBuildError(
            f"BSR fill too low: {csr.nnz / max(n_blocks * br * bc, 1):.4f} "
            f"({dense_bytes/2**20:.0f} MiB vs CSR {csr_bytes/2**20:.0f} MiB); "
            "use a gather-based format for this matrix")
    data = np.zeros((nb_pad, br, bc), dtype=_np_dtype(dtype))
    data[block_of_nnz, rows % br, csr.ja.astype(np.int64) - bcol * bc] = csr.a
    block_rows_np = (uniq // nbc).astype(INDEX_DTYPE)
    block_cols_np = (uniq % nbc).astype(INDEX_DTYPE)
    block_rowptr = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(block_rowptr, block_rows_np + 1, 1)
    np.cumsum(block_rowptr, out=block_rowptr)
    return F.BSR(
        data=_t(data),
        block_cols=_t(_pad1(block_cols_np, nb_pad, 0)),
        block_rowptr=_t(block_rowptr.astype(INDEX_DTYPE)),
        block_rows=_t(_pad1(block_rows_np, nb_pad, mb)),
        shape=(csr.m, csr.n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded,
        br=br, bc=bc, n_blocks=n_blocks)


def build_dia(csr: HostCSR, dtype=torch.float32, max_diags: int = 512) -> F.DIA:
    rows = _row_ids(csr, np.int64)
    offs = csr.ja.astype(np.int64) - rows
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        raise DIABuildError(
            f"matrix has {uniq.size} distinct diagonals (> {max_diags}); "
            "DIA is unsuitable")
    data = np.zeros((max(uniq.size, 1), csr.m), dtype=_np_dtype(dtype))
    data[np.searchsorted(uniq, offs), rows] = csr.a
    return F.DIA(data=_t(data), shape=(csr.m, csr.n), nnz=csr.nnz,
                 nnz_expanded=csr.nnz_expanded,
                 offsets=tuple(int(o) for o in uniq))


def build_ldu(csr: HostCSR, dtype=torch.float32, face_align: int = 1024) -> F.LDU:
    """Split a square matrix into its diagonal and strictly lower/upper
    face pairs. Needs a structurally symmetric off-diagonal pattern
    (OpenFOAM meshes guarantee it); anything else raises
    ``LDUBuildError``."""
    if csr.m != csr.n:
        raise LDUBuildError("LDU requires square matrix")
    rows = _row_ids(csr, np.int64)
    cols = csr.ja.astype(np.int64)
    vals = csr.a
    diag = np.zeros(csr.m, dtype=_np_dtype(dtype))
    dmask = rows == cols
    diag[rows[dmask]] = vals[dmask]
    upper_mask = rows < cols
    lower_mask = rows > cols
    # faces keyed by their (min, max) pair
    uo, un, uv = rows[upper_mask], cols[upper_mask], vals[upper_mask]
    lo_, ln_, lv = cols[lower_mask], rows[lower_mask], vals[lower_mask]
    ukey = uo * csr.n + un
    lkey = lo_ * csr.n + ln_
    uorder = np.argsort(ukey, kind="stable")
    lorder = np.argsort(lkey, kind="stable")
    if not np.array_equal(ukey[uorder], lkey[lorder]):
        raise LDUBuildError(
            "LDU requires structurally symmetric off-diagonal pattern")
    nf_pad = max(round_up(max(uo.size, 1), face_align), face_align)
    vdt = _np_dtype(dtype)
    return F.LDU(
        diag=_t(diag),
        lower=_t(_pad1(lv[lorder].astype(vdt), nf_pad, 0)),
        upper=_t(_pad1(uv[uorder].astype(vdt), nf_pad, 0)),
        owner=_t(_pad1(uo[uorder].astype(INDEX_DTYPE), nf_pad, 0)),
        neighbour=_t(_pad1(un[uorder].astype(INDEX_DTYPE), nf_pad, 0)),
        shape=(csr.m, csr.n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded)


def build_csc(csr: HostCSR, dtype=torch.float32, nnz_align: int = 1024) -> F.CSC:
    """Column-major (CSC) device format via a host-side transpose sort."""
    rows = _row_ids(csr, np.int64)
    order = np.lexsort((rows, csr.ja))
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.CSC(
        data=_t(_pad1(csr.a[order].astype(_np_dtype(dtype)), nnz_pad, 0)),
        rows=_t(_pad1(rows[order].astype(INDEX_DTYPE), nnz_pad, csr.m)),
        cols=_t(_pad1(csr.ja[order].astype(INDEX_DTYPE), nnz_pad, 0)),
        shape=(csr.m, csr.n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded)


def build_csr_sym(csr: HostCSR, dtype=torch.float32,
                  nnz_align: int = 1024) -> F.CSRSym:
    """Symmetric format from lower-triangle-stored CSR, or from any CSR
    that is numerically symmetric (its upper triangle dropped first);
    anything else raises ``CSRSymBuildError``."""
    if csr.m != csr.n:
        raise CSRSymBuildError("CSR_SYM requires a square (symmetric) matrix")
    if not csr.symmetric_storage:
        sp = csr.to_scipy()
        asym = abs(sp - sp.T)
        if asym.nnz and asym.max() > 1e-12 * max(abs(sp).max(), 1e-300):
            raise CSRSymBuildError(
                "CSR_SYM requires a numerically symmetric matrix")
        csr = csr_drop_upper(csr)
    nnz_pad = max(round_up(csr.nnz, nnz_align), nnz_align)
    return F.CSRSym(
        data=_t(_pad1(csr.a.astype(_np_dtype(dtype)), nnz_pad, 0)),
        rows=_t(_pad1(_row_ids(csr), nnz_pad, csr.m)),
        cols=_t(_pad1(csr.ja.astype(INDEX_DTYPE), nnz_pad, 0)),
        shape=(csr.m, csr.n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded)
