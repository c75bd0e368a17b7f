"""RSPLIT: long rows split into sub-rows, then a combine of their partials.

Counterpart of ``spmv_research_tpu/ops/rowsplit.py``. Rows longer than a
threshold are cut at build time into sub-rows of at most T nnz; the inner
program (any CLOSG program: ``ClosG``, ``ClosGChunked`` or ``ClosGX``) runs
on the split matrix, whose bounded row length keeps the y extraction
windowed and the scan short, and a combine adds each heavy row's sub-row
partials into its y.

Layout: rows ``0..m-1`` of the split matrix are the original rows (heavy
rows keep their first T nnz in place); the extra sub-rows follow at ``m..``,
grouped per heavy row in row order and padded with empty sub-rows to a
multiple of 128 per heavy row, then one all-empty 128-row block (the
combine's gather target). The inner matrix has ``m + E + 128`` rows, so its
y is longer than m.

The combine is plain PyTorch (it was XLA in the JAX package, not a Pallas
kernel): a gather of whole 128-partial blocks, a sum per heavy row, and an
``index_add_`` on the heavy rows, which are unique, so it is deterministic.
Partials of different rows never mix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import INDEX_DTYPE, HostCSR
from . import dispatch
from .dispatch import register_spmm_column_loop, register_spmv

DEFAULT_T = 256
_PB = 128     # extras padded per heavy row to a multiple of this


def split_long_rows(csr: HostCSR, T: int = DEFAULT_T,
                    threshold: int | None = None):
    """Cut every row longer than ``threshold`` (default: T) into sub-rows
    of ≤ T nnz.

    Returns ``(csr2, heavy_rows, seg_ptr)`` — or ``(csr, None, None)`` when
    no row exceeds the threshold. ``csr2`` has ``m + E + 128`` rows: the
    originals first (heavy rows truncated to their first T nnz), then per
    heavy row its extra sub-rows padded with empty rows to a multiple of
    128, then one all-empty 128-row block (combine gather target).
    ``seg_ptr[i]:seg_ptr[i+1]`` is heavy row i's (padded) extra range.
    """
    lengths = csr.row_lengths().astype(np.int64)
    heavy = np.flatnonzero(lengths > (T if threshold is None else threshold))
    if heavy.size == 0:
        return csr, None, None
    ia = csr.ia.astype(np.int64)
    m = csr.m
    l2 = lengths.copy()                              # new first-part lengths
    # only split rows truncate; a row no longer than T (possible when the
    # threshold is below T) keeps its length, where the JAX package would
    # give it T nnz and read into the next rows
    l2[heavy] = np.minimum(lengths[heavy], T)
    extra_parts = (lengths[heavy] - 1) // T          # live extras, ≥ 1 each
    padded = ((extra_parts + _PB - 1) // _PB) * _PB
    seg_ptr = np.zeros(heavy.size + 1, np.int64)
    np.cumsum(padded, out=seg_ptr[1:])
    E = int(seg_ptr[-1])

    # per-extra-sub-row (start, len) in the ORIGINAL nnz space; padding
    # sub-rows get length 0
    slot_of = np.repeat(np.arange(heavy.size), padded)
    rank = np.arange(E) - seg_ptr[slot_of]           # 0-based extra index
    live = rank < extra_parts[slot_of]
    ex_start = np.where(live, ia[heavy][slot_of] + (rank + 1) * T, 0)
    ex_len = np.where(
        live, np.minimum(lengths[heavy][slot_of] - (rank + 1) * T, T), 0)

    ia2 = np.zeros(m + E + _PB + 1, np.int64)
    ia2[1:m + 1] = np.cumsum(l2)
    ia2[m + 1:m + E + 1] = ia2[m] + np.cumsum(ex_len)
    ia2[m + E + 1:] = ia2[m + E]                     # trailing empty block

    # gather map: new nnz order -> old nnz order
    total = int(ia2[-1])
    starts_new = ia2[:-1]
    starts_old = np.concatenate(
        [ia[:-1], ex_start, np.zeros(_PB, np.int64)])
    lens_all = np.concatenate([l2, ex_len, np.zeros(_PB, np.int64)])
    nz = lens_all > 0
    row_of = np.repeat(np.arange(m + E + _PB)[nz], lens_all[nz])
    pos = np.arange(total) - starts_new[row_of]
    gmap = starts_old[row_of] + pos

    csr2 = HostCSR(a=csr.a[gmap], ia=ia2.astype(INDEX_DTYPE),
                   ja=csr.ja[gmap], m=m + E + _PB, n=csr.n,
                   nnz_expanded=csr.nnz_expanded)
    return csr2, heavy.astype(np.int64), seg_ptr


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """Wrapper format (field for field the JAX ``RowSplit``): ``inner``
    computes the split matrix's y; the combine gathers each heavy row's
    padded 128-partial blocks and sums them into its y."""

    inner: Any                 # a CLOSG program of m + n_extra + 128 rows
    heavy_rows: torch.Tensor   # (H,) int32 original row of each heavy row
    gidx: torch.Tensor         # (H, kmax) int32 128-block ids into the extras
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    n_extra: int               # padded extra sub-rows (excl. the zero block)

    format_name = "RSPLIT"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.heavy_rows.device

    @property
    def inner_format(self) -> str:
        return self.inner.format_name

    def to(self, device) -> "RowSplit":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return (self.inner.mem_footprint_bytes()
                + self.heavy_rows.numel() * 4 + self.gidx.numel() * 4)


def wrap_row_split(inner, csr_shape, nnz, nnz_expanded, heavy_rows,
                   seg_ptr) -> RowSplit:
    """Assemble the wrapper. ``seg_ptr`` entries are multiples of 128; the
    per-row gather rows point into extras2d = y[m:].reshape(-1,128), short
    rows padded with the final all-zero block."""
    H = heavy_rows.size
    E = int(seg_ptr[-1])
    blocks = (seg_ptr[1:] - seg_ptr[:-1]) // _PB
    kmax = max(int(blocks.max()), 1)
    zero_block = E // _PB                            # the trailing empty block
    gidx = np.full((H, kmax), zero_block, np.int64)
    for i in range(H):
        b0 = seg_ptr[i] // _PB
        gidx[i, : blocks[i]] = np.arange(b0, b0 + blocks[i])
    return RowSplit(inner=inner,
                    heavy_rows=torch.from_numpy(heavy_rows.astype(np.int32)),
                    gidx=torch.from_numpy(gidx.astype(np.int32)),
                    shape=tuple(csr_shape), nnz=nnz,
                    nnz_expanded=nnz_expanded, n_extra=E)


def rowsplit_from_jax(leaves: dict, meta: dict, inner) -> RowSplit:
    """The port's ``RowSplit`` for one built by the JAX package: ``leaves``
    holds ``heavy_rows`` and ``gidx`` (numpy), ``meta`` the meta fields, and
    ``inner`` the port's copy of the inner program (``from_jax_program``,
    a ``ClosGChunked`` of those, or ``closgx_from_jax``)."""
    return RowSplit(inner=inner,
                    heavy_rows=torch.from_numpy(
                        np.array(leaves["heavy_rows"], np.int32)),
                    gidx=torch.from_numpy(np.array(leaves["gidx"], np.int32)),
                    shape=tuple(meta["shape"]), nnz=meta["nnz"],
                    nnz_expanded=meta["nnz_expanded"],
                    n_extra=meta["n_extra"])


def _combine(A: RowSplit, y2: torch.Tensor) -> torch.Tensor:
    m = A.shape[0]
    ex2 = y2[m:].view(-1, _PB)                       # (E/128 + 1, 128)
    seg = ex2[A.gidx.long()].sum(dim=(1, 2))
    return y2[:m].index_add(0, A.heavy_rows.long(), seg)


@register_spmv("RSPLIT", "torch")
def spmv_rowsplit_torch(A: RowSplit, x: torch.Tensor) -> torch.Tensor:
    """RSPLIT in plain PyTorch: the inner format's ``torch`` impl."""
    return _combine(A, dispatch.spmv(A.inner, x, impl="torch"))


@register_spmv("RSPLIT", "cuda")
def spmv_rowsplit_cuda(A: RowSplit, x: torch.Tensor) -> torch.Tensor:
    """RSPLIT through the inner format's ``cuda`` impl (its kernels)."""
    return _combine(A, dispatch.spmv(A.inner, x, impl="cuda"))


# SpMM: one SpMV per column of X, for both impls (the JAX lax.scan)
register_spmm_column_loop("RSPLIT")


def execute_rowsplit_numpy(A: RowSplit, y2: np.ndarray) -> np.ndarray:
    """float64 host reference of the combine (program semantics)."""
    m = A.shape[0]
    ex2 = np.asarray(y2)[m:].reshape(-1, _PB)
    seg = ex2[A.gidx.cpu().numpy()].sum(axis=(1, 2))
    y = np.asarray(y2)[:m].astype(np.float64)
    np.add.at(y, A.heavy_rows.cpu().numpy(), seg)
    return y
