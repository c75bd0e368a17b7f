"""Value-compressed CSR (CSR_LUT) — the reference's value-compression theme.

Counterpart of ``spmv_research_tpu/ops/value_compress.py``: the values are
deduplicated into a LUT and the value array replaced by indices of the
narrowest dtype that holds the unique count (int8/int16/int32, the
reference's 1/2/3-byte choice — ``csr_lut_x86.cpp:102-104``), so a matrix
with few distinct values moves 1–2 bytes of value a nonzero. The builder
gives the JAX builder's arrays; the SpMV and SpMM rebuild the values as
``lut[val_idx]`` and reduce rows with the sorted segment sum of
``ops/reference.py``. The JAX package computes them in XLA, so they are
plain PyTorch on every device (``dispatch.PLAIN_FORMATS``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..convert.build import _np_dtype, _t
from ..core.formats import _Format
from ..core.host import INDEX_DTYPE, HostCSR
from .dispatch import register_spmm, register_spmv
from .reference import _segment_sum


@dataclasses.dataclass(frozen=True)
class CSRLUT(_Format):
    """Value-deduplicated CSR; padding slots index the LUT's trailing zero
    and row ``m`` (sliced off)."""

    lut: torch.Tensor      # (n_unique + 1,) distinct values, then a zero
    val_idx: torch.Tensor  # (nnz_pad,) int8/int16/int32 index into lut
    indices: torch.Tensor  # (nnz_pad,) int32 column ids
    rows: torch.Tensor     # (nnz_pad,) int32 row ids (sorted; pad = m)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    n_unique: int

    format_name = "CSR_LUT"
    data_fields = ("lut", "val_idx", "indices", "rows")
    meta_fields = ("shape", "nnz", "nnz_expanded", "n_unique")

    def mem_footprint_bytes(self) -> int:
        """LUT + narrow value indices + column ids + rowptr (the
        reference's accounting — ``csr_lut_x86.cpp:166``)."""
        return (self.n_unique * self.lut.element_size()
                + self.nnz * (self.val_idx.element_size() + 4)
                + (self.m + 1) * 4)


def build_csr_lut(csr: HostCSR, dtype=torch.float32,
                  nnz_align: int = 1024) -> CSRLUT:
    vals = csr.a.astype(_np_dtype(dtype))
    lut, inv = np.unique(vals, return_inverse=True)
    u = lut.size
    if u <= 127:
        idx_dtype = np.int8
    elif u <= 32767:
        idx_dtype = np.int16
    else:
        idx_dtype = np.int32
    nnz_pad = max(((csr.nnz + nnz_align - 1) // nnz_align) * nnz_align,
                  nnz_align)
    # the zero slot after the LUT, for the padding: it may not fit the dtype
    if u > np.iinfo(idx_dtype).max:
        idx_dtype = np.int32
    vi = np.full(nnz_pad, u, dtype=idx_dtype)
    vi[: csr.nnz] = inv.astype(idx_dtype)
    cols = np.zeros(nnz_pad, INDEX_DTYPE)
    cols[: csr.nnz] = csr.ja
    rows = np.full(nnz_pad, csr.m, INDEX_DTYPE)
    rows[: csr.nnz] = np.repeat(np.arange(csr.m, dtype=INDEX_DTYPE),
                                csr.row_lengths())
    return CSRLUT(lut=_t(np.concatenate([lut, np.zeros(1, lut.dtype)])),
                  val_idx=_t(vi), indices=_t(cols), rows=_t(rows),
                  shape=(csr.m, csr.n), nnz=csr.nnz,
                  nnz_expanded=csr.nnz_expanded, n_unique=int(u))


def _values(A: CSRLUT) -> torch.Tensor:
    return A.lut.index_select(0, A.val_idx.int())


@register_spmv("CSR_LUT", "torch")
def spmv_csr_lut(A: CSRLUT, x: torch.Tensor) -> torch.Tensor:
    prod = _values(A) * x.index_select(0, A.indices)
    return _segment_sum(prod, A.rows, A.m + 1)[: A.m]


@register_spmm("CSR_LUT", "torch")
def spmm_csr_lut(A: CSRLUT, X: torch.Tensor) -> torch.Tensor:
    prod = _values(A)[:, None] * X.index_select(0, A.indices)
    return _segment_sum(prod, A.rows, A.m + 1)[: A.m]
