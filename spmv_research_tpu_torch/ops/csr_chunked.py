"""Chunked CSR: the JAX package's crash-safe CSR baseline, CSR/torchc.

Counterpart of ``spmv_research_tpu/ops/csr_chunked.py``. The JAX package's
plain ``CSR/xla`` faulted its TPU worker past ~20M nnz, so it bounds every
device op: the nnz stream is cut into uniform ``B``-element blocks
(merge-path style nnz balancing), stacked on a leading block axis, and run
as one ``lax.scan``:

  per block:  prod = data * x[cols]            (B-gather)
              part = segment sum over the block's row ids   (R + 1 bins,
                                               the last one the padding's)
              y[row0 : row0 + R] += part       (contiguous add, no scatter)

``R`` = the most rows any block spans (host-computed, rounded up to 8).
Rows crossing a block boundary accumulate across blocks in y. Storage is
CSR (values + column ids + row ids); the block table adds O(C) ints.

The port runs the scan as a Python loop over the blocks, in plain PyTorch
on every device (XLA, not Pallas, in the JAX package); the SpMM is a loop
of SpMVs over X's columns, as JAX's scan. The impl is ``torchc`` (JAX's
``xlac``: the port's ``torch`` is JAX's ``xla``), registered for format
``CSR``, so the rows read as the CSR baseline they are; a plain ``CSR``
has no ``torchc`` and the sweep never runs it (``harness/sweep.py:
sweep_impls``). Name the impl: the default for ``CSR`` is ``torch``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _Format
from ..core.host import HostCSR
from .dispatch import register_spmm, register_spmv, spmm_column_loop
from .reference import _segment_sum


@dataclasses.dataclass(frozen=True)
class CSRChunked(_Format):
    """CSR split into uniform nnz blocks (leading axis = block)."""

    data: torch.Tensor      # (C, B) values; padding 0
    cols: torch.Tensor      # (C, B) int32 column ids; padding 0
    lrow: torch.Tensor      # (C, B) int32 row - row0[c], sorted; padding R
    row0: torch.Tensor      # (C,) int32 first row of each block
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    R: int                  # max rows spanned by one block

    format_name = "CSR"
    data_fields = ("data", "cols", "lrow", "row0")
    meta_fields = ("shape", "nnz", "nnz_expanded", "R")

    def mem_footprint_bytes(self) -> int:
        """Reference CSR footprint model (spmv_kernel.h:21-24): the chunk
        table is metadata, the stream is values + indices + row ptr."""
        vb = self.data.element_size()
        return self.nnz * (vb + 4) + (self.m + 1) * 4

    @functools.cached_property
    def row0_host(self) -> Tuple[int, ...]:
        """``row0`` as host ints, read once: each block's add into y slices
        at a host offset, so no SpMV waits on the device for it."""
        return tuple(self.row0.tolist())


def build_csr_chunked(host: HostCSR, dtype=np.float32,
                      block: int = 1 << 21) -> CSRChunked:
    """The JAX package's ``build_csr_chunked`` arrays: blocks of
    B = min(block, max(1024, nnz)) nonzeros, the last one padded (value 0,
    column 0, local row R)."""
    m = host.m
    nnz = host.nnz
    B = min(block, max(1 << 10, nnz))
    C = (nnz + B - 1) // B
    rows = np.repeat(np.arange(m, dtype=np.int32), host.row_lengths())

    row0 = rows[np.arange(C, dtype=np.int64) * B]
    last = rows[np.minimum((np.arange(C, dtype=np.int64) + 1) * B, nnz) - 1]
    R = int((last - row0 + 1).max()) if C else 1
    R = (R + 7) // 8 * 8

    pad = C * B - nnz
    data = np.pad(host.a.astype(np.dtype(dtype)), (0, pad))
    cols = np.pad(host.ja.astype(np.int32), (0, pad))
    lrow = np.pad(rows, (0, pad), constant_values=0)
    lrow = lrow.reshape(C, B) - row0[:, None]
    if pad:  # padding lands in the sliced-off overflow segment R
        lrow[-1, B - pad:] = R
    return CSRChunked(
        data=torch.from_numpy(data.reshape(C, B)),
        cols=torch.from_numpy(cols.reshape(C, B)),
        lrow=torch.from_numpy(lrow.astype(np.int32)),
        row0=torch.from_numpy(row0.astype(np.int32)),
        shape=(m, host.n), nnz=nnz, nnz_expanded=host.nnz_expanded, R=R)


@register_spmv("CSR", "torchc")
def spmv_csr_chunked(A: CSRChunked, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, one block at a time: gather-multiply, a segment sum into
    R + 1 bins, an add into y[row0 : row0 + R].

    The last block's padding (value 0, bin R, which is sliced off) is not
    summed: JAX's sorted segment sum takes it for free, but on a card its
    entries would all meet one atomic address in ``index_add_`` (647,382
    of them on the shipsec1 twin at blocks of 2^21, where a SpMV took
    1.41 ms with them and 0.28 ms without on an H100, ``chip_smoke.py``
    phase 19). y is the same."""
    R, B = A.R, A.data.shape[1]
    xp = x.to(A.data.dtype)
    y = torch.zeros(A.m + R, dtype=A.data.dtype, device=A.data.device)
    for c, row0 in enumerate(A.row0_host):
        live = min(B, A.nnz - c * B)
        prod = A.data[c, :live] * xp.index_select(0, A.cols[c, :live])
        y[row0: row0 + R].add_(_segment_sum(prod, A.lrow[c, :live],
                                            R + 1)[:R])
    return y[: A.m]


@register_spmm("CSR", "torchc")
def spmm_csr_chunked(A: CSRChunked, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, one chunked SpMV per column of X (JAX's scan over them)."""
    return spmm_column_loop(A, X, "torchc")
