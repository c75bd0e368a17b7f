"""Row-gather SpMM (SELLG) and SDDMM (``CSR/gather``).

Counterpart of ``spmv_research_tpu/ops/gatherk.py``. Every nonzero of an
SpMM or SDDMM consumes a K-wide dense row, so both are row gathers:

* **SpMM** (``SELLG``): rows sorted by length into power-of-two width
  classes; a class is a padded (m_c, w) slab of column ids and one of
  values, and its w steps are ``Y_c += val[:, j] · Xp[idx[:, j]]``, one row
  gather and one multiply-add a step, never a (m_c, w, K) plane. Padding
  points at an appended zero row of X. The classes' rows are put back in
  order with one final row gather.
* **SDDMM** (plain CSR): ``C[j] = A[rows[j]] · B[cols[j]]``, two (nnz, K)
  row gathers and a lane sum, in chunks of 2^17 nonzeros to bound the
  intermediate.

The JAX package computes both in XLA, so they are plain PyTorch on every
device: SELLG is in ``dispatch.PLAIN_FORMATS`` and the SDDMM is CSR's
``gather`` impl, beside ``torch``. ``width_classes`` and ``slab_fill`` are
BSRG's class split too (``ops/bsr_mxu.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..convert.build import _np_dtype, _t
from ..core import formats as F
from ..core.formats import _Format
from ..core.host import HostCSR
from .dispatch import register_sddmm, register_spmm


@dataclasses.dataclass(frozen=True)
class SellG(_Format):
    """Width-classed gather slabs for SpMM.

    ``idx``/``val`` map each class width w to its (m_w, w) slab;
    ``inv_perm[r]`` is the position of output row r in the classes'
    concatenation. Padding entries: idx = n (the appended zero row of X),
    val = 0.
    """

    idx: Dict[int, torch.Tensor]
    val: Dict[int, torch.Tensor]
    inv_perm: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    widths: Tuple[int, ...]
    counts: Tuple[int, ...]

    format_name = "SELLG"
    data_fields = ("inv_perm", "idx", "val")
    meta_fields = ("shape", "nnz", "nnz_expanded", "widths", "counts")

    def mem_footprint_bytes(self) -> int:
        tot = sum(a.numel() for a in self.idx.values())
        return tot * (4 + self.inv_perm.element_size()) + self.m * 4


def width_classes(lengths: np.ndarray):
    """Rows sorted by length (stable) into power-of-two width classes:
    (inv_perm, [(w, the class's rows in order)]); a class holds the rows of
    length in (w/2, w], the first class also the empty rows (w ≥ 1)."""
    order = np.argsort(lengths, kind="stable")
    inv_perm = np.empty(lengths.size, np.int32)
    inv_perm[order] = np.arange(lengths.size, dtype=np.int32)
    Ls = lengths[order]
    classes, lo = [], 0
    while lo < lengths.size:
        w = max(1, 1 << int(max(int(Ls[lo]), 1) - 1).bit_length())
        hi = max(int(np.searchsorted(Ls, w, side="right")), lo + 1)
        classes.append((w, order[lo:hi]))
        lo = hi
    return inv_perm, classes


def slab_fill(ptr: np.ndarray, rows_c: np.ndarray):
    """(slab row, slab column, source entry) of every stored entry of the
    rows ``rows_c``, whose entries are ``ptr[r]:ptr[r + 1]``."""
    lens = (ptr[rows_c + 1] - ptr[rows_c]).astype(np.int64)
    t = np.repeat(np.arange(rows_c.size), lens)
    j = np.arange(t.size) - np.repeat(np.cumsum(lens) - lens, lens)
    return t, j, np.repeat(ptr[rows_c].astype(np.int64), lens) + j


def build_sellg(csr: HostCSR, dtype=torch.float32) -> SellG:
    dt = _np_dtype(dtype)
    inv_perm, classes = width_classes(csr.row_lengths())
    idx, val = {}, {}
    for w, rows_c in classes:
        ic = np.full((rows_c.size, w), csr.n, np.int32)
        vc = np.zeros((rows_c.size, w), dt)
        t, j, src = slab_fill(csr.ia, rows_c)
        ic[t, j] = csr.ja[src]
        vc[t, j] = csr.a[src].astype(dt)
        idx[w], val[w] = _t(ic), _t(vc)
    return SellG(idx=idx, val=val, inv_perm=_t(inv_perm),
                 shape=(csr.m, csr.n), nnz=csr.nnz,
                 nnz_expanded=csr.nnz_expanded,
                 widths=tuple(w for w, _ in classes),
                 counts=tuple(r.size for _, r in classes))


@register_spmm("SELLG", "torch")
def spmm_sellg(A: SellG, X: torch.Tensor) -> torch.Tensor:
    """Per class, w steps of ``Y += v · Xp[idx[:, j]]`` (JAX's order, one
    ``addcmul_`` a step); the slabs are transposed once a call so that each
    step reads a contiguous column."""
    Xp = TF.pad(X, (0, 0, 0, 1))
    outs = []
    for w in A.widths:
        ict, vct = A.idx[w].t().contiguous(), A.val[w].t().contiguous()
        Y = X.new_zeros((ict.shape[1], X.shape[1]))
        for j in range(w):
            Y.addcmul_(vct[j, :, None].to(X.dtype),
                       Xp.index_select(0, ict[j]))
        outs.append(Y)
    return torch.cat(outs).index_select(0, A.inv_perm)


@register_sddmm("CSR", "gather")
def sddmm_csr_gather(S: F.CSR, A: torch.Tensor, B: torch.Tensor,
                     chunk: int = 1 << 17) -> torch.Tensor:
    """C[j] = A[rows[j]] · B[cols[j]] by chunked row gathers; padding
    entries (row m) read an appended zero row of A."""
    Ap = TF.pad(A, (0, 0, 0, 1))
    rows = S.rows.clamp(max=A.shape[0])
    return torch.cat([
        (Ap.index_select(0, rows[i:i + chunk])
         * B.index_select(0, S.indices[i:i + chunk])).sum(dim=1)
        for i in range(0, rows.shape[0], chunk)])
