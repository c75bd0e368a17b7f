"""BSRG — width-classed block slabs (SpMV and SpMM with no scatter) — and
the block-dense ``BSR/mxu`` SDDMM.

Counterpart of ``spmv_research_tpu/ops/bsr_mxu.py``. BSRG takes SELLG's
width classes one level up: block rows sorted by block count into
power-of-two classes, a class a (mc, w) slab of block-column ids and a
(mc, w, br, bc) slab of values (padding points at an appended zero block
of X), each class one batched product ``einsum("mwrc,mwck->mrk")`` over
its gathered X blocks, and the block rows put back in order with one row
gather. The SDDMM needs no extraction: ``C_blk = A_blk · B_blkᵀ`` over the
stored blocks is the BSR value layout, masked to the stored pattern.

The JAX package computes them in XLA, outside any Pallas kernel, so they
are plain PyTorch on every device (BSRG in ``dispatch.PLAIN_FORMATS``, the
SDDMM BSR's ``mxu`` impl); the products run in full float32
(``reference.check_full_fp32``). A class's gathered X blocks are cut into
pieces of at most ``GATHER_ELEMS`` elements, which bounds the plane at a
large K and changes no sum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ..convert.build import _np_dtype, _t, build_bsr
from ..core import formats as F
from ..core.formats import _Format
from ..core.host import HostCSR
from .dispatch import register_sddmm, register_spmm, register_spmv
from .gatherk import slab_fill, width_classes
from .reference import check_full_fp32

GATHER_ELEMS = 1 << 28   # elements of gathered X blocks a product at most


@dataclasses.dataclass(frozen=True)
class BsrG(_Format):
    """Width-classed BSR slabs (dicts keyed by class width w)."""

    idx: Dict[int, torch.Tensor]   # (mc, w) int32 block-col ids (pad = nb_x)
    val: Dict[int, torch.Tensor]   # (mc, w, br, bc)
    inv_perm: torch.Tensor         # (mb,) position of block row i in sort
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    br: int
    bc: int
    n_blocks: int
    widths: Tuple[int, ...]

    format_name = "BSRG"
    data_fields = ("inv_perm", "idx", "val")
    meta_fields = ("shape", "nnz", "nnz_expanded", "br", "bc", "n_blocks",
                   "widths")

    def mem_footprint_bytes(self) -> int:
        vb = (next(iter(self.val.values())).element_size() if self.val
              else 4)
        slots = sum(a.numel() for a in self.idx.values())
        return (slots * (4 + self.br * self.bc * vb)
                + self.inv_perm.numel() * 4)


def build_bsrg(csr: HostCSR, br: int = 8, bc: int = 128,
               dtype=torch.float32) -> BsrG:
    """Width-classed slabs of the BSR conversion (its fill guard raises
    ``BSRBuildError``)."""
    bsr = build_bsr(csr, br=br, bc=bc, dtype=dtype)
    mb = (csr.m + br - 1) // br
    rowptr = bsr.block_rowptr.numpy()[: mb + 1]
    inv_perm, classes = width_classes(np.diff(rowptr))
    nb_x = (csr.n + bc - 1) // bc            # the appended zero X block
    data, bcols = bsr.data.numpy(), bsr.block_cols.numpy()
    idx, val = {}, {}
    for w, rows_c in classes:
        ic = np.full((rows_c.size, w), nb_x, np.int32)
        vc = np.zeros((rows_c.size, w, br, bc), _np_dtype(dtype))
        t, j, src = slab_fill(rowptr, rows_c)
        ic[t, j] = bcols[src]
        vc[t, j] = data[src]
        idx[w], val[w] = _t(ic), _t(vc)
    return BsrG(idx=idx, val=val, inv_perm=_t(inv_perm),
                shape=(csr.m, csr.n), nnz=csr.nnz,
                nnz_expanded=csr.nnz_expanded, br=br, bc=bc,
                n_blocks=bsr.n_blocks, widths=tuple(w for w, _ in classes))


def _x_blocks(A: BsrG, X: torch.Tensor) -> torch.Tensor:
    """(nb_x + 1, bc, k) dense blocks of X with a trailing zero block."""
    nb_x = (A.n + A.bc - 1) // A.bc
    Xp = TF.pad(X, (0, 0, 0, (nb_x + 1) * A.bc - A.n))
    return Xp.view(nb_x + 1, A.bc, X.shape[1])


@register_spmm("BSRG", "torch")
def spmm_bsrg(A: BsrG, X: torch.Tensor) -> torch.Tensor:
    check_full_fp32(X, "BSRG")
    k = X.shape[1]
    xb = _x_blocks(A, X)
    outs = []
    for w in A.widths:
        ic, vc = A.idx[w], A.val[w].to(X.dtype)
        step = max(1, GATHER_ELEMS // (w * A.bc * k))
        for i in range(0, ic.shape[0], step):
            ig = ic[i:i + step]
            xg = xb.index_select(0, ig.reshape(-1)).view(*ig.shape, A.bc, k)
            outs.append(torch.einsum("mwrc,mwck->mrk", vc[i:i + step], xg))
    Yb = torch.cat(outs).index_select(0, A.inv_perm)      # (mb, br, k)
    return Yb.reshape(-1, k)[: A.m]


@register_spmv("BSRG", "torch")
def spmv_bsrg(A: BsrG, x: torch.Tensor) -> torch.Tensor:
    return spmm_bsrg(A, x[:, None])[:, 0]


@register_sddmm("BSR", "mxu")
def sddmm_bsr_mxu(S: F.BSR, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C_blk = A_blk · B_blkᵀ per stored block, one batched product: the
    (n_blocks_pad · br · bc,) values aligned with ``S.data``, 0 outside the
    stored pattern (``data != 0``) and on the padding blocks."""
    check_full_fp32(A, "BSR")
    br, bc, k = S.br, S.bc, A.shape[1]
    mb = (S.m + br - 1) // br
    nb_x = (S.n + bc - 1) // bc
    Ap = TF.pad(A, (0, 0, 0, mb * br - S.m)).view(mb, br, k)
    Bp = TF.pad(B, (0, 0, 0, nb_x * bc - S.n)).view(nb_x, bc, k)
    Ag = Ap.index_select(0, S.block_rows.clamp(max=mb - 1))
    Bg = Bp.index_select(0, S.block_cols.clamp(max=nb_x - 1))
    C = torch.bmm(Ag, Bg.transpose(1, 2))                  # (nb, br, bc)
    mask = (S.data != 0) & (S.block_rows < mb)[:, None, None]
    return torch.where(mask, C, 0.0).reshape(-1)


def bsr_sddmm_to_csr_values(S: F.BSR, C: torch.Tensor,
                            host: HostCSR) -> np.ndarray:
    """The per-nnz values, in CSR order (float64), of ``sddmm_bsr_mxu``'s
    block layout, for validation: each entry's block is found among the
    stored blocks, which the builder sorts by (block row, block column)."""
    rows = np.repeat(np.arange(host.m, dtype=np.int64), host.row_lengths())
    cols = host.ja.astype(np.int64)
    nbc = (S.n + S.bc - 1) // S.bc
    keys = (S.block_rows[: S.n_blocks].cpu().numpy().astype(np.int64) * nbc
            + S.block_cols[: S.n_blocks].cpu().numpy())
    b = np.searchsorted(keys, (rows // S.br) * nbc + cols // S.bc)
    flat = (b * S.br + rows % S.br) * S.bc + cols % S.bc
    return C.double().cpu().numpy()[flat]
