"""Plain PyTorch sparse ops — the portable baseline implementations.

Counterpart of ``spmv_research_tpu/ops/reference.py``, every impl of it:
CSR SpMV, SpMM and SDDMM; SpMV of COO, ELL, SELL-C-σ, BSR, DIA, LDU, CSC
and CSR_SYM; SpMM of ELL, BSR, SELL-C-σ and COO; SDDMM of COO. The JAX
package computes them in XLA, outside Pallas, so plain PyTorch is their
faithful port, registered as ``torch`` on every device (``dispatch.
PLAIN_FORMATS``): gathers are ``index_select``, segment sums
``index_add_`` (atomics on a card, so a sum's order is not fixed from run
to run), the block products ``torch.bmm`` in full float32, and DIA keeps
the static loop over its offsets. CSR's stay the speedup baselines of
their workloads (the role of the reference's "Naive_CSR_CPU" kernel,
``spmv_kernels/csr.cpp:334-350``, and of its SDDMM dot loops,
``sddmm_kernels/csr.cpp:109-135``). ``CSR/sparse`` is the JAX package's
``CSR/bcoo``: the vendor library's SpMV through the same registry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..core import formats as F
from .dispatch import register_sddmm, register_spmm, register_spmv


@register_spmv("CSR", "torch")
def spmv_csr(A: F.CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via gather + ``index_add_`` (padding rows land in row m).

    On a CUDA tensor ``index_add_`` adds with atomics, so the order of a
    row's sum is not fixed from run to run."""
    prod = A.data * x.index_select(0, A.indices)
    y = torch.zeros(A.m + 1, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, A.rows, prod)[: A.m]


@register_spmv("CSR", "sparse")
def spmv_csr_sparse(A: F.CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through ``torch.sparse_csr_tensor`` — the "vendor library
    baseline" role of the reference's MKL/cuSPARSE adapters
    (``mkl_csr.cpp``, ``cusparse_csr.cu``) and of the JAX package's
    ``CSR/bcoo``: cuSPARSE's SpMV on the card, PyTorch's own CSR kernel on
    the CPU, on the format's ``sparse_csr`` view of its arrays (built
    once)."""
    return torch.mv(A.sparse_csr, x)


@register_spmm("CSR", "torch")
def spmm_csr(A: F.CSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (n, k): the SpMV's gather and ``index_add_``
    over rows of X."""
    prod = A.data[:, None] * X.index_select(0, A.indices)
    Y = prod.new_zeros((A.m + 1, X.shape[1]))
    return Y.index_add_(0, A.rows, prod)[: A.m]


@register_sddmm("CSR", "torch")
def sddmm_csr(S: F.CSR, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """C[j] = dot(A[row_j, :], B[col_j, :]) over the pattern of S, per nnz
    (nnz_pad,), 0 on the padding entries; A (m, k), B (n, k)."""
    a_rows = A.index_select(0, S.rows.clamp(max=S.m - 1))
    vals = (a_rows * B.index_select(0, S.indices)).sum(dim=-1)
    return torch.where(S.rows < S.m, vals, 0.0)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``vals`` by leading index ``seg`` into ``n`` rows (the JAX
    package's ``segment_sum``)."""
    return vals.new_zeros((n, *vals.shape[1:])).index_add_(0, seg, vals)


def check_full_fp32(X: torch.Tensor, fmt: str) -> None:
    """Refuse to run ``fmt``'s matrix products in TF32 on a card: the JAX
    package's ran in full float32."""
    if X.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{fmt} needs full float32 products: switch "
                           "torch.backends.cuda.matmul.allow_tf32 off")


# ------------------------------------------------------------------ COO / CSC

@register_spmv("COO", "torch")
def spmv_coo(A: F.COO, x: torch.Tensor) -> torch.Tensor:
    prod = A.data * x.index_select(0, A.cols)
    return _segment_sum(prod, A.rows, A.m + 1)[: A.m]


@register_spmm("COO", "torch")
def spmm_coo(A: F.COO, X: torch.Tensor) -> torch.Tensor:
    prod = A.data[:, None] * X.index_select(0, A.cols)
    return _segment_sum(prod, A.rows, A.m + 1)[: A.m]


@register_sddmm("COO", "torch")
def sddmm_coo(S: F.COO, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-nnz dots as CSR's SDDMM, on the COO triplets."""
    a_rows = A.index_select(0, S.rows.clamp(max=S.m - 1))
    vals = (a_rows * B.index_select(0, S.cols)).sum(dim=-1)
    return torch.where(S.rows < S.m, vals, 0.0)


@register_spmv("CSC", "torch")
def spmv_csc(A: F.CSC, x: torch.Tensor) -> torch.Tensor:
    """Column-major SpMV: per-column products scattered to their rows (the
    scatter role of the reference's CSC adapters)."""
    prod = A.data * x.index_select(0, A.cols)
    return _segment_sum(prod, A.rows, A.m + 1)[: A.m]


@register_spmv("CSR_SYM", "torch")
def spmv_csr_sym(A: F.CSRSym, x: torch.Tensor) -> torch.Tensor:
    """Symmetric SpMV from the stored lower triangle (reference
    ``csr_sym.cpp``): y += a·x[col] per stored entry, plus y[col] +=
    a·x[row] for the strict off-diagonals."""
    y = _segment_sum(A.data * x.index_select(0, A.cols), A.rows,
                     A.m + 1)[: A.m]
    x_rows = TF.pad(x, (0, 1)).index_select(0, A.rows)
    prod_t = torch.where(A.rows != A.cols, A.data * x_rows, 0.0)
    return y + _segment_sum(prod_t, A.cols, A.m)


# ------------------------------------------------------------------ ELL / SELL

@register_spmv("ELL", "torch")
def spmv_ell(A: F.ELL, x: torch.Tensor) -> torch.Tensor:
    gathered = x.index_select(0, A.cols.reshape(-1)).view(A.cols.shape)
    return (A.data * gathered).sum(dim=1)[: A.m]


@register_spmm("ELL", "torch")
def spmm_ell(A: F.ELL, X: torch.Tensor) -> torch.Tensor:
    """Each padded row's (1, width) values times its (width, k) gathered
    rows of X, one batched product."""
    check_full_fp32(X, "ELL")
    gathered = X.index_select(0, A.cols.reshape(-1)).view(
        *A.cols.shape, X.shape[1])                       # (m_pad, w, k)
    return torch.bmm(A.data.unsqueeze(1), gathered).squeeze(1)[: A.m]


@register_spmv("SELL-C-s", "torch")
def spmv_sellcs(A: F.SellCS, x: torch.Tensor) -> torch.Tensor:
    """Slab SpMV: the (C, W) slab times gathered x, slab columns summed by
    slice, then each (slice, lane) added to its output row."""
    contrib = A.data * x.index_select(0, A.cols.reshape(-1)).view(
        A.cols.shape)
    per_slice = _segment_sum(contrib.t(), A.slice_of_col, A.n_slices)
    return _segment_sum(per_slice.reshape(-1), A.lane_rows, A.m + 1)[: A.m]


@register_spmm("SELL-C-s", "torch")
def spmm_sellcs(A: F.SellCS, X: torch.Tensor) -> torch.Tensor:
    """Slab SpMM: rows of X gathered per slab column, summed per slice."""
    k = X.shape[1]
    gathered = X.index_select(0, A.cols.reshape(-1)).view(*A.cols.shape, k)
    contrib = A.data[..., None] * gathered               # (C, W, k)
    per_slice = _segment_sum(contrib.transpose(0, 1), A.slice_of_col,
                             A.n_slices)                 # (n_slices, C, k)
    return _segment_sum(per_slice.reshape(-1, k), A.lane_rows,
                        A.m + 1)[: A.m]


# ------------------------------------------------------------------ BSR / DIA / LDU

def _x_blocks(A: F.BSR, X: torch.Tensor) -> torch.Tensor:
    """X (n, k) padded to whole block columns and gathered per block:
    (n_blocks_pad, bc, k)."""
    nbc = (A.n + A.bc - 1) // A.bc
    xpad = TF.pad(X, (0, 0, 0, A.bc * nbc - A.n))
    return xpad.view(nbc, A.bc, -1).index_select(0, A.block_cols)


def _bsr_product(A: F.BSR, X: torch.Tensor) -> torch.Tensor:
    check_full_fp32(X, "BSR")
    yb = torch.bmm(A.data, _x_blocks(A, X))              # (nb, br, k)
    mb = (A.m + A.br - 1) // A.br
    Y = _segment_sum(yb, A.block_rows, mb + 1)
    return Y[:mb].reshape(mb * A.br, -1)[: A.m]


@register_spmv("BSR", "torch")
def spmv_bsr(A: F.BSR, x: torch.Tensor) -> torch.Tensor:
    """Per-block dense matvec + block-row segment sum."""
    return _bsr_product(A, x[:, None])[:, 0]


@register_spmm("BSR", "torch")
def spmm_bsr(A: F.BSR, X: torch.Tensor) -> torch.Tensor:
    return _bsr_product(A, X)


@register_spmv("Custom_DIA", "torch")
def spmv_dia(A: F.DIA, x: torch.Tensor) -> torch.Tensor:
    """Shifted axpys, one a diagonal, gather-free: y[i] += data[d, i] ·
    x[i + off_d] over the rows where i + off_d is a column."""
    y = A.data.new_zeros(A.m)
    for d, off in enumerate(A.offsets):
        lo, hi = max(0, -off), min(A.m, A.n - off)
        if hi > lo:
            y[lo:hi] += A.data[d, lo:hi] * x[lo + off: hi + off]
    return y


@register_spmv("LDU", "torch")
def spmv_ldu(A: F.LDU, x: torch.Tensor) -> torch.Tensor:
    y = A.diag * x[: A.m]
    y.index_add_(0, A.owner, A.upper * x.index_select(0, A.neighbour))
    return y.index_add_(0, A.neighbour, A.lower * x.index_select(0, A.owner))
