"""Plain PyTorch sparse ops — the portable baseline implementations.

Counterpart of ``spmv_research_tpu/ops/reference.py``; CSR SpMV, SpMM and
SDDMM are ported so far. The JAX package computes them in XLA, outside
Pallas, so plain PyTorch is their faithful port, and they stay the speedup
baselines of their workloads (the role of the reference's "Naive_CSR_CPU"
kernel, ``spmv_kernels/csr.cpp:334-350``, and of its SDDMM dot loops,
``sddmm_kernels/csr.cpp:109-135``). ``CSR/sparse`` is the JAX package's
``CSR/bcoo``: the vendor library's SpMV through the same registry.
"""

from __future__ import annotations

import torch

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
