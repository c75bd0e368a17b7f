"""Kernel registry and dispatch.

Counterpart of ``spmv_research_tpu/ops/dispatch.py``: every (format,
workload) pair maps to a named set of implementations chosen at call time,
for the workloads SpMV, SpMM and SDDMM. The port has three impl names:

* ``"cuda"`` — the hand-written kernels (``ops/*_cuda.py``);
* ``"torch"`` — the plain PyTorch versions;
* ``"sparse"`` — CSR's SpMV through ``torch.sparse_csr_tensor`` (cuSPARSE
  on the card), the library baseline of the JAX package's ``"bcoo"``; it
  is never a default.

With no ``impl=`` given, ``default_impl`` decides from the input tensor's
device: a CPU tensor takes ``"torch"``; a CUDA tensor takes ``"cuda"``,
except for the formats that have no hand kernel, which take ``"torch"`` on
every device (``TORCH_FORMATS``): those in ``LIBRARY_FORMATS``, CSR and
DENSE (library code in the JAX package too) and CSRDS, the double-single
CSR; and those in ``PLAIN_FORMATS``, the classic formats and the engines
SELLG, BSRG and CSR_LUT, which the JAX package computes only in XLA (its
``xla`` impls, ``ops/reference.py``, ``gatherk.py``, ``bsr_mxu.py`` and
``value_compress.py``). Two SDDMMs keep the JAX package's impl names:
CSR's ``gather`` and BSR's ``mxu``.
A format outside those sets with no ``"cuda"`` impl raises on a CUDA
tensor, and asking for ``"cuda"`` with a CPU tensor raises. There is no
other preference walk and no fallback.

The engines whose JAX SpMM is a scan of their SpMV over X's columns
(CLOSG, RSPLIT, CLOSGX, SELLR) register ``spmm_column_loop`` for both
impls: a Python loop over the columns, each through the format's SpMV of
the same impl.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

_SPMV: Dict[Tuple[str, str], Callable] = {}
_SPMM: Dict[Tuple[str, str], Callable] = {}
_SDDMM: Dict[Tuple[str, str], Callable] = {}
_TABLES = {"spmv": _SPMV, "spmm": _SPMM, "sddmm": _SDDMM}

# formats whose impls are library calls or plain PyTorch on every device:
# no hand kernel, by design (CSR, DENSE), or none in the JAX package (CSRDS)
LIBRARY_FORMATS = frozenset({"CSR", "DENSE", "CSRDS"})
# the classic formats and the XLA-only engines, plain PyTorch on every
# device: the JAX package computes them only in XLA
PLAIN_FORMATS = frozenset({"COO", "CSC", "ELL", "SELL-C-s", "BSR",
                           "Custom_DIA", "LDU", "CSR_SYM", "SELLG", "BSRG",
                           "CSR_LUT"})
TORCH_FORMATS = LIBRARY_FORMATS | PLAIN_FORMATS


def _make_register(table):
    def register(fmt: str, impl: str):
        def deco(fn):
            table[(fmt, impl)] = fn
            return fn
        return deco
    return register


register_spmv = _make_register(_SPMV)
register_spmm = _make_register(_SPMM)
register_sddmm = _make_register(_SDDMM)


def default_impl(fmt: str, device) -> str:
    """The impl a tensor on ``device`` takes when none is named."""
    if device.type == "cuda" and fmt not in TORCH_FORMATS:
        return "cuda"
    return "torch"


def _lookup(table, fmt: str, impl: Optional[str], device):
    if impl is None:
        impl = default_impl(fmt, device)
    elif impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl 'cuda' needs a CUDA tensor, got one on {device}")
    key = (fmt, impl)
    if key not in table:
        raise KeyError(
            f"no impl {impl!r} for format {fmt!r}; have "
            f"{sorted(i for f, i in table if f == fmt)}")
    return table[key]


def spmv(A, x, impl: Optional[str] = None):
    """y = A @ x."""
    return _lookup(_SPMV, A.format_name, impl, x.device)(A, x)


def spmm(A, X, impl: Optional[str] = None):
    """Y = A @ X (dense X of shape (n, k))."""
    return _lookup(_SPMM, A.format_name, impl, X.device)(A, X)


def sddmm(S, A, B, impl: Optional[str] = None):
    """Values of (A @ Bᵀ) ∘ pattern(S); A: (m, k), B: (n, k). The layout
    is the format's (CSR: per nnz; BTILE: its tile slab)."""
    return _lookup(_SDDMM, S.format_name, impl, A.device)(S, A, B)


def available_impls(workload: str, fmt: str):
    return sorted(i for f, i in _TABLES[workload] if f == fmt)


def register_spmm_column_loop(fmt: str) -> None:
    """Register ``spmm_column_loop`` as ``fmt``'s SpMM for both impls."""
    for impl in ("torch", "cuda"):
        register_spmm(fmt, impl)(
            lambda A, X, impl=impl: spmm_column_loop(A, X, impl))


def spmm_column_loop(A, X: torch.Tensor, impl: str) -> torch.Tensor:
    """Y = A @ X as one SpMV of impl ``impl`` per column of X (the JAX
    package's ``lax.scan`` over the columns)."""
    xt = X.t().contiguous()
    return torch.stack([spmv(A, xk, impl=impl) for xk in xt], dim=1)
