"""Kernel registry and dispatch.

Counterpart of ``spmv_research_tpu/ops/dispatch.py``: every (format,
workload) pair maps to a named set of implementations chosen at call time.
The port has two impl names:

* ``"cuda"`` — the hand-written kernels (``ops/clos_cuda.py``);
* ``"torch"`` — the plain PyTorch versions.

With no ``impl=`` given, ``default_impl`` decides from the input tensor's
device: a CPU tensor takes ``"torch"``; a CUDA tensor takes ``"cuda"``,
except for the formats in ``LIBRARY_FORMATS`` (CSR and DENSE, library code
in the JAX package too), which have only ``"torch"``. A format outside that
set with no ``"cuda"`` impl raises on a CUDA tensor, and asking for
``"cuda"`` with a CPU tensor raises. There is no other preference walk and
no fallback.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

_SPMV: Dict[Tuple[str, str], Callable] = {}

# formats computed by one library call on every device, by design
LIBRARY_FORMATS = frozenset({"CSR", "DENSE"})


def register_spmv(fmt: str, impl: str):
    def deco(fn):
        _SPMV[(fmt, impl)] = fn
        return fn
    return deco


def default_impl(fmt: str, device) -> str:
    """The impl a tensor on ``device`` takes when none is named."""
    if device.type == "cuda" and fmt not in LIBRARY_FORMATS:
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


def available_impls(workload: str, fmt: str):
    table = {"spmv": _SPMV}[workload]
    return sorted(i for f, i in table if f == fmt)
