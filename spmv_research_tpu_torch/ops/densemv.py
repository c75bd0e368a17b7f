"""DENSE fallback: a densified matvec for dense-row scattered matrices.

Counterpart of ``spmv_research_tpu/ops/densemv.py``. Matrices whose group
column windows are too wide for every gather engine and which have no
column locality (the human_gene1 / TSOPF_RS_b2383 / gupta3 class, density
≳ 1%) are densified, and the SpMV becomes a full-width matrix-vector
product that streams the plane at device-memory speed (SpMM: a
matrix-matrix product).

The product is ``torch.matmul`` (cuBLAS on a card): the JAX package left it
to XLA's ``jnp.dot`` outside any Pallas kernel (SpMV and SpMM), so a library product stands
here and no kernel is written. On a card it runs in full float32 (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32`` False); the impl refuses
to run with TF32 switched on.

The builder is budget-gated: it refuses a plane larger than ``max_bytes``
(6 GB, the JAX package's budget, so the same matrices are refused).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.formats import _move
from ..core.host import HostCSR
from .dispatch import register_spmm, register_spmv

_RB, _CB = 8, 128                       # fp32 tile multiples


class DenseBuildError(ValueError):
    """Matrix unsuitable for the dense fallback (plane over budget)."""


@dataclasses.dataclass(frozen=True)
class DenseMV:
    """Row-major dense plane, padded to (8, 128) fp32 tiles."""

    mat: torch.Tensor           # (m_pad, n_pad) float32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "DENSE"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mat.device

    def to(self, device) -> "DenseMV":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(self.mat.numel()) * self.mat.element_size()


def build_dense(host: HostCSR, max_bytes: int = 6 << 30) -> DenseMV:
    """The dense float32 plane of ``host``; duplicate (row, col) entries are
    summed, as the CSR gold sums them. Raises ``DenseBuildError`` past
    ``max_bytes``."""
    m, n = host.m, host.n
    mp = (m + _RB - 1) // _RB * _RB
    npad = (n + _CB - 1) // _CB * _CB
    need = mp * npad * 4
    if need > max_bytes:
        raise DenseBuildError(
            f"dense plane {need / 1e9:.1f} GB exceeds the "
            f"{max_bytes / 1e9:.1f} GB budget (m={m}, n={n})")
    dense = np.zeros((mp, npad), dtype=np.float32)
    rows = np.repeat(np.arange(m), host.row_lengths())
    np.add.at(dense, (rows, host.ja), host.a.astype(np.float32))
    return DenseMV(mat=torch.from_numpy(dense), shape=(m, n), nnz=host.nnz,
                   nnz_expanded=host.nnz_expanded)


def _check_precision(X: torch.Tensor) -> None:
    if X.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("DENSE needs full float32 products: switch "
                           "torch.backends.cuda.matmul.allow_tf32 off")


@register_spmv("DENSE", "torch")
def spmv_dense_torch(A: DenseMV, x: torch.Tensor) -> torch.Tensor:
    _check_precision(x)
    xp = F.pad(x.to(A.mat.dtype), (0, A.mat.shape[1] - x.shape[0]))
    return torch.matmul(A.mat, xp)[: A.m]


@register_spmm("DENSE", "torch")
def spmm_dense_torch(A: DenseMV, X: torch.Tensor) -> torch.Tensor:
    _check_precision(X)
    Xp = F.pad(X.to(A.mat.dtype), (0, 0, 0, A.mat.shape[1] - X.shape[0]))
    return torch.matmul(A.mat, Xp)[: A.m]
