"""The plain reference: SpMV, SpMM and Jacobi CG in plain PyTorch.

It works from the benchmark's own matrix (``matrices.Csr``, float64 values)
and inputs, on any device, in any floating dtype: float64 to judge the
program, a lower precision for the control (``program.ReferenceProgram``).
A product is computed in blocks of rows, each a gather, a multiply and an
``index_add_`` into its rows, so that it fits beside nothing else. It
imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

BLOCK_NNZ = 1 << 24     # nonzeros a block of the SpMV
BLOCK_SLOTS = 1 << 27   # nonzeros × columns a block of the SpMM


class RefMatrix:
    """The matrix on ``device`` in ``dtype``, with each nonzero's row."""

    def __init__(self, csr, device, dtype=torch.float64, absolute=False):
        a = np.abs(csr.a) if absolute else csr.a
        self.m, self.n, self.nnz = csr.m, csr.n, csr.nnz
        self.dtype = dtype
        self.ia = csr.ia.astype(np.int64)
        self.a = torch.as_tensor(a).to(device=device, dtype=dtype)
        self.ja = torch.as_tensor(csr.ja).to(device=device, dtype=torch.int64)
        self.rows = torch.as_tensor(csr.row_ids()).to(device)

    def _blocks(self, per_row_width: int):
        """(lo, hi): the nonzero ranges of blocks of whole rows."""
        budget = max(BLOCK_NNZ if per_row_width == 1
                     else BLOCK_SLOTS // per_row_width, 1)
        r0 = 0
        while r0 < self.m:
            lo = int(self.ia[r0])
            r1 = int(np.searchsorted(self.ia, lo + budget, side="right")) - 1
            r1 = min(max(r1, r0 + 1), self.m)
            yield lo, int(self.ia[r1])
            r0 = r1

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        y = torch.zeros(self.m, dtype=self.dtype, device=self.a.device)
        for lo, hi in self._blocks(1):
            y.index_add_(0, self.rows[lo:hi],
                         self.a[lo:hi] * x[self.ja[lo:hi]])
        return y

    def spmm(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(self.dtype)
        Y = torch.zeros((self.m, X.shape[1]), dtype=self.dtype,
                        device=self.a.device)
        for lo, hi in self._blocks(X.shape[1]):
            Y.index_add_(0, self.rows[lo:hi],
                         self.a[lo:hi, None] * X[self.ja[lo:hi]])
        return Y

    def inv_diag(self) -> torch.Tensor:
        """1 / diag(A), a zero or missing diagonal taken as 1."""
        on = self.rows == self.ja
        d = torch.ones(self.m, dtype=self.dtype, device=self.a.device)
        d[self.rows[on]] = self.a[on]
        return 1.0 / torch.where(d == 0, torch.ones_like(d), d)


def cg(A: RefMatrix, b: torch.Tensor, rtol: float,
       max_iters: int) -> Tuple[torch.Tensor, int]:
    """Jacobi-preconditioned CG from x = 0 in A's dtype: stops once
    ‖r‖ < rtol·‖b‖ or after ``max_iters`` iterations; (x, iterations)."""
    b = b.to(A.dtype)
    inv_d = A.inv_diag()
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_d * r
    p = z
    rz = torch.dot(r, z)
    tol2 = float(rtol) ** 2 * float(torch.dot(b, b))
    it = 0
    while it < max_iters and float(torch.dot(r, r)) > tol2:
        Ap = A.spmv(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_d * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it


def rel_err(y: torch.Tensor, want: torch.Tensor,
            scale: torch.Tensor) -> float:
    """max |y − want| / scale elementwise (scale = |A|·|x|, each row's
    sum of absolute products); a non-finite y reads inf."""
    y = y.to(torch.float64)
    if not bool(torch.isfinite(y).all()):
        return float("inf")
    tiny = torch.finfo(torch.float64).tiny
    return float(((y - want).abs() / scale.clamp_min(tiny)).max())


def rel_residual(A: RefMatrix, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ with A in float64; a non-finite x reads inf."""
    x = x.to(torch.float64)
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    b = b.to(torch.float64)
    return float(torch.linalg.vector_norm(b - A.spmv(x))
                 / torch.linalg.vector_norm(b))
