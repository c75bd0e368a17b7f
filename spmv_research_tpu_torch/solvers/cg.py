"""Iterative solvers: Jacobi-preconditioned CG and BiCGStab.

Counterpart of ``spmv_research_tpu/solvers/cg.py``, on top of the
format-dispatched SpMV:

* CG — ``bench_cg.cpp:93`` ``preconditioned_cg``: Jacobi preconditioner
  K = diag(A) (``:116-135``), convergence ‖r‖ < rtol·‖b‖ (``:163-174``), an
  explicit residual every ``check_every`` iterations with best-iterate
  tracking and a restart when the implicit and explicit residuals disagree
  by ×1e3 (``:191-238``);
* BiCGStab — ``bench_bicg.cpp:150`` ``preconditioned_bicgstab``: the same
  shell, two SpMVs per iteration.

The JAX solvers are ``lax.while_loop``s: compiled once, with no host round
trip per iteration. PyTorch runs eagerly, and reading a device scalar on
the host in every iteration would add a round trip to every SpMV. So the
loop state stays on the device: ``active = (i < max_iters) & (rr > tol2)``,
the ``while_loop``'s condition, is a device tensor, every state update goes
through ``torch.where(active, new, old)`` and ``i`` counts on the device.
The host polls ``active`` once every ``POLL_EVERY`` iterations and stops
when it is false. The frozen state makes the result the ``while_loop``'s:
the same iteration count, ``x_best`` and ``rr_best``, explicit-residual
check and restart, and ``where(denom == 0, 1e-30, denom)`` guards. The
cost is at most ``POLL_EVERY - 1`` iterations run after convergence, whose
results are thrown away: ``info["loop_iterations"]`` counts the iterations
the host ran, ``info["iterations"]`` those that counted. A CUDA graph of the
body would save the launches too, but it needs every kernel wrapper of
every format to be capturable (static buffers, no host-side checks that
read the device); the masked loop works for any format as it is.

Reductions use ``torch.dot`` for ``jnp.vdot``: their order differs from
XLA's, so parity with the JAX solvers holds at a tolerance, not bit for
bit. The IC(0) and ILU(0) preconditioners need ``solvers/ilu.py``, which
is not ported yet: ``make_precond`` and ``make_precond_state`` raise
``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import spmv as spmv_dispatch

POLL_EVERY = 4          # iterations between the host's reads of `active`


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual: float        # final implicit residual norm
    explicit_residual: float
    converged: bool


def _jacobi_inv_diag(host_csr, dtype=torch.float32, device="cpu"):
    """K⁻¹ = 1/diag(A) (reference ``bench_cg.cpp:116-135``); zero diagonals
    fall back to 1 (the harness normally runs fix_diagonal_zeros first)."""
    diag = np.zeros(host_csr.m)
    rows = np.repeat(np.arange(host_csr.m), host_csr.row_lengths())
    on_diag = rows == host_csr.ja
    diag[rows[on_diag]] = host_csr.a[on_diag]
    diag[diag == 0.0] = 1.0
    return torch.as_tensor(1.0 / diag, dtype=dtype, device=device)


def _guard(t: torch.Tensor) -> torch.Tensor:
    """``where(t == 0, 1e-30, t)``: a zero denominator becomes 1e-30."""
    return torch.where(t == 0, torch.full_like(t, 1e-30), t)


def _run(step, state, active_of, max_iters: int):
    """Iterate ``state ← where(active, step(state), state)`` (``state[0]``
    the device iteration count ``i``), polling ``active`` on the host every
    ``POLL_EVERY`` iterations; returns (state, iterations run)."""
    it = 0
    while it < max_iters:
        active = active_of(state)
        if it % POLL_EVERY == 0 and not bool(active):
            break
        new = step(state, it)
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
        it += 1
    return state, it


def cg(A, b: torch.Tensor, *, inv_diag: Optional[torch.Tensor] = None,
       max_iters: int = 50, rtol: float = 1e-6,
       x0: Optional[torch.Tensor] = None,
       spmv_fn: Optional[Callable] = None, impl: Optional[str] = None,
       check_every: int = 100, divergence_factor: float = 1e3,
       precond_fn: Optional[Callable] = None):
    """Preconditioned CG. ``precond_fn(r) = M⁻¹ r`` (must be SPD); defaults
    to Jacobi via ``inv_diag``. Returns (x_best, info dict of device
    scalars, and ``loop_iterations``, a host int)."""
    mv = spmv_fn or (lambda v: spmv_dispatch(A, v, impl=impl))
    if precond_fn is None and inv_diag is None:
        raise ValueError("provide inv_diag (Jacobi) or precond_fn "
                         "(identity: precond_fn=lambda r: r)")
    mz = precond_fn or (lambda r_: inv_diag * r_)
    x = torch.zeros_like(b) if x0 is None else x0
    tol2 = (rtol * rtol) * torch.dot(b, b)

    # the explicit-residual check fires at least once per solve even for
    # short runs (the reference's 100-iteration cadence with the default
    # 50-iteration cap would otherwise never run it)
    check_every = max(min(check_every, max_iters), 1)

    r = b - mv(x)
    z = mz(r)
    p = z
    rho = torch.dot(r, z)
    rr = torch.dot(r, r)

    def active_of(state):
        i, x, r, p, rho, rr, x_best, rr_best = state
        return (i < max_iters) & (rr > tol2)

    def step(state, it):
        # while the state is active its device count i equals the host's
        # count it, so the check's cadence is read from it (no round trip)
        i, x, r, p, rho, rr, x_best, rr_best = state
        Ap = mv(p)
        alpha = rho / _guard(torch.dot(p, Ap))
        x = x + alpha * p
        r_new = r - alpha * Ap
        if it % check_every == check_every - 1:
            # periodic explicit residual + divergence restart
            r_exp = b - mv(x)
            rr_exp = torch.dot(r_exp, r_exp)
            rr_imp = torch.dot(r_new, r_new)
            diverged = rr_exp > divergence_factor * torch.clamp_min(rr_imp,
                                                                    1e-300)
            r_new = torch.where(diverged, r_exp, r_new)
        z = mz(r_new)
        rho_new = torch.dot(r_new, z)
        beta = rho_new / _guard(rho)
        p = z + beta * p
        rr_new = torch.dot(r_new, r_new)
        better = rr_new < rr_best
        x_best = torch.where(better, x, x_best)
        rr_best = torch.where(better, rr_new, rr_best)
        return (i + 1, x, r_new, p, rho_new, rr_new, x_best, rr_best)

    i0 = torch.zeros((), dtype=torch.int32, device=b.device)
    state, loops = _run(step, (i0, x, r, p, rho, rr, x, rr), active_of,
                        max_iters)
    i, x, r, p, rho, rr, x_best, rr_best = state
    return x_best, {"iterations": i, "rr": rr_best, "tol2": tol2,
                    "converged": rr_best <= tol2, "loop_iterations": loops}


def bicgstab(A, b: torch.Tensor, *, inv_diag: Optional[torch.Tensor] = None,
             max_iters: int = 50, rtol: float = 1e-6,
             x0: Optional[torch.Tensor] = None,
             spmv_fn: Optional[Callable] = None,
             impl: Optional[str] = None,
             precond_fn: Optional[Callable] = None):
    """Preconditioned BiCGStab (reference ``bench_bicg.cpp:150``);
    ``precond_fn(r) = M⁻¹ r`` defaults to Jacobi via ``inv_diag``."""
    mv = spmv_fn or (lambda v: spmv_dispatch(A, v, impl=impl))
    if precond_fn is None and inv_diag is None:
        raise ValueError("provide inv_diag (Jacobi) or precond_fn "
                         "(identity: precond_fn=lambda r: r)")
    mz = precond_fn or (lambda r_: inv_diag * r_)
    x = torch.zeros_like(b) if x0 is None else x0
    tol2 = (rtol * rtol) * torch.dot(b, b)

    r = b - mv(x)
    r_hat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)

    def active_of(state):
        i, x, r = state[:3]
        return (i < max_iters) & (torch.dot(r, r) > tol2)

    def step(state, _it):
        i, x, r, rho, alpha, omega, v, p, x_best, rr_best = state
        rho_new = torch.dot(r_hat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = r + beta * (p - omega * v)
        p_hat = mz(p)
        v = mv(p_hat)
        alpha = rho_new / _guard(torch.dot(r_hat, v))
        s = r - alpha * v
        s_hat = mz(s)
        t = mv(s_hat)
        omega = torch.dot(t, s) / _guard(torch.dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        rr = torch.dot(r, r)
        better = rr < rr_best
        x_best = torch.where(better, x, x_best)
        rr_best = torch.where(better, rr, rr_best)
        return (i + 1, x, r, rho_new, alpha, omega, v, p, x_best, rr_best)

    i0 = torch.zeros((), dtype=torch.int32, device=b.device)
    init = (i0, x, r, rho, alpha, omega, v, p, x, torch.dot(r, r))
    state, loops = _run(step, init, active_of, max_iters)
    i, x_best, rr_best = state[0], state[8], state[9]
    return x_best, {"iterations": i, "rr": rr_best, "tol2": tol2,
                    "converged": rr_best <= tol2, "loop_iterations": loops}


def solve_cg(host_csr, A, b, dtype=torch.float32, **kw):
    """CG with the Jacobi preconditioner built from host CSR, on
    ``A.device``."""
    inv_diag = _jacobi_inv_diag(host_csr, dtype, A.device)
    return cg(A, torch.as_tensor(b, dtype=dtype, device=A.device),
              inv_diag=inv_diag, **kw)


def solve_bicgstab(host_csr, A, b, dtype=torch.float32, **kw):
    """BiCGStab with the Jacobi preconditioner, on ``A.device``."""
    inv_diag = _jacobi_inv_diag(host_csr, dtype, A.device)
    return bicgstab(A, torch.as_tensor(b, dtype=dtype, device=A.device),
                    inv_diag=inv_diag, **kw)


def check_precond(precond: str) -> None:
    """Raise unless ``precond`` is a preconditioner the port has."""
    if precond in ("ic0", "ilu0"):
        raise NotImplementedError(
            f"preconditioner {precond!r} needs solvers/ilu.py (IC(0)/ILU(0) "
            "and the level-scheduled trisolve), which is not ported yet "
            "(ROADMAP queue A item 8)")
    if precond != "jacobi":
        raise ValueError(f"unknown preconditioner {precond!r}")


def make_precond_state(host_csr, precond: str, dtype=torch.float32,
                       device="cpu"):
    """``(apply_fn, state)`` with ``apply_fn(state, r) = M⁻¹ r``: the
    preconditioner's arrays in ``state``, built once outside any timed
    region."""
    check_precond(precond)
    return (lambda st, r: st * r), _jacobi_inv_diag(host_csr, dtype, device)


def make_precond(host_csr, precond: str, dtype=torch.float32, device="cpu"):
    """The preconditioner's apply function ``r ↦ M⁻¹ r``, built once."""
    apply_fn, state = make_precond_state(host_csr, precond, dtype, device)
    return lambda r: apply_fn(state, r)
