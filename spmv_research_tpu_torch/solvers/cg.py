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
bit.

Under a torch profiler each solve records the spans ``solver.cg`` (or
``solver.bicgstab``: the whole call), ``solver.start`` (entry to the
loop), one ``solver.step`` a loop iteration (every launch of it but the
poll's read) and one ``solver.poll`` a poll (the host's blocking read of
``active``); with no profiler each costs a flag read
(``utils.trace.trace_region``).

The IC(0) and ILU(0) preconditioners (``solvers/ilu.py``) factor on
the host and apply two triangular solves through their schedules, as the
JAX package's do: ``make_precond`` and the ``solve_*`` helpers on dense
level schedules, ``make_precond_state`` (the benchmarks') on
``build_schedule``'s choice (band blocks, level or chunked).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import spmv as spmv_dispatch
from ..utils.trace import trace_region

POLL_EVERY = 4          # iterations between the host's reads of `active`
PRECONDS = ("jacobi", "ic0", "ilu0")


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual: float        # final implicit residual norm
    explicit_residual: float
    converged: bool


def _jacobi_inv_diag(host_csr, dtype=torch.float32, device="cuda"):
    """K⁻¹ = 1/diag(A) (reference ``bench_cg.cpp:116-135``) on ``device``
    (the card unless the caller asks for the CPU); zero diagonals fall back
    to 1 (the harness normally runs fix_diagonal_zeros first)."""
    diag = np.zeros(host_csr.m)
    rows = np.repeat(np.arange(host_csr.m), host_csr.row_lengths())
    on_diag = rows == host_csr.ja
    diag[rows[on_diag]] = host_csr.a[on_diag]
    diag[diag == 0.0] = 1.0
    return torch.as_tensor(1.0 / diag, dtype=dtype, device=device)


def _guard(t: torch.Tensor) -> torch.Tensor:
    """``where(t == 0, 1e-30, t)``: a zero denominator becomes 1e-30."""
    return torch.where(t == 0, torch.full_like(t, 1e-30), t)


def _traced(name: str):
    """Run the decorated solver inside ``trace_region(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with trace_region(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def _run(step, state, active, active_of, max_iters: int):
    """Iterate ``state ← where(active, step(state), state)`` (``state[0]``
    the device iteration count ``i``, ``active = active_of(state)``),
    polling ``active`` on the host every ``POLL_EVERY`` iterations; returns
    (state, iterations run). The caller computes the first ``active`` and
    each step the next one, so that a ``solver.step`` span holds all of an
    iteration's launches but the poll's read."""
    it = 0
    while it < max_iters:
        if it % POLL_EVERY == 0:
            with trace_region("solver.poll"):
                go = bool(active)
            if not go:
                break
        with trace_region("solver.step"):
            new = step(state, it)
            state = tuple(torch.where(active, n, o)
                          for n, o in zip(new, state))
            it += 1
            if it < max_iters:
                active = active_of(state)
    return state, it


@_traced("solver.cg")
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

    # the explicit-residual check fires at least once per solve even for
    # short runs (the reference's 100-iteration cadence with the default
    # 50-iteration cap would otherwise never run it)
    check_every = max(min(check_every, max_iters), 1)

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

    with trace_region("solver.start"):
        x = torch.zeros_like(b) if x0 is None else x0
        tol2 = (rtol * rtol) * torch.dot(b, b)
        r = b - mv(x)
        z = mz(r)
        p = z
        rho = torch.dot(r, z)
        rr = torch.dot(r, r)
        i0 = torch.zeros((), dtype=torch.int32, device=b.device)
        init = (i0, x, r, p, rho, rr, x, rr)
        active = active_of(init)
    state, loops = _run(step, init, active, active_of, max_iters)
    i, x, r, p, rho, rr, x_best, rr_best = state
    return x_best, {"iterations": i, "rr": rr_best, "tol2": tol2,
                    "converged": rr_best <= tol2, "loop_iterations": loops}


@_traced("solver.bicgstab")
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

    with trace_region("solver.start"):
        x = torch.zeros_like(b) if x0 is None else x0
        tol2 = (rtol * rtol) * torch.dot(b, b)
        r = b - mv(x)
        r_hat = r
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho = alpha = omega = one
        v = p = torch.zeros_like(b)
        i0 = torch.zeros((), dtype=torch.int32, device=b.device)
        init = (i0, x, r, rho, alpha, omega, v, p, x, torch.dot(r, r))
        active = active_of(init)
    state, loops = _run(step, init, active, active_of, max_iters)
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
    if precond not in PRECONDS:
        raise ValueError(f"unknown preconditioner {precond!r} (have "
                         f"{', '.join(PRECONDS)})")


def _factor_schedules(host_csr, precond, build, dtype, device):
    """The schedules (``build``: ``build_level_schedule`` or
    ``build_schedule``) of IC(0)'s L and Lᵀ or ILU(0)'s L and U."""
    from ..core.host import HostCSR
    from .ilu import ic0, ilu0
    if precond == "ic0":
        L = ic0(host_csr)
        U = HostCSR.from_scipy(L.to_scipy().T.tocsr())
    else:
        L, U = ilu0(host_csr)
    return (build(L, lower=True, dtype=dtype, device=device),
            build(U, lower=False, dtype=dtype, device=device))


def _trisolves(st, r):
    """M⁻¹ r = U⁻¹ L⁻¹ r through the factors' schedules ``st``."""
    from .ilu import ilu0_solve
    return ilu0_solve(st[0], st[1], r)


def make_precond_state(host_csr, precond: str, dtype=torch.float32,
                       device="cuda"):
    """``(apply_fn, state)`` with ``apply_fn(state, r) = M⁻¹ r``: the
    preconditioner's arrays in ``state`` on ``device`` (the card unless the
    caller asks for the CPU), built once outside any timed region. IC(0)
    and ILU(0) hold the schedules ``build_schedule`` picks for their two
    factors."""
    check_precond(precond)
    if precond == "jacobi":
        return (lambda st, r: st * r), _jacobi_inv_diag(host_csr, dtype,
                                                         device)
    from .ilu import build_schedule
    return _trisolves, _factor_schedules(host_csr, precond, build_schedule,
                                         dtype, device)


def make_precond(host_csr, precond: str, dtype=torch.float32,
                 device="cuda"):
    """The preconditioner's apply function ``r ↦ M⁻¹ r``, built once on
    ``device`` (the card unless the caller asks for the CPU); IC(0) and
    ILU(0) on dense level schedules, as the JAX package's."""
    check_precond(precond)
    if precond == "jacobi":
        inv_diag = _jacobi_inv_diag(host_csr, dtype, device)
        return lambda r: inv_diag * r
    from .ilu import build_level_schedule
    st = _factor_schedules(host_csr, precond, build_level_schedule, dtype,
                           device)
    return lambda r: _trisolves(st, r)


def solve_cg_ic0(host_csr, A, b, dtype=torch.float32, **kw):
    """IC(0)-preconditioned CG (SPD systems) on ``A.device``: M = L·Lᵀ on
    A's lower pattern, applied as two level-scheduled trisolves per
    iteration. To keep the one-time factorization out of a timed region,
    build it once with ``make_precond`` and pass it to ``cg`` as
    ``precond_fn``."""
    return cg(A, torch.as_tensor(b, dtype=dtype, device=A.device),
              precond_fn=make_precond(host_csr, "ic0", dtype, A.device),
              **kw)


def solve_bicgstab_ilu0(host_csr, A, b, dtype=torch.float32, **kw):
    """ILU(0)-preconditioned BiCGStab (general square systems) on
    ``A.device``."""
    return bicgstab(A, torch.as_tensor(b, dtype=dtype, device=A.device),
                    precond_fn=make_precond(host_csr, "ilu0", dtype,
                                            A.device), **kw)
