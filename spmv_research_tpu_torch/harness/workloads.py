"""Benchmark runners for the workloads beside SpMV: SpMM, SDDMM, CG,
BiCGStab, SpGEMM and the ILU(0) trisolve.

Counterpart of ``spmv_research_tpu/harness/workloads.py``, every runner of
it.
Protocol parity with the reference:

* SpMM — ``bench_spmm.cpp``: Y = A·X, X (n × K) uniform in [0, 1) from
  ``PCG64(11)``; GFLOPS = 2·nnz_expanded·K / t_median (K = ``K_DIM``).
* SDDMM — ``bench_sddmm.cpp``: C = (A·Bᵀ) ∘ S, A (m × K) and B (n × K)
  uniform in [0, 1) from ``PCG64(12)``; GFLOPS = 2·nnz·K / t_median
  (``:391``).
* CG / BiCGStab — ``bench_cg.cpp`` / ``bench_bicg.cpp``: b uniform in
  [0, 1) from ``PCG64(13)``, rtol 1e-6 (fp32), the preconditioner built
  once and timed apart; solve time, iterations and the final relative
  residual ‖A·x − b‖ / ‖b‖, taken on the host in fp64 (``:410-415``).
  The row's ``num_loops`` is the counted iterations, as in the JAX
  schema; its per-iteration time and GFLOPS divide the solve by the
  iterations the host loop ran (``extra["loop_iterations"]``, which may
  pass the counted ones by up to ``solvers.cg.POLL_EVERY`` − 1).
* Trisolve — ILU(0) of the matrix (diagonal zeros fixed first), the
  schedules ``build_schedule`` picks for L and U, b uniform in [0, 1)
  from ``PCG64(5)``; x = U⁻¹ L⁻¹ b gated at ‖L·U·x − b‖ / ‖b‖ ≤ 1e-2;
  GFLOPS = 2·(nnz L + nnz U) / t_median; impl ``torch-<kind>`` (the JAX
  package's ``xla-<kind>``), kind ``band``, ``dense`` (level) or
  ``chunk``, or ``<L's>+<U's>`` where they differ.
* SpGEMM — C = A·A (BASELINE.json config #4, beyond the reference, whose
  SpGEMM is a stub): the host plans (``ops/spgemm.py``) timed as
  ``t_symbolic``, the numeric phase of every block as one timed call;
  GFLOPS = 2·pairs / t_median; C checked against scipy's float64 product
  block by block over its first 2^25 entries (``max_ae`` relative to max
  |gold|, ``extra["checked_frac"]``); format ``CSR-ESC``, impl ``torch``.

The gold is the float64 product on the host (scipy's ``A @ X``; the per-nnz
dots of A's and B's rows), held against the result through the 8 error
metrics of ``metrics.py``. A BTILE SDDMM returns its tile slab and a
``BSR/mxu`` SDDMM its block layout; their per-nnz values are put in CSR
order (``sddmm_slab_to_csr_values``, ``bsr_sddmm_to_csr_values``) for that
check only, and the timed chain runs the raw call. (The JAX package's
``bench_sddmm`` reads ``BSR/mxu``'s block layout as if it were in CSR
order, so its error columns for that impl are wrong; the product is
right.) Timing is ``utils/timing``'s chain
of dependent calls (CUDA events on a card), each call's output folded into
its input.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.host import HostCSR
from ..core.formats import BSR
from ..ops import sddmm as sddmm_dispatch, spmm as spmm_dispatch
from ..ops.bsr_mxu import bsr_sddmm_to_csr_values
from ..ops.btile import BTile, sddmm_slab_to_csr_values
from ..utils.timing import fold, sync, time_chain
from .config import BenchConfig
from .metrics import EPSILON_GATE, ErrorMetrics, error_metrics

_GOLD_CHUNK = 1 << 20     # nnz per block of the float64 SDDMM gold


class BenchGateError(RuntimeError):
    """A benchmark produced garbage (non-finite metrics, a solve that made
    no progress): the row is a failure to log, never data to commit."""


@dataclasses.dataclass
class WorkloadResult:
    workload: str
    matrix_name: str
    format_name: str
    impl: str
    k: int
    time_iter_median: float
    gflops: float
    num_loops: int
    mape: float
    max_ae: float
    extra: dict
    metrics: Optional[ErrorMetrics] = None
    # the checked output (float64; SpMM Y (m, K), SDDMM per-nnz values in
    # CSR order, CG/BiCGStab x), for checks beyond the metrics; not part of
    # the CSV schema
    out: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)


def spmm_inputs(host: HostCSR, k: int) -> np.ndarray:
    """X (n, k), the SpMM input of ``bench_spmm``."""
    return np.random.Generator(np.random.PCG64(11)).uniform(0, 1, (host.n, k))


def sddmm_inputs(host: HostCSR, k: int):
    """(A (m, k), B (n, k)), the SDDMM inputs of ``bench_sddmm``."""
    rng = np.random.Generator(np.random.PCG64(12))
    return rng.uniform(0, 1, (host.m, k)), rng.uniform(0, 1, (host.n, k))


def sddmm_gold(host: HostCSR, Am: np.ndarray, Bm: np.ndarray) -> np.ndarray:
    """Per-nnz float64 dots A[row]·B[col], in CSR order, in blocks of nnz
    (two nnz × K gathers at once would take tens of GB at full size)."""
    rows = np.repeat(np.arange(host.m), host.row_lengths())
    out = np.empty(host.nnz)
    for j in range(0, host.nnz, _GOLD_CHUNK):
        sl = slice(j, j + _GOLD_CHUNK)
        out[sl] = np.einsum("ij,ij->i", Am[rows[sl]], Bm[host.ja[sl]])
    return out


def _timed(fn, arg: torch.Tensor, cfg: BenchConfig):
    batch = cfg.inner_iters or 64
    time_chain(fn, arg, cfg.warmup_iters, 0.0, batch=cfg.warmup_iters)
    samples = time_chain(fn, arg, cfg.min_num_loops, cfg.min_time_s,
                         batch=batch)
    return max(float(np.median(samples)), 1e-12), int(samples.size)


def _result(workload, name, fmt, impl, k, t_med, loops, flops, metrics,
            out) -> WorkloadResult:
    return WorkloadResult(
        workload=workload, matrix_name=name, format_name=fmt,
        impl=impl or "auto", k=k, time_iter_median=t_med,
        gflops=flops / t_med * 1e-9, num_loops=loops, mape=metrics.mape,
        max_ae=metrics.max_ae, extra={}, metrics=metrics, out=out)


def bench_spmm(host: HostCSR, A, *, config: Optional[BenchConfig] = None,
               impl: Optional[str] = None,
               matrix_name: str = "matrix") -> WorkloadResult:
    """SpMM protocol for one (matrix, format) pair on ``A.device``."""
    cfg = config or BenchConfig()
    k = cfg.k_dim
    X = spmm_inputs(host, k)
    Xd = torch.as_tensor(X, dtype=getattr(torch, cfg.dtype), device=A.device)
    Y = spmm_dispatch(A, Xd, impl=impl)
    sync(A.device)
    Y = Y.double().cpu().numpy()
    m = error_metrics((host.to_scipy() @ X).reshape(-1), Y.reshape(-1),
                      EPSILON_GATE[np.dtype(cfg.dtype)])
    t_med, loops = _timed(lambda v: spmm_dispatch(A, v, impl=impl), Xd, cfg)
    return _result("spmm", matrix_name, A.format_name, impl, k, t_med,
                   loops, 2.0 * host.nnz_expanded * k, m, Y)


def bench_sddmm(host: HostCSR, S, *, config: Optional[BenchConfig] = None,
                impl: Optional[str] = None,
                matrix_name: str = "matrix") -> WorkloadResult:
    """SDDMM protocol for one (matrix, format) pair on ``S.device``."""
    cfg = config or BenchConfig()
    k = cfg.k_dim
    Amat, Bmat = sddmm_inputs(host, k)
    dt = getattr(torch, cfg.dtype)
    Ad = torch.as_tensor(Amat, dtype=dt, device=S.device)
    Bd = torch.as_tensor(Bmat, dtype=dt, device=S.device)
    C = sddmm_dispatch(S, Ad, Bd, impl=impl)
    sync(S.device)
    if isinstance(S, BTile):       # the tile slab, for validation only
        vals = sddmm_slab_to_csr_values(S, C, host)
    elif isinstance(S, BSR):       # the block layout, likewise
        vals = bsr_sddmm_to_csr_values(S, C, host)
    else:
        vals = C.double().cpu().numpy()[: host.nnz]
    m = error_metrics(sddmm_gold(host, Amat, Bmat), vals,
                      EPSILON_GATE[np.dtype(cfg.dtype)])
    t_med, loops = _timed(lambda a: sddmm_dispatch(S, a, Bd, impl=impl), Ad,
                          cfg)
    return _result("sddmm", matrix_name, S.format_name, impl, k, t_med,
                   loops, 2.0 * host.nnz * k, m, vals)


def _time_solves(solve, b: torch.Tensor, min_time_s: float) -> float:
    """Median seconds of one whole solve in a chain of dependent solves
    (each x folded into the next b): at least 3, then on until
    ``min_time_s`` or 15 (the JAX runner's stop). CUDA events on a card;
    the host clock on the CPU. A solve polls its loop condition on the
    host, so its time includes those round trips."""
    cuda = b.device.type == "cuda"
    samples = []
    v = b
    t_start = time.perf_counter()
    while len(samples) < 3 or (time.perf_counter() - t_start < min_time_s
                               and len(samples) < 15):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            x = solve(v)
            e1.record()
            e1.synchronize()
            samples.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            x = solve(v)
            samples.append(time.perf_counter() - t0)
        v = fold(v, x)
    return max(float(np.median(samples)), 1e-9)


def bench_cg(host: HostCSR, A, *, config: Optional[BenchConfig] = None,
             impl: Optional[str] = None, matrix_name: str = "matrix",
             bicgstab: bool = False,
             precond: str = "jacobi") -> WorkloadResult:
    """CG / BiCGStab protocol for one (matrix, format) pair on ``A.device``
    (``bench_cg.cpp:93-315`` / ``bench_bicg.cpp:150``). The first solve
    (which builds the kernels) is timed apart as ``compile_time`` and
    checked; a solve whose relative residual is not finite or reaches 0.9
    raises :class:`BenchGateError` (CG on a nonsymmetric matrix, say)."""
    from ..solvers import bicgstab as bicg_fn, cg as cg_fn
    from ..solvers import make_precond_state
    cfg = config or BenchConfig()
    rng = np.random.Generator(np.random.PCG64(13))
    b = rng.uniform(0, 1, host.m)
    rtol = 1e-6 if cfg.dtype == "float32" else 1e-12
    dt = getattr(torch, cfg.dtype)

    t0 = time.perf_counter()
    apply_fn, pstate = make_precond_state(host, precond, dtype=dt,
                                          device=A.device)
    t_setup = time.perf_counter() - t0
    solver = bicg_fn if bicgstab else cg_fn

    def solve(v):
        return solver(A, v, precond_fn=lambda r: apply_fn(pstate, r),
                      max_iters=cfg.cg_max_num_iters, rtol=rtol, impl=impl)

    bd = torch.as_tensor(b, dtype=dt, device=A.device)
    t0 = time.perf_counter()
    x, info = solve(bd)
    xh = x.double().cpu().numpy()
    t_compile = time.perf_counter() - t0
    iters = int(info["iterations"])
    # the host loop polls its condition every few iterations and may run
    # past convergence: the solve's time divides by the iterations it ran
    loops = int(info["loop_iterations"])
    converged = bool(info["converged"])
    res = float(np.linalg.norm(host.to_scipy() @ xh - b)
                / max(np.linalg.norm(b), 1e-300))
    name = "bicgstab" if bicgstab else "cg"
    if not np.isfinite(res) or res >= 0.9:
        raise BenchGateError(
            f"{name} made no progress on {matrix_name}: relative residual "
            f"{res:.3g} after {iters} iterations (wrong matrix class for "
            "this solver?)")

    t_solve = _time_solves(lambda v: solve(v)[0], bd, cfg.min_time_s)
    spmv_per_iter = 2 if bicgstab else 1
    flops_iter = 2.0 * host.nnz_expanded * spmv_per_iter + 10.0 * host.m
    return WorkloadResult(
        workload=name, matrix_name=matrix_name, format_name=A.format_name,
        impl=(impl or "auto") + ("" if precond == "jacobi"
                                 else f"+{precond}"), k=0,
        time_iter_median=t_solve / max(loops, 1),
        gflops=flops_iter * loops / t_solve * 1e-9,
        num_loops=iters, mape=res, max_ae=res,
        extra={"converged": converged, "relative_residual": res,
               "solve_time": t_solve, "precond_setup_time": t_setup,
               "compile_time": t_compile, "loop_iterations": loops,
               "time_divisor": "loop_iterations"},
        out=xh)


def bench_spgemm(host: HostCSR, *, config: Optional[BenchConfig] = None,
                 matrix_name: str = "matrix",
                 device="cuda") -> WorkloadResult:
    """C = A·A: the chunked ESC plans built on the host (``t_symbolic``),
    the numeric phase of every block on ``device`` (the card unless the
    caller asks for the CPU) timed as one call, C checked against the
    per-block scipy gold. Past 2^25 pairs the timed chain is cut to 8
    iterations and at most 2 s."""
    from ..ops import spgemm as sg
    cfg = config or BenchConfig()
    device = torch.device(device)
    t0 = time.perf_counter()
    plans = [bp for bp in sg.spgemm_device_plans(
        host, host, getattr(torch, cfg.dtype), device=device)
        if bp.nnz_c > 0]
    sync(device)
    t_sym = time.perf_counter() - t0
    n_pairs_total = sum(bp.npairs for bp in plans)
    nnz_c_total = sum(bp.nnz_c for bp in plans)

    def fn(carry):
        # the numeric phase's input depends on the carry, so that no
        # iteration of the chain repeats the one before
        eps = carry[0] * 1e-30
        tot = carry.new_zeros(())
        for bp in plans:
            tot = tot + sg._scan_numeric_plane(
                bp.av * (1.0 + eps), bp.bv, bp.guard, bp.rowg,
                bp.cross_lane, bp.headmask, stages=bp.stages,
                cstages=bp.cstages).sum()
        return tot.reshape(1)

    A_sp = host.to_scipy().tocsr()
    budget = 1 << 25
    max_ae = 0.0
    checked = 0
    for bp in plans:
        if checked + bp.nnz_c > budget and checked > 0:
            break
        gold = (A_sp[bp.r0: bp.r1] @ A_sp).tocsr()
        gold.sum_duplicates()
        gold.sort_indices()
        got = bp.numeric()[: bp.nnz_c].double().cpu().numpy()
        err = float(np.max(np.abs(got - gold.data))) if gold.nnz else 0.0
        denom = float(np.abs(gold.data).max()) if gold.nnz else 1.0
        max_ae = max(max_ae, err / (denom or 1.0))
        checked += bp.nnz_c
    t_cfg = cfg
    if n_pairs_total > 1 << 25:
        t_cfg = dataclasses.replace(cfg, inner_iters=8, min_num_loops=8,
                                    min_time_s=min(cfg.min_time_s, 2.0))
    t_med, loops = _timed(fn, torch.zeros(8, device=device), t_cfg)
    return WorkloadResult(
        workload="spgemm", matrix_name=matrix_name, format_name="CSR-ESC",
        impl="torch", k=0, time_iter_median=t_med,
        gflops=2.0 * n_pairs_total / t_med * 1e-9, num_loops=loops,
        mape=max_ae, max_ae=max_ae,
        extra={"nnz_c": int(nnz_c_total), "t_symbolic": t_sym,
               "n_blocks": len(plans),
               "checked_frac": checked / max(nnz_c_total, 1)})


def schedule_kind(sched) -> str:
    """The JAX label of a schedule: ``band``, ``chunk`` or ``dense``."""
    from ..solvers.ilu import BandBlockSchedule, ChunkSchedule
    if isinstance(sched, BandBlockSchedule):
        return "band"
    return "chunk" if isinstance(sched, ChunkSchedule) else "dense"


def bench_trisolve(host: HostCSR, *, config: Optional[BenchConfig] = None,
                   matrix_name: str = "matrix",
                   device="cuda") -> WorkloadResult:
    """ILU(0) factorization on the host + the level-scheduled L and U
    solves on ``device`` (the card unless the caller asks for the CPU);
    gflops counts the 2·nnz(L) + 2·nnz(U) solve flops. A residual past
    1e-2 (or not finite) raises :class:`BenchGateError`."""
    from ..convert import fix_diagonal_zeros
    from ..solvers.ilu import build_schedule, ilu0, ilu0_solve
    cfg = config or BenchConfig()
    dt = getattr(torch, cfg.dtype)
    host = fix_diagonal_zeros(host)
    t0 = time.perf_counter()
    L, U = ilu0(host)
    t_fact = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ls = build_schedule(L, lower=True, dtype=dt, device=device)
    Us = build_schedule(U, lower=False, dtype=dt, device=device)
    t_sched = time.perf_counter() - t0
    rng = np.random.Generator(np.random.PCG64(5))
    bd = torch.as_tensor(rng.uniform(0, 1, host.m), dtype=dt, device=device)

    def fn(v):
        return ilu0_solve(Ls, Us, v)

    x = fn(bd).double().cpu().numpy()
    b = bd.double().cpu().numpy()
    lux = L.to_scipy() @ (U.to_scipy() @ x)
    res = float(np.linalg.norm(lux - b) / max(np.linalg.norm(b), 1e-300))
    if not np.isfinite(res) or res > 1e-2:
        raise BenchGateError(
            f"trisolve on {matrix_name}: residual {res:.3g} (a NaN or "
            "garbage schedule must fail loudly, not ship rows)")
    t_med, loops = _timed(fn, bd, cfg)
    kinds = (schedule_kind(Ls), schedule_kind(Us))
    kind = kinds[0] if kinds[0] == kinds[1] else "+".join(kinds)
    return WorkloadResult(
        workload="trisolve", matrix_name=matrix_name, format_name="ILU0-LVL",
        impl=f"torch-{kind}", k=0, time_iter_median=t_med,
        gflops=2.0 * (L.nnz + U.nnz) / t_med * 1e-9, num_loops=loops,
        mape=res, max_ae=res,
        extra={"t_factorize": t_fact, "t_schedule": t_sched,
               "n_levels_L": Ls.n_levels, "n_levels_U": Us.n_levels},
        out=x)
