"""Benchmark runners for the workloads beside SpMV: SpMM, SDDMM, CG and
BiCGStab.

Counterpart of ``spmv_research_tpu/harness/workloads.py`` (its SpMM, SDDMM
and CG/BiCGStab runners; SpGEMM and trisolve follow their slice).
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

The gold is the float64 product on the host (scipy's ``A @ X``; the per-nnz
dots of A's and B's rows), held against the result through the 8 error
metrics of ``metrics.py``. A BTILE SDDMM returns its tile slab; its per-nnz
values are extracted (``sddmm_slab_to_csr_values``) for that check only,
and the timed chain runs the raw kernel. Timing is ``utils/timing``'s chain
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
from ..ops import sddmm as sddmm_dispatch, spmm as spmm_dispatch
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
        time_iter_median=t_solve / max(iters, 1),
        gflops=flops_iter * iters / t_solve * 1e-9,
        num_loops=iters, mape=res, max_ae=res,
        extra={"converged": converged, "relative_residual": res,
               "solve_time": t_solve, "precond_setup_time": t_setup,
               "compile_time": t_compile},
        out=xh)
