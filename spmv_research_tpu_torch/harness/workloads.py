"""Benchmark runners for the K-dimension workloads, SpMM and SDDMM.

Counterpart of ``spmv_research_tpu/harness/workloads.py`` (its SpMM and
SDDMM runners; CG, BiCGStab, SpGEMM and trisolve follow their slice).
Protocol parity with the reference:

* SpMM — ``bench_spmm.cpp``: Y = A·X, X (n × K) uniform in [0, 1) from
  ``PCG64(11)``; GFLOPS = 2·nnz_expanded·K / t_median (K = ``K_DIM``).
* SDDMM — ``bench_sddmm.cpp``: C = (A·Bᵀ) ∘ S, A (m × K) and B (n × K)
  uniform in [0, 1) from ``PCG64(12)``; GFLOPS = 2·nnz·K / t_median
  (``:391``).

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
from typing import Optional

import numpy as np
import torch

from ..core.host import HostCSR
from ..ops import sddmm as sddmm_dispatch, spmm as spmm_dispatch
from ..ops.btile import BTile, sddmm_slab_to_csr_values
from ..utils.timing import sync, time_chain
from .config import BenchConfig
from .metrics import EPSILON_GATE, ErrorMetrics, error_metrics

_GOLD_CHUNK = 1 << 20     # nnz per block of the float64 SDDMM gold


class BenchGateError(RuntimeError):
    """A benchmark produced garbage (non-finite metrics): the row is a
    failure to log, never data to commit."""


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
    # CSR order), for checks beyond the metrics; not part of the CSV schema
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
