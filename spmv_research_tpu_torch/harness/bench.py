"""Benchmark runner: the reference measurement protocol on a torch device.

Counterpart of ``spmv_research_tpu/harness/bench.py``, with the same
``BenchResult`` fields and CSV schemas. The protocol (SURVEY.md §6):

* one un-scaled call checked against the extended-precision gold (the 8
  error metrics and the ε gate of ``metrics.py``); a double-single format
  (one with an ``spmv_f64`` hook: CSRDS, SELLWDS) takes an fp64 x there,
  returns an fp64 y and is judged at the fp64 gate (1e-10), while its
  timed chain drives the registered fp32 entry, whose zero lo plane of x
  does the same gathers and flops as a pair call;
* warm-up calls (kernel build + steady clocks — the role of the GPU
  1000-iteration warm-up, ``bench_spmv.cpp:287-294``);
* a timed chain of dependent SpMVs: at least ``min_num_loops`` iterations AND
  at least ``min_time_s`` seconds (``:335``), each iteration timed on its own
  (``utils/timing.py``: CUDA events on a GPU); min / median / max reported,
  the median is the headline (``:378-384``);
* GFLOPS = 2·nnz_expanded / t_median ×1e-9 (``:404``), plus the roofline
  columns against the card's data-sheet bandwidth (NaN for a device without
  one, such as the CPU); a double-single format's CSR roofline counts 8
  bytes per value (``roofline_kind`` csr64), as its planes carry two.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..core.formats import tree_map
from ..core.host import HostCSR
from ..ops import spmv as spmv_dispatch
from ..utils import roofline as rl
from ..utils.timing import sync, time_chain
from .config import BenchConfig
from .metrics import ErrorMetrics, check_accuracy


@dataclasses.dataclass
class BenchResult:
    matrix_name: str
    format_name: str
    impl: str
    num_devices: int
    time_total: float
    time_iter_min: float
    time_iter_median: float
    time_iter_max: float
    num_loops: int
    gflops: float
    nnz_per_s: float
    csr_mem_footprint_mb: float
    mem_footprint_mb: float
    mem_ratio: float
    achieved_gbps: float
    roofline_frac: float
    metrics: ErrorMetrics
    m: int
    n: int
    nnz: int
    symmetric: bool
    time_convert: float = 0.0
    time_compile: float = 0.0
    time_convert_cold: float = 0.0
    roofline_kind: str = "csr32"
    # y of the accuracy call (float64 copy), for checks beyond the metrics;
    # not part of any CSV schema
    y: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)


REAL_LABELS = (
    "matrix_name,num_threads,csr_m,csr_n,csr_nnz,symmetry,time,time_iter_min,"
    "time_iter_median,time_iter_max,gflops,csr_mem_footprint,W_avg,J_estimated,"
    "format_name,m,n,nnz,mem_footprint,mem_ratio,num_loops,"
    "spmv_mae,spmv_max_ae,spmv_mse,spmv_mape,spmv_smape,spmv_lnQ_error,"
    "spmv_mlare,spmv_gmare"
)

SYNTH_LABELS = (
    "matrix_name,distribution,placement,seed,nr_rows,nr_cols,nr_nzeros,density,"
    "mem_footprint,mem_range,avg_nnz_per_row,std_nnz_per_row,avg_bw,std_bw,"
    "avg_bw_scaled,std_bw_scaled,avg_sc,std_sc,avg_sc_scaled,std_sc_scaled,"
    "skew,avg_num_neighbours,cross_row_similarity,format_name,time,gflops,"
    "W_avg,J_estimated"
)

# Device extension columns appended to either schema (the JAX package's
# TPU_EXTRA_LABELS, unchanged). roofline_kind names the denominator of
# roofline_frac: csr32 — fp32-CSR storage speed-of-light; csr64 — the
# fp64-CSR one, for the double-single formats.
DEVICE_EXTRA_LABELS = (",achieved_GBps,roofline_frac,roofline_kind,"
                       "time_convert,time_compile")

SYNTH_METRIC_LABELS = (",spmv_mae,spmv_max_ae,spmv_mse,spmv_mape,spmv_smape,"
                       "spmv_lnQ_error,spmv_mlare,spmv_gmare")


def csv_labels(synthetic: bool = False, device_extra: bool = True) -> str:
    base = SYNTH_LABELS if synthetic else REAL_LABELS
    if not device_extra:
        return base
    return base + DEVICE_EXTRA_LABELS + (SYNTH_METRIC_LABELS if synthetic else "")


def _scale_for_iteration(host: HostCSR, A):
    """Copy of format A with values scaled so that ‖A‖∞ ≤ 1 (iterates of
    x←A·x stay bounded through the timed chain). Timing-only copy."""
    row_abs_sum = np.zeros(host.m)
    np.add.at(row_abs_sum, np.repeat(np.arange(host.m), host.row_lengths()),
              np.abs(host.a))
    norm = float(row_abs_sum.max()) if host.m else 1.0
    if norm == 0 or not np.isfinite(norm):
        return A
    c = 1.0 / norm
    return tree_map(lambda t: t * c if t.is_floating_point() else t, A)


def bench_spmv(host: HostCSR, A, *, config: Optional[BenchConfig] = None,
               impl: Optional[str] = None, matrix_name: str = "matrix",
               x: Optional[np.ndarray] = None,
               time_convert: float = 0.0,
               time_convert_cold: Optional[float] = None) -> BenchResult:
    """Run the full protocol for one (matrix, format) pair on ``A.device``."""
    cfg = config or BenchConfig()
    dtype = getattr(torch, cfg.dtype)
    device = A.device
    rng = np.random.Generator(np.random.PCG64(7))
    if x is None:
        x = rng.uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=dtype, device=device)

    # --- accuracy: single un-scaled call (its first call builds kernels) ---
    t0 = time.perf_counter()
    if hasattr(A, "spmv_f64"):
        # double-single formats: fp64 x in, fp64 y out, judged at the fp64
        # gate (bench_spmv.cpp:114-119) through the pair of the impl that
        # the timed chain below drives (its registered fp32 entry)
        y = np.asarray(A.spmv_f64(x, impl=impl), dtype=np.float64)
        value_dtype = np.dtype(np.float64)
    else:
        y = spmv_dispatch(A, xd, impl=impl)
        sync(device)
        y = y.double().cpu().numpy()
        value_dtype = np.dtype(cfg.dtype)
    time_compile = time.perf_counter() - t0
    metrics = check_accuracy(host, x, y, value_dtype=value_dtype)

    # --- timing ---
    A_t = _scale_for_iteration(host, A) if A.m == A.n else A
    fn = lambda v: spmv_dispatch(A_t, v, impl=impl)  # noqa: E731
    time_chain(fn, xd, cfg.warmup_iters, 0.0, batch=cfg.warmup_iters)
    t_start = time.perf_counter()
    samples = time_chain(fn, xd, cfg.min_num_loops, cfg.min_time_s,
                         batch=cfg.inner_iters or 64)
    t_total = time.perf_counter() - t_start
    t_med = max(float(np.median(samples)), 1e-12)

    gflops = 2.0 * host.nnz_expanded / t_med * 1e-9
    nnz_per_s = host.nnz_expanded / t_med
    itemsize = torch.empty(0, dtype=dtype).element_size()
    csr_fp = host.mem_footprint_bytes(value_bytes=itemsize)
    fmt_fp = A.mem_footprint_bytes()
    # ONE roofline definition everywhere: the CSR-storage speed-of-light, on
    # STORED nnz (see the JAX harness); achieved_GBps on the format footprint.
    # Double-single formats carry 8 B of value per nnz (hi and lo planes):
    # their fair roofline is the fp64-CSR stream.
    val_bytes = 8 if hasattr(A, "spmv_f64") else itemsize
    sol_nnz_s = rl.csr_roofline_nnz_per_s(host.nnz, host.m, host.n,
                                          val_bytes, rl.device_spec(device))
    return BenchResult(
        matrix_name=matrix_name,
        format_name=A.format_name,
        impl=impl or "auto",
        num_devices=1,
        time_total=t_total,
        time_iter_min=float(samples.min()),
        time_iter_median=t_med,
        time_iter_max=float(samples.max()),
        num_loops=int(samples.size),
        gflops=gflops,
        nnz_per_s=nnz_per_s,
        csr_mem_footprint_mb=csr_fp / 2**20,
        mem_footprint_mb=fmt_fp / 2**20,
        mem_ratio=fmt_fp / csr_fp,
        achieved_gbps=rl.spmv_bytes(A, itemsize) / t_med / 1e9,
        roofline_frac=(host.nnz / t_med) / sol_nnz_s if sol_nnz_s
        else float("nan"),
        metrics=metrics,
        m=host.m,
        n=host.n,
        nnz=host.nnz,
        symmetric=host.symmetric_storage,
        time_convert=time_convert,
        time_compile=time_compile,
        time_convert_cold=(time_convert if time_convert_cold is None
                           else time_convert_cold),
        roofline_kind="csr64" if val_bytes == 8 else "csr32",
        y=y,
    )


def csv_row_real(r: BenchResult, device_extra: bool = True) -> str:
    f = [
        r.matrix_name, r.num_devices, r.m, r.n, r.nnz, int(r.symmetric),
        f"{r.time_total:.6f}", f"{r.time_iter_min:.9f}",
        f"{r.time_iter_median:.9f}", f"{r.time_iter_max:.9f}",
        f"{r.gflops:.6f}", f"{r.csr_mem_footprint_mb:.6f}",
        "0", "0",  # W_avg, J_estimated: no energy counters read
        f"{r.format_name}_{r.impl}" if getattr(r, "impl", None)
        else r.format_name,
        r.m, r.n, r.nnz, f"{r.mem_footprint_mb:.6f}",
        f"{r.mem_ratio:.6f}", r.num_loops,
        *(f"{v:.6g}" for v in r.metrics.as_csv_fields()),
    ]
    row = ",".join(str(v) for v in f)
    if device_extra:
        row += (f",{r.achieved_gbps:.3f},{r.roofline_frac:.4f},"
                f"{r.roofline_kind},"
                f"{r.time_convert:.4f},{r.time_compile:.3f}")
    return row


def csv_row_synthetic(r: BenchResult, params, feats,
                      device_extra: bool = True) -> str:
    """Synthetic-schema row (``bench_spmv.cpp:529-563``): generator params +
    measured features + format/time/gflops."""
    f = [
        r.matrix_name or "synthetic",
        params.distribution, params.placement, params.seed,
        feats.m, feats.n, feats.nnz, f"{feats.density:.6f}",
        f"{feats.mem_footprint_mb:.6f}", feats.mem_range,
        f"{feats.nnz_per_row_avg:.6f}", f"{feats.nnz_per_row_std:.6f}",
        f"{feats.bw_avg:.6f}", f"{feats.bw_std:.6f}",
        f"{feats.bw_scaled_avg:.6f}", f"{feats.bw_scaled_std:.6f}",
        f"{feats.scatter_avg:.6f}", f"{feats.scatter_std:.6f}",
        f"{feats.scatter_scaled_avg:.6f}", f"{feats.scatter_scaled_std:.6f}",
        f"{feats.skew:.6f}", f"{feats.num_neighbours_avg:.6f}",
        f"{feats.cross_row_similarity_avg:.6f}",
        f"{r.format_name}_{r.impl}" if getattr(r, "impl", None)
        else r.format_name,
        f"{r.time_total:.6f}", f"{r.gflops:.6f}", "0", "0",
    ]
    row = ",".join(str(v) for v in f)
    if device_extra:
        row += (f",{r.achieved_gbps:.3f},{r.roofline_frac:.4f},"
                f"{r.roofline_kind},"
                f"{r.time_convert:.4f},{r.time_compile:.3f}")
        row += "," + ",".join(f"{v:.6g}" for v in r.metrics.as_csv_fields())
    return row

