"""Sweep runner for the SpMV, SpMM, SDDMM, CG and BiCGStab workloads — the
run.sh / proc_run.sh analog.

Counterpart of ``spmv_research_tpu/harness/sweep.py``. It iterates
matrices × formats × workloads on one torch device with the JAX sweep's
output discipline: one CSV file per (format, workload) pair
(``<fmt>_<workload>.csv``) with the labels row first (SpMV: the JAX
package's synthetic schema, ``csv_labels`` / ``csv_row_synthetic``; SpMM,
SDDMM, CG and BiCGStab: its ``matrix_name,format_name,impl,K,...`` schema,
a solver's residual in the ``mape`` and ``max_ae`` columns), human lines
on stdout, and an idempotent done-log (``done.log``) so that a restarted
sweep skips finished pairs.

Differences from the JAX sweep, each deliberate:

* matrices are synthetic 11-arg parameter lines; a ``.mtx`` spec raises
  ``NotImplementedError`` (the Matrix Market reader is ROADMAP queue A
  item 6);
* ``FORMAT_BUILDERS`` holds ``csr``, ``sellr``, ``sellw``, ``closg`` (whose
  builder may return a CLOSG, RSPLIT or CLOSGX program, as in the JAX
  sweep), the fallback engines ``clos`` and ``bfly``, ``dense``, ``btile``
  and the double-single ``csrds`` and ``sellwds``, and the workloads are ``spmv``, ``spmm``, ``sddmm``, ``cg``
  and ``bicgstab``: any other name, and a solver preconditioner other than
  Jacobi (``ic0`` and ``ilu0`` need ``solvers/ilu.py``), raises before the
  sweep starts;
* the impls are the device's (``ops.dispatch.default_impl``): on a CUDA
  device the engines run ``cuda`` and the library formats (CSR, DENSE) run
  ``torch``; on the CPU everything runs ``torch``. A (format, workload)
  pair with no such impl (BTILE SpMV; DENSE, SELLW and the CLOS engines'
  SDDMM) is skipped, as ``available_impls`` skips it in the JAX sweep; the
  solvers run on the format's SpMV;
* a builder's suitability error (``SellRBuildError``, ``SellWBuildError``,
  ``ClosRoutingError``, ``RoutingError`` (BFLY past 2^22 slots),
  ``DenseBuildError``, ``BTileBuildError``, and ``DSRangeError``, a value
  too large for the double-single split) is
  printed and the format skipped, as in the JAX sweep; a gated row
  (non-finite metrics, a solve without progress) is printed and logged as
  ``FAIL``; any other exception propagates (no retries: a GPU fault is not
  transient);
* the TPU-worker-crash handling (``_fatal_runtime``, exit code 3, the
  ``CRASH`` records) has no counterpart on the GPU.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..convert import (build_csr, extract_features, fix_diagonal_zeros,
                       make_diag_dominant, make_spd, rcm_reorder)
from ..convert.reorder import rcm_if_beneficial
from ..gen import ArtificialParams, artificial_matrix_generation
from ..ops import available_impls, default_impl
from ..ops.bfly import build_bfly
from ..ops.btile import BTileBuildError, build_btile
from ..ops.clos import build_clos
from ..ops.compensated import DSRangeError, build_csrds
from ..ops.clos_gather import build_clos_gather_auto
from ..ops.clos_route import ClosRoutingError
from ..ops.densemv import DenseBuildError, build_dense
from ..ops.routing import RoutingError
from ..ops.sellr import SellRBuildError, build_sellr
from ..ops.sellw import SellWBuildError, build_sellw
from ..ops.sellw_ds import build_sellwds
from ..solvers import check_precond
from .bench import BenchResult, bench_spmv, csv_labels, csv_row_synthetic
from .config import BenchConfig
from .workloads import BenchGateError, bench_cg, bench_sddmm, bench_spmm

FORMAT_BUILDERS = {
    "csr": build_csr,
    "sellr": build_sellr,
    "sellw": build_sellw,
    "closg": build_clos_gather_auto,   # CLOSG, RSPLIT or CLOSGX
    "clos": build_clos,
    "bfly": build_bfly,
    "dense": build_dense,
    "btile": build_btile,
    "csrds": build_csrds,
    "sellwds": build_sellwds,
}
WORKLOADS = ("spmv", "spmm", "sddmm", "cg", "bicgstab")
SOLVERS = ("cg", "bicgstab")        # workloads that run on the SpMV
# a builder raising one of these refuses the matrix: the format is skipped
SUITABILITY_ERRORS = (SellRBuildError, SellWBuildError, ClosRoutingError,
                      RoutingError, DenseBuildError, BTileBuildError,
                      DSRangeError)
WORKLOAD_LABELS = ("matrix_name,format_name,impl,K,time_iter_median,gflops,"
                   "num_loops,mape,max_ae")


def check_sweep_args(formats: Sequence[str], workloads: Sequence[str],
                     precond: str = "jacobi") -> None:
    """Raise on a format, workload or (for the solvers) preconditioner the
    port does not have yet."""
    bad_f = [f for f in formats if f not in FORMAT_BUILDERS]
    if bad_f:
        raise NotImplementedError(
            f"formats {bad_f} are not ported: the sweep has "
            f"{sorted(FORMAT_BUILDERS)} (the others follow their engines, "
            "ROADMAP queue A items 4 and 5)")
    bad_w = [w for w in workloads if w not in WORKLOADS]
    if bad_w:
        raise NotImplementedError(
            f"workloads {bad_w} are not ported: the sweep runs "
            f"{', '.join(WORKLOADS)} (trisolve and SpGEMM are ROADMAP queue "
            "A items 2 and 3)")
    if any(w in SOLVERS for w in workloads):
        check_precond(precond)


def load_matrix(spec: str, cfg: BenchConfig):
    """spec: an 11-arg synthetic parameter line (a ``.mtx`` path raises).
    Applies the config's transforms, then RCM (True, or "auto" = only where
    it narrows the band). Returns (host, name, params)."""
    t0 = time.time()
    if spec.endswith(".mtx") or os.path.exists(spec):
        raise NotImplementedError(
            f"{spec}: Matrix Market input is not ported (ROADMAP queue A "
            "item 6, io/matrix_market.py)")
    params = ArtificialParams.from_args(spec.split())
    host, _ = artificial_matrix_generation(params)
    name = params.name or "synthetic"
    if cfg.matrix_transform:
        tf = {"spd": make_spd, "dd": make_diag_dominant}[cfg.matrix_transform]
        host = tf(host)
        name = f"{name}_{cfg.matrix_transform}"   # honest labeling
    if cfg.fix_diagonal_zeros:
        host = fix_diagonal_zeros(host)
    if cfg.use_rcm_reordering == "auto":
        host, _ = rcm_if_beneficial(host)
    elif cfg.use_rcm_reordering:
        host, _ = rcm_reorder(host)
    t_read = time.time() - t0
    print(f"# read+transform {name}: m={host.m} nnz={host.nnz} "
          f"({t_read:.2f}s)", flush=True)
    return host, name, params


class SweepDoneLog:
    """Idempotent per-pair records (SURVEY §5.4): keys of completed (DONE)
    or gated (FAIL) (matrix, format, impl, workload) pairs, so a restarted
    sweep process skips finished work."""

    def __init__(self, out_dir):
        self.path = os.path.join(out_dir, "done.log")
        self.done = set()
        if os.path.exists(self.path):
            with open(self.path) as f:
                for ln in f:
                    tag, _, key = ln.strip().partition(" ")
                    if tag in ("DONE", "FAIL"):   # FAIL = gated garbage row:
                        self.done.add(key)        # permanent, don't re-run

    def skip(self, *key) -> bool:
        return "/".join(map(str, key)) in self.done

    def mark(self, tag, *key):
        with open(self.path, "a") as f:
            f.write(f"{tag} {'/'.join(map(str, key))}\n")
        if tag == "DONE":
            self.done.add("/".join(map(str, key)))


def run_sweep(matrices: Sequence[str],
              formats: Sequence[str] = ("csr", "bfly"),
              workloads: Sequence[str] = ("spmv",),
              out_dir: str = "out_logs",
              config: Optional[BenchConfig] = None,
              device="cuda") -> list:
    """Benchmark every (matrix, format, workload) triple on ``device`` that
    the format has an impl for; returns the results (``BenchResult`` for
    SpMV, ``WorkloadResult`` otherwise) and appends each to
    ``<out_dir>/<fmt>_<workload>.csv``."""
    cfg = config or BenchConfig.from_env()
    check_sweep_args(formats, workloads, cfg.solver_precond)
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype {cfg.dtype}: the port's engines "
                                  "are float32")
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    label_written = set()
    donelog = SweepDoneLog(out_dir)

    for spec in matrices:
        host, name, params = load_matrix(spec, cfg)
        feats = extract_features(host)
        for fmt in formats:
            t0 = time.time()
            try:
                A = FORMAT_BUILDERS[fmt](host)
            except SUITABILITY_ERRORS as e:
                print(f"# {fmt} build refused {name}: "
                      f"{type(e).__name__}: {e}", flush=True)
                continue
            t_convert = time.time() - t0
            print(f"# convert {name} -> {fmt}: {t_convert:.2f}s", flush=True)
            A = A.to(device)
            impl = default_impl(A.format_name, device)
            for workload in workloads:
                kernel = "spmv" if workload in SOLVERS else workload
                if impl not in available_impls(kernel, A.format_name):
                    print(f"# {A.format_name}/{impl} has no {workload}: "
                          "skipped", flush=True)
                    continue
                if donelog.skip(name, fmt, impl, workload):
                    continue
                try:
                    r = _run_one(host, A, workload, impl, cfg, name,
                                 t_convert)
                    _gate_result(r, workload)
                except BenchGateError as e:
                    donelog.mark("FAIL", name, fmt, impl, workload)
                    print(f"# GATE-FAIL {name}/{fmt}/{impl}/{workload}: {e}",
                          flush=True)
                    continue
                results.append(r)
                csv_path = os.path.join(out_dir, f"{fmt}_{workload}.csv")
                with open(csv_path, "a") as f:
                    if csv_path not in label_written and f.tell() == 0:
                        f.write(_labels_for(workload) + "\n")
                    label_written.add(csv_path)
                    f.write(_row_for(r, workload, params, feats) + "\n")
                donelog.mark("DONE", name, fmt, impl, workload)
                print(f"# {name} {fmt}/{impl} {workload}: {_summary(r)}",
                      flush=True)
            del A   # release the format's device buffers before the next
    return results


def _run_one(host, A, workload, impl, cfg, name, t_convert):
    if workload == "spmv":
        return bench_spmv(host, A, config=cfg, impl=impl, matrix_name=name,
                          time_convert=t_convert)
    if workload in SOLVERS:
        return bench_cg(host, A, config=cfg, impl=impl, matrix_name=name,
                        bicgstab=workload == "bicgstab",
                        precond=cfg.solver_precond)
    bench = {"spmm": bench_spmm, "sddmm": bench_sddmm}[workload]
    return bench(host, A, config=cfg, impl=impl, matrix_name=name)


def _gate_result(r, workload):
    """NaN metrics or a solve without progress must be a loud FAILURE, not
    a committed CSV row."""
    m = r.metrics if isinstance(r, BenchResult) else r
    for v, tag in ((m.mape, "mape"), (m.max_ae, "max_ae")):
        if not np.isfinite(v):
            raise BenchGateError(f"{workload}: non-finite {tag} ({v})")
    if workload in SOLVERS and m.mape >= 0.9:
        raise BenchGateError(
            f"{workload}: residual {m.mape:.3g} — no convergence progress")


def _labels_for(workload):
    return csv_labels(synthetic=True) if workload == "spmv" else WORKLOAD_LABELS


def _row_for(r, workload, params, feats):
    if workload == "spmv":
        return csv_row_synthetic(r, params, feats)
    return (f"{r.matrix_name},{r.format_name},{r.impl},{r.k},"
            f"{r.time_iter_median:.9f},{r.gflops:.4f},{r.num_loops},"
            f"{r.mape:.6g},{r.max_ae:.6g}")


def _summary(r):
    if isinstance(r, BenchResult):
        return (f"{r.nnz_per_s/1e9:.3f} Gnnz/s median="
                f"{r.time_iter_median*1e6:.0f}us mape={r.metrics.mape:.2e}")
    return (f"{r.gflops:.2f} GFLOPS median={r.time_iter_median*1e6:.0f}us "
            f"mape={r.mape:.2e}")
