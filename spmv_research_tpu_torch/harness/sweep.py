"""Sweep runner for the SpMV, SpMM, SDDMM, CG, BiCGStab, SpGEMM and
trisolve workloads — the run.sh / proc_run.sh analog.

Counterpart of ``spmv_research_tpu/harness/sweep.py``. It iterates
matrices × formats × impls × workloads on one torch device with the JAX
sweep's output discipline: one CSV file per (format, workload) pair
(``<fmt>_<workload>.csv``; SpGEMM and the trisolve, which need no
format, ``spgemm.csv`` and ``trisolve.csv``) with the labels row first
(SpMV: the JAX package's synthetic schema, ``csv_labels(synthetic=True)``
/ ``csv_row_synthetic``, or for a matrix read from a file its real-matrix
schema, ``csv_labels()`` / ``csv_row_real``; the others: its
``matrix_name,format_name,impl,K,...`` schema, a solve's residual in the
``mape`` and ``max_ae`` columns), human lines on stdout, and an idempotent
done-log (``done.log``, keys (matrix, format, impl, workload), and
(matrix, workload) for SpGEMM and the trisolve) so that a restarted
sweep skips finished pairs.

A matrix is a ``.mtx`` path (or any existing path: Matrix Market,
``io/matrix_market.py``, symmetry expanded) or a synthetic 11-arg
parameter line. ``FORMAT_BUILDERS`` holds every format of the JAX sweep:
``csr``, the classic formats ``coo``, ``csc``, ``ell``, ``sellcs``,
``bsr`` (8 × 128 blocks) and ``csr_sym``, the XLA-only engines ``sellg``
(SpMM only), ``bsrg`` (8 × 128 blocks) and ``csr_lut``, ``sellr``,
``sellw``, ``closg`` (whose builder may return a CLOSG, RSPLIT or CLOSGX
program), the fallback engines ``clos`` and ``bfly``, ``dense``, ``btile``
and the double-single ``csrds`` and ``sellwds``. The builders of ``sellr``,
``sellw``, ``closg``, ``clos``, ``bfly``, ``btile`` and ``sellwds`` go
through the format cache (``convert/cache.py``) under the JAX sweep's keys,
as the JAX sweep's do; a row's ``time_convert`` is then the load's
seconds. The workloads are
``spmv``, ``spmm``, ``sddmm`` (CSR's impls ``torch`` and ``gather``,
BSR's ``mxu``), ``cg``, ``bicgstab``, and once per matrix ``spgemm`` (C =
A·A) and ``trisolve`` (ILU(0) and the level-scheduled solves), the
solvers' preconditioners ``jacobi``, ``ic0`` and ``ilu0``.

Differences from the JAX sweep, each deliberate:

* a format, workload or preconditioner name it does not have raises
  before the sweep starts;
* the impls are the device's (``sweep_impls``): on a CUDA device ``cuda``
  for an engine and every registered impl of a format with no hand
  kernel (``TORCH_FORMATS``: CSR's SpMV runs ``torch`` and ``sparse``, the
  cuSPARSE baseline; the classic formats and the XLA-only engines
  ``torch``); on the CPU every
  impl but ``cuda``; the engines'
  plain versions are never sweep rows on the card. ``impls`` narrows that
  set as the JAX sweep's does (its names in its order), and each name
  left out is printed as a ``#`` line. A (format, workload) pair with no
  such impl (BTILE SpMV; DENSE, SELLW and the CLOS engines' SDDMM) is
  skipped, as ``available_impls`` skips it in the JAX sweep; the solvers
  run on the format's SpMV;
* a matrix's formats are built only when a workload runs on them (the
  JAX sweep builds them for a SpGEMM- or trisolve-only sweep too);
* a builder's suitability error (``SellRBuildError``, ``SellWBuildError``,
  ``ClosRoutingError``, ``RoutingError`` (BFLY past 2^22 slots),
  ``DenseBuildError``, ``BTileBuildError``, ``DSRangeError``, a value
  too large for the double-single split, ``BSRBuildError``, the fill
  guard of BSR and BSRG, and ``CSRSymBuildError``, a matrix that is not
  symmetric) is
  printed and the format skipped, as in the JAX sweep, which catches any
  builder error; a gated row
  (non-finite metrics, a solve without progress, a trisolve residual past
  1e-2) is printed and logged as ``FAIL``; any other exception propagates
  (no retries: a GPU fault is not transient);
* the TPU-worker-crash handling (``_fatal_runtime``, exit code 3, the
  ``CRASH`` records) has no counterpart on the GPU.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..convert import (BSRBuildError, CSRSymBuildError, build_bsr,
                       build_coo, build_csc, build_csr, build_csr_sym,
                       build_ell, build_sellcs, coo_to_csr, extract_features,
                       fix_diagonal_zeros, make_diag_dominant, make_spd,
                       rcm_reorder)
from ..convert.cache import cached_build
from ..convert.reorder import rcm_if_beneficial
from ..gen import ArtificialParams, artificial_matrix_generation
from ..io import mtx_read
from ..ops import available_impls, default_impl
from ..ops.dispatch import TORCH_FORMATS
from ..ops.bfly import build_bfly
from ..ops.bsr_mxu import build_bsrg
from ..ops.btile import BTileBuildError, build_btile
from ..ops.clos import build_clos
from ..ops.compensated import DSRangeError, build_csrds
from ..ops.clos_gather import build_clos_gather_auto
from ..ops.clos_route import ClosRoutingError
from ..ops.densemv import DenseBuildError, build_dense
from ..ops.gatherk import build_sellg
from ..ops.routing import RoutingError
from ..ops.sellr import SellRBuildError, build_sellr
from ..ops.sellw import SellWBuildError, build_sellw
from ..ops.sellw_ds import build_sellwds
from ..ops.value_compress import build_csr_lut
from ..solvers import check_precond
from .bench import (BenchResult, bench_spmv, csv_labels, csv_row_real,
                    csv_row_synthetic)
from .config import BenchConfig
from .workloads import (BenchGateError, bench_cg, bench_sddmm, bench_spgemm,
                        bench_spmm, bench_trisolve)


def _cached(builder, key):
    """``builder`` through the format cache under the JAX sweep's ``key``
    (``build_best`` shares the entries of sellr, sellw, closg, clos and
    bfly)."""
    return functools.partial(cached_build, builder, fmt_name=key)


FORMAT_BUILDERS = {
    "csr": build_csr,
    "coo": build_coo,
    "csc": build_csc,
    "ell": build_ell,
    "sellcs": build_sellcs,
    "bsr": functools.partial(build_bsr, br=8, bc=128),
    "csr_sym": build_csr_sym,
    "csr_lut": build_csr_lut,
    "sellg": build_sellg,
    "bsrg": functools.partial(build_bsrg, br=8, bc=128),
    # the builders the JAX sweep caches, under its keys
    "sellr": _cached(build_sellr, "sellr"),
    "sellw": _cached(build_sellw, "sellw"),
    "closg": _cached(build_clos_gather_auto, "closg"),  # CLOSG/RSPLIT/CLOSGX
    "clos": _cached(build_clos, "clos"),
    "bfly": _cached(build_bfly, "bfly"),
    "dense": build_dense,
    "btile": _cached(build_btile, "btile"),
    "csrds": build_csrds,
    "sellwds": _cached(build_sellwds, "sellwds"),
}
WORKLOADS = ("spmv", "spmm", "sddmm", "cg", "bicgstab", "spgemm",
             "trisolve")
SOLVERS = ("cg", "bicgstab")        # workloads that run on the SpMV
# once per matrix, on no format: each one's runner
MATRIX_WORKLOADS = {"spgemm": bench_spgemm, "trisolve": bench_trisolve}
# a builder raising one of these refuses the matrix: the format is skipped
SUITABILITY_ERRORS = (SellRBuildError, SellWBuildError, ClosRoutingError,
                      RoutingError, DenseBuildError, BTileBuildError,
                      BSRBuildError, CSRSymBuildError, DSRangeError)
WORKLOAD_LABELS = ("matrix_name,format_name,impl,K,time_iter_median,gflops,"
                   "num_loops,mape,max_ae")


def check_sweep_args(formats: Sequence[str], workloads: Sequence[str],
                     precond: str = "jacobi") -> None:
    """Raise on a format, workload or (for the solvers) preconditioner the
    sweep does not have."""
    bad_f = [f for f in formats if f not in FORMAT_BUILDERS]
    if bad_f:
        raise ValueError(f"unknown formats {bad_f}: the sweep has "
                         f"{', '.join(sorted(FORMAT_BUILDERS))}")
    bad_w = [w for w in workloads if w not in WORKLOADS]
    if bad_w:
        raise ValueError(f"unknown workloads {bad_w}: the sweep runs "
                         f"{', '.join(WORKLOADS)}")
    if any(w in SOLVERS for w in workloads):
        check_precond(precond)


def load_matrix(spec: str, cfg: BenchConfig):
    """spec: a ``.mtx`` path (or any existing path: read as Matrix Market,
    symmetry expanded; name = the file's base name, params None) or an
    11-arg synthetic parameter line. Applies the config's transforms, then
    RCM (True, or "auto" = only where it narrows the band). Returns (host,
    name, params)."""
    t0 = time.time()
    if spec.endswith(".mtx") or os.path.exists(spec):
        host = coo_to_csr(mtx_read(spec, expand_symmetry=True))
        name = os.path.splitext(os.path.basename(spec))[0]
        params = None
    else:
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


def sweep_impls(workload: str, fmt: str, device) -> list:
    """The impls a sweep runs for ``fmt``'s ``workload`` (a solver: its
    SpMV) on ``device``: on a CUDA device ``cuda`` for an engine and every
    registered impl of a format with no hand kernel (``TORCH_FORMATS``);
    on the CPU every impl but ``cuda``. ``torchc`` is never one: it runs
    a ``CSRChunked``, which no sweep format builds (the JAX sweep tries
    ``xlac`` on a plain CSR, fails and writes no row)."""
    kernel = "spmv" if workload in SOLVERS else workload
    have = [i for i in available_impls(kernel, fmt) if i != "torchc"]
    if device.type == "cuda" and fmt not in TORCH_FORMATS:
        return [i for i in have if i == "cuda"]
    if device.type == "cuda":
        return have
    return [i for i in have if i != "cuda"]


def run_sweep(matrices: Sequence[str],
              formats: Sequence[str] = ("csr", "bfly"),
              workloads: Sequence[str] = ("spmv",),
              impls: Optional[Sequence[str]] = None,
              out_dir: str = "out_logs",
              config: Optional[BenchConfig] = None,
              device="cuda") -> list:
    """Benchmark every (matrix, format, impl, workload) the device runs
    (``sweep_impls``, narrowed to ``impls`` where given) and every
    per-matrix workload (SpGEMM, trisolve) on ``device``; returns the
    results (``BenchResult`` for SpMV, ``WorkloadResult`` otherwise) and
    appends each to ``<out_dir>/<fmt>_<workload>.csv``
    (``<workload>.csv``)."""
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

    def record(r, csv_name, label, key, params, feats):
        """Append r's row to csv_name and mark its key done."""
        workload = key[-1]
        results.append(r)
        csv_path = os.path.join(out_dir, csv_name)
        with open(csv_path, "a") as f:
            if csv_path not in label_written and f.tell() == 0:
                f.write(_labels_for(workload, params is not None) + "\n")
            label_written.add(csv_path)
            f.write(_row_for(r, workload, params, feats) + "\n")
        donelog.mark("DONE", *key)
        print(f"# {label} {workload}: {_summary(r)}", flush=True)

    def gated(fn, key):
        """fn's result, or None (logged as FAIL) where it is gated."""
        try:
            r = fn()
            _gate_result(r, key[-1])
            return r
        except BenchGateError as e:
            donelog.mark("FAIL", *key)
            print(f"# GATE-FAIL {'/'.join(map(str, key))}: {e}", flush=True)
            return None

    fmt_workloads = [w for w in workloads if w not in MATRIX_WORKLOADS]
    for spec in matrices:
        host, name, params = load_matrix(spec, cfg)
        feats = extract_features(host) if params is not None else None
        for workload in workloads:
            if (workload not in MATRIX_WORKLOADS
                    or donelog.skip(name, workload)):
                continue
            r = gated(lambda: MATRIX_WORKLOADS[workload](
                host, config=cfg, matrix_name=name, device=device),
                (name, workload))
            if r is not None:
                record(r, f"{workload}.csv", name, (name, workload), params,
                       feats)
        for fmt in formats if fmt_workloads else ():
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
            for workload in fmt_workloads:
                have = sweep_impls(workload, A.format_name, device)
                if not have:
                    print(f"# {A.format_name}/"
                          f"{default_impl(A.format_name, device)} has no "
                          f"{workload}: skipped", flush=True)
                    continue
                for i in [i for i in have if impls and i not in impls]:
                    print(f"# {A.format_name}/{i} {workload}: not in impls "
                          f"{list(impls)}: skipped", flush=True)
                for impl in [i for i in (impls or have) if i in have]:
                    if donelog.skip(name, fmt, impl, workload):
                        continue
                    key = (name, fmt, impl, workload)
                    r = gated(lambda: _run_one(host, A, workload, impl, cfg,
                                               name, t_convert), key)
                    if r is not None:
                        record(r, f"{fmt}_{workload}.csv",
                               f"{name} {fmt}/{impl}", key, params, feats)
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


def _labels_for(workload, synthetic):
    if workload == "spmv":
        return csv_labels(synthetic=synthetic)
    return WORKLOAD_LABELS


def _row_for(r, workload, params, feats):
    if workload == "spmv":
        if params is not None:
            return csv_row_synthetic(r, params, feats)
        return csv_row_real(r)
    return (f"{r.matrix_name},{r.format_name},{r.impl},{r.k},"
            f"{r.time_iter_median:.9f},{r.gflops:.4f},{r.num_loops},"
            f"{r.mape:.6g},{r.max_ae:.6g}")


def _summary(r):
    if isinstance(r, BenchResult):
        return (f"{r.nnz_per_s/1e9:.3f} Gnnz/s median="
                f"{r.time_iter_median*1e6:.0f}us mape={r.metrics.mape:.2e}")
    return (f"{r.gflops:.2f} GFLOPS median={r.time_iter_median*1e6:.0f}us "
            f"mape={r.mape:.2e}")
