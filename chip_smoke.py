#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and the repository checkout (it imports
``spmv_research_tpu_torch`` and nothing of JAX). Phases, each fatal on
failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and whether the native
   host library loaded;
2. build the CUDA kernels from ``spmv_research_tpu_torch/csrc/closg.cu``,
   ``csrc/sell.cu`` and ``csrc/btile.cu`` (one nvcc each, started
   together) and print their ptxas lines;
3. generate the full-size scircuit twin (bench.py's line), RCM, build the
   CLOSG program (asserts N = 2^20, one program) and print its fields;
4. each CLOSG kernel against its plain PyTorch version on the card, at the
   main path's shapes (K1, K2 exact; K3 within 1e-6 of max |y|), both timed
   with CUDA events (L2 flushed before each call); the device time of one
   whole CLOSG/cuda and CSR/torch SpMV;
5. the bench path: ``spmv_research_tpu_torch.bench.run`` end to end, with
   the kernels' launch counters reset just before and read just after (each
   must have launched); y checked against the longdouble gold within 1e-5
   of |A|·|x|; the 8 error metrics and the ε gate printed;
6. the shipsec1 twin (datasets/validation_twins.txt:27): RCM, ``build_best``
   (asserts SELLR, SELLW and a chunked CLOSG with W > 0 in every chunk),
   each program's fields, the SELLW kernel and SELLR's two kernels against
   their plain versions (exact) and timed, K1-K3 against theirs on every
   CLOSG chunk (tolerances as in phase 4; the widest chunk timed), and per
   candidate the device time of one whole SpMV and a torch.profiler trace
   of a chain of 50 (device time, wall time, busy share, top events);
7. a streamed SELLW program (seeded tridiagonal, n = 1.2M, so
   ``stream_wins``): the kernel against its plain version, timed, then one
   SpMV through ``ops.spmv`` between a reset and a read of the counters,
   y within 1e-5 of |A|·|x|;
8. the sweep path: ``harness.run_sweep`` on the shipsec1 line with formats
   csr, sellr, sellw and closg, counters reset before and read after (the
   SELLW, SELLR and CLOSG kernels must each have launched); four CSV rows
   under the JAX labels; each engine's y within 1e-5 of |A|·|x| of the
   longdouble gold; the 8 error metrics per row;
9. the opt-in front ends on the scircuit twin: a value-LUT program (values
   quantised to 64 seeded levels) and a ``fuse_windows=True`` program; B4
   and B7 against their plain versions (exact) and timed; one SpMV of each
   through ``ops.spmv`` between a reset and a read of the counters, y within
   1e-5 of |A|·|x| of the gold;
10. the gupta3 twin (validation_twins.txt:30): ``build_best`` (asserts a
    chunked CLOSG with W = 0 in every chunk), B5 and B6 against their plain
    versions on every chunk (exact; the widest timed), one SpMV through
    ``ops.spmv`` between a reset and a read of the counters, y within 1e-5
    of |A|·|x|; device times of CLOSG/cuda, DENSE/torch, CSR/torch and the
    cuSPARSE product (a library yardstick), and the traced chain of 50;
11. the mip1 twin (validation_twins.txt:31): ``build_best`` (asserts an
    RSPLIT over a CLOSGX), K1, K2 and B15 on the stacked planes against
    their plain versions (exact) and timed, one SpMV as in phase 10, y
    within 1e-5 of |A|·|x|, device times and the traced chain;
12. the sweep on the gupta3 and mip1 lines with formats csr, closg and
    dense: rows CLOSG/cuda, DENSE/torch and CSR/torch on gupta3, RSPLIT/cuda
    and CSR/torch on mip1 (its 17.7 GB dense plane is refused); B5, B6 and
    B15 must have launched; each y within 1e-5 of |A|·|x| of the gold;
13. the program kind ``build_clos_gather_auto`` gives four more twins of
    validation_twins.txt (RCM where the matrix is square): ASIC_680k (:17)
    an RSPLIT over a 6-chunk CLOSG with W = 1, 1, 1, 1, 32, 32; pwtk (:33) a
    13-chunk CLOSGX with W = 8; rail4284 (:32) and TSOPF_RS_b2383 (:36)
    refused by the XL builder's guards. Host work only;
14. the K-dimension workloads at K = 128 (``k_dim_phase``): gupta3's and
    shipsec1's BTILE programs (ntiles, nsteps, slots/nnz, MB printed), B16a
    and B16b against their plain versions on both (within 1e-5 of |A|·|X|
    per element and of Σ|a||b| per slot) and timed on gupta3's beside
    cuSPARSE's SpMM and SDDMM; shipsec1's SELLW
    SpMM kernel B12 against its plain version (exact), timed beside
    cuSPARSE's SpMM; one CLOSG SpMM on gupta3 at K = 8 through ``ops.spmm``
    (B5 and B6 launch 8× their per-SpMV count; Y within 1e-5 of |A|·|X|);
    the sweep with workloads spmm and sddmm, formats csr, btile, dense and
    sellw, on the gupta3 and shipsec1 lines: its ten rows and six CSVs
    under the JAX labels, B16a (its product and its chunks' combine), B16b
    and B12 launched, every row within
    1e-5 of the fp64 gold's |·| yardstick, the 8 error metrics printed;
    then each row's call timed alone on the card;
15. double-single and solvers (``ds_phase``): the shipsec1 twin with RCM
    (``USE_RCM_REORDERING=1``, as ``load_matrix`` makes it), SELLWDS and
    CSRDS built (chunks, classes, MiB, seconds); B13 against its plain
    version on every stage class (exact) and timed beside cuSPARSE's fp64
    CSR SpMV, its launches per SpMV counted; the fp64 results of
    SELLWDS/cuda and CSRDS/torch through ``spmv_f64`` against the
    longdouble gold (max relative error < 1e-10) and their fp32 entries
    within 1e-6 of the fp32-x gold, CSR/torch's fp32 gate logged beside
    them; the spmv sweep with RCM on and formats csr, sellw, sellwds and
    csrds (the DS rows judged at the fp64 gate, B13 launched); a traced
    chain of 50 per DS candidate; the CG sweep on shipsec1_spd (csr,
    sellw, sellwds) and the BiCGStab sweep on scircuit_dd (csr, closg),
    every row converged with a relative residual < 1e-5, and one counted
    solve of each (B13's and B1-B3's launches per solve).

Every kernel entry carries its bound: the larger of the bytes the function
must move (each input read once, each output written once, a gather
counting the elements it picks) over the card's data-sheet memory rate and
its fp32 operations over the fp32 peak (``utils/roofline.py``), from this
run's inputs. ``library_ms`` is null for the fp32 SpMV kernels: no single
PyTorch call computes one of their functions (phases 10 and 11 time
cuSPARSE's whole SpMV); the SpMM and SDDMM kernels have cuSPARSE's
(``torch.sparse.mm``, ``torch.sparse.sampled_addmm``), and B13, whose
function is an fp64-accurate SpMV, cuSPARSE's fp64 CSR SpMV (a float64
``torch.sparse_csr`` product), none of which the port ever calls. B16a's entry also carries ``combine_launches``, the sweep's launches
of its second kernel (the sum of a band's chunk partials); its ``ms`` is
the wrapper's, both launches.

Device times hold the card busy (a flush of 1 GiB, then a spin kernel) while
the host enqueues the timed call, so they time the device's work and not
the Python wrapper; a plain version that synchronises inside still includes
its host time. The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# datasets/validation_twins.txt:27, the SuiteSparse DNVS ship-section matrix
SHIPSEC1_LINE = ("140874 140874 55.4637761404 11.0748106399 normal random "
                 "0.0458755451 0.8390381452 1.7123850245 0.8734443677 14 "
                 "shipsec1")
# validation_twins.txt:30 and :31: the Gupta linear-programming matrix
# (dense rows: W = 0 chunks) and the mip1 mixed-integer matrix (rows past
# 16,384 nnz and more than 12 chunks: RSPLIT over CLOSGX)
GUPTA3_LINE = ("16783 16783 555.5280343204 1233.5202594143 normal random "
               "0.5718415058 25.4109083495 1.9016586927 0.9767488489 14 "
               "gupta3")
MIP1_LINE = ("66463 66463 155.7681567188 350.7443175355 normal random "
             "0.5902849043 425.2424451736 1.9249020001 0.9614697347 14 mip1")
# validation_twins.txt line → the program build_clos_gather_auto must give:
# ("RSPLIT", chunk W of the inner ClosGChunked), ("CLOSGX", chunks, W), or
# ("refused", the start of the ClosRoutingError message)
TWINS = "datasets/validation_twins.txt"
KINDS = {17: ("RSPLIT", [1, 1, 1, 1, 32, 32]),
         32: ("refused", "rows [2048,2176) exceed one XL chunk"),
         33: ("CLOSGX", 13, 8),
         36: ("refused", "XL chunk fell back to legacy extraction")}
STREAM_N = 1_200_000      # > 2^20 columns: a stream_wins SELLW program
# the JAX package's SpMM/SDDMM CSV labels (spmv_research_tpu/harness/
# sweep.py:_labels_for)
WORKLOAD_LABELS = ("matrix_name,format_name,impl,K,time_iter_median,gflops,"
                   "num_loops,mape,max_ae")
CLOSG_SRC = "spmv_research_tpu_torch/csrc/closg.cu"
SELL_SRC = "spmv_research_tpu_torch/csrc/sell.cu"
# the TPU kernel each CLOSG wrapper replaces, and its tolerance against the
# plain version (K3 alone adds accumulate records: fp32 add-order slack)
REPLACES = {
    "closg_front": "spmv_research_tpu/ops/clos_gather.py:675",
    "closg_front_lut": "spmv_research_tpu/ops/clos_gather.py:734",
    "closg_front_win": "spmv_research_tpu/ops/clos_gather.py:602",
    "clos_invreg": "spmv_research_tpu/ops/clos_pallas.py:52",
    "closg_r3_scan_yext": "spmv_research_tpu/ops/clos_pallas.py:117",
    "closg_r3_scan": "spmv_research_tpu/ops/clos_pallas.py:106",
    "closg_cand_yext": "spmv_research_tpu/ops/clos_gather.py:752",
    "closgx_r3_scan_yext": "spmv_research_tpu/ops/clos_xl.py:252",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class DeviceTimer:
    """Mean device ms per call of fn, each call timed alone with CUDA events
    after a 1 GiB L2 flush (larger than the 50 MB L2) and a spin kernel of
    ``hold_ms`` that keeps the card busy while the host enqueues the call.
    ``spec`` holds the card's data-sheet rates, for the kernels' bounds."""

    def __init__(self, spec, hold_ms: float = 8.0):
        import torch
        self.spec = spec
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        e0.record()
        torch.cuda._sleep(10_000_000)
        e1.record()
        e1.synchronize()
        self.cycles = int(10_000_000 * hold_ms / e0.elapsed_time(e1))

    def ms(self, fn, iters: int = 30) -> float:
        import torch
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters

    def bound(self, nbytes: float, ops: float) -> tuple:
        """(bound_ms, bound_by): bytes over the memory rate or fp32
        operations over the fp32 peak, whichever takes longer."""
        t_bytes = nbytes / self.spec.hbm_bw * 1e3
        t_ops = ops / (self.spec.peak_tflops * 1e12) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (other arguments count 0)."""
    import torch
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def check_kernel(timer, name, source, replaces, cases, tol_fn, work,
                 library=None):
    """Kernel vs plain version on the same inputs for each (kern, plain) of
    ``cases`` (tolerance ``tol_fn`` of the plain result, or a case's own
    third element: a number, or a tensor of per-element limits), then both
    timed on the first case, whose (bytes, fp32 operations) are ``work``,
    and ``library`` (one PyTorch call of the same function) if given; the
    kernels-JSON entry (launches filled in by the path that launches it)."""
    import torch
    err = 0.0
    for i, (kern, plain, *own_tol) in enumerate(cases):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        d = (got - want).abs()
        e = float(d.max())
        case_tol = own_tol[0] if own_tol else tol_fn
        tol = case_tol(want)
        if not bool((d <= tol).all()):
            fail(f"{name}: case {i}: kernel vs plain max|d|={e} past the "
                 f"tolerance ({case_tol.__doc__})")
        err = max(err, e)
    ms, plain_ms = timer.ms(cases[0][0]), timer.ms(cases[0][1])
    library_ms = timer.ms(library) if library else None
    bound_ms, bound_by = timer.bound(*work)
    log(f"# {name}: max|d|={err} over {len(cases)} case(s), tol "
        f"{tol_fn.__doc__}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{work[0]} B, {work[1]} ops)")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def closg_stages(K, A, xd):
    """(kernel, args, (bytes, ops)) for each kernel of one CLOSG program's
    SpMV, each stage's input made by the plain versions of the stages
    before it (the kernels match them exactly)."""
    from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
    N = A.N
    if A.fused_win:
        front = ("closg_front_win", (A.gbase, A.nbids, A.perm_r1, A.vals_cs,
                                     xd, A.dense_blocks))
    elif A.use_vlut:
        front = ("closg_front_lut", (A.rowidx, A.perm_r1, A.vals_cs, xd))
    else:
        front = ("closg_front", (A.rowidx, A.perm_r1, A.vals_cs, xd))
    yield front[0], front[1], (nbytes(*front[1]) + 4 * N, N)
    v = getattr(K, front[0] + "_torch")(*front[1])
    mid = (_t_fwd(v, A.V), A.perm_r2)
    yield "clos_invreg", mid, (nbytes(*mid) + 4 * N, 0)
    v = _t_bwd(K.clos_invreg_torch(*mid), A.V)
    if A.W:
        stages = A.scan_cap or A.scan_stages
        back = (v, A.perm_r3, A.scan_hi, A.ysel_w, A.wstart, A.acc_ptr,
                A.acc_src, stages)
        y_bytes = 4 * (A.acc_ptr.numel() - 1) * 1024
        # a segmented prefix sum needs one addition per slot, whatever
        # number of stages this scan takes
        yield "closg_r3_scan_yext", back, (
            nbytes(*back) + y_bytes, N + 1024 * A.acc_src.numel())
        return
    scan = (v, A.perm_r3, A.scan_hi, A.scan_stages)
    yield "closg_r3_scan", scan, (nbytes(*scan) + 4 * N, N)
    cand = (K.closg_r3_scan_torch(*scan), A.ycand, A.ysel)
    # ycand, ysel and y, plus the one scanned element each y element picks
    yield "closg_cand_yext", cand, (nbytes(A.ycand, A.ysel)
                                    + 8 * A.ysel.numel(), 0)


def closgx_stages(K, A, xd):
    """As ``closg_stages`` for a CLOSGX stack: K1 and K2 over the stacked
    planes, then B15 over all chunks at once."""
    from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
    C, N, V = A.n_chunks, A.N, A.V
    front = (A.rowidx.view(-1), A.r1.view(-1, 128), A.vals.view(-1, 128), xd)
    yield "closg_front", front, (nbytes(*front) + 4 * C * N, C * N)
    mid = (_t_fwd(K.closg_front_torch(*front), V), A.r2.view(-1, V // 8))
    yield "clos_invreg", mid, (nbytes(*mid) + 4 * C * N, 0)
    back = (_t_bwd(K.clos_invreg_torch(*mid), V), A.r3.view(-1, 128),
            A.ysel_w.view(-1, 128), A.wstart_abs.view(-1), A.stages, N)
    yield "closgx_r3_scan_yext", back, (nbytes(*back) + 4 * A.ysel_w.numel(),
                                        C * N)


def closg_checks(timer, K, programs, xd, suffix="", stages=closg_stages,
                 names=None):
    """The kernels of each program's SpMV (``names``: only these) against
    their plain versions, at the shapes its SpMV gives them; each kernel
    timed on the first program that runs it."""
    cases, work = {}, {}
    for A in programs:
        for name, args, w in stages(K, A, xd):
            if names is not None and name not in names:
                continue
            cases.setdefault(name, []).append(
                (lambda f=getattr(K, name), a=args: f(*a),
                 lambda f=getattr(K, name + "_torch"), a=args: f(*a)))
            work.setdefault(name, w)
    return [check_kernel(timer, name + suffix, CLOSG_SRC, REPLACES[name],
                         cases[name],
                         rel_max if name == "closg_r3_scan_yext" else exact,
                         work[name])
            for name in cases]


def counted_spmv(A, xd, *libs):
    """One SpMV through ``ops.spmv`` between a reset and a read of the
    launch counters of ``libs`` (the kernel modules): (y, launches)."""
    import torch
    from spmv_research_tpu_torch.ops import spmv
    for lib in libs:
        lib.reset_launch_counts()
    y = spmv(A, xd)
    torch.cuda.synchronize()
    return y, {k: v for lib in libs for k, v in lib.LAUNCHES.items()}


def trace_chain(fn, x, n: int = 50) -> str:
    """One chain of n SpMVs (x ← fold(x, fn(x))) under torch.profiler: the
    device time per SpMV (the sum of the device-side events: kernels,
    memsets, copies; the CPU ops that launched them are not added again),
    the wall time per SpMV of the traced chain and of the same chain
    untraced, the busy share (device time over traced wall time), and the
    five device events that take most of the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from spmv_research_tpu_torch.utils.timing import fold

    def chain(v):
        for _ in range(n):
            v = fold(v, fn(v))
        torch.cuda.synchronize()
        return v

    x = chain(x)
    t0 = time.perf_counter()
    x = chain(x)
    plain_wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chain(x)
        wall = (time.perf_counter() - t0) / n
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / n
    dev = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return (f"device {dev:.2f} us, traced wall {wall * 1e6:.2f} us (untraced "
            f"{plain_wall * 1e6:.2f} us), busy share "
            f"{dev / (wall * 1e6):.4f}; top: " + "; ".join(
                f"{k[:48]} {v:.2f} us" for k, v in top))


def exact(_):
    """exact"""
    return 0.0


def rel_max(want):
    """1e-6 of max |plain|"""
    return 1e-6 * float(want.abs().max())


def rel_to_absax(mat, x, y):
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    return float(np.max(np.abs(y - mat @ x) / scale))


def check_gold(label, host, x, y, gold=None):
    """y (a device tensor or array) against the longdouble gold of ``host``
    within 1e-5 of |A|·|x|; returns the relative error."""
    y = np.asarray(y.double().cpu().numpy() if hasattr(y, "cpu") else y)
    if gold is None:
        gold = host.spmv_gold_fast(x).astype(np.float64)
    scale = np.abs(host.to_scipy()) @ np.abs(x) + 1e-30
    rel = float(np.max(np.abs(y - gold) / scale))
    if not (y.shape == (host.m,) and np.isfinite(y).all() and rel <= 1e-5):
        fail(f"{label} y: shape {y.shape}, finite {np.isfinite(y).all()}, "
             f"max |y-gold|/(|A||x|) = {rel}")
    log(f"# {label} y vs longdouble gold: max rel (|A||x|) = {rel}")
    return rel


def time_candidates(timer, label, fns, traced, xd):
    """One SpMV's device time for each of ``fns`` (label → fn(x)), and the
    traced chain of 50 for those named in ``traced``."""
    for key, fn in fns.items():
        log(f"# {label} {key}: one SpMV, device time "
            f"{timer.ms(lambda: fn(xd), iters=10):.4f} ms")
        if key in traced:
            log(f"# {label} {key}, traced chain of 50: {trace_chain(fn, xd)}")


def cusparse(host, dev):
    """The host matrix as a torch sparse CSR tensor on ``dev``: its product
    with x is cuSPARSE's SpMV, a library yardstick the port never calls."""
    import torch
    return torch.sparse_csr_tensor(
        torch.as_tensor(host.ia, dtype=torch.int32),
        torch.as_tensor(host.ja, dtype=torch.int32),
        torch.as_tensor(host.a, dtype=torch.float32),
        size=(host.m, host.n)).to(dev)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from spmv_research_tpu_torch import bench
        from spmv_research_tpu_torch.convert import build_csr
        from spmv_research_tpu_torch.convert.build_best import build_best
        from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
        from spmv_research_tpu_torch.core.host import HostCSR
        from spmv_research_tpu_torch.gen import generate_from_line
        from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
        from spmv_research_tpu_torch.harness.bench import csv_labels
        from spmv_research_tpu_torch.io import native
        from spmv_research_tpu_torch.ops import (ClosG, ClosGChunked, ClosGX,
                                                 RowSplit, SellR, SellW,
                                                 build_clos_gather,
                                                 build_clos_gather_auto,
                                                 build_dense, build_sellw,
                                                 spmv)
        from spmv_research_tpu_torch.ops import btile_cuda as KB
        from spmv_research_tpu_torch.ops import clos_cuda as K
        from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError
        from spmv_research_tpu_torch.ops import sell_cuda as KS
        from spmv_research_tpu_torch.ops.sellw import class_plan
        from spmv_research_tpu_torch.utils.roofline import device_spec
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the repo root")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(dev)
    spec = device_spec(dev)
    if spec is None:
        fail(f"no data-sheet rates for {kind} in utils/roofline.py")
    torch.backends.cuda.matmul.allow_tf32 = False     # DENSE: full fp32
    t_start = time.perf_counter()

    # --- 1. the card and the host library ---
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"native host library loaded: {native.have_native()}; data sheet: "
        f"{spec.hbm_bw / 1e12} TB/s, {spec.peak_tflops} TFLOP/s fp32")

    # --- 2. build the kernels (one nvcc per source, together) ---
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        list(ex.map(lambda lib: lib.build(), (K, KS, KB)))
    log(f"# kernels built in {time.perf_counter() - t0:.2f}s "
        f"({K.SOURCE}, {KS.SOURCE}, {KB.SOURCE})")
    for lib in (K, KS, KB):
        log(f"# nvcc {os.path.basename(lib.SOURCE)}: " + " | ".join(
            ln.strip() for ln in lib.build_log().splitlines()
            if "registers" in ln or "spill" in ln))

    # --- 3. the scircuit program ---
    t0 = time.perf_counter()
    host, _ = generate_from_line(bench.SCIRCUIT_LINE)
    host, _ = rcm_if_beneficial(host)
    fmts = build_best(host)
    A = fmts["CLOSG"][0]
    if not isinstance(A, ClosG) or A.N != 1 << 20:
        fail(f"expected one CLOSG program of 2^20 slots, got "
             f"{type(A).__name__} N={getattr(A, 'N', None)}")
    log(f"# program ({time.perf_counter() - t0:.1f}s): m={A.m} n={A.n} "
        f"nnz={A.nnz} N={A.N} V={A.V} S={8 * A.V} x_rows={A.x_rows} "
        f"W={A.W} scan_stages={len(A.scan_stages)} "
        f"scan_cap={len(A.scan_cap)} yext_classes={A.yext_classes} "
        f"scan_hi={tuple(A.scan_hi.shape)} accum_records="
        f"{A.acc_src.numel()} footprint_MB="
        f"{A.mem_footprint_bytes() / 1e6:.2f}")
    A = A.to(dev)

    # --- 4. CLOSG kernels against their plain versions ---
    timer = DeviceTimer(spec)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, A.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    kernels = closg_checks(timer, K, [A], xd)
    log(f"# launches during one scircuit CLOSG SpMV: "
        f"{counted_spmv(A, xd, K)[1]}")
    csr = build_csr(host).to(dev)
    for key, fn in (("CLOSG/cuda", lambda: spmv(A, xd, impl="cuda")),
                    ("CSR/torch", lambda: spmv(csr, xd, impl="torch"))):
        log(f"# scircuit {key}: one SpMV, device time "
            f"{timer.ms(fn):.4f} ms")
    del csr

    # --- 5. the bench path ---
    K.reset_launch_counts()
    run = bench.run(dev)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(json.dumps(run.json))
    log(f"# launches during the bench path: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"the bench path never launched {k['name']}")
    if run.json["detail"]["best_impl"] != "cuda":
        log("# note: CSR/torch beat CLOSG/cuda")
    Am = run.formats["CLOSG"][0]
    check_gold("CLOSG/cuda", run.host, x, spmv(Am, torch.as_tensor(
        x, dtype=torch.float32, device=dev)))
    for key, r in run.results.items():
        log_metrics(key, r.metrics)
    del run, Am
    log(f"# phases 1-5 done at {time.perf_counter() - t_start:.0f}s")

    # --- 6. the shipsec1 programs ---
    t0 = time.perf_counter()
    ship, _ = generate_from_line(SHIPSEC1_LINE)
    ship, _ = rcm_if_beneficial(ship)
    log(f"# shipsec1 twin: m={ship.m} nnz={ship.nnz} (generate + RCM "
        f"{time.perf_counter() - t0:.1f}s)")
    fmts = build_best(ship)
    if set(fmts) != {"SELLR", "SELLW", "CLOSG"}:
        fail(f"build_best on shipsec1 gave {sorted(fmts)}")
    Ar, Aw, Ac = (fmts[k][0] for k in ("SELLR", "SELLW", "CLOSG"))
    if not (isinstance(Ar, SellR) and isinstance(Aw, SellW)
            and isinstance(Ac, ClosGChunked) and len(Ac.chunks) > 1
            and all(c.W > 0 for c in Ac.chunks)):
        fail(f"shipsec1 programs: {type(Ar).__name__}, {type(Aw).__name__}, "
             f"{type(Ac).__name__} with chunk W "
             f"{[c.W for c in getattr(Ac, 'chunks', ())]}")
    for key, (F, info) in fmts.items():
        log(f"# {key} cold build {info['build_s']:.2f}s, footprint_MB="
            f"{F.mem_footprint_bytes() / 1e6:.2f}")
    log(f"# SELLR: nchunks={Ar.nchunks} nch_pad={Ar.word.shape[0] // 8} "
        f"x_rows={Ar.x_rows} y_rows={Ar.y_rows} stages={Ar.stages} "
        f"rolls={Ar.rolls} groups={Ar.gptr.numel() - 1} "
        f"max_chunks_per_group="
        f"{int((Ar.gptr[1:] - Ar.gptr[:-1]).max())}")
    log(f"# SELLW: nchunks={Aw.nchunks} npad={Aw.wrow.numel() // 8} G={Aw.G} "
        f"K={Aw.K} stages={Aw.stages} classes={Aw.classes} "
        f"stream_wins={Aw.stream_wins}")
    log(f"# CLOSG: {len(Ac.chunks)} chunks, row_split={Ac.row_split}, "
        f"N={[c.N for c in Ac.chunks]}, W={[c.W for c in Ac.chunks]}, "
        f"scan_cap={[len(c.scan_cap) for c in Ac.chunks]}")
    Ar, Aw, Ac = Ar.to(dev), Aw.to(dev), Ac.to(dev)
    xs = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, ship.n)
    xsd = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    w_args = (Aw.word, Aw.vals, Aw.wrow, xsd, class_plan(Aw), Aw.G)
    p_args = (Ar.word, Ar.vals, Ar.smeta, xsd, Ar.nchunks, Ar.stages,
              Ar.rolls)
    f_args = (KS.sellr_place_torch(*p_args), Ar.gptr, Ar.gchunk)
    sell_ops = 2 * Aw.vals.numel()        # a product and a sum per slot
    k_sellw = check_kernel(timer, "sellw", SELL_SRC,
                           "spmv_research_tpu/ops/sellw.py:490",
                           [(lambda: KS.sellw_planes(*w_args),
                             lambda: KS.sellw_planes_torch(*w_args))], exact,
                           (nbytes(*w_args)
                            + nbytes(KS.sellw_planes_torch(*w_args)),
                            sell_ops))
    p_out = f_args[0]
    f_out = KS.sellr_flush_torch(*f_args)
    k_sellr = [check_kernel(timer, f"sellr_{part}", SELL_SRC,
                            "spmv_research_tpu/ops/sellr.py:402",
                            [(lambda f=getattr(KS, f"sellr_{part}"), a=args:
                              f(*a),
                              lambda f=getattr(KS, f"sellr_{part}_torch"),
                              a=args: f(*a))], exact, work)
               for part, args, work in (
                   ("place", p_args, (nbytes(*p_args) + nbytes(p_out),
                                      2 * Ar.vals.numel())),
                   ("flush", f_args, (nbytes(*f_args) + nbytes(f_out),
                                      p_out.numel())))]
    # K1-K3 at the chunks' own shapes, the widest chunk timed
    k_chunks = closg_checks(timer, K, sorted(Ac.chunks, key=lambda c: -c.N),
                            xsd, suffix="_chunked")
    for key, F in (("SELLR", Ar), ("SELLW", Aw), ("CLOSG", Ac)):
        log(f"# launches during one shipsec1 {key} SpMV: "
            f"{counted_spmv(F, xsd, K, KS)[1]}")
    csr = build_csr(ship).to(dev)
    time_candidates(timer, "shipsec1", {
        "SELLR/cuda": lambda v: spmv(Ar, v, impl="cuda"),
        "SELLW/cuda": lambda v: spmv(Aw, v, impl="cuda"),
        "CLOSG/cuda": lambda v: spmv(Ac, v, impl="cuda"),
        "CSR/torch": lambda v: spmv(csr, v, impl="torch")},
        ("SELLR/cuda", "SELLW/cuda", "CLOSG/cuda", "CSR/torch"), xsd)
    del Ar, Ac, csr, fmts, w_args, p_args, f_args, p_out, f_out
    log(f"# phase 6 done at {time.perf_counter() - t_start:.0f}s")

    # --- 7. the streamed SELLW program ---
    rng = np.random.Generator(np.random.PCG64(11))
    import scipy.sparse as sp
    tri = sp.diags([rng.uniform(-1, 1, STREAM_N - 1),
                    rng.uniform(-1, 1, STREAM_N),
                    rng.uniform(-1, 1, STREAM_N - 1)], [-1, 0, 1],
                   shape=(STREAM_N, STREAM_N), format="csr")
    t0 = time.perf_counter()
    As = build_sellw(HostCSR.from_scipy(tri))
    log(f"# streamed SELLW (tridiagonal n={STREAM_N}): build "
        f"{time.perf_counter() - t0:.2f}s nchunks={As.nchunks} "
        f"footprint_MB={As.mem_footprint_bytes() / 1e6:.2f} "
        f"stream_wins={As.stream_wins} classes={As.classes}")
    if not As.stream_wins:
        fail("the n = 1.2M tridiagonal SELLW program is not stream_wins")
    As = As.to(dev)
    xt = rng.uniform(-1.0, 1.0, STREAM_N)
    xtd = torch.as_tensor(xt, dtype=torch.float32, device=dev)
    s_args = (As.word, As.vals, As.wrow, xtd, class_plan(As), As.G)
    k_stream = check_kernel(timer, "sellw_stream", SELL_SRC,
                            "spmv_research_tpu/ops/sellw.py:521",
                            [(lambda: KS.sellw_planes(*s_args,
                                                      stream_wins=True),
                              lambda: KS.sellw_planes_torch(*s_args))], exact,
                            (nbytes(*s_args)
                             + nbytes(KS.sellw_planes_torch(*s_args)),
                             2 * As.vals.numel()))
    KS.reset_launch_counts()
    y = spmv(As, xtd)
    torch.cuda.synchronize()
    k_stream["launches"] = KS.LAUNCHES["sellw_stream"]
    log(f"# launches during the streamed SpMV: {dict(KS.LAUNCHES)}")
    if k_stream["launches"] <= 0:
        fail("the streamed SpMV never launched the SELLW kernel")
    rel = rel_to_absax(tri, xt, y.double().cpu().numpy())
    if not rel <= 1e-5:
        fail(f"streamed SELLW/cuda y: max rel (|A||x|) = {rel}")
    log(f"# streamed SELLW/cuda y vs scipy: max rel (|A||x|) = {rel}; "
        f"one SpMV, device time "
        f"{timer.ms(lambda: spmv(As, xtd), iters=10):.4f} ms")
    del As, s_args, y, tri

    # --- 8. the sweep path ---
    cfg = BenchConfig(min_num_loops=64, min_time_s=1.0,
                      use_rcm_reordering="auto")
    formats = ("csr", "sellr", "sellw", "closg")
    with tempfile.TemporaryDirectory() as out_dir:
        K.reset_launch_counts()
        KS.reset_launch_counts()
        results = run_sweep([SHIPSEC1_LINE], formats=formats,
                            out_dir=out_dir, config=cfg)
        torch.cuda.synchronize()
        launches = {**K.LAUNCHES, **KS.LAUNCHES}
        log(f"# launches during the sweep path: {launches}")
        for name in ("sellw", "sellr_place", "sellr_flush", "closg_front",
                     "clos_invreg", "closg_r3_scan_yext"):
            if launches[name] <= 0:
                fail(f"the sweep path never launched {name}")
        check_csvs(out_dir, csv_labels(synthetic=True),
                   {f"{f}_spmv": 1 for f in formats})
    for k in (k_sellw, *k_sellr, *k_chunks):
        k["launches"] = launches[k["name"].removesuffix("_chunked")]
    check_rows(results, ["CLOSG/cuda", "CSR/torch", "SELLR/cuda",
                         "SELLW/cuda"], {"shipsec1": ship}, xs)
    del results
    log(f"# phases 7-8 done at {time.perf_counter() - t_start:.0f}s")

    # --- 9. the opt-in front ends on the scircuit twin ---
    rng = np.random.Generator(np.random.PCG64(13))
    levels = rng.uniform(-1.0, 1.0, 64)
    hq = HostCSR.from_arrays(host.ia, host.ja,
                             levels[rng.integers(0, 64, host.nnz)],
                             host.m, host.n)
    t0 = time.perf_counter()
    Al = build_clos_gather(hq, value_lut=True)
    Af = build_clos_gather(host, fuse_windows=True)
    log(f"# opt-in programs ({time.perf_counter() - t0:.1f}s): LUT "
        f"use_vlut={Al.use_vlut} footprint_MB="
        f"{Al.mem_footprint_bytes() / 1e6:.2f}; fused fused_win="
        f"{Af.fused_win} dense_blocks={Af.dense_blocks} "
        f"nbids={Af.nbids.numel()} footprint_MB="
        f"{Af.mem_footprint_bytes() / 1e6:.2f}")
    if not (Al.use_vlut and Af.fused_win and Al.N == Af.N == 1 << 20):
        fail("the scircuit opt-in programs lost their front end")
    Al, Af = Al.to(dev), Af.to(dev)
    k_opt = []
    for label, Ao, hh, name in (("LUT", Al, hq, "closg_front_lut"),
                                ("fused", Af, host, "closg_front_win")):
        k = closg_checks(timer, K, [Ao], xd, names=(name,))[0]
        y, launches = counted_spmv(Ao, xd, K)
        log(f"# launches during one {label} SpMV: {launches}")
        k["launches"] = launches[name]
        if k["launches"] <= 0:
            fail(f"the {label} SpMV never launched {name}")
        check_gold(f"CLOSG/cuda ({label})", hh, x, y)
        log(f"# scircuit CLOSG/cuda ({label}): one SpMV, device time "
            f"{timer.ms(lambda: spmv(Ao, xd), iters=10):.4f} ms")
        k_opt.append(k)
    del Al, Af, hq, host
    log(f"# phase 9 done at {time.perf_counter() - t_start:.0f}s")

    # --- 10. the gupta3 twin: W = 0 chunks ---
    t0 = time.perf_counter()
    gup, _ = generate_from_line(GUPTA3_LINE)
    gup, _ = rcm_if_beneficial(gup)
    log(f"# gupta3 twin: m={gup.m} nnz={gup.nnz} max row "
        f"{int(gup.row_lengths().max())} (generate + RCM "
        f"{time.perf_counter() - t0:.1f}s)")
    fmts = build_best(gup)
    Ag = fmts["CLOSG"][0]
    if not (isinstance(Ag, ClosGChunked)
            and all(c.W == 0 for c in Ag.chunks)):
        fail(f"gupta3: expected a chunked CLOSG with W = 0 in every chunk, "
             f"got {type(Ag).__name__} W "
             f"{[c.W for c in getattr(Ag, 'chunks', (Ag,))]}")
    log(f"# gupta3 candidates {sorted(fmts)}; CLOSG cold build "
        f"{fmts['CLOSG'][1]['build_s']:.2f}s: {len(Ag.chunks)} chunks, "
        f"row_split={Ag.row_split}, N={[c.N for c in Ag.chunks]}, "
        f"C={[c.C for c in Ag.chunks]}, stages="
        f"{[len(c.scan_stages) for c in Ag.chunks]}, scan_hi="
        f"{[tuple(c.scan_hi.shape) for c in Ag.chunks]}, footprint_MB="
        f"{Ag.mem_footprint_bytes() / 1e6:.2f}")
    Ag = Ag.to(dev)
    xg = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, gup.n)
    xgd = torch.as_tensor(xg, dtype=torch.float32, device=dev)
    k_w0 = closg_checks(timer, K, sorted(Ag.chunks, key=lambda c: -c.N),
                        xgd, names=("closg_r3_scan", "closg_cand_yext"))
    y, launches = counted_spmv(Ag, xgd, K)
    gup_launches = launches
    log(f"# launches during one gupta3 SpMV: {launches}")
    for k in k_w0:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"the gupta3 SpMV never launched {k['name']}")
    gold_g = gup.spmv_gold_fast(xg).astype(np.float64)
    check_gold("gupta3 CLOSG/cuda", gup, xg, y, gold_g)
    t0 = time.perf_counter()
    Ad = build_dense(gup).to(dev)
    log(f"# gupta3 DENSE: plane {tuple(Ad.mat.shape)}, "
        f"{Ad.mem_footprint_bytes() / 1e9:.3f} GB (build + copy "
        f"{time.perf_counter() - t0:.1f}s)")
    check_gold("gupta3 DENSE/torch", gup, xg, spmv(Ad, xgd), gold_g)
    csr, lib = build_csr(gup).to(dev), cusparse(gup, dev)
    time_candidates(timer, "gupta3", {
        "CLOSG/cuda": lambda v: spmv(Ag, v, impl="cuda"),
        "DENSE/torch": lambda v: spmv(Ad, v, impl="torch"),
        "CSR/torch": lambda v: spmv(csr, v, impl="torch"),
        "cuSPARSE (library)": lambda v: lib @ v.unsqueeze(1)},
        ("CLOSG/cuda", "CSR/torch"), xgd)
    del Ad, csr, lib, fmts, y
    log(f"# phase 10 done at {time.perf_counter() - t_start:.0f}s")

    # --- 11. the mip1 twin: RSPLIT over CLOSGX ---
    t0 = time.perf_counter()
    mip, _ = generate_from_line(MIP1_LINE)
    mip, _ = rcm_if_beneficial(mip)
    lengths = mip.row_lengths()
    log(f"# mip1 twin: m={mip.m} nnz={mip.nnz} rows past 16,384 nnz "
        f"{int((lengths > 16384).sum())}, max row {int(lengths.max())} "
        f"(generate + RCM {time.perf_counter() - t0:.1f}s)")
    fmts = build_best(mip)
    Ax = fmts["CLOSG"][0]
    if not (isinstance(Ax, RowSplit) and isinstance(Ax.inner, ClosGX)):
        fail(f"mip1: expected RSPLIT over CLOSGX, got {type(Ax).__name__} "
             f"over {type(getattr(Ax, 'inner', None)).__name__}")
    X = Ax.inner
    log(f"# mip1 candidates {sorted(fmts)}; cold build "
        f"{fmts['CLOSG'][1]['build_s']:.2f}s: RSPLIT H="
        f"{Ax.heavy_rows.numel()} n_extra={Ax.n_extra} kmax="
        f"{Ax.gidx.shape[1]} over CLOSGX C={X.n_chunks} N={X.N} "
        f"stages={X.stages} W={X.W} mrp={X.mrp} footprint_MB="
        f"{Ax.mem_footprint_bytes() / 1e6:.2f}")
    Ax = Ax.to(dev)
    xm = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, mip.n)
    xmd = torch.as_tensor(xm, dtype=torch.float32, device=dev)
    k_xl = closg_checks(timer, K, [Ax.inner], xmd, stages=closgx_stages)
    y, launches = counted_spmv(Ax, xmd, K)
    log(f"# launches during one mip1 SpMV: {launches}")
    for k in k_xl:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"the mip1 SpMV never launched {k['name']}")
        if k["name"] != "closgx_r3_scan_yext":
            k["name"] += "_xl"
    gold_m = mip.spmv_gold_fast(xm).astype(np.float64)
    check_gold("mip1 RSPLIT/cuda", mip, xm, y, gold_m)
    csr, lib = build_csr(mip).to(dev), cusparse(mip, dev)
    time_candidates(timer, "mip1", {
        "RSPLIT/cuda": lambda v: spmv(Ax, v, impl="cuda"),
        "CSR/torch": lambda v: spmv(csr, v, impl="torch"),
        "cuSPARSE (library)": lambda v: lib @ v.unsqueeze(1)},
        ("RSPLIT/cuda", "CSR/torch"), xmd)
    del Ax, X, csr, lib, fmts, y
    log(f"# phase 11 done at {time.perf_counter() - t_start:.0f}s")

    # --- 12. the sweep on the gupta3 and mip1 lines ---
    formats = ("csr", "closg", "dense")
    with tempfile.TemporaryDirectory() as out_dir:
        K.reset_launch_counts()
        results = run_sweep([GUPTA3_LINE, MIP1_LINE], formats=formats,
                            out_dir=out_dir, config=cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        log(f"# launches during the gupta3 + mip1 sweep: {launches}")
        for name in ("closg_front", "clos_invreg", "closg_r3_scan",
                     "closg_cand_yext", "closgx_r3_scan_yext"):
            if launches[name] <= 0:
                fail(f"the gupta3 + mip1 sweep never launched {name}")
        check_csvs(out_dir, csv_labels(synthetic=True),
                   {"csr_spmv": 2, "closg_spmv": 2, "dense_spmv": 1})
    check_rows(results, ["CLOSG/cuda", "CSR/torch", "CSR/torch",
                         "DENSE/torch", "RSPLIT/cuda"],
               {"gupta3": gup, "mip1": mip}, None,
               {"gupta3": (xg, gold_g), "mip1": (xm, gold_m)})
    del mip, results
    log(f"# phase 12 done at {time.perf_counter() - t_start:.0f}s")

    # --- 13. the program kinds of four more twins ---
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           TWINS)) as f:
        twins = f.read().splitlines()
    for no, want in KINDS.items():
        t0 = time.perf_counter()
        tw, _ = generate_from_line(twins[no - 1])
        if tw.m == tw.n:                    # RCM needs a square matrix
            tw, _ = rcm_if_beneficial(tw)
        try:
            Ak = build_clos_gather_auto(tw)
            got = program_kind(Ak, RowSplit, ClosGChunked, ClosGX)
            shape = (f"{got}, footprint_MB="
                     f"{Ak.mem_footprint_bytes() / 1e6:.2f}")
            del Ak
        except ClosRoutingError as e:
            got = ("refused", str(e)[:len(want[1])])
            shape = f"refused: {e}"
        log(f"# {TWINS}:{no} {twins[no - 1].split()[-1]}: m={tw.m} n={tw.n} "
            f"nnz={tw.nnz}; generate + RCM + build "
            f"{time.perf_counter() - t0:.1f}s: {shape}")
        if got != want:
            fail(f"{TWINS}:{no}: program {got}, want {want}")
    del tw
    log(f"# phase 13 done at {time.perf_counter() - t_start:.0f}s")

    # --- 14. the K-dimension workloads ---
    k_kdim = k_dim_phase(timer, dev, gup, ship, Ag, Aw, gup_launches, cfg)
    del gup, Ag, Aw
    log(f"# phase 14 done at {time.perf_counter() - t_start:.0f}s")

    # --- 15. double-single and solvers ---
    del ship
    k_ds = ds_phase(timer, dev, cfg)
    log(f"# all phases done at {time.perf_counter() - t_start:.0f}s")

    kernels += [*k_chunks, k_sellw, k_stream, *k_sellr, *k_opt, *k_w0,
                *k_xl, *k_kdim, *k_ds]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def k_dim_phase(timer, dev, gup, ship, Ag, Aw, gup_launches, cfg) -> list:
    """Phase 14, the K-dimension workloads at K = 128 (phases 10's gupta3
    and 6's shipsec1 hosts, their CLOSG and SELLW programs, one gupta3
    SpMV's launch counts): B16a and B16b against their plain versions on
    both twins' BTILE programs and timed on gupta3's, B12 against its plain
    version, each timed beside a library call, one CLOSG SpMM through
    ``ops.spmm``,
    and the spmm/sddmm sweep over both lines. Memory: CSR/torch's SDDMM at
    K = 128 gathers two nnz × K planes (9.4 GB on gupta3, 14 GB with the
    product), and the plain BTILE versions hold a step's product per step
    (2.2 GB on shipsec1): all inside the card's 80 GB."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness.workloads import (sddmm_gold,
                                                           sddmm_inputs,
                                                           spmm_inputs)
    from spmv_research_tpu_torch.convert import build_csr
    from spmv_research_tpu_torch.ops import (build_btile, build_dense, sddmm,
                                             spmm)
    from spmv_research_tpu_torch.ops import btile_cuda as KB
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops.sellw import class_plan

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the workloads' comparisons need full fp32")
    k = 128

    # 1. BTILE: B16a and B16b, checked on gupta3's and shipsec1's programs,
    # timed on gupta3's
    def btile_case(label, host):
        """(program, X, A, B, SpMM args, SDDMM args, |A|·|X| per element)
        of ``host``'s BTILE program at K = 128 on the card."""
        t0 = time.perf_counter()
        Ab = build_btile(host)
        log(f"# {label} BTILE ({time.perf_counter() - t0:.1f}s): ntiles="
            f"{Ab.ntiles} nsteps={Ab.nsteps} bands={Ab.ngroups} slots/nnz="
            f"{Ab.ntiles * 1024 / Ab.nnz:.2f} MB="
            f"{Ab.mem_footprint_bytes() / 1e6:.1f} (slab "
            f"{Ab.tiles.numel() * 4 / 1e6:.1f}, pattern "
            f"{Ab.patt.numel() / 1e6:.1f})")
        Ab = Ab.to(dev)
        Xd, Ad, Bd = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (spmm_inputs(host, k), *sddmm_inputs(host, k)))
        xp = F.pad(Xd, (0, 0, 0, Ab.ncb * 128 - host.n))
        ap = F.pad(Ad, (0, 0, 0, Ab.ngroups * 1024 - host.m))
        bp = F.pad(Bd, (0, 0, 0, Ab.ncb * 128 - host.n))
        s_args = (Ab.tiles, Ab.tgt, Ab.step_g, Ab.step_cb, Ab.step_nt,
                  Ab.band_ptr, xp, Ab.ngroups, Ab.max_band_steps)
        d_args = (Ab.patt, Ab.tgt, Ab.step_g, Ab.step_cb, Ab.step_nt, ap, bp)
        # |A|·|X| per element (X ≥ 0; |A| from the tiles)
        yard = KB.btile_spmm_torch(Ab.tiles.abs(), *s_args[1:])
        return Ab, Xd, Ad, Bd, s_args, d_args, yard

    def tol_c(want):
        """1e-5 of Σ|a||b| per slot (the plain result: a, b ≥ 0)"""
        return 1e-5 * want.abs()

    Ab, Xd, Ad, Bd, s_args, d_args, yard_y = btile_case("gupta3", gup)
    _, _, _, _, s_ship, d_ship, yard_ship = btile_case("shipsec1", ship)

    def tol_y(_):
        """1e-5 of |A|·|X| per element"""
        return 1e-5 * yard_y

    def tol_ship(_):
        """1e-5 of |A|·|X| per element (shipsec1)"""
        return 1e-5 * yard_ship

    lib = cusparse(gup, dev)
    live = Ab.ntiles * 1024                      # live tile slots
    # the function's operations are 2·nnz·K; the kernel multiplies every
    # live slot, stored zeros included (2·live·K), which is logged beside
    tile_ms, _ = timer.bound(0, 2 * live * k)
    log(f"# btile_spmm: the kernel's tile products are {2 * live * k} "
        f"operations, {live / gup.nnz:.2f} slots per nnz, {tile_ms:.4f} ms "
        f"at the fp32 peak; the function needs {2 * gup.nnz * k}")
    k_spmm = check_kernel(
        timer, "btile_spmm", "spmv_research_tpu_torch/csrc/btile.cu",
        "spmv_research_tpu/ops/btile.py:215",
        [(lambda: KB.btile_spmm(*s_args), lambda: KB.btile_spmm_torch(
            *s_args)),
         (lambda: KB.btile_spmm(*s_ship), lambda: KB.btile_spmm_torch(
             *s_ship), tol_ship)], tol_y,
        (4 * live + 4 * live // 128 + nbytes(Ab.step_cb, Ab.step_nt,
                                             Ab.band_ptr, Xd)
         + 4 * Ab.ngroups * 1024 * k, 2 * gup.nnz * k),
        library=lambda: torch.sparse.mm(lib, Xd))
    k_sddmm = check_kernel(
        timer, "btile_sddmm", "spmv_research_tpu_torch/csrc/btile.cu",
        "spmv_research_tpu/ops/btile.py:316",
        [(lambda: KB.btile_sddmm(*d_args), lambda: KB.btile_sddmm_torch(
            *d_args)),
         (lambda: KB.btile_sddmm(*d_ship), lambda: KB.btile_sddmm_torch(
             *d_ship))], tol_c,
        (live + 4 * live // 128 + nbytes(Ab.step_g, Ab.step_cb, Ab.step_nt,
                                         Ad, Bd) + 4 * Ab.tiles.numel(),
         2 * gup.nnz * k),
        library=lambda: torch.sparse.sampled_addmm(lib, Ad, Bd.t(),
                                                   beta=0.0))
    del s_ship, d_ship, yard_ship
    log(f"# gupta3 BTILE one SpMM through ops.spmm, device time "
        f"{timer.ms(lambda: spmm(Ab, Xd), iters=10):.4f} ms; one SDDMM "
        f"{timer.ms(lambda: sddmm(Ab, Ad, Bd), iters=10):.4f} ms")
    del Ab, s_args, d_args, yard_y, Xd, Ad, Bd, lib

    # 2. shipsec1 SELLW: B12
    Xs = spmm_inputs(ship, k)
    Xsd = torch.as_tensor(Xs, dtype=torch.float32, device=dev)
    w_args = (Aw.word, Aw.vals, Aw.wrow, Xsd.t().contiguous(), class_plan(Aw),
              Aw.G)
    planes = KS.sellw_spmm_planes_torch(*w_args)
    lib = cusparse(ship, dev)
    k_b12 = check_kernel(
        timer, "sellw_spmm", SELL_SRC, "spmv_research_tpu/ops/sellw.py:634",
        [(lambda: KS.sellw_spmm_planes(*w_args),
          lambda: KS.sellw_spmm_planes_torch(*w_args))], exact,
        (nbytes(*w_args) + nbytes(planes), 2 * Aw.vals.numel() * k),
        library=lambda: torch.sparse.mm(lib, Xsd))
    log(f"# shipsec1 SELLW one SpMM through ops.spmm, device time "
        f"{timer.ms(lambda: spmm(Aw, Xsd), iters=10):.4f} ms")
    del w_args, planes, lib, Xsd

    # 3. one CLOSG SpMM (the column loop) on gupta3 at K = 8
    X8 = np.random.Generator(np.random.PCG64(7)).uniform(0, 1, (gup.n, 8))
    K.reset_launch_counts()
    Y8 = spmm(Ag, torch.as_tensor(X8, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"# launches during one gupta3 CLOSG SpMM (K = 8): {launches}")
    for name in ("closg_r3_scan", "closg_cand_yext"):
        if launches[name] != 8 * gup_launches[name]:
            fail(f"the CLOSG SpMM launched {name} {launches[name]} times, "
                 f"not 8 × {gup_launches[name]}")
    check_y("gupta3 CLOSG/cuda SpMM", gup, X8, Y8.double().cpu().numpy())

    # 4. the spmm/sddmm sweep on both lines
    formats = ("csr", "btile", "dense", "sellw")
    kcfg = dataclasses.replace(cfg, k_dim=k)
    with tempfile.TemporaryDirectory() as out_dir:
        for lib_ in (K, KS, KB):
            lib_.reset_launch_counts()
        results = run_sweep([GUPTA3_LINE, SHIPSEC1_LINE], formats=formats,
                            workloads=("spmm", "sddmm"), out_dir=out_dir,
                            config=kcfg, device=dev)
        torch.cuda.synchronize()
        launches = {**KS.LAUNCHES, **KB.LAUNCHES}
        log(f"# launches during the spmm/sddmm sweep: {launches}")
        for kk in (k_spmm, k_sddmm, k_b12):
            kk["launches"] = launches[kk["name"]]
            if kk["launches"] <= 0:
                fail(f"the spmm/sddmm sweep never launched {kk['name']}")
        # B16a's second launch, its chunks' combine (bands are cut on both)
        k_spmm["combine_launches"] = launches["btile_combine"]
        if launches["btile_combine"] <= 0:
            fail("the spmm/sddmm sweep never launched btile_combine")
        rows = {"csr_spmm": 2, "csr_sddmm": 2, "btile_spmm": 2,
                "btile_sddmm": 2, "dense_spmm": 1, "sellw_spmm": 1}
        got_files = sorted(f for f in os.listdir(out_dir) if f.endswith(".csv"))
        if got_files != sorted(f"{f}.csv" for f in rows):
            fail(f"spmm/sddmm sweep CSVs {got_files}")
        check_csvs(out_dir, WORKLOAD_LABELS, rows)
    want = sorted(["gupta3 CSR/torch spmm", "gupta3 BTILE/cuda spmm",
                   "gupta3 DENSE/torch spmm", "gupta3 CSR/torch sddmm",
                   "gupta3 BTILE/cuda sddmm", "shipsec1 CSR/torch spmm",
                   "shipsec1 BTILE/cuda spmm", "shipsec1 SELLW/cuda spmm",
                   "shipsec1 CSR/torch sddmm", "shipsec1 BTILE/cuda sddmm"])
    got = sorted(f"{r.matrix_name} {r.format_name}/{r.impl} {r.workload}"
                 for r in results)
    if got != want:
        fail(f"spmm/sddmm sweep rows {got}, want {want}")
    hosts = {"gupta3": gup, "shipsec1": ship}
    for r in results:
        host = hosts[r.matrix_name]
        key = f"{r.matrix_name} {r.format_name}/{r.impl} {r.workload}"
        log(f"# sweep {key}: {r.gflops:.2f} GFLOPS median="
            f"{r.time_iter_median * 1e6:.1f}us loops={r.num_loops}")
        if r.workload == "spmm":
            check_y(f"sweep {key}", host, spmm_inputs(host, k), r.out)
        else:
            Am, Bm = sddmm_inputs(host, k)
            gold = sddmm_gold(host, Am, Bm)     # = Σ|a||b|: a, b ≥ 0
            rel = float(np.max(np.abs(r.out - gold) / (gold + 1e-30)))
            if not (r.out.shape == (host.nnz,) and rel <= 1e-5):
                fail(f"sweep {key}: shape {r.out.shape}, max |C-gold|/"
                     f"(Σ|a||b|) = {rel}")
            log(f"# sweep {key} vs fp64 gold: max rel (Σ|a||b|) = {rel}")
        log_metrics(key, r.metrics)
    # 5. the device time of each row's call (one call timed alone)
    for name, host, fmts in (
            ("gupta3", gup, (("CSR", build_csr), ("BTILE", build_btile),
                             ("DENSE", build_dense))),
            ("shipsec1", ship, (("CSR", build_csr), ("BTILE", build_btile),
                                ("SELLW", lambda _: Aw)))):
        X = torch.as_tensor(spmm_inputs(host, k), dtype=torch.float32,
                            device=dev)
        Ad, Bd = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in sddmm_inputs(host, k))
        for fmt, build in fmts:
            Fm = build(host).to(dev)
            log(f"# {name} {fmt} spmm: one call, device time "
                f"{timer.ms(lambda: spmm(Fm, X), iters=5):.4f} ms")
            if fmt in ("CSR", "BTILE"):
                log(f"# {name} {fmt} sddmm: one call, device time "
                    f"{timer.ms(lambda: sddmm(Fm, Ad, Bd), iters=5):.4f} ms")
            del Fm
        del X, Ad, Bd
    return [k_spmm, k_sddmm, k_b12]


def ds_phase(timer, dev, cfg) -> list:
    """Phase 15, double-single and solvers: on the shipsec1 twin with RCM
    (the sweep's host for ``USE_RCM_REORDERING=1``, and the x of its bench)
    the SELLWDS and CSRDS programs, B13 against its plain version and timed
    beside cuSPARSE's fp64 SpMV, the fp64 gate, the DS spmv sweep rows and
    their traces; CG on shipsec1_spd and BiCGStab on scircuit_dd through
    the sweep, and one counted solve of each."""
    import dataclasses
    import torch
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.convert import build_csr
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness.bench import csv_labels
    from spmv_research_tpu_torch.harness.metrics import check_accuracy
    from spmv_research_tpu_torch.harness.sweep import load_matrix
    from spmv_research_tpu_torch.ops import (build_clos_gather_auto,
                                             build_csrds, build_sellwds, spmv)
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops.compensated import SEG, _split_f64
    from spmv_research_tpu_torch.ops.sellw import class_plan
    from spmv_research_tpu_torch.solvers import solve_bicgstab, solve_cg

    t_phase = time.perf_counter()
    # 1. the programs
    dcfg = dataclasses.replace(cfg, use_rcm_reordering=True)
    ship = load_matrix(SHIPSEC1_LINE, dcfg)[0]
    xs = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, ship.n)
    t0 = time.perf_counter()
    Ads = build_sellwds(ship)
    t_w = time.perf_counter() - t0
    t0 = time.perf_counter()
    Acs = build_csrds(ship)
    t_c = time.perf_counter() - t0
    B = Ads.base
    plan = class_plan(B)
    log(f"# shipsec1 SELLWDS (build {t_w:.2f}s): nchunks={B.nchunks} "
        f"npad={B.wrow.numel() // 8} G={B.G} K={B.K} stages={B.stages} "
        f"classes={B.classes} MiB={Ads.mem_footprint_bytes() / 2**20:.1f}")
    log(f"# shipsec1 CSRDS (build {t_c:.2f}s): "
        f"{Acs.vhi.shape[0] - 1} segments x {SEG}, kseg={Acs.kseg}, "
        f"MiB={Acs.mem_footprint_bytes() / 2**20:.1f}")
    Ads, Acs = Ads.to(dev), Acs.to(dev)
    B = Ads.base
    xsd = torch.as_tensor(xs, dtype=torch.float32, device=dev)

    # 2. B13 against its plain version, timed beside cuSPARSE's fp64 SpMV
    xh, xl = (torch.as_tensor(v, device=dev) for v in _split_f64(xs))
    args = (B.word, B.vals, Ads.vlo, B.wrow, xh, xl, plan, B.G)
    planes = KS.sellwds_planes_torch(*args)
    # per slot: TwoProd and the cross terms (20 operations) and 7 per scan
    # stage of its class; per chunk lane and y block, 8 TwoSum folds (8
    # each)
    ops = sum(cnt * 1024 * (20 + 7 * st) + cnt * 128 * B.G * 64
              for _, cnt, st in plan)
    lib64 = torch.sparse_csr_tensor(
        torch.as_tensor(ship.ia, dtype=torch.int32),
        torch.as_tensor(ship.ja, dtype=torch.int32),
        torch.as_tensor(ship.a, dtype=torch.float64),
        size=(ship.m, ship.n)).to(dev)
    x64 = torch.as_tensor(xs, dtype=torch.float64, device=dev)
    k_b13 = check_kernel(
        timer, "sellwds", SELL_SRC, "spmv_research_tpu/ops/sellw_ds.py:154",
        [(lambda: KS.sellwds_planes(*args),
          lambda: KS.sellwds_planes_torch(*args))], exact,
        (nbytes(*args) + nbytes(planes), ops),
        library=lambda: lib64 @ x64.unsqueeze(1))
    y, launches = counted_spmv(Ads, xsd, KS)
    log(f"# launches during one shipsec1 SELLWDS SpMV: {launches} "
        f"({len(plan)} stage classes)")
    if launches["sellwds"] != sum(1 for _, cnt, _ in plan if cnt):
        fail(f"one SELLWDS SpMV launched B13 {launches['sellwds']} times")
    y64 = (lib64 @ x64.unsqueeze(1)).squeeze(1).cpu().numpy()
    log(f"# cuSPARSE fp64 SpMV vs longdouble gold: max rel = "
        f"{check_accuracy(ship, xs, y64, np.float64).max_rel_err}")
    del planes, y, lib64, x64, y64

    # 3. the fp64 gate (and the fp32 entries, and CSR/torch's fp32 row)
    gold32 = ship.to_scipy() @ xs.astype(np.float32).astype(np.float64)
    for label, A in (("SELLWDS/cuda", Ads), ("CSRDS/torch", Acs)):
        t0 = time.perf_counter()
        y = A.spmv_f64(xs)
        t_f64 = time.perf_counter() - t0
        m = check_accuracy(ship, xs, y, value_dtype=np.float64)
        log(f"# {label} spmv_f64 ({t_f64:.2f}s on the host clock) vs "
            f"longdouble gold: max rel = {m.max_rel_err}, fp64 gate "
            f"(1e-10) passed={m.passed}")
        if not (y.shape == (ship.m,) and np.isfinite(y).all() and m.passed
                and m.max_rel_err < 1e-10):
            fail(f"{label} fails the fp64 gate: max rel {m.max_rel_err}")
        y32 = spmv(A, xsd).double().cpu().numpy()
        rel32 = float(np.max(np.abs(y32 - gold32)
                             / np.maximum(np.abs(gold32), 1e-300)))
        log(f"# {label} fp32 entry vs the fp32-x gold: max rel = {rel32}")
        if not rel32 < 1e-6:
            fail(f"{label} fp32 entry: max rel {rel32} past 1e-6")
    csr = build_csr(ship).to(dev)
    m = check_accuracy(ship, xs, spmv(csr, xsd).double().cpu().numpy(),
                       value_dtype=np.float32)
    log(f"# CSR/torch (fp32, for contrast) vs longdouble gold: max rel = "
        f"{m.max_rel_err}, fp32 gate (1e-7) passed={m.passed}")
    del csr

    # 4. the spmv sweep rows, RCM on
    formats = ("csr", "sellw", "sellwds", "csrds")
    with tempfile.TemporaryDirectory() as out_dir:
        KS.reset_launch_counts()
        results = run_sweep([SHIPSEC1_LINE], formats=formats,
                            out_dir=out_dir, config=dcfg, device=dev)
        torch.cuda.synchronize()
        launches = dict(KS.LAUNCHES)
        log(f"# launches during the DS spmv sweep: {launches}")
        for name in ("sellw", "sellwds"):
            if launches[name] <= 0:
                fail(f"the DS spmv sweep never launched {name}")
        check_csvs(out_dir, csv_labels(synthetic=True),
                   {f"{f}_spmv": 1 for f in formats})
    k_b13["launches"] = launches["sellwds"]
    check_rows(results, ["CSR/torch", "SELLW/cuda", "SELLWDS/cuda",
                         "CSRDS/torch"], {"shipsec1": ship}, xs)
    for r in results:
        ds = r.format_name in ("SELLWDS", "CSRDS")
        if ds != (r.roofline_kind == "csr64") or (ds and not (
                r.metrics.passed and r.metrics.max_rel_err < 1e-10)):
            fail(f"sweep {r.format_name}/{r.impl}: roofline "
                 f"{r.roofline_kind}, max rel {r.metrics.max_rel_err}")
        log(f"# sweep {r.format_name}/{r.impl}: roofline_frac "
            f"{r.roofline_frac:.4f} ({r.roofline_kind}), achieved "
            f"{r.achieved_gbps:.1f} GB/s")
    del results

    # 5. the DS candidates, one SpMV each and a traced chain of 50
    time_candidates(timer, "shipsec1", {
        "SELLWDS/cuda": lambda v: spmv(Ads, v, impl="cuda"),
        "CSRDS/torch": lambda v: spmv(Acs, v, impl="torch")},
        ("SELLWDS/cuda", "CSRDS/torch"), xsd)
    del Ads, Acs, args, xh, xl, ship
    log(f"# phase 15 DS part done in {time.perf_counter() - t_phase:.0f}s")

    # 6. CG on shipsec1_spd, 7. BiCGStab on scircuit_dd
    def bench_b(m):
        """bench_cg's b: uniform in [0, 1) from PCG64(13)."""
        return np.random.Generator(np.random.PCG64(13)).uniform(0, 1, m)

    for workload, line, transform, fmts, libs, build, solve, rows in (
            ("cg", SHIPSEC1_LINE, "spd", ("csr", "sellw", "sellwds"), (KS,),
             build_sellwds, solve_cg,
             ["CSR/torch", "SELLW/cuda", "SELLWDS/cuda"]),
            ("bicgstab", bench.SCIRCUIT_LINE, "dd", ("csr", "closg"), (K,),
             build_clos_gather_auto, solve_bicgstab,
             ["CSR/torch", "CLOSG/cuda"])):
        scfg = dataclasses.replace(
            cfg, use_rcm_reordering=True if workload == "cg" else "auto",
            matrix_transform=transform, cg_max_num_iters=50)
        with tempfile.TemporaryDirectory() as out_dir:
            for lib in libs:
                lib.reset_launch_counts()
            results = run_sweep([line], formats=fmts, workloads=(workload,),
                                out_dir=out_dir, config=scfg, device=dev)
            torch.cuda.synchronize()
            launches = {k: v for lib in libs for k, v in lib.LAUNCHES.items()}
            log(f"# launches during the {workload} sweep: {launches}")
            check_csvs(out_dir, WORKLOAD_LABELS,
                       {f"{f}_{workload}": 1 for f in fmts})
        got = sorted(f"{r.format_name}/{r.impl}" for r in results)
        if got != sorted(rows):
            fail(f"{workload} sweep rows {got}, want {sorted(rows)}")
        for r in results:
            e = r.extra
            log(f"# {workload} {r.matrix_name} {r.format_name}/{r.impl}: "
                f"converged={e['converged']} iterations={r.num_loops} "
                f"relative residual={e['relative_residual']} solve "
                f"{e['solve_time'] * 1e3:.4f} ms, per iteration "
                f"{r.time_iter_median * 1e6:.1f} us, {r.gflops:.2f} GFLOPS, "
                f"first solve {e['compile_time']:.2f}s, preconditioner "
                f"{e['precond_setup_time']:.3f}s")
            if not (e["converged"] and e["relative_residual"] < 1e-5):
                fail(f"{workload} {r.format_name}/{r.impl} did not converge "
                     f"below 1e-5: {e}")
        # one solve of the engine, counted
        host = load_matrix(line, scfg)[0]
        A = build(host).to(dev)
        for lib in libs:
            lib.reset_launch_counts()
        x, info = solve(host, A, bench_b(host.m), max_iters=50, rtol=1e-6)
        torch.cuda.synchronize()
        launches = {k: v for lib in libs for k, v in lib.LAUNCHES.items()
                    if v}
        prog = getattr(A, "base", None)
        shape = (f" (nchunks={prog.nchunks} K={prog.K} classes="
                 f"{prog.classes})" if prog is not None else "")
        log(f"# one {workload} solve on {type(A).__name__}{shape}: "
            f"iterations={int(info['iterations'])} (loop "
            f"{info['loop_iterations']}), converged="
            f"{bool(info['converged'])}, launches {launches}")
        if not launches:
            fail(f"the counted {workload} solve launched no kernel")
        del host, A, x, results
    log(f"# phase 15 done in {time.perf_counter() - t_phase:.0f}s")
    return [k_b13]


def check_y(label, host, X, Y) -> None:
    """Y (m, K) against the fp64 product within 1e-5 of |A|·|X|."""
    mat = host.to_scipy()
    scale = np.abs(mat) @ np.abs(X) + 1e-30
    rel = float(np.max(np.abs(Y - mat @ X) / scale))
    if not (Y.shape == (host.m, X.shape[1]) and np.isfinite(Y).all()
            and rel <= 1e-5):
        fail(f"{label}: shape {Y.shape}, max |Y-gold|/(|A||X|) = {rel}")
    log(f"# {label} vs fp64 gold: max rel (|A||X|) = {rel}")


def program_kind(A, RowSplit, ClosGChunked, ClosGX):
    """("RSPLIT", inner chunk W) for an RSPLIT over a ClosGChunked,
    ("CLOSGX", chunks, W), else the format's name."""
    if isinstance(A, RowSplit) and isinstance(A.inner, ClosGChunked):
        return ("RSPLIT", [c.W for c in A.inner.chunks])
    if isinstance(A, ClosGX):
        return ("CLOSGX", A.n_chunks, A.W)
    return (A.format_name,)


def check_csvs(out_dir, labels, rows) -> None:
    """Each CSV ``<name>.csv`` of ``rows`` (name -> row count): the JAX
    labels, then that many rows."""
    for name, n in rows.items():
        with open(os.path.join(out_dir, f"{name}.csv")) as f:
            lines = f.read().splitlines()
        if lines[0] != labels or len(lines) != 1 + n:
            fail(f"{name}.csv: {len(lines)} lines (want {1 + n}), labels "
                 f"{'ok' if lines[0] == labels else 'wrong'}")


def check_rows(results, want, hosts, x, golds=None) -> None:
    """The sweep's rows are ``want`` (sorted FORMAT/impl), and each row's y
    is within 1e-5 of |A|·|x| of its matrix's longdouble gold."""
    got = sorted(f"{r.format_name}/{r.impl}" for r in results)
    if got != sorted(want):
        fail(f"sweep results {got}, want {sorted(want)}")
    for r in results:
        host = hosts[r.matrix_name]
        xr, gold = (golds or {}).get(r.matrix_name, (x, None))
        key = f"{r.matrix_name} {r.format_name}/{r.impl}"
        log(f"# sweep {key}: {r.nnz_per_s / 1e9:.4f} Gnnz/s median="
            f"{r.time_iter_median * 1e6:.1f}us min="
            f"{r.time_iter_min * 1e6:.1f}us max="
            f"{r.time_iter_max * 1e6:.1f}us loops={r.num_loops} "
            f"convert={r.time_convert:.2f}s")
        check_gold(f"sweep {key}", host, xr, r.y, gold)
        log_metrics(key, r.metrics)


def log_metrics(key, m) -> None:
    log(f"# {key} metrics: mae={m.mae} max_ae={m.max_ae} mse={m.mse} "
        f"mape={m.mape} smape={m.smape} lnQ_error={m.lnQ_error} "
        f"mlare={m.mlare} gmare={m.gmare} max_rel_err={m.max_rel_err} "
        f"gate passed={m.passed} (1e-7; the DS rows' fp64 gate 1e-10)")


if __name__ == "__main__":
    main()
