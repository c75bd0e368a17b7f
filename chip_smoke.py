#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and the repository checkout (it imports
``spmv_research_tpu_torch`` and nothing of JAX). Phases, each fatal on
failure (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and whether the native
   host library loaded;
2. build the CUDA kernels from ``spmv_research_tpu_torch/csrc/closg.cu``
   and ``csrc/sell.cu`` (one nvcc each, started together) and print their
   ptxas lines;
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
   longdouble gold; the 8 error metrics per row.

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
STREAM_N = 1_200_000      # > 2^20 columns: a stream_wins SELLW program


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class DeviceTimer:
    """Mean device ms per call of fn, each call timed alone with CUDA events
    after a 1 GiB L2 flush (larger than the 50 MB L2) and a spin kernel of
    ``hold_ms`` that keeps the card busy while the host enqueues the call."""

    def __init__(self, hold_ms: float = 8.0):
        import torch
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


def check_kernel(timer, name, source, replaces, cases, tol_fn):
    """Kernel vs plain version on the same inputs for each (kern, plain) of
    ``cases`` (tolerance from the plain result), then both timed on the
    first case; the kernels-JSON entry (launches filled in by the path that
    launches it)."""
    import torch
    err = 0.0
    for i, (kern, plain) in enumerate(cases):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        tol = tol_fn(want)
        if not (e <= tol):
            fail(f"{name}: case {i}: kernel vs plain max|d|={e} > {tol}")
        err = max(err, e)
    ms, plain_ms = timer.ms(cases[0][0]), timer.ms(cases[0][1])
    log(f"# {name}: max|d|={err} over {len(cases)} case(s), tol "
        f"{tol_fn.__doc__}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def closg_checks(timer, K, programs, xd, suffix=""):
    """K1, K2 and K3 against their plain versions on each CLOSG program of
    ``programs`` (the first is timed), at the shapes its SpMV gives them."""
    from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
    cases = {"closg_front": [], "clos_invreg": [], "closg_r3_scan_yext": []}
    for A in programs:
        front = (A.rowidx, A.perm_r1, A.vals_cs, xd)
        mid = (_t_fwd(K.closg_front_torch(*front), A.V), A.perm_r2)
        back = (_t_bwd(K.clos_invreg_torch(*mid), A.V), A.perm_r3, A.scan_hi,
                A.ysel_w, A.wstart, A.acc_ptr, A.acc_src,
                A.scan_cap or A.scan_stages)
        for name, args in (("closg_front", front), ("clos_invreg", mid),
                           ("closg_r3_scan_yext", back)):
            cases[name].append(
                (lambda f=getattr(K, name), a=args: f(*a),
                 lambda f=getattr(K, name + "_torch"), a=args: f(*a)))
    src = "spmv_research_tpu_torch/csrc/closg.cu"
    return [check_kernel(timer, name + suffix, src, replaces, cases[name], tol)
            for name, replaces, tol in (
                ("closg_front", "spmv_research_tpu/ops/clos_gather.py:675",
                 exact),
                ("clos_invreg", "spmv_research_tpu/ops/clos_pallas.py:52",
                 exact),
                ("closg_r3_scan_yext",
                 "spmv_research_tpu/ops/clos_pallas.py:117", rel_max))]


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
        from spmv_research_tpu_torch.ops import (ClosG, ClosGChunked, SellR,
                                                 SellW, build_sellw, spmv)
        from spmv_research_tpu_torch.ops import clos_cuda as K
        from spmv_research_tpu_torch.ops import sell_cuda as KS
        from spmv_research_tpu_torch.ops.sellw import class_plan
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from the repo root")
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(dev)
    t_start = time.perf_counter()

    # --- 1. the card and the host library -----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"native host library loaded: {native.have_native()}")

    # --- 2. build the kernels (one nvcc per source, together) ---------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda lib: lib.build(), (K, KS)))
    log(f"# kernels built in {time.perf_counter() - t0:.2f}s "
        f"({K.SOURCE}, {KS.SOURCE})")
    for lib in (K, KS):
        log(f"# nvcc {os.path.basename(lib.SOURCE)}: " + " | ".join(
            ln.strip() for ln in lib.build_log().splitlines()
            if "registers" in ln or "spill" in ln))

    # --- 3. the scircuit program ----------------------------------------------
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

    # --- 4. CLOSG kernels against their plain versions ------------------------
    timer = DeviceTimer()
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, A.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    kernels = closg_checks(timer, K, [A], xd)
    csr = build_csr(host).to(dev)
    for key, fn in (("CLOSG/cuda", lambda: spmv(A, xd, impl="cuda")),
                    ("CSR/torch", lambda: spmv(csr, xd, impl="torch"))):
        log(f"# scircuit {key}: one SpMV, device time "
            f"{timer.ms(fn):.4f} ms")
    del csr

    # --- 5. the bench path -----------------------------------------------------
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
    y = spmv(Am, torch.as_tensor(x, dtype=torch.float32, device=dev))
    y = y.double().cpu().numpy()
    gold = run.host.spmv_gold_fast(x).astype(np.float64)
    scale = np.abs(run.host.to_scipy()) @ np.abs(x) + 1e-30
    rel = float(np.max(np.abs(y - gold) / scale))
    if not (y.shape == (run.host.m,) and np.isfinite(y).all() and rel <= 1e-5):
        fail(f"CLOSG/cuda y: shape {y.shape}, finite {np.isfinite(y).all()}, "
             f"max |y-gold|/(|A||x|) = {rel}")
    log(f"# CLOSG/cuda y vs longdouble gold: max rel (|A||x|) = {rel}")
    for key, r in run.results.items():
        log_metrics(key, r.metrics)
    del run, Am
    log(f"# phases 1-5 done at {time.perf_counter() - t_start:.0f}s")

    # --- 6. the shipsec1 programs ----------------------------------------------
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
    sell_src = "spmv_research_tpu_torch/csrc/sell.cu"
    w_args = (Aw.word, Aw.vals, Aw.wrow, xsd, class_plan(Aw), Aw.G)
    p_args = (Ar.word, Ar.vals, Ar.smeta, xsd, Ar.nchunks, Ar.stages,
              Ar.rolls)
    f_args = (KS.sellr_place_torch(*p_args), Ar.gptr, Ar.gchunk)
    k_sellw = check_kernel(timer, "sellw", sell_src,
                           "spmv_research_tpu/ops/sellw.py:490",
                           [(lambda: KS.sellw_planes(*w_args),
                             lambda: KS.sellw_planes_torch(*w_args))], exact)
    k_sellr = [check_kernel(timer, f"sellr_{part}", sell_src,
                            "spmv_research_tpu/ops/sellr.py:402",
                            [(lambda f=getattr(KS, f"sellr_{part}"), a=args:
                              f(*a),
                              lambda f=getattr(KS, f"sellr_{part}_torch"),
                              a=args: f(*a))], exact)
               for part, args in (("place", p_args), ("flush", f_args))]
    # K1-K3 at the chunks' own shapes, the widest chunk timed
    k_chunks = closg_checks(timer, K, sorted(Ac.chunks, key=lambda c: -c.N),
                            xsd, suffix="_chunked")
    csr = build_csr(ship).to(dev)
    for key, fn in (("SELLR/cuda", lambda v: spmv(Ar, v, impl="cuda")),
                    ("SELLW/cuda", lambda v: spmv(Aw, v, impl="cuda")),
                    ("CLOSG/cuda", lambda v: spmv(Ac, v, impl="cuda")),
                    ("CSR/torch", lambda v: spmv(csr, v, impl="torch"))):
        log(f"# shipsec1 {key}: one SpMV, device time "
            f"{timer.ms(lambda: fn(xsd), iters=10):.4f} ms")
        log(f"# shipsec1 {key}, traced chain of 50: {trace_chain(fn, xsd)}")
    del Ar, Aw, Ac, csr, fmts, w_args, p_args, f_args
    log(f"# phase 6 done at {time.perf_counter() - t_start:.0f}s")

    # --- 7. the streamed SELLW program -----------------------------------------
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
    k_stream = check_kernel(timer, "sellw_stream", sell_src,
                            "spmv_research_tpu/ops/sellw.py:521",
                            [(lambda: KS.sellw_planes(*s_args,
                                                      stream_wins=True),
                              lambda: KS.sellw_planes_torch(*s_args))], exact)
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

    # --- 8. the sweep path -----------------------------------------------------
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
        for name in ("sellw", "sellr_place", "sellr_flush", *K.LAUNCHES):
            if launches[name] <= 0:
                fail(f"the sweep path never launched {name}")
        for fmt in formats:
            with open(os.path.join(out_dir, f"{fmt}_spmv.csv")) as f:
                lines = f.read().splitlines()
            if lines[0] != csv_labels(synthetic=True) or len(lines) != 2:
                fail(f"{fmt}_spmv.csv: {len(lines)} lines, labels "
                     f"{'ok' if lines[0] == csv_labels(True) else 'wrong'}")
    for k in (k_sellw, *k_sellr, *k_chunks):
        k["launches"] = launches[k["name"].removesuffix("_chunked")]
    got = sorted(f"{r.format_name}/{r.impl}" for r in results)
    if got != ["CLOSG/cuda", "CSR/torch", "SELLR/cuda", "SELLW/cuda"]:
        fail(f"sweep results {got}")
    gold = ship.spmv_gold_fast(xs).astype(np.float64)
    scale = np.abs(ship.to_scipy()) @ np.abs(xs) + 1e-30
    for r in results:
        rel = float(np.max(np.abs(r.y - gold) / scale))
        key = f"{r.format_name}/{r.impl}"
        log(f"# sweep {key}: {r.nnz_per_s / 1e9:.4f} Gnnz/s median="
            f"{r.time_iter_median * 1e6:.1f}us min="
            f"{r.time_iter_min * 1e6:.1f}us max="
            f"{r.time_iter_max * 1e6:.1f}us loops={r.num_loops} "
            f"convert={r.time_convert:.2f}s; y vs longdouble gold: max rel "
            f"(|A||x|) = {rel}")
        log_metrics(key, r.metrics)
        if not (r.y.shape == (ship.m,) and np.isfinite(r.y).all()
                and rel <= 1e-5):
            fail(f"sweep {key} y: max |y-gold|/(|A||x|) = {rel}")
    log(f"# all phases done at {time.perf_counter() - t_start:.0f}s")

    kernels += [*k_chunks, k_sellw, k_stream, *k_sellr]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def log_metrics(key, m) -> None:
    log(f"# {key} metrics: mae={m.mae} max_ae={m.max_ae} mse={m.mse} "
        f"mape={m.mape} smape={m.smape} lnQ_error={m.lnQ_error} "
        f"mlare={m.mlare} gmare={m.gmare} max_rel_err={m.max_rel_err} "
        f"gate(1e-7) passed={m.passed}")


if __name__ == "__main__":
    main()
