#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py              # phases 1-21
    python3 chip_smoke.py --phase 20   # phases 1, 2 and 20 alone
    python3 chip_smoke.py --phase 21   # phases 1, 2 and 21 alone

Needs one CUDA card, nvcc, and the repository checkout (it imports
``spmv_research_tpu_torch`` and nothing of JAX). Each run points
``SPARSE_FORMAT_CACHE_TORCH`` at an empty directory of its own (removed at
its end): every build is cold the first time, and a later phase that
builds what an earlier phase built (the same matrix, format and kwargs:
phase 5's scircuit CLOSG, phase 8's shipsec1 programs, phase 12's gupta3
and mip1 CLOSG, phase 14's sweep BTILE programs, phase 16's sweeps' CLOS
and BFLY, ...) loads it; the kernel checks run on the loaded programs all
the same, and the cache's hits, misses, saved host seconds and the
seconds its saves cost are printed before phase 20. Phases, each fatal on failure (non-zero exit,
no result line):

1. the card (``nvidia-smi`` name and power limit) and whether the native
   host library loaded;
2. build the CUDA kernels from ``spmv_research_tpu_torch/csrc/closg.cu``,
   ``csrc/sell.cu``, ``csrc/btile.cu`` and ``csrc/bfly.cu`` (one nvcc
   each, started together) and print their ptxas lines (the phased scan's
   kernels by name, adding and selecting);
3. generate the full-size scircuit twin (bench.py's line), RCM, build the
   CLOSG program (asserts N = 2^20, one program) and print its fields;
4. each CLOSG kernel against its plain PyTorch version on the card, at the
   main path's shapes (B1 and B2's ``clos_r2``, the r2 layer with its
   transposes, exact; K3 within 1e-6 of max |y|), both timed with CUDA
   events (L2 flushed before each call); B1 and ``clos_r2`` also timed warm
   (back to back, inputs in the L2), and ``clos_r2`` beside the same
   function as two PyTorch transposes around the natural-layout layer
   kernel (``unfolded_ms``, the parent's three launches), B1's persistent
   grid logged; K3's phase plan logged and one counted SpMV (4 wrapper
   launches: B1, ``clos_r2``, K3 once a phase of its plan and once for the
   extraction, asserted); a profiled run of 10 SpMVs (4 device kernels a
   SpMV and no copy, asserted); the device time of one whole CLOSG/cuda
   and CSR/torch SpMV, and CLOSG/cuda's traced chain of 50;
5. the bench path: ``spmv_research_tpu_torch.bench.run`` end to end, with
   the kernels' launch counters reset just before and read just after (each
   must have launched); y checked against the longdouble gold within 1e-5
   of |A|·|x|; the 8 error metrics and the ε gate printed;
6. the shipsec1 twin (datasets/validation_twins.txt:27): RCM, ``build_best``
   (asserts SELLR, SELLW and a chunked CLOSG with W > 0 in every chunk),
   each program's fields, the SELLW kernel and SELLR's two kernels against
   their plain versions (exact) and timed beside cuSPARSE's SpMV of the
   same matrix (their persistent grids, blocks an SM and registers
   logged), K1-K3 against theirs on every
   CLOSG chunk (tolerances as in phase 4; the widest chunk timed), K3's
   plan on the widest chunk logged and one counted SpMV of each chunk and
   of the program (K3 once a phase of each chunk's plan + the extraction,
   asserted), and per candidate the device time of one whole SpMV and a
   torch.profiler trace of a chain of 50 (device time, wall time, busy
   share, top events);
7. a streamed SELLW program (seeded tridiagonal, n = 1.2M, so
   ``stream_wins``): the kernel against its plain version, timed beside
   cuSPARSE's SpMV of the same matrix, then one
   SpMV through ``ops.spmv`` between a reset and a read of the counters,
   y within 1e-5 of |A|·|x|;
8. the sweep path: ``harness.run_sweep`` on the shipsec1 line with formats
   csr, sellr, sellw and closg, counters reset before and read after (the
   SELLW, SELLR and CLOSG kernels must each have launched); four CSV rows
   under the JAX labels; each engine's y within 1e-5 of |A|·|x| of the
   longdouble gold; the 8 error metrics per row;
9. the opt-in front ends on the scircuit twin: a value-LUT program (values
   quantised to 64 seeded levels) and a ``fuse_windows=True`` program; B4
   and B7 (B1's persistent tile body in its LUT and window modes) against
   their plain versions (exact) and timed cold and warm, their persistent
   grids and registers logged; one SpMV of each
   through ``ops.spmv`` between a reset and a read of the counters, y within
   1e-5 of |A|·|x| of the gold;
10. the gupta3 twin (validation_twins.txt:30): ``build_best`` (asserts a
    chunked CLOSG with W = 0 in every chunk), B1, ``clos_r2``, B5 and B6
    against their plain versions on every chunk (exact; the widest timed;
    B1 and ``clos_r2`` also warm and ``clos_r2`` beside ``unfolded_ms``),
    B6 as the SpMV runs it, one launch over all chunks with y in place,
    against its plain version (exact) and timed (its entry keeps the
    widest chunk's time as ``chunk_ms``),
    B5's phases on the widest chunk logged, the host time of one B5 call
    and of one SpMV (enqueue only), one SpMV of each chunk (at most 3 phases in its B5
    plan, and B5 launched once per phase, asserted) and one
    of the program through ``ops.spmv`` between a reset and a read of the
    counters (41 wrapper launches: B1 and ``clos_r2`` once a chunk, B5
    once a phase, B6 once, asserted), a profiled SpMV (only those kernels,
    B6 once, no concatenation or copy, asserted), y within 1e-5 of
    |A|·|x|; device
    times of CLOSG/cuda,
    DENSE/torch, CSR/torch and the cuSPARSE product (a library yardstick),
    and the traced chain of 50;
11. the mip1 twin (validation_twins.txt:31): ``build_best`` (asserts an
    RSPLIT over a CLOSGX), B1, ``clos_r2`` and B15 on the stacked planes
    against
    their plain versions (exact) and timed, B15's phases logged, one SpMV
    as in phase 10 (B15 launched once per phase and once for the
    extraction, at most 3 in all, asserted), y within 1e-5 of
    |A|·|x|, device times and the traced chain;
12. the sweep on the gupta3 and mip1 lines with formats csr, closg and
    dense: rows CLOSG/cuda, DENSE/torch and CSR/torch on gupta3, RSPLIT/cuda
    and CSR/torch on mip1 (its 17.7 GB dense plane is refused); B5, B6 and
    B15 must have launched; each y within 1e-5 of |A|·|x| of the gold;
13. the program kind ``build_clos_gather_auto`` gives four more twins of
    validation_twins.txt (RCM where the matrix is square): ASIC_680k (:17)
    an RSPLIT over a 6-chunk CLOSG with W = 1, 1, 1, 1, 32, 32; pwtk (:33) a
    13-chunk CLOSGX with W = 8; rail4284 (:32) and TSOPF_RS_b2383 (:36)
    refused by the XL tier's guards. Host work only, so it runs in a
    child process (``--program-kinds``) beside phase 14 and its lines
    follow phase 14's;
14. the K-dimension workloads at K = 128 (``k_dim_phase``): gupta3's and
    shipsec1's BTILE programs (ntiles, nsteps, slots/nnz, MB printed) and
    the cut of B16a's launch on each (blocks, chunks per band, K slices,
    shared bytes), B16a and B16b against their plain versions on both
    (within 1e-5 of |A|·|X| per element and of Σ|a||b| per slot) and timed
    on gupta3's beside cuSPARSE's SpMM and SDDMM, B16b's launch logged
    (shared bytes a block, blocks an SM) and B16b timed on shipsec1's, B16a
    also on shipsec1's and at other chunk targets; shipsec1's SELLW
    SpMM kernel B12 (the scan in registers) against its plain
    version (exact), timed beside cuSPARSE's SpMM and its first kernel's
    time; SELLW's combine B12c on B12's planes and on their first column
    (the SpMV's y) against its plain version (exact), timed beside its
    bound and the gather and sum PyTorch ran before it, and one counted
    SELLW SpMM through ``ops.spmm`` (B12 once a stage class, B12c once,
    asserted); one CLOSG SpMM on gupta3 at K = 8
    through ``ops.spmm``
    (B5 and B6 launch 8× their per-SpMV count; Y within 1e-5 of |A|·|X|);
    the sweep with workloads spmm and sddmm, formats csr, btile, dense and
    sellw, on the gupta3 and shipsec1 lines: its ten rows and six CSVs
    under the JAX labels, B16a (its product, and its chunks' combine where
    a band is cut), B16b, B12 and B12c launched, every row within
    1e-5 of the fp64 gold's |·| yardstick, the 8 error metrics printed;
    then each row's call timed alone on the card;
15. double-single and solvers (``ds_phase``): the shipsec1 twin with RCM
    (``USE_RCM_REORDERING=1``, as ``load_matrix`` makes it), SELLWDS and
    CSRDS built (chunks, classes, MiB, seconds); B13 against its plain
    version on every stage class (exact) and timed beside cuSPARSE's fp64
    CSR SpMV, the combine kernel against its plain version (exact) and
    timed; one SpMV's launches counted (B13 once per stage class, the
    combine once, no other); the fp64 results of
    SELLWDS/cuda and CSRDS/torch through ``spmv_f64`` against the
    longdouble gold (max relative error < 1e-10) and their fp32 entries
    within 1e-6 of the fp32-x gold, CSR/torch's fp32 gate logged beside
    them; the spmv sweep with RCM on and formats csr, sellw, sellwds and
    csrds (the DS rows judged at the fp64 gate, B13 and the combine
    launched, B13 once per stage class for each combine); a traced chain
    of 50 per DS candidate; the CG sweep on shipsec1_spd (csr, sellw,
    sellwds) and the BiCGStab sweep on scircuit_dd (csr, closg), every row
    converged with a relative residual < 1e-5, and one counted solve of
    each (B13's, the combine's and B1-B3's launches per solve; on SELLWDS
    B13 once per stage class for each combine);
16. the fallback engines CLOS, CLOSM and BFLY (``fallback_phase``): the
    scircuit twin as the sweep loads it (RCM where it narrows the band), CLOS
    (asserts N = 2^20) and BFLY (N = 2^20, L = 20) built, cold build times
    and program shapes logged; CLOS's r1 layers (``clos_invreg``) and r2
    layers (``clos_r2``, also beside ``unfolded_ms``) on its three
    networks, B8's three parts (fill, scan, valid) and
    B9's three (exchange network, fill, scan) against their plain versions
    on the program's own pipeline inputs (``torch.equal``; the valid step
    at m, over the blocks that hold y, and over the whole plane) and timed,
    each call's phase plan logged (B8's fill and scan one phase each,
    asserted; the valid step also timed over the whole plane); B10
    (the program in phases, one launch a phase) against its plain version
    and B9's chain (``torch.equal``), timed beside cuSPARSE's fp32 SpMV,
    its phases and launches per SpMV logged; one counted
    SpMV per engine (launches per SpMV; CLOS's asserted to be 3
    ``clos_invreg``, 3 ``clos_r2`` and B8 one a phase of the fill's and
    scan's plans + 1, BFLY's B9 launches one
    a phase of its calls' plans, 11); CLOSM, the multicast Clos engine,
    built on the same host (N = 2^20 and a live spill side path
    asserted; its build seconds logged), each of its B2 and B8 calls
    (``clos_invreg`` and ``clos_r2`` on both networks, ``clos_r3_scan``,
    ``clos_r3_valid``) against its plain version on the program's own
    inputs (``torch.equal``) and timed, one counted CLOSM/cuda SpMV (2 +
    2 layers, the scan once a phase, the valid step once, asserted) against
    the gold, and one run of ``harness.bench_spmv`` on it (its launches
    the CLOSM kernel entries'); one SpMV's device time and a
    traced chain of 50 per engine (and B10 and cuSPARSE timed alone); the
    sweep with formats csr, clos and bfly (the B8 and B9 kernels must
    launch, every row within 1e-5 of |A|·|x|); one counted B10 SpMV (one
    launch per phase, at most 20), checked against the gold; then
    mac_econ_fwd500 (validation_twins.txt:6, N = 2^21): ``build_clos``
    and ``build_clos_mcast`` refuse it past ``max_N``, BFLY builds it,
    B9 equals its plain versions there and B10
    (the strided tiling at L = 21) its plain version and B9's chain, timed,
    y against the gold, one counted BFLY/cuda SpMV (B9 one launch a phase
    of its plans, asserted) against the gold, and the sweep with clos and
    bfly skips
    clos as unsuitable and gives a BFLY/cuda row within 1e-5;
17. IC(0)/ILU(0) and the trisolve (``ilu_phase``; plain PyTorch, no hand
    kernel, as the JAX package solves in XLA), on the shipsec1_spd twin
    cut to a quarter of its rows (at full size its factors take chunked
    schedules, too slow for the smoke): the trisolve workload once
    through the sweep (its residual gated at 1e-2, the schedules' kinds
    and step counts, the solve's time), a CG job with ``precond=ic0``
    (SELLW), and a BiCGStab job with ``precond=ilu0`` on scircuit_dd
    (CLOSG), each converged below 1e-5, and per preconditioner one
    apply's device kernels (torch.profiler) and time;
18. SpGEMM and the classic formats (``classic_phase``; plain PyTorch, no
    hand kernel, as the JAX package computes them in XLA), on the
    scircuit (validation_twins.txt:5) and raefsky3 (:7) twins at full
    size: (a) the ``spgemm`` workload through the sweep (C = A·A: one
    row block on scircuit, 8 on raefsky3, asserted, and the plans' pairs
    equal to Σ over A's entries of the length of the B row each meets;
    C within 1e-5 of max |gold| over the blocks the row checks; each
    block's numeric phase profiled: device time and kernels); (b) the
    SpMV rows of coo, csc, ell, sellcs, bsr, csr and csr_sym (scircuit's
    BSR and both twins' CSR_SYM printed as refused), each y within 1e-5
    of |A|·|x|, each format's call timed alone (device ms, host µs a
    call) beside CSR/sparse's, and the CLI job
    ``formats=csr_sym,csr;workloads=spmv;transform=spd`` on raefsky3; (c)
    the K = 128 SpMM rows of ell, bsr, sellcs, coo and csr and the
    SDDMM rows of coo and csr on raefsky3, held to their float64 golds;
    (d) DIA and LDU SpMV through ``ops.spmv`` on phase 7's tridiagonal
    matrix (n = 1.2M), y within 1e-5 of |A|·|x|, timed;
19. the XLA-only engines and real-matrix input (``xla_engines_phase``;
    plain PyTorch, no hand kernel, as the JAX package computes them in
    XLA), on the scircuit, raefsky3 and shipsec1 (:27) twins at full size,
    no RCM: (a) CSR_LUT SpMV and K = 128 SpMM on scircuit, on its own
    values (int32 indices) and on phase 9's 64 levels (int8), asserted;
    (b) SELLG SpMM at K = 128 on raefsky3 and shipsec1; (c) BSRG SpMV and
    K = 128 SpMM and the ``BSR/mxu`` SDDMM on raefsky3, BSRG on scircuit
    refused with ``BSRBuildError``; (d) the ``CSR/gather`` SDDMM at K =
    128 on raefsky3 and shipsec1; (g) the chunked CSR baseline
    ``CSR/torchc`` on shipsec1 at blocks of 2^21 (≥ 4 blocks, asserted)
    and 2^20 nonzeros, SpMV and K = 128 SpMM, beside CSR/torch; each y,
    Y and C within 1e-5 of |A|·|x|,
    |A|·|X| and Σ|a||b|, each call timed alone, cold and warm, with its
    host µs, beside cuSPARSE's (SpMV, ``torch.sparse.mm``,
    ``sampled_addmm``); (e) the raefsky3 SDDMM sweep rows CSR/torch,
    CSR/gather and BSR/mxu, each held to the gold (BSR/mxu through its
    map to CSR order); (f) the ``.mtx`` round trip (``mtx_sweep``):
    scircuit and raefsky3 written as ``.mtx`` and swept from disk and
    from memory (csr, csr_lut, sellg, bsrg; SpMV and K = 16 SpMM; the
    torch impls, deterministic), every disk row equal to its in-memory
    row in m, n, nnz and the 8 metrics, under JAX's real-matrix labels,
    and held to its gold; both files parsed on the native and the numpy
    tier, timed;
20. the format cache, row clustering, tracing and the tools
    (``tooling_phase``), at the main path's full size: (a) ``build_best``
    on the scircuit twin cold and again on the same (fresh) cache
    directory, every entry loaded with every tensor ``torch.equal`` to
    the fresh build's, load and cold build seconds and MB on disk logged,
    the loaded CLOSG program's CLOSG/cuda y bit for bit the fresh
    program's; ``bench.run`` twice on one cache directory, the second
    loading CLOSG (its convert time the load, its cold time the first
    run's build); (b) ``kmeans_reorder`` (k = 16) on the shipsec1 and
    scircuit twins as generated: host seconds, ``bw_avg``,
    ``scatter_avg`` and ``cross_row_similarity_avg`` before and after,
    CSR/torch and CSR/sparse SpMV in both orders timed and, mapped back
    through the permutation, held to the gold; (c) in a child process
    (``--trace-check``: the profiler drops device events late in a long
    process), one CLOSG/cuda SpMV inside ``trace_region`` under
    ``utils.trace.profile``: the region among the profiler's events, B1,
    ``clos_r2``, the scan and the extraction inside its window, a Chrome
    trace written; (d) ``tools.machine_info`` (the name and power limit
    phase 1 read), ``mat_feat`` on the scircuit line, ``twin_fidelity
    --limit 3``, the locality statistics of shipsec1 after RCM and
    ``collect_results`` over the CSVs of phases 8, 12, 14 and 16: corpus
    files for spmv, spmm and sddmm, a speedup over CSR/torch and over
    CSR/sparse for every SpMV matrix, the card in the title; (e)
    ``tools.xl_run`` on pwtk (validation_twins.txt:33, 11.5M nnz, no RCM):
    a CLOSGX of several chunks, B1, ``clos_r2`` and B15 launched, y held
    to the gold, the JSON line's fields (``passed`` is the reference's
    fp32 gate, logged) and the CSV row under the real-matrix labels;
21. the distributed layer (``dist_phase``; ``parallel/``, one process a
    rank): (a) one rank over NCCL (``init_multihost()``: a group of one),
    the shipsec1 twin after RCM through ``build_dist_sellr`` with
    allgather, ring and psum_scatter (the three share one SELLR build
    through the format cache), each y equal to the single-device
    SELLR/cuda SpMV of the same program and held to the gold, one SpMV's
    launches (B14's place and flush once each, asserted), B14 exact to
    its plain versions on the rank's padded program; (b) pwtk (:33, no
    RCM) through ``build_dist_closgx`` with ``overlap`` off (y equal to
    the single-device CLOSGX/cuda SpMV) and on, B1, ``clos_r2`` and B15
    launched (asserted); (c) two ranks on the one card over gloo (two
    processes, ``chip_smoke.py --dist-rank``): (a)'s ring and (b)'s
    overlap, the backend and the bytes staged through host memory a SpMV
    printed, each y held to the gold; no scaling claim; (d)
    ``build_sharded_best`` on gupta3 in two shards on ``[cuda:0,
    cuda:0]`` in this process, each shard's engine printed, y held to the
    gold; (e) ``distributed_cg_step`` on shipsec1_spd and
    ``dist_cg_step_sellr`` on (a)'s allgather program: finite; (f)
    ``tools.weak_scaling --device cuda --ranks 2 --backend gloo`` at
    100k rows a rank, its CSV read back (host-staged). For (a), (b) and
    (d) the distributed SpMV's device ms beside the single-device SpMV
    of the same program, the host µs a call and the launches a SpMV;
    each path's launches go into its kernels' entries as
    ``dist_launches``.

Every sweep with ``csr`` in it gives CSR/torch and CSR/sparse rows side by
side (cuSPARSE's SpMV through the registry: the JAX package's CSR/bcoo),
each y held to 1e-5 of |A|·|x| as every other row's; phase 16 asserts the
pair in the scircuit twin's csr_spmv.csv.

Every kernel entry carries its bound: the larger of the bytes the function
must move (each input read once, each output written once, a gather
counting the elements it picks) over the card's data-sheet memory rate and
its fp32 operations over the fp32 peak (``utils/roofline.py``), from this
run's inputs. ``library_ms`` is null for the Clos and butterfly layers,
scans and networks and the SELLWDS combine: no single PyTorch call
computes one of their functions (phases 10 and 11 time cuSPARSE's whole
SpMV). The locality SpMV kernels (SELLW's B11; SELLR's place and flush,
which write y between them) and B10 have cuSPARSE's fp32 CSR SpMV of the
same matrix; the SpMM and SDDMM kernels have cuSPARSE's
(``torch.sparse.mm``, ``torch.sparse.sampled_addmm``), and B13, whose
function is an fp64-accurate SpMV, cuSPARSE's fp64 CSR SpMV (a float64
``torch.sparse_csr`` product), none of which the port ever calls.
B16a's entry also carries ``combine_launches``, the sweep's launches
of its second kernel (the sum of a cut band's chunk partials); its ``ms``
is the wrapper's, both launches where gupta3's bands are cut.

Device times hold the card busy (a flush of 1 GiB, then a spin kernel) while
the host enqueues the timed call, so they time the device's work and not
the Python wrapper; a plain version that synchronises inside still includes
its host time. The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import io
import json
import os
import shutil
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
# validation_twins.txt:6, the SuiteSparse mac_econ_fwd500 economic model:
# ~1.27M nnz, so N = 2^21 slots: past CLOS, inside BFLY
MAC_ECON_LINE = ("206500 206500 6.1665326877 4.4358653323 normal random "
                 "0.0019079565 6.1352901588 0.1766859930 0.3305090836 14 "
                 "mac_econ_fwd500")
# validation_twins.txt line → the program build_clos_gather_auto must give:
# ("RSPLIT", chunk W of the inner ClosGChunked), ("CLOSGX", chunks, W), or
# ("refused", the start of the ClosRoutingError message)
TWINS = "datasets/validation_twins.txt"
KINDS = {17: ("RSPLIT", [1, 1, 1, 1, 32, 32]),
         32: ("refused", "rows [2048,2176) exceed one XL chunk"),
         33: ("CLOSGX", 13, 8),
         36: ("refused", "XL chunk fell back to legacy extraction")}
STREAM_N = 1_200_000      # > 2^20 columns: a stream_wins SELLW program
# the shipsec1 line cut to a quarter of its rows, for phase 17's trisolve
# and CG + IC(0): at full size 7.9% of the ILU(0) factors' entries lie
# past the widest band the band-block budget allows (8192 columns), so
# build_schedule takes chunked schedules of ≈ 17k chunks, one Python step
# each (trisolve_plan.py), and a full-size trisolve through the sweep did
# not end within the smoke's limit; the half-size twin's factors fit the
# band (Q = 18, 138 blocks a factor), and so do the quarter's, whose
# host factorisations (ILU(0) and IC(0), ≈ 30 and 26 s at half size)
# take about half as long: the cut that keeps the smoke's phases near
# 1000 s with phase 21
SHIPSEC1_QUARTER_LINE = ("35218 35218 55.4637761404 11.0748106399 normal "
                         "random 0.0458755451 0.8390381452 1.7123850245 "
                         "0.8734443677 14 shipsec1_quarter")
# the JAX package's SpMM/SDDMM CSV labels (spmv_research_tpu/harness/
# sweep.py:_labels_for)
WORKLOAD_LABELS = ("matrix_name,format_name,impl,K,time_iter_median,gflops,"
                   "num_loops,mape,max_ae")
CLOSG_SRC = "spmv_research_tpu_torch/csrc/closg.cu"
SELL_SRC = "spmv_research_tpu_torch/csrc/sell.cu"
BFLY_SRC = "spmv_research_tpu_torch/csrc/bfly.cu"
# the TPU kernel each CLOSG wrapper replaces, and its tolerance against the
# plain version (K3 alone adds accumulate records: fp32 add-order slack)
REPLACES = {
    "closg_front": "spmv_research_tpu/ops/clos_gather.py:675",
    "closg_front_lut": "spmv_research_tpu/ops/clos_gather.py:734",
    "closg_front_win": "spmv_research_tpu/ops/clos_gather.py:602",
    "clos_invreg": "spmv_research_tpu/ops/clos_pallas.py:52",
    "clos_r2": "spmv_research_tpu/ops/clos_pallas.py:52",
    "closg_r3_scan_yext": "spmv_research_tpu/ops/clos_pallas.py:117",
    "closg_r3_scan": "spmv_research_tpu/ops/clos_pallas.py:106",
    "closg_cand_yext": "spmv_research_tpu/ops/clos_gather.py:752",
    "closgx_r3_scan_yext": "spmv_research_tpu/ops/clos_xl.py:252",
    "clos_r3_fill": "spmv_research_tpu/ops/clos_pallas.py:84",
    "clos_r3_scan": "spmv_research_tpu/ops/clos_pallas.py:95",
    "clos_r3_valid": "spmv_research_tpu/ops/clos_pallas.py:182",
    "bfly_xor_net": "spmv_research_tpu/ops/bfly_pallas.py:56",
    "bfly_fill": "spmv_research_tpu/ops/bfly_pallas.py:66",
    "bfly_scan": "spmv_research_tpu/ops/bfly_pallas.py:75",
    "bfly_full": "spmv_research_tpu/ops/bfly_pallas.py:107",
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
    The flush writes the 1 GiB, so the timed call finds the L2 full of
    dirty lines and its first 50 MB of traffic also write them back; with
    ``clean`` it reads the 1 GiB instead, which leaves clean lines.
    ``spec`` holds the card's data-sheet rates, for the kernels' bounds."""

    def __init__(self, spec, hold_ms: float = 8.0, clean: bool = False):
        import torch
        self.spec = spec
        self.clean = clean
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
            if self.clean:
                self.flush.max()
            else:
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

    def warm_ms(self, fn, iters: int = 30) -> float:
        """Mean device ms per call of fn over iters calls back to back behind
        the spin kernel, no flush: the inputs stay in the L2, as on the main
        path, where a kernel reads the output of the one before."""
        import torch
        for _ in range(3):
            fn()
        torch.cuda._sleep(self.cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters

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
    mid = (v, A.perm_r2, A.V)
    yield "clos_r2", mid, (nbytes(*mid) + 4 * N, 0)
    v = K.clos_r2_torch(*mid)
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
    """As ``closg_stages`` for a CLOSGX stack: B1 and ``clos_r2`` over the
    stacked planes, then B15 over all chunks at once."""
    C, N, V = A.n_chunks, A.N, A.V
    front = (A.rowidx.view(-1), A.r1.view(-1, 128), A.vals.view(-1, 128), xd)
    yield "closg_front", front, (nbytes(*front) + 4 * C * N, C * N)
    mid = (K.closg_front_torch(*front), A.r2.view(-1, V // 8), V)
    yield "clos_r2", mid, (nbytes(*mid) + 4 * C * N, 0)
    back = (K.clos_r2_torch(*mid), A.r3.view(-1, 128),
            A.ysel_w.view(-1, 128), A.wstart_abs.view(-1), A.stages, N)
    yield "closgx_r3_scan_yext", back, (nbytes(*back) + 4 * A.ysel_w.numel(),
                                        C * N)


def describe_plan(K, stages, n, chunk) -> str:
    """The phased scan's phases (``plan_scan_phases``: K3, B5, B8's fill
    and scan, B15) in words: each phase's tiling, stages, halo and
    window."""
    stages = tuple(stages)
    L = chunk.bit_length() - 1
    T = min(K.SCAN_TILE_LOG, L)
    words = []
    for first, count, tiling, halo in K.plan_scan_phases(stages, n, chunk):
        ks = stages[first:first + count]
        span = f"stages {ks[0]}-{ks[-1]}" if ks else "no stage"
        if tiling == K.CONTIG:
            words.append(f"contiguous (r3 + {span}, tiles of 2^{T}, halo "
                         f"{halo} slots: window 2^{T} + "
                         f"{1024 if halo and T < L else 0})")
        elif tiling == K.STRIDED:
            words.append(f"strided ({span}, 32 residues × 2^"
                         f"{min(T - 5, L - ks[0])} rows, halo {halo} rows)")
        else:
            words.append(f"global ({span})")
    return f"{len(words)} phases: " + "; ".join(words)


def k3_launches(K, label, programs, xd) -> int:
    """K3's plan on each W > 0 CLOSG program of ``programs`` (the widest
    one's logged) and one counted SpMV of each, which must launch
    ``closg_r3_scan_yext`` once a phase of its plan and once for the
    extraction; returns the launches over all programs."""
    total = 0
    for c in programs:
        stages = c.scan_cap or c.scan_stages
        want = len(K.plan_scan_phases(stages, c.N, c.N)) + 1
        got = counted_spmv(c, xd, K)[1]["closg_r3_scan_yext"]
        if got != want:
            fail(f"a {label} CLOSG SpMV (N = {c.N}) launched "
                 f"closg_r3_scan_yext {got} times, not its plan's phases + "
                 f"the extraction ({want})")
        total += want
    w = max(programs, key=lambda c: c.N)
    stages = w.scan_cap or w.scan_stages
    log(f"# {label} K3 plan (N = {w.N}, {len(stages)} stages of "
        f"{len(w.scan_stages)}): " + describe_plan(K, stages, w.N, w.N)
        + f", then the extraction; {total} K3 launches over "
        f"{len(programs)} program(s)")
    return total


def ptxas_of(build_log: str, names) -> str:
    """Registers and spill stores of the entry functions whose mangled
    names hold one of ``names``, from nvcc's ``-Xptxas -v`` output."""
    found, cur = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            cur = next((nm for nm in names if nm in ln), None)
        elif cur and "spill stores" in ln:
            found[cur] = [ln.split(",")[1].strip()]
        elif cur and "registers" in ln:
            found.setdefault(cur, []).insert(
                0, ln.split("Used", 1)[1].split(",")[0].strip())
    return "; ".join(f"{nm} {', '.join(v)}" for nm, v in found.items())


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of fn: n calls enqueued back to back
    (after a warm call and a synchronize), no synchronize between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return t * 1e6


def call_times(timer, fn) -> str:
    """'<cold> ms cold, <warm> warm, <host> us host': device ms of one call
    alone (L2 flushed) and back to back, host µs a call enqueued."""
    return (f"{timer.ms(fn, iters=10):.4f} ms cold, "
            f"{timer.warm_ms(fn, iters=10):.4f} warm, "
            f"{host_us(fn, n=50):.1f} us host")


def device_kernels(fn, n: int = 10) -> dict:
    """The device events of one call of fn by name (kernels, copies,
    memsets): n calls after a warm one, under torch.profiler, each name's
    count over n."""
    return {k: c for k, (c, _) in device_events(fn, n)[0].items()}


def device_events(fn, n: int = 5):
    """A call of fn under torch.profiler, over n calls after a warm one:
    ({device event name: (count, device µs)}, kernel launch calls the host
    made). The profiler can drop device events late in a long process
    (on an H100 machine, a fifth to all of them by phase 18), so the
    host's launch calls are the count to hold them to; the cache is
    emptied first, in case the profiler's device buffers compete with
    PyTorch's cached blocks."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, us = out.get(e.name, (0, 0.0))
            out[e.name] = (c + 1, us + e.time_range.elapsed_us())
        elif e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaMemsetAsync", "cudaMemcpyAsync")):
            launches += 1
    return {k: (c / n, us / n) for k, (c, us) in out.items()}, launches / n


def layer_times(timer, K, entries, args, label):
    """Warm times (``DeviceTimer.warm_ms``) of B1 and ``clos_r2`` in
    ``entries`` (by name), and ``clos_r2``'s function computed as before
    its transposes were folded (``_t_fwd``, the natural-layout layer
    kernel, ``_t_bwd``: three launches), checked equal and timed cold and
    warm: kept in the entries as ``warm_ms``, ``unfolded_ms`` and
    ``unfolded_warm_ms``."""
    import torch
    from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
    for k in entries:
        name = k["name"]
        for base in ("closg_front", "clos_r2"):
            if name == base or name.startswith(base + "_"):
                fn = (lambda f=getattr(K, base), a=args[base]: f(*a))
                k["warm_ms"] = timer.warm_ms(fn)
        if k["name"] in ("clos_r2", "clos_r2" + label):
            v, w, V = args["clos_r2"]
            unfolded = (lambda: _t_bwd(K.clos_invreg(_t_fwd(v, V), w), V))
            if not torch.equal(unfolded(), K.clos_r2(v, w, V)):
                fail(f"{name}: the unfolded r2 layer differs from clos_r2")
            k["unfolded_ms"] = timer.ms(unfolded)
            k["unfolded_warm_ms"] = timer.warm_ms(unfolded)
    log(f"# {label or 'scircuit'} B1/B2 cold and warm ms: " + "; ".join(
        f"{k['name']} {k['ms']:.5f} / {k['warm_ms']:.5f}"
        + (f" (unfolded: transposes + natural layer {k['unfolded_ms']:.5f}"
           f" / {k['unfolded_warm_ms']:.5f})" if "unfolded_ms" in k else "")
        for k in entries if "warm_ms" in k))


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


def b6_chunked(timer, K, A, xd, per_chunk):
    """B6 as an all-W = 0 ClosGChunked SpMV runs it: one launch over every
    chunk's scanned plane (the plain stages' output), each chunk's y
    written in place, against its plain version (exact) and timed; its
    bound the chunks' ycand, ysel and y bytes and one 4-byte scanned
    element read per y element. ``per_chunk``, the single-program entry
    timed on the widest chunk, is kept in it as ``chunk_*``."""
    parts = [dict((nm, a) for nm, a, _ in closg_stages(K, c, xd))[
        "closg_cand_yext"] for c in A.chunks]
    k = check_kernel(
        timer, "closg_cand_yext", CLOSG_SRC, REPLACES["closg_cand_yext"],
        [(lambda: K.closg_cand_yext_chunked(parts, A.row_split),
          lambda: K.closg_cand_yext_chunked_torch(parts, A.row_split))],
        exact, (sum(nbytes(c.ycand, c.ysel) for c in A.chunks) + 8 * A.m, 0))
    k.update({f"chunk_{f}": per_chunk[f]
              for f in ("ms", "plain_ms", "bound_ms")})
    log(f"# gupta3 B6 over {len(A.chunks)} chunks in one launch: "
        f"{k['ms']:.5f} ms (bound {k['bound_ms']:.5f}); one chunk alone "
        f"{per_chunk['ms']:.5f} ms (bound {per_chunk['bound_ms']:.5f})")
    return k


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
    args = sys.argv[1:]
    if args[:1] == ["--dist-rank"] and len(args) == 3:
        dist_child(int(args[1]), args[2])
        return
    if args not in ([], ["--phase", "20"], ["--phase", "21"],
                    ["--trace-check"], ["--program-kinds"]):
        fail(f"usage: python3 chip_smoke.py [--phase 20 | --phase 21 | "
             f"--trace-check | --program-kinds], not {args}")
    if args == ["--trace-check"]:
        trace_check()
        return
    if args == ["--program-kinds"]:
        program_kinds()
        return
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    # one format cache a run, empty at its start: a cache an earlier run
    # left can never make a "cold build" line lie, and a later phase that
    # builds what an earlier phase built (the same matrix, format and
    # kwargs) loads it
    os.environ["SPARSE_FORMAT_CACHE_TORCH"] = os.path.join(run_dir,
                                                           "format_cache")
    try:
        run(run_dir, only=int(args[1]) if args else None)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def kept_dir(run_dir, name) -> str:
    """A new directory ``name`` in the run's directory, for a sweep's CSVs
    that phase 20's ``collect_results`` merges."""
    path = os.path.join(run_dir, name)
    os.makedirs(path)
    return path


def run(run_dir, only=None) -> None:
    """The phases: 1-21, or with ``only`` = 20 or 21 phases 1, 2 and that
    one (phase 20's CSVs from a short sweep of its own)."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    try:
        from spmv_research_tpu_torch import bench
        from spmv_research_tpu_torch.convert import build_csr
        from spmv_research_tpu_torch.convert import cache
        from spmv_research_tpu_torch.convert.build_best import build_best
        from spmv_research_tpu_torch.convert.cache import describe
        from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
        from spmv_research_tpu_torch.core.host import HostCSR
        from spmv_research_tpu_torch.gen import generate_from_line
        from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
        from spmv_research_tpu_torch.harness.bench import csv_labels
        from spmv_research_tpu_torch.io import native
        from spmv_research_tpu_torch.ops import (ClosG, ClosGChunked, ClosGX,
                                                 RowSplit, SellR, SellW,
                                                 build_clos_gather,
                                                 build_dense, build_sellw,
                                                 spmv)
        from spmv_research_tpu_torch.ops import bfly_cuda as KF
        from spmv_research_tpu_torch.ops import btile_cuda as KB
        from spmv_research_tpu_torch.ops import clos_cuda as K
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
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"native host library loaded: {native.have_native()}; data sheet: "
        f"{spec.hbm_bw / 1e12} TB/s, {spec.peak_tflops} TFLOP/s fp32")

    # --- 2. build the kernels (one nvcc per source, together) ---
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda lib: lib.build(), (K, KS, KB, KF)))
    log(f"# kernels built in {time.perf_counter() - t0:.2f}s "
        f"({K.SOURCE}, {KS.SOURCE}, {KB.SOURCE}, {KF.SOURCE})")
    for lib in (K, KS, KB, KF):
        log(f"# nvcc {os.path.basename(lib.SOURCE)}: " + " | ".join(
            ln.strip() for ln in lib.build_log().splitlines()
            if "registers" in ln or "spill" in ln))
    log("# ptxas of the phased scan (K3, B5, B8, B15; <9, select, vals> "
        "mangled as ILi9ELb<select>ELb<vals>): " + ptxas_of(K.build_log(), (
            "scan_contig_kernelILi9ELb0ELb0", "scan_contig_kernelILi9ELb0ELb1",
            "scan_contig_kernelILi9ELb1ELb0", "scan_strided_kernelILi9ELb0",
            "scan_strided_kernelILi9ELb1")))

    if only == 20:
        tooling_phase(DeviceTimer(spec), dev, run_dir,
                      tooling_sweeps(run_dir, dev), smi_line)
        log(f"# phase 20 alone passed at {time.perf_counter() - t_start:.0f}s")
        return
    if only == 21:
        dist_phase(DeviceTimer(spec), dev, run_dir)
        log(f"# phase 21 alone passed at {time.perf_counter() - t_start:.0f}s")
        return
    cache.reset_stats()

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
    layer_times(timer, K, kernels, {name: a for name, a, _ in
                                    closg_stages(K, A, xd)}, "")
    n_sms, per_sm = K.front_occupancy(dev)
    log(f"# B1 (front_kernel<0>): grid "
        f"{K.front_grid(A.N // 1024, dev)} persistent blocks ({per_sm} an "
        f"SM x {n_sms} SMs) over {A.N // 1024} tiles; ptxas: "
        + ptxas_of(K.build_log(), ("front_kernelILi0E", "layer_kernelILb0E",
                                   "layer_kernelILb1E")))
    k3_scircuit = k3_launches(K, "scircuit", [A], xd)
    if k3_scircuit != 2:
        fail(f"a scircuit CLOSG SpMV takes {k3_scircuit} K3 launches, not 2 "
             f"(one phase and the extraction)")
    launches = counted_spmv(A, xd, K)[1]
    log(f"# launches during one scircuit CLOSG SpMV: {launches}")
    if launches != {**dict.fromkeys(K.LAUNCHES, 0), "closg_front": 1,
                    "clos_r2": 1, "closg_r3_scan_yext": 2}:
        fail("a scircuit CLOSG SpMV is not 4 wrapper launches: B1, clos_r2, "
             "K3's phase and its extraction")
    kinds = device_kernels(lambda: spmv(A, xd, impl="cuda"))
    log(f"# device events a scircuit CLOSG/cuda SpMV (10 profiled): {kinds}")
    if sum(kinds.values()) != 4 or any(
            "copy" in k.lower() or "memset" in k.lower() for k in kinds):
        fail(f"a scircuit CLOSG/cuda SpMV ran {sum(kinds.values())} device "
             f"events, not 4 kernels and no copy")
    csr = build_csr(host).to(dev)
    time_candidates(timer, "scircuit", {
        "CLOSG/cuda": lambda v: spmv(A, v, impl="cuda"),
        "CSR/torch": lambda v: spmv(csr, v, impl="torch")},
        ("CLOSG/cuda",), xd)
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
        log(f"# {key} {describe(info)}, footprint_MB="
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
    lib = cusparse(ship, dev)             # the same SpMV, one library call
    k_sellw = check_kernel(timer, "sellw", SELL_SRC,
                           "spmv_research_tpu/ops/sellw.py:490",
                           [(lambda: KS.sellw_planes(*w_args),
                             lambda: KS.sellw_planes_torch(*w_args))], exact,
                           (nbytes(*w_args)
                            + nbytes(KS.sellw_planes_torch(*w_args)),
                            sell_ops),
                           library=lambda: lib @ xsd.unsqueeze(1))
    p_out = f_args[0]
    f_out = KS.sellr_flush_torch(*f_args)
    k_sellr = [check_kernel(timer, f"sellr_{part}", SELL_SRC,
                            "spmv_research_tpu/ops/sellr.py:402",
                            [(lambda f=getattr(KS, f"sellr_{part}"), a=args:
                              f(*a),
                              lambda f=getattr(KS, f"sellr_{part}_torch"),
                              a=args: f(*a))], exact, work,
                            library=lambda: lib @ xsd.unsqueeze(1))
               for part, args, work in (
                   ("place", p_args, (nbytes(*p_args) + nbytes(p_out),
                                      2 * Ar.vals.numel())),
                   ("flush", f_args, (nbytes(*f_args) + nbytes(f_out),
                                      p_out.numel())))]
    b14_ms = k_sellr[0]["ms"] + k_sellr[1]["ms"]
    log(f"# B14 place + flush {b14_ms:.4f} ms, B11 {k_sellw['ms']:.4f} ms "
        f"(before _combine_y); cuSPARSE's SpMV of the same matrix "
        f"{k_sellw['library_ms']:.4f} ms: {b14_ms / k_sellw['library_ms']:.2f}"
        f"x and {k_sellw['ms'] / k_sellw['library_ms']:.2f}x")
    for name, stages, n in (*(("sellw_spmv", st, cnt)
                              for _, cnt, st in class_plan(Aw)),
                            ("sellr_place", 0, Ar.nchunks)):
        n_sms, per_sm = KS.occupancy(name, stages, dev)
        log(f"# {name} (depth {stages}): grid "
            f"{KS.grid_of(name, stages, n, dev)} persistent blocks "
            f"({per_sm} an SM x {n_sms} SMs) over {n} chunks")
    log(f"# sellr_flush: {KS.FLUSH_SPLIT * (Ar.gptr.numel() - 1)} blocks "
        f"({KS.FLUSH_SPLIT} a group of 1024 cells)")
    log("# ptxas of B11 (sellw_spmv_kernel<0..7>) and B14: " + ptxas_of(
        KS.build_log(), (*(f"sellw_spmv_kernelILi{d}E" for d in range(8)),
                         "sellr_place_kernel", "sellr_flush_kernel")))
    # K1-K3 at the chunks' own shapes, the widest chunk timed
    k_chunks = closg_checks(timer, K, sorted(Ac.chunks, key=lambda c: -c.N),
                            xsd, suffix="_chunked")
    k3_ship = k3_launches(K, "shipsec1", Ac.chunks, xsd)
    k3_ms = {k["name"]: k["ms"] for k in (*kernels, *k_chunks)}
    log(f"# K3 (B3) timed alone: scircuit {k3_ms['closg_r3_scan_yext']:.5f}"
        f" ms, shipsec1's widest chunk "
        f"{k3_ms['closg_r3_scan_yext_chunked']:.5f} ms")
    for key, F in (("SELLR", Ar), ("SELLW", Aw), ("CLOSG", Ac)):
        launches = counted_spmv(F, xsd, K, KS)[1]
        log(f"# launches during one shipsec1 {key} SpMV: {launches}")
    if launches["closg_r3_scan_yext"] != k3_ship:
        fail(f"a shipsec1 CLOSG SpMV launched closg_r3_scan_yext "
             f"{launches['closg_r3_scan_yext']} times, its chunks' plans "
             f"{k3_ship}")
    csr = build_csr(ship).to(dev)
    time_candidates(timer, "shipsec1", {
        "SELLR/cuda": lambda v: spmv(Ar, v, impl="cuda"),
        "SELLW/cuda": lambda v: spmv(Aw, v, impl="cuda"),
        "CLOSG/cuda": lambda v: spmv(Ac, v, impl="cuda"),
        "CSR/torch": lambda v: spmv(csr, v, impl="torch"),
        "cuSPARSE (library)": lambda v: lib @ v.unsqueeze(1)},
        ("SELLR/cuda", "SELLW/cuda", "CLOSG/cuda", "CSR/torch"), xsd)
    del Ar, Ac, csr, fmts, w_args, p_args, f_args, p_out, f_out, lib
    log(f"# phase 6 done at {time.perf_counter() - t_start:.0f}s")

    # --- 7. the streamed SELLW program ---
    rng = np.random.Generator(np.random.PCG64(11))
    tri = stream_tridiagonal(rng)
    t0 = time.perf_counter()
    tri_host = HostCSR.from_scipy(tri)
    As = build_sellw(tri_host)
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
    lib_tri = cusparse(tri_host, dev)
    k_stream = check_kernel(timer, "sellw_stream", SELL_SRC,
                            "spmv_research_tpu/ops/sellw.py:521",
                            [(lambda: KS.sellw_planes(*s_args,
                                                      stream_wins=True),
                              lambda: KS.sellw_planes_torch(*s_args))], exact,
                            (nbytes(*s_args)
                             + nbytes(KS.sellw_planes_torch(*s_args)),
                             2 * As.vals.numel()),
                            library=lambda: lib_tri @ xtd.unsqueeze(1))
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
    del As, s_args, y, tri, tri_host, lib_tri

    # --- 8. the sweep path ---
    cfg = BenchConfig(min_num_loops=64, min_time_s=0.25,
                      use_rcm_reordering="auto")
    formats = ("csr", "sellr", "sellw", "closg")
    out_dir = kept_dir(run_dir, "phase8_sweep")
    K.reset_launch_counts()
    KS.reset_launch_counts()
    results = run_sweep([SHIPSEC1_LINE], formats=formats,
                        out_dir=out_dir, config=cfg)
    torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **KS.LAUNCHES}
    log(f"# launches during the sweep path: {launches}")
    for name in ("sellw", "sellr_place", "sellr_flush", "closg_front",
                 "clos_r2", "closg_r3_scan_yext"):
        if launches[name] <= 0:
            fail(f"the sweep path never launched {name}")
    check_csvs(out_dir, csv_labels(synthetic=True),
               {f"{f}_spmv": 2 if f == "csr" else 1 for f in formats})
    for k in (k_sellw, *k_sellr, *k_chunks):
        k["launches"] = launches[k["name"].removesuffix("_chunked")]
    check_rows(results, ["CLOSG/cuda", "CSR/sparse", "CSR/torch",
                         "SELLR/cuda", "SELLW/cuda"], {"shipsec1": ship}, xs)
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
        args = next(a for nm, a, _ in closg_stages(K, Ao, xd) if nm == name)
        k["warm_ms"] = timer.warm_ms(lambda f=getattr(K, name): f(*args))
        mode = K.FRONT_LUT if name == "closg_front_lut" else K.FRONT_WIN
        n_sms, per_sm = K.front_occupancy(dev, mode)
        log(f"# {'B4' if mode == K.FRONT_LUT else 'B7'} (front_kernel<"
            f"{mode}>): grid {K.front_grid(Ao.N // 1024, dev, mode)} "
            f"persistent blocks ({per_sm} an SM x {n_sms} SMs) over "
            f"{Ao.N // 1024} tiles"
            + (f", nbids {Ao.nbids.numel()} of {Ao.x_rows} x rows"
               if mode == K.FRONT_WIN else "")
            + f"; cold {k['ms']:.5f} ms, warm {k['warm_ms']:.5f} ms; "
            f"ptxas: " + ptxas_of(K.build_log(),
                                  (f"front_kernelILi{mode}E",)))
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
    log(f"# gupta3 candidates {sorted(fmts)}; CLOSG "
        f"{describe(fmts['CLOSG'][1])}: {len(Ag.chunks)} chunks, "
        f"row_split={Ag.row_split}, N={[c.N for c in Ag.chunks]}, "
        f"C={[c.C for c in Ag.chunks]}, stages="
        f"{[len(c.scan_stages) for c in Ag.chunks]}, scan_hi="
        f"{[tuple(c.scan_hi.shape) for c in Ag.chunks]}, footprint_MB="
        f"{Ag.mem_footprint_bytes() / 1e6:.2f}")
    Ag = Ag.to(dev)
    xg = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, gup.n)
    xgd = torch.as_tensor(xg, dtype=torch.float32, device=dev)
    widest = max(Ag.chunks, key=lambda c: c.N)
    k_w0 = closg_checks(timer, K, sorted(Ag.chunks, key=lambda c: -c.N),
                        xgd, names=("closg_r3_scan", "closg_cand_yext"))
    k_w0 = [k for k in k_w0 if k["name"] != "closg_cand_yext"] + [
        b6_chunked(timer, K, Ag, xgd, next(
            k for k in k_w0 if k["name"] == "closg_cand_yext"))]
    k_g = closg_checks(timer, K, sorted(Ag.chunks, key=lambda c: -c.N),
                       xgd, suffix="_gupta3", names=("closg_front", "clos_r2"))
    layer_times(timer, K, k_g, {name: a for name, a, _ in
                                closg_stages(K, widest, xgd)}, "_gupta3")
    plans = [K.plan_scan_phases(c.scan_stages, c.N, c.N) for c in Ag.chunks]
    log(f"# gupta3 B5 plan of the widest chunk (N = {widest.N}, "
        f"{len(widest.scan_stages)} stages, T = {K.SCAN_TILE_LOG}, halo "
        f"budget {K.SCAN_HALO_MAX} slots): "
        + describe_plan(K, widest.scan_stages, widest.N, widest.N))
    b5_args = next(a for nm, a, _ in closg_stages(K, widest, xgd)
                   if nm == "closg_r3_scan")
    log(f"# gupta3 host time per call (enqueue, no sync): closg_r3_scan "
        f"{host_us(lambda: K.closg_r3_scan(*b5_args)):.2f} us, one CLOSG "
        f"SpMV {host_us(lambda: spmv(Ag, xgd), n=20):.2f} us")
    for c, plan in zip(Ag.chunks, plans):
        if len(plan) > 3:
            fail(f"a gupta3 chunk's B5 plan (N = {c.N}) has {len(plan)} "
                 f"phases, more than 3")
        n_b5 = counted_spmv(c, xgd, K)[1]["closg_r3_scan"]
        if n_b5 != len(plan):
            fail(f"a gupta3 chunk's SpMV (N = {c.N}) launched "
                 f"closg_r3_scan {n_b5} times, its plan has {len(plan)} "
                 f"phases")
    y, launches = counted_spmv(Ag, xgd, K)
    gup_launches = launches
    log(f"# launches during one gupta3 SpMV: {launches} (B5 "
        f"{[len(p) for p in plans]} per chunk; "
        f"{sum(launches.values())} in all)")
    for k in (*k_w0, *k_g):
        k["launches"] = launches[k["name"].removesuffix("_gupta3")]
        if k["launches"] <= 0:
            fail(f"the gupta3 SpMV never launched {k['name']}")
    n_c = len(Ag.chunks)
    if not (launches["closg_front"] == launches["clos_r2"] == n_c
            and launches["closg_cand_yext"] == 1
            and sum(launches.values()) == 2 * n_c + sum(map(len, plans)) + 1
            == 41):
        fail(f"a gupta3 SpMV launched {launches}: not B1 and clos_r2 once "
             f"a chunk, B5 once a phase and B6 once, 41 in all")
    # the profiler may drop a few of 410 events: the kernels are counted
    # by the wrappers above, the trace shows which ran
    kinds = device_kernels(lambda: spmv(Ag, xgd, impl="cuda"))
    log(f"# device events a gupta3 CLOSG/cuda SpMV (10 profiled): "
        f"{sum(kinds.values())} in all; {kinds}")
    ours = ("front_kernel<0>", "layer_kernel<true>", "scan_contig_kernel",
            "scan_strided_kernel", "scan_step_kernel", "cand_yext_kernel")
    if (sum(kinds.values()) > 41
            or not all(any(o in k for o in ours) for k in kinds)
            or not 0 < sum(v for k, v in kinds.items()
                           if "cand_yext_kernel" in k) <= 1):
        fail(f"a gupta3 CLOSG/cuda SpMV ran device events other than the "
             f"41 kernels of B1, clos_r2, B5 and one B6 (a concatenation, "
             f"a copy?): {kinds}")
    if launches["closg_r3_scan"] != sum(map(len, plans)):
        fail(f"the gupta3 SpMV launched closg_r3_scan "
             f"{launches['closg_r3_scan']} times, not once per phase "
             f"({sum(map(len, plans))})")
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
    log(f"# mip1 candidates {sorted(fmts)}; CLOSG "
        f"{describe(fmts['CLOSG'][1])}: RSPLIT H="
        f"{Ax.heavy_rows.numel()} n_extra={Ax.n_extra} kmax="
        f"{Ax.gidx.shape[1]} over CLOSGX C={X.n_chunks} N={X.N} "
        f"stages={X.stages} W={X.W} mrp={X.mrp} footprint_MB="
        f"{Ax.mem_footprint_bytes() / 1e6:.2f}")
    Ax = Ax.to(dev)
    xm = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, mip.n)
    xmd = torch.as_tensor(xm, dtype=torch.float32, device=dev)
    k_xl = closg_checks(timer, K, [Ax.inner], xmd, stages=closgx_stages)
    plan_x = K.plan_scan_phases(range(X.stages), X.n_chunks * X.N, X.N)
    log(f"# mip1 B15 plan ({X.n_chunks} chunks of {X.N} slots, {X.stages} "
        f"stages, T = {K.SCAN_TILE_LOG}): "
        + describe_plan(K, range(X.stages), X.n_chunks * X.N, X.N)
        + ", then the extraction")
    y, launches = counted_spmv(Ax, xmd, K)
    log(f"# launches during one mip1 SpMV: {launches} "
        f"({sum(launches.values())} in all)")
    for k in k_xl:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            fail(f"the mip1 SpMV never launched {k['name']}")
        if k["name"] != "closgx_r3_scan_yext":
            k["name"] += "_xl"
    if (launches["closg_front"], launches["clos_r2"]) != (1, 1):
        fail(f"a mip1 SpMV launched {launches}: not B1 and clos_r2 once for "
             f"the whole stack")
    if len(plan_x) + 1 > 3:
        fail(f"mip1's B15 plan has {len(plan_x)} phases: with the "
             f"extraction more than 3 launches")
    if launches["closgx_r3_scan_yext"] != len(plan_x) + 1:
        fail(f"the mip1 SpMV launched closgx_r3_scan_yext "
             f"{launches['closgx_r3_scan_yext']} times, not its "
             f"{len(plan_x)} phases + the extraction")
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
    out_dir = kept_dir(run_dir, "phase12_sweep")
    K.reset_launch_counts()
    results = run_sweep([GUPTA3_LINE, MIP1_LINE], formats=formats,
                        out_dir=out_dir, config=cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"# launches during the gupta3 + mip1 sweep: {launches}")
    for name in ("closg_front", "clos_r2", "closg_r3_scan",
                 "closg_cand_yext", "closgx_r3_scan_yext"):
        if launches[name] <= 0:
            fail(f"the gupta3 + mip1 sweep never launched {name}")
    check_csvs(out_dir, csv_labels(synthetic=True),
               {"csr_spmv": 4, "closg_spmv": 2, "dense_spmv": 1})
    check_rows(results, ["CLOSG/cuda", "CSR/sparse", "CSR/sparse",
                         "CSR/torch", "CSR/torch", "DENSE/torch",
                         "RSPLIT/cuda"],
               {"gupta3": gup, "mip1": mip}, None,
               {"gupta3": (xg, gold_g), "mip1": (xm, gold_m)})
    del mip, results
    log(f"# phase 12 done at {time.perf_counter() - t_start:.0f}s")

    # --- 13. the program kinds of four more twins: host work only, in a
    # child process (``--program-kinds``) while phase 14 runs the card ---
    kinds_out = open(os.path.join(run_dir, "phase13.log"), "w+")
    kinds = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--program-kinds"], stdout=kinds_out,
                             stderr=subprocess.STDOUT, text=True)
    log("# phase 13 started beside phase 14 (a child process)")

    # --- 14. the K-dimension workloads ---
    try:
        k_kdim = k_dim_phase(timer, dev, gup, ship, Ag, Aw, gup_launches,
                             cfg, run_dir)
    except BaseException:
        kinds.kill()
        kinds.wait()
        raise
    del gup, Ag, Aw
    log(f"# phase 14 done at {time.perf_counter() - t_start:.0f}s")
    try:
        kinds.wait(timeout=900)
    except subprocess.TimeoutExpired:
        kinds.kill()
        kinds.wait()
        fail("phase 13's child process ran past 900 s")
    kinds_out.seek(0)
    log(kinds_out.read().rstrip())
    kinds_out.close()
    if kinds.returncode != 0:
        fail(f"phase 13's child process exited {kinds.returncode}")
    log(f"# phase 13 done at {time.perf_counter() - t_start:.0f}s")

    # --- 15. double-single and solvers ---
    del ship
    k_ds = ds_phase(timer, dev, cfg)
    log(f"# phase 15 done at {time.perf_counter() - t_start:.0f}s")

    # --- 16. the fallback engines CLOS, CLOSM and BFLY ---
    k_fb = fallback_phase(timer, dev, cfg, run_dir)
    log(f"# phase 16 done at {time.perf_counter() - t_start:.0f}s")

    # --- 17. IC(0)/ILU(0) and the trisolve ---
    ilu_phase(timer, dev, cfg)
    log(f"# phase 17 done at {time.perf_counter() - t_start:.0f}s")

    # --- 18. SpGEMM and the classic formats ---
    classic_phase(timer, dev, cfg)
    log(f"# phase 18 done at {time.perf_counter() - t_start:.0f}s")

    # --- 19. the XLA-only engines and real-matrix input ---
    xla_engines_phase(timer, dev, cfg)
    log(f"# phase 19 done at {time.perf_counter() - t_start:.0f}s")
    st = dict(cache.STATS)
    log(f"# format cache over phases 3-19: {st['hits']} hits, "
        f"{st['misses']} misses; the hits saved {st['saved_s']:.2f}s of host "
        f"(their cold builds less their loads), the misses' saves cost "
        f"{st['save_s']:.2f}s: net {st['saved_s'] - st['save_s']:.2f}s")
    if st["hits"] <= 0:
        fail("no phase loaded a program from the run's format cache")

    # --- 20. the format cache, row clustering, tracing and the tools ---
    tooling_phase(timer, dev, run_dir,
                  [os.path.join(run_dir, f"phase{n}_sweep")
                   for n in (8, 12, 14, 16)], smi_line)
    log(f"# phase 20 done at {time.perf_counter() - t_start:.0f}s")

    # --- 21. the distributed layer ---
    dist_launches = dist_phase(timer, dev, run_dir)
    log(f"# all phases done at {time.perf_counter() - t_start:.0f}s")

    kernels += [*k_chunks, k_sellw, k_stream, *k_sellr, *k_opt, *k_w0, *k_g,
                *k_xl, *k_kdim, *k_ds, *k_fb]
    for k in kernels:
        if k["name"] in dist_launches:
            k["dist_launches"] = dist_launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def k_dim_phase(timer, dev, gup, ship, Ag, Aw, gup_launches, cfg,
                csv_dir) -> list:
    """Phase 14, the K-dimension workloads at K = 128 (phases 10's gupta3
    and 6's shipsec1 hosts, their CLOSG and SELLW programs, one gupta3
    SpMV's launch counts): B16a and B16b against their plain versions on
    both twins' BTILE programs and timed on gupta3's, B12 and B12c against
    their plain versions, each timed beside a library call (B12c beside the
    gather and sum it replaced), one SELLW and one CLOSG SpMM through
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
    from spmv_research_tpu_torch.convert.cache import (cached_build,
                                                       cached_build_timed,
                                                       describe)
    from spmv_research_tpu_torch.ops import (build_btile, build_dense, sddmm,
                                             spmm)
    from spmv_research_tpu_torch.ops import btile_cuda as KB
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops.sellw import class_plan

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the workloads' comparisons need full fp32")
    k = 128
    cached_btile = functools.partial(cached_build, build_btile,
                                     fmt_name="btile")

    # 1. BTILE: B16a and B16b, checked on gupta3's and shipsec1's programs,
    # timed on gupta3's (built through the format cache, under the sweep's
    # key: the sweep below loads them)
    def btile_case(label, host):
        """(program, X, A, B, SpMM args, SDDMM args, |A|·|X| per element)
        of ``host``'s BTILE program at K = 128 on the card."""
        Ab, info = cached_build_timed(build_btile, host, "btile")
        log(f"# {label} BTILE ({describe(info)}): ntiles="
            f"{Ab.ntiles} nsteps={Ab.nsteps} bands={Ab.ngroups} slots/nnz="
            f"{Ab.ntiles * 1024 / Ab.nnz:.2f} MB="
            f"{Ab.mem_footprint_bytes() / 1e6:.1f} (slab "
            f"{Ab.tiles.numel() * 4 / 1e6:.1f}, pattern "
            f"{Ab.patt.numel() / 1e6:.1f})")
        plan = KB.spmm_plan(Ab.ngroups, Ab.max_band_steps, k,
                            KB.sm_count(dev))
        log(f"# {label} B16a launch: {plan.blocks} blocks of "
            f"{KB.SPMM_SLICE} columns, {plan.nchunk} chunks per band of "
            f"{plan.ch} steps (bands of {Ab.max_band_steps} steps at most), "
            f"{plan.slices} K slices (K padded to {plan.kp}), "
            f"{plan.smem_bytes} B of shared memory a block, partials "
            f"{plan.part_bytes / 1e6:.1f} MB")
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
        return Ab, Xd, Ad, Bd, s_args, d_args, yard, plan

    def tol_c(want):
        """1e-5 of Σ|a||b| per slot (the plain result: a, b ≥ 0)"""
        return 1e-5 * want.abs()

    Ab, Xd, Ad, Bd, s_args, d_args, yard_y, plan_g = btile_case("gupta3",
                                                                 gup)
    _, _, _, _, s_ship, d_ship, yard_ship, plan_s = btile_case("shipsec1",
                                                               ship)

    def tol_y(_):
        """1e-5 of |A|·|X| per element"""
        return 1e-5 * yard_y

    def tol_ship(_):
        """1e-5 of |A|·|X| per element (shipsec1)"""
        return 1e-5 * yard_ship

    lib = cusparse(gup, dev)
    live = Ab.ntiles * 1024                      # live tile slots
    # the function's operations are 2·nnz·K; the kernel skips the stored
    # zeros of the live slots (2·live·K operations to multiply them all)
    tile_ms, _ = timer.bound(0, 2 * live * k)
    log(f"# btile_spmm: {live / gup.nnz:.2f} slots per nnz; multiplying "
        f"every live slot would be {2 * live * k} operations, {tile_ms:.4f} "
        f"ms at the fp32 peak; the function needs {2 * gup.nnz * k}")
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
    # the blocks an SM by shared memory (1 KB of it reserved a block) and
    # threads; registers (64 a thread at K <= 128) allow 2
    props = torch.cuda.get_device_properties(dev)
    smem = KB.sddmm_smem(k)
    blocks = min(props.shared_memory_per_multiprocessor // (smem + 1024),
                 props.max_threads_per_multi_processor // KB.SDDMM_THREADS)
    log(f"# btile_sddmm at K = {k}: one block of {KB.SDDMM_THREADS} "
        f"threads a step "
        f"(gupta3 {Ab.nsteps} steps), {smem} B of dynamic shared memory a "
        f"block, {blocks} blocks an SM by shared memory and threads; "
        f"shipsec1 "
        f"{timer.ms(lambda: KB.btile_sddmm(*d_ship)):.4f} ms, its plain "
        f"version {timer.ms(lambda: KB.btile_sddmm_torch(*d_ship)):.4f} ms")
    # B16a on shipsec1 alone, and at other chunk targets (blocks per SM
    # over the launch; the planner's is KB.SPMM_WAVES)
    ship_ms = timer.ms(lambda: KB.btile_spmm(*s_ship))
    log(f"# btile_spmm shipsec1: {ship_ms:.4f} ms ({plan_s.nchunk} chunks "
        f"per band, {plan_s.blocks} blocks)")
    waves = KB.SPMM_WAVES
    for w in (1, 2, 4, 8):
        KB.SPMM_WAVES = w
        pg, ps = (KB.spmm_plan(*a[7:9], k, KB.sm_count(dev))
                  for a in (s_args, s_ship))
        log(f"# btile_spmm at {w} blocks per SM: gupta3 "
            f"{timer.ms(lambda: KB.btile_spmm(*s_args)):.4f} ms ({pg.nchunk} "
            f"chunks, {pg.blocks} blocks), shipsec1 "
            f"{timer.ms(lambda: KB.btile_spmm(*s_ship)):.4f} ms ({ps.nchunk} "
            f"chunks, {ps.blocks} blocks)")
    KB.SPMM_WAVES = waves
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
    log(f"# B12 (scan in registers): {k_b12['ms']:.4f} ms, bound "
        f"{k_b12['bound_ms']:.4f} ms, cuSPARSE {k_b12['library_ms']:.4f} ms")
    k_b12c = sellw_combine_check(timer, Aw, planes)
    log(f"# shipsec1 SELLW one SpMM through ops.spmm, device time "
        f"{timer.ms(lambda: spmm(Aw, Xsd), iters=10):.4f} ms")
    KS.reset_launch_counts()
    spmm(Aw, Xsd)
    torch.cuda.synchronize()
    launches = {name: n for name, n in KS.LAUNCHES.items() if n}
    n_classes = sum(1 for _, cnt, _ in class_plan(Aw) if cnt)
    if launches != {"sellw_spmm": n_classes, "sellw_combine": 1}:
        fail(f"a shipsec1 SELLW SpMM launched {launches}, not B12 once a "
             f"stage class ({n_classes}) and B12c once")
    log(f"# launches during one shipsec1 SELLW SpMM: {launches}")
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
    out_dir = kept_dir(csv_dir, "phase14_sweep")
    for lib_ in (K, KS, KB):
        lib_.reset_launch_counts()
    # CSR's gather SDDMM is phase 19's
    results = run_sweep([GUPTA3_LINE, SHIPSEC1_LINE], formats=formats,
                        workloads=("spmm", "sddmm"),
                        impls=("cuda", "torch"), out_dir=out_dir,
                        config=kcfg, device=dev)
    torch.cuda.synchronize()
    launches = {**KS.LAUNCHES, **KB.LAUNCHES}
    log(f"# launches during the spmm/sddmm sweep: {launches}")
    for kk in (k_spmm, k_sddmm, k_b12, k_b12c):
        kk["launches"] = launches[kk["name"]]
        if kk["launches"] <= 0:
            fail(f"the spmm/sddmm sweep never launched {kk['name']}")
    # B16a's second launch, its chunks' combine, where bands are cut
    k_spmm["combine_launches"] = launches["btile_combine"]
    if (launches["btile_combine"] > 0) != (plan_g.nchunk > 1
                                           or plan_s.nchunk > 1):
        fail(f"the spmm/sddmm sweep launched btile_combine "
             f"{launches['btile_combine']} times for chunks per band "
             f"{plan_g.nchunk} (gupta3) and {plan_s.nchunk} (shipsec1)")
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
            ("gupta3", gup, (("CSR", build_csr), ("BTILE", cached_btile),
                             ("DENSE", build_dense))),
            ("shipsec1", ship, (("CSR", build_csr), ("BTILE", cached_btile),
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
    return [k_spmm, k_sddmm, k_b12, k_b12c]


def sellw_combine_check(timer, A, planes) -> dict:
    """B12c, SELLW's combine, on ``planes`` (program A's SpMM planes, one
    set a column of X) and on their first column (the SpMV's y): against
    its plain version (exact) and timed beside the combine PyTorch ran
    before it (``planes[..., yidx, :].sum(-3)``, the yardstick); bound:
    the live plane rows read once and y written once. The SpMV's numbers
    are kept in the entry as ``spmv_*``."""
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops.clos_route import LANES
    idx = A.yidx.long()
    live = int((A.yidx != planes.shape[-2] - 1).sum())
    entries = []
    for p in (planes, planes[0]):
        cols = planes.shape[0] if p.dim() == 3 else 1
        args = (p, A.yidx, A.m)
        entries.append(check_kernel(
            timer, "sellw_combine", SELL_SRC,
            "spmv_research_tpu/ops/sellw.py:453",
            [(lambda a=args: KS.sellw_combine(*a),
              lambda a=args: KS.sellw_combine_torch(*a))], exact,
            (4 * (LANES * live + A.m) * cols, LANES * live * cols),
            library=lambda p=p: p[..., idx, :].sum(dim=-3)))
    k, k1 = entries
    k.update({f"spmv_{f}": k1[f]
              for f in ("ms", "plain_ms", "bound_ms", "library_ms")})
    log(f"# B12c (SELLW's combine, {live} live yidx entries of "
        f"{A.yidx.numel()}): {planes.shape[0]} columns {k['ms']:.4f} ms, "
        f"bound {k['bound_ms']:.4f} ms, the gather and sum before it "
        f"{k['library_ms']:.4f} ms; one column {k1['ms']:.5f} ms, bound "
        f"{k1['bound_ms']:.5f} ms, gather and sum {k1['library_ms']:.5f} ms")
    log("# ptxas of B12c: " + ptxas_of(KS.build_log(), (
        "sellw_combine_kernelILi4E", "sellw_combine_kernelILi1E")))
    return k


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
    from spmv_research_tpu_torch.convert.cache import (cached_build_timed,
                                                       describe)
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
    Ads, info_w = cached_build_timed(build_sellwds, ship, "sellwds")
    t0 = time.perf_counter()
    Acs = build_csrds(ship)
    t_c = time.perf_counter() - t0
    B = Ads.base
    plan = class_plan(B)
    log(f"# shipsec1 SELLWDS ({describe(info_w)}): nchunks={B.nchunks} "
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
    # the combine: the planes' live rows (each named by one yidx entry)
    # read once, y's s and e written; 8 operations per entry and lane
    live_rows = int((B.yidx != B.G * (B.wrow.numel() // 8)).sum())
    c_args = (planes, B.yidx, B.m)
    k_comb = check_kernel(
        timer, "sellwds_combine", SELL_SRC,
        "spmv_research_tpu/ops/sellw_ds.py:228",
        [(lambda: torch.stack(KS.sellwds_combine(*c_args)),
          lambda: torch.stack(KS.sellwds_combine_torch(*c_args)))], exact,
        (2 * 4 * 128 * live_rows + nbytes(B.yidx) + 2 * 4 * B.m,
         8 * 128 * live_rows))
    n_classes = sum(1 for _, cnt, _ in plan if cnt)
    y, launches = counted_spmv(Ads, xsd, KS)
    log(f"# launches during one shipsec1 SELLWDS SpMV: {launches} "
        f"({len(plan)} stage classes)")
    if {k: v for k, v in launches.items() if v} != {
            "sellwds": n_classes, "sellwds_combine": 1}:
        fail(f"one SELLWDS SpMV launched {launches}, not B13 once per "
             f"stage class ({n_classes}) and the combine once")
    y64 = (lib64 @ x64.unsqueeze(1)).squeeze(1).cpu().numpy()
    log(f"# cuSPARSE fp64 SpMV vs longdouble gold: max rel = "
        f"{check_accuracy(ship, xs, y64, np.float64).max_rel_err}")
    del planes, c_args, y, lib64, x64, y64

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
        for name in ("sellw", "sellwds", "sellwds_combine"):
            if launches[name] <= 0:
                fail(f"the DS spmv sweep never launched {name}")
        if launches["sellwds"] != n_classes * launches["sellwds_combine"]:
            fail(f"the DS spmv sweep launched B13 {launches['sellwds']} "
                 f"times for {launches['sellwds_combine']} combines, not "
                 f"{n_classes} per SpMV")
        check_csvs(out_dir, csv_labels(synthetic=True),
                   {f"{f}_spmv": 2 if f == "csr" else 1 for f in formats})
    k_b13["launches"] = launches["sellwds"]
    k_comb["launches"] = launches["sellwds_combine"]
    check_rows(results, ["CSR/sparse", "CSR/torch", "SELLW/cuda",
                         "SELLWDS/cuda", "CSRDS/torch"], {"shipsec1": ship},
               xs)
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
             ["CSR/sparse", "CSR/torch", "SELLW/cuda", "SELLWDS/cuda"]),
            ("bicgstab", bench.SCIRCUIT_LINE, "dd", ("csr", "closg"), (K,),
             build_clos_gather_auto, solve_bicgstab,
             ["CSR/sparse", "CSR/torch", "CLOSG/cuda"])):
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
                       {f"{f}_{workload}": 2 if f == "csr" else 1
                        for f in fmts})
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
        if prog is not None:
            per = sum(1 for _, cnt, _ in class_plan(prog) if cnt)
            spmvs = launches.get("sellwds_combine", 0)
            if not (spmvs and launches == {"sellwds": per * spmvs,
                                           "sellwds_combine": spmvs}):
                fail(f"the counted CG solve on SELLWDS launched {launches}, "
                     f"not B13 {per} times and the combine once per SpMV")
            log(f"# {spmvs} SELLWDS SpMVs in the solve, {per} B13 launches "
                f"and 1 combine each")
        del host, A, x, results
    log(f"# phase 15 done in {time.perf_counter() - t_phase:.0f}s")
    return [k_b13, k_comb]


def fallback_phase(timer, dev, cfg, csv_dir) -> list:
    """Phase 16, the fallback engines: CLOS, CLOSM and BFLY on the
    scircuit twin (B2 and B8 on CLOS's and CLOSM's planes, B9, B10 against
    their plain versions and timed, cuSPARSE beside B10, counted and
    traced SpMVs, CLOSM through ``bench_spmv``, the csr/clos/bfly sweep,
    one counted B10 SpMV), then mac_econ_fwd500 (CLOS and CLOSM refuse
    it, BFLY runs it)."""
    import contextlib
    import io
    import torch
    import torch.nn.functional as F
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.convert import build_csr
    from spmv_research_tpu_torch.convert.cache import (cached_build_timed,
                                                       describe)
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness.bench import bench_spmv, csv_labels
    from spmv_research_tpu_torch.harness.sweep import load_matrix
    from spmv_research_tpu_torch.ops import (build_bfly, build_clos,
                                             build_clos_mcast, spmv,
                                             spmv_bfly_cuda_fused)
    from spmv_research_tpu_torch.ops import bfly as BF
    from spmv_research_tpu_torch.ops import clos_mcast as CM
    from spmv_research_tpu_torch.ops import bfly_cuda as KF
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError

    t_phase = time.perf_counter()
    host = load_matrix(bench.SCIRCUIT_LINE, cfg)[0]
    # through the format cache, under the sweep's keys: the sweeps below
    # load these programs
    Ac, info_c = cached_build_timed(build_clos, host, "clos")
    Ab, info_b = cached_build_timed(build_bfly, host, "bfly")
    log(f"# scircuit CLOS ({describe(info_c)}): N={Ac.N} V={Ac.V} "
        f"fill_stages={Ac.fill_stages} scan_stages={len(Ac.scan_stages)} "
        f"fill_hi={tuple(Ac.fill_hi.shape)} scan_hi="
        f"{tuple(Ac.scan_hi.shape)} footprint_MB="
        f"{Ac.mem_footprint_bytes() / 1e6:.2f}")
    log(f"# scircuit BFLY ({describe(info_b)}): N={Ab.N} L={Ab.L} "
        f"sigma_x={Ab.sigma_x} sigma_y={Ab.sigma_y} stages widen/fill/perm/"
        f"scan/compact={len(Ab.widen_stages)}/{len(Ab.fill_stages)}/"
        f"{len(Ab.perm_stages)}/{len(Ab.scan_stages)}/"
        f"{len(Ab.compact_stages)} word planes "
        f"{Ab.widen_B.shape[0]}/{Ab.perm_B.shape[0]}/{Ab.compact_B.shape[0]}"
        f" footprint_MB={Ab.mem_footprint_bytes() / 1e6:.2f}")
    if not (Ac.N == Ab.N == 1 << 20 and Ab.L == 20):
        fail(f"scircuit: CLOS N={Ac.N}, BFLY N={Ab.N} L={Ab.L}; want 2^20")
    Ac, Ab = Ac.to(dev), Ab.to(dev)
    N = Ac.N
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    lib = cusparse(host, dev)

    def equal(name, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name}: kernel != plain version (max |d| "
                 f"{float((got - want).abs().max())})")
        return want

    def entry(name, source, cases, work, library=None):
        """torch.equal on every case, then check_kernel's times and the
        kernels-JSON entry (its launches filled in by the sweep)."""
        for kern, plain in cases:
            equal(name, kern, plain)
        return check_kernel(timer, name, source, REPLACES[name], cases,
                            exact, work, library)

    # B2 (the r1 layer, then the r2 layer with its transposes) and B8 on
    # the program's own pipeline inputs (the plain stages before them)
    layers = {"clos_invreg": [], "clos_r2": []}

    def net(v, r1, r2):
        layers["clos_invreg"].append((v, r1))
        v = K.clos_invreg_torch(v, r1)
        layers["clos_r2"].append((v, r2, Ac.V))
        return K.clos_r2_torch(v, r2, Ac.V)

    hi = lambda t: t if t.numel() == N else None  # noqa: E731
    u = net(F.pad(xd, (0, N - Ac.n)).view(-1, 128), Ac.widen_r1,
            Ac.widen_r2)
    fill = (u, Ac.widen_r3, Ac.fill_hi, Ac.fill_stages)
    u = net(K.clos_r3_fill_torch(*fill), Ac.perm_r1, Ac.perm_r2)
    scan = (u, Ac.perm_r3, Ac.vals, Ac.scan_hi, Ac.scan_stages)
    u = net(K.clos_r3_scan_torch(*scan), Ac.compact_r1, Ac.compact_r2)
    # the valid step as the pipeline calls it, over the blocks that hold y
    # (its bound those blocks' bytes), and over the whole plane
    valid, whole = (u, Ac.compact_r3, Ac.m), (u, Ac.compact_r3)
    rows = -(-Ac.m // 1024) * 8
    b8_case = lambda name, a: (  # noqa: E731
        lambda: getattr(K, name)(*a),
        lambda: getattr(K, name + "_torch")(*a))
    # the layers on the three networks (the widen network timed); 12 bytes
    # a slot: word and value read, out written
    k_b2 = [entry(name, CLOSG_SRC,
                  [b8_case(name, a) for a in layers[name]],
                  (nbytes(*layers[name][0]) + 4 * N, 0))
            for name in ("clos_invreg", "clos_r2")]
    k_b2[1]["name"] = "clos_r2_clos"
    layer_times(timer, K, k_b2[1:], {"clos_r2": layers["clos_r2"][0]},
                "_clos")
    del layers
    k_b8 = [entry(name, CLOSG_SRC, cases, work)
            for name, cases, work in (
                ("clos_r3_fill", [b8_case("clos_r3_fill", fill)],
                 (nbytes(u, Ac.widen_r3, hi(Ac.fill_hi)) + 4 * N, 0)),
                # a product per slot and a prefix sum, one add per slot
                ("clos_r3_scan", [b8_case("clos_r3_scan", scan)],
                 (nbytes(u, Ac.perm_r3, Ac.vals, hi(Ac.scan_hi)) + 4 * N,
                  2 * N)),
                ("clos_r3_valid", [b8_case("clos_r3_valid", valid),
                                   b8_case("clos_r3_valid", whole)],
                 (3 * 4 * rows * 128, 0)))]
    whole_ms = timer.ms(b8_case("clos_r3_valid", whole)[0])
    b8_plans = {name: K.plan_scan_phases(st, N, N) for name, st in (
        ("clos_r3_fill", Ac.fill_stages), ("clos_r3_scan", Ac.scan_stages))}
    log(f"# B8 plans: fill ({len(Ac.fill_stages)} stages) "
        + describe_plan(K, Ac.fill_stages, N, N) + f"; scan "
        f"({len(Ac.scan_stages)} stages) "
        + describe_plan(K, Ac.scan_stages, N, N) + f"; valid over {rows // 8}"
        f" of {N // 1024} blocks (m = {Ac.m}): "
        f"{k_b8[2]['ms']:.5f} ms, the whole plane {whole_ms:.5f} ms (bound "
        f"{timer.bound(nbytes(*whole) + 4 * N, 0)[0]:.5f})")
    if any(len(p) != 1 for p in b8_plans.values()):
        fail(f"scircuit's B8 plans take {[len(p) for p in b8_plans.values()]}"
             f" phases, not one each")

    # B9 on the program's own pipeline inputs, B10 against both
    v0 = BF._spread_x(xd, Ab.n, N, Ab.sigma_x)
    v1 = KF.bfly_xor_net_torch(v0, Ab.widen_B, Ab.widen_stages)
    v2 = KF.bfly_fill_torch(v1, Ab.fill_words, Ab.fill_stages)
    v3 = KF.bfly_xor_net_torch(v2, Ab.perm_B, Ab.perm_stages) * Ab.vals
    v4 = KF.bfly_scan_torch(v3, Ab.scan_guards, Ab.scan_stages)
    nets = [(v0, Ab.widen_B, Ab.widen_stages),
            (v2, Ab.perm_B, Ab.perm_stages),
            (v4, Ab.compact_B, Ab.compact_stages)]
    case = lambda name, a: (  # noqa: E731
        lambda: getattr(KF, name)(*a),
        lambda: getattr(KF, name + "_torch")(*a))
    k_b9 = [
        # each stage's bit plane read once per network: v, the word planes
        # the network uses, the output (the widen network timed)
        entry("bfly_xor_net", BFLY_SRC, [case("bfly_xor_net", a)
                                         for a in nets],
              (nbytes(v0, Ab.widen_B) + 4 * N, 0)),
        entry("bfly_fill", BFLY_SRC,
              [case("bfly_fill", (v1, Ab.fill_words, Ab.fill_stages))],
              (nbytes(v1, Ab.fill_words) + 4 * N, 0)),
        entry("bfly_scan", BFLY_SRC,
              [case("bfly_scan", (v3, Ab.scan_guards, Ab.scan_stages))],
              (nbytes(v3, Ab.scan_guards) + 4 * N, N))]
    # B9's phases: each call's plan, and the widen network's time a phase
    b9_want = b9_launches(KF, Ab)
    log(f"# B9 plans at T = {KF.tile_log(Ab.L)}: " + "; ".join(
        f"{key} {KF.b9_phase_table(key, st, Ab.L)}"
        for key, st in b9_calls(Ab) if st)
        + f"; {sum(b9_want.values())} launches per SpMV {b9_want}")
    n_widen = len(KF.b9_phase_table("bfly_xor_net", Ab.widen_stages, Ab.L))
    log(f"# B9 widen network: {k_b9[0]['ms']:.5f} ms in {n_widen} phases, "
        f"{k_b9[0]['ms'] / n_widen:.5f} ms a phase")
    planes = Ab.planes()
    chain = KF.bfly_xor_net(v0, Ab.widen_B, Ab.widen_stages)
    chain = KF.bfly_fill(chain, Ab.fill_words, Ab.fill_stages)
    chain = KF.bfly_xor_net(chain, Ab.perm_B, Ab.perm_stages) * Ab.vals
    chain = KF.bfly_scan(chain, Ab.scan_guards, Ab.scan_stages)
    chain = (KF.bfly_xor_net(chain, Ab.compact_B, Ab.compact_stages)
             * Ab.out_valid)
    full = equal("bfly_full vs the B9 chain",
                 lambda: KF.bfly_full(v0, *planes), lambda: chain)
    xcol = xd.unsqueeze(1)
    k_b10 = entry("bfly_full", BFLY_SRC,
                  [case("bfly_full", (v0, *planes))],
                  # the whole program's planes read once, out written once;
                  # its function, y = A·x, two operations per nnz
                  (nbytes(v0, *planes[:7]) + nbytes(full), 2 * host.nnz),
                  library=lambda: lib @ xcol)
    phases = KF.phase_table(Ab.planes()[7:], Ab.L)
    n_stages = sum(len(st) for st in Ab.planes()[7:])
    log(f"# B10 in {len(phases)} phases for {n_stages} stages (T = "
        f"{KF.tile_log(Ab.L)}): {len(phases)} launches per SpMV; phases "
        f"{phases}; {k_b10['ms']:.4f} ms; equals B9's chain and the plain "
        f"version; cuSPARSE fp32 SpMV {k_b10['library_ms']:.4f} ms")
    del u, fill, scan, valid, whole, v0, v1, v2, v3, v4, nets, chain, full
    del planes

    # CLOSM on the same host: one multicast gather network (x to every CSR
    # slot of its column) on B2, B8's scan, the compact network on B2, B8's
    # valid step, and the spilled nonzeros through a PyTorch side path;
    # each B2 and B8 call on the program's own pipeline inputs
    t_part = time.perf_counter()
    Am = build_clos_mcast(host)
    t_closm = time.perf_counter() - t_part
    log(f"# scircuit CLOSM (cold build {t_closm:.2f}s): N={Am.N} V={Am.V} "
        f"x_stride={Am.x_stride} scan_stages={len(Am.scan_stages)} "
        f"scan_hi={tuple(Am.scan_hi.shape)} n_spill={Am.n_spill} (padded "
        f"{Am.spill_rows.numel()}) footprint_MB="
        f"{Am.mem_footprint_bytes() / 1e6:.2f}")
    if not (Am.N == N and Am.n_spill > 0):
        fail(f"scircuit CLOSM: N={Am.N}, {Am.n_spill} spilled; want 2^20 "
             f"and a live side path")
    Am = Am.to(dev)
    m_calls = {"clos_invreg": [], "clos_r2": [], "clos_r3_scan": [],
               "clos_r3_valid": []}

    def m_step(name, *args):
        m_calls[name].append(args)
        return getattr(K, name + "_torch")(*args)

    u = CM._spread(xd, N, Am.x_stride)
    u = m_step("clos_r2", m_step("clos_invreg", u, Am.g_r1), Am.g_r2, Am.V)
    u = m_step("clos_r3_scan", u, Am.g_r3, Am.vals, Am.scan_hi,
               Am.scan_stages)
    u = m_step("clos_r2", m_step("clos_invreg", u, Am.compact_r1),
               Am.compact_r2, Am.V)
    m_step("clos_r3_valid", u, Am.compact_r3, Am.m)
    m_rows = -(-Am.m // 1024) * 8
    m_work = {   # as CLOS's: 12 bytes a slot a layer; the scan's product
        "clos_invreg": lambda a: (nbytes(*a) + 4 * N, 0),  # and adds
        "clos_r2": lambda a: (nbytes(*a) + 4 * N, 0),
        "clos_r3_scan": lambda a: (nbytes(a[0], a[1], a[2], hi(a[3]))
                                   + 4 * N, 2 * N),
        "clos_r3_valid": lambda a: (3 * 4 * m_rows * 128, 0)}
    k_closm = []
    for name, calls in m_calls.items():
        k_closm.append(entry(name, CLOSG_SRC,
                             [b8_case(name, a) for a in calls],
                             m_work[name](calls[0])))
        k_closm[-1]["name"] = name + "_closm"
    m_scan = K.plan_scan_phases(Am.scan_stages, N, N)
    log(f"# CLOSM's B2 and B8 calls equal their plain versions on its "
        f"multicast planes ({sum(map(len, m_calls.values()))} calls); scan "
        f"({len(Am.scan_stages)} stages) " + describe_plan(
            K, Am.scan_stages, N, N))
    del m_calls, u
    y, launches = counted_spmv(Am, xd, K)
    log(f"# launches during one scircuit CLOSM/cuda SpMV: "
        f"{ {k: v for k, v in launches.items() if v} } (total "
        f"{sum(launches.values())}; + the spread and the {Am.n_spill}-entry "
        f"side path in PyTorch)")
    if launches != {**dict.fromkeys(K.LAUNCHES, 0), "clos_invreg": 2,
                    "clos_r2": 2, "clos_r3_scan": len(m_scan),
                    "clos_r3_valid": 1}:
        fail(f"one scircuit CLOSM/cuda SpMV launched {launches}, not the "
             f"layers 2 + 2, the scan once a phase and the valid step once")
    check_gold("scircuit CLOSM/cuda", host, x, y)
    t_part = time.perf_counter() - t_part

    for label, A in (("CLOS", Ac), ("BFLY", Ab)):
        y, launches = counted_spmv(A, xd, K, KF)
        log(f"# launches during one scircuit {label}/cuda SpMV: "
            f"{ {k: v for k, v in launches.items() if v} } (total "
            f"{sum(launches.values())})")
        check_gold(f"scircuit {label}/cuda", host, x, y)
        if label == "CLOS":
            b8 = {k: launches[k] for k in (*b8_plans, "clos_r3_valid")}
            if b8 != {**{k: len(p) for k, p in b8_plans.items()},
                      "clos_r3_valid": 1}:
                fail(f"one scircuit CLOS/cuda SpMV launched B8 {b8}, not "
                     f"one a phase of its fill and scan plans + 1")
            if (launches["clos_invreg"], launches["clos_r2"]) != (3, 3):
                fail(f"one scircuit CLOS/cuda SpMV launched the layers "
                     f"{launches['clos_invreg']} + {launches['clos_r2']} "
                     f"times, not 3 + 3 (a network each)")
    if {k: launches[k] for k in KF.LAUNCHES} != {**b9_want, "bfly_full": 0}:
        fail(f"one scircuit BFLY/cuda SpMV launched "
             f"{ {k: launches[k] for k in KF.LAUNCHES} }, not one launch a "
             f"phase of its B9 plans {b9_want}")
    if sum(b9_want.values()) != 11:
        fail(f"scircuit's B9 plans take {sum(b9_want.values())} phases, "
             f"not 11 (3 a network, 1 the fill, 1 the scan)")
    time_candidates(timer, "scircuit", {
        "CLOS/cuda": lambda v: spmv(Ac, v, impl="cuda"),
        "CLOSM/cuda": lambda v: spmv(Am, v, impl="cuda"),
        "BFLY/cuda": lambda v: spmv(Ab, v, impl="cuda"),
        "BFLY/cuda fused (B10)": lambda v: spmv_bfly_cuda_fused(Ab, v),
        "cuSPARSE (library)": lambda v: (lib @ v.unsqueeze(1)).squeeze(1)},
        ("CLOS/cuda", "CLOSM/cuda", "BFLY/cuda", "BFLY/cuda fused (B10)"),
        xd)
    del Ac
    # CLOSM's main path: the bench protocol, as a user times a format; the
    # CLOSM kernel entries' launches are this run's
    t0 = time.perf_counter()
    K.reset_launch_counts()
    r = bench_spmv(host, Am, config=cfg, matrix_name="scircuit_twin", x=x)
    torch.cuda.synchronize()
    log(f"# scircuit CLOSM/{r.impl} through harness.bench_spmv: "
        f"{r.nnz_per_s / 1e9:.4f} Gnnz/s median="
        f"{r.time_iter_median * 1e6:.1f}us min={r.time_iter_min * 1e6:.1f}us"
        f" loops={r.num_loops}; launches "
        f"{ {k: v for k, v in K.LAUNCHES.items() if v} }")
    for k in k_closm:
        k["launches"] = K.LAUNCHES[k["name"].removesuffix("_closm")]
        if k["launches"] <= 0:
            fail(f"CLOSM's bench run never launched {k['name']}")
    check_gold("bench_spmv scircuit CLOSM/cuda", host, x, r.y)
    log_metrics("scircuit CLOSM/cuda", r.metrics)
    del Am, r
    log(f"# phase 16 CLOSM part done in "
        f"{t_part + time.perf_counter() - t0:.0f}s (build {t_closm:.1f}s; "
        f"its two timed candidates not counted)")

    # the sweep path: csr, clos, bfly
    out_dir = kept_dir(csv_dir, "phase16_sweep")
    K.reset_launch_counts()
    KF.reset_launch_counts()
    results = run_sweep([bench.SCIRCUIT_LINE],
                        formats=("csr", "clos", "bfly"),
                        out_dir=out_dir, config=cfg, device=dev)
    torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **KF.LAUNCHES}
    log(f"# launches during the csr/clos/bfly sweep: {launches}")
    check_csvs(out_dir, csv_labels(synthetic=True),
               {"csr_spmv": 2, "clos_spmv": 1, "bfly_spmv": 1})
    csr_labels = sorted(c for ln in open(os.path.join(
        out_dir, "csr_spmv.csv")).read().splitlines()[1:]
        for c in ln.split(",") if c.startswith("CSR_"))
    if csr_labels != ["CSR_sparse", "CSR_torch"]:
        fail(f"the scircuit csr_spmv.csv rows are {csr_labels}, not a "
             f"CSR/torch and a CSR/sparse row")
    for k in (*k_b2, *k_b8, *k_b9):
        k["launches"] = launches[k["name"].removesuffix("_clos")]
        if k["launches"] <= 0:
            fail(f"the csr/clos/bfly sweep never launched {k['name']}")
    check_rows(results, ["CSR/sparse", "CSR/torch", "CLOS/cuda",
                         "BFLY/cuda"], {"scircuit_twin": host}, x)
    log("# scircuit CSR/sparse (cuSPARSE through the registry) beside "
        "CSR/torch: " + "; ".join(
            f"{r.format_name}/{r.impl} {r.nnz_per_s / 1e9:.4f} Gnnz/s "
            f"median {r.time_iter_median * 1e6:.1f} us"
            for r in results if r.format_name == "CSR"))
    # CSR/sparse's host time: the call, on the format's sparse_csr view
    # (built once), and what a build of that view each call would add
    Ar = build_csr(host).to(dev)
    build_us = host_us(lambda: torch.sparse_csr_tensor(
        Ar.indptr, Ar.indices[:Ar.nnz], Ar.data[:Ar.nnz], size=Ar.shape,
        check_invariants=False))
    log(f"# scircuit CSR/sparse host enqueue: one SpMV "
        f"{host_us(lambda: spmv(Ar, xd, impl='sparse')):.1f} us (the "
        f"sparse_csr view built once; a build {build_us:.1f} us); "
        f"CSR/torch {host_us(lambda: spmv(Ar, xd, impl='torch')):.1f} us")
    del Ar
    del results
    # B10's path: the unregistered fused SpMV, called as a user would
    KF.reset_launch_counts()
    y = spmv_bfly_cuda_fused(Ab, xd)
    torch.cuda.synchronize()
    k_b10["launches"] = KF.LAUNCHES["bfly_full"]
    if not (k_b10["launches"] == len(phases) <= 20
            and sum(KF.LAUNCHES.values()) == len(phases)):
        fail(f"one fused BFLY SpMV launched {dict(KF.LAUNCHES)}, not one "
             f"per phase of {len(phases)}")
    check_gold("scircuit BFLY/cuda fused (B10)", host, x, y)
    del Ab, y, lib, host
    log(f"# phase 16 scircuit part done in "
        f"{time.perf_counter() - t_phase:.0f}s")

    # mac_econ_fwd500: past CLOS, inside BFLY
    mac = load_matrix(MAC_ECON_LINE, cfg)[0]
    try:
        build_clos(mac)
        fail("build_clos accepted mac_econ_fwd500 (N = 2^21)")
    except ClosRoutingError as e:
        log(f"# mac_econ_fwd500 (m={mac.m} nnz={mac.nnz}): build_clos "
            f"refused it: {e}")
    try:
        build_clos_mcast(mac)
        fail("build_clos_mcast accepted mac_econ_fwd500 (N = 2^21)")
    except ClosRoutingError as e:
        if "too large" not in str(e):
            fail(f"build_clos_mcast refused mac_econ_fwd500 for another "
                 f"reason than max_N: {e}")
        log(f"# mac_econ_fwd500: build_clos_mcast refused it: {e}")
    Am, info_m = cached_build_timed(build_bfly, mac, "bfly")
    log(f"# mac_econ_fwd500 BFLY ({describe(info_m)}): N={Am.N} L={Am.L} "
        f"stages "
        f"{len(Am.widen_stages)}/{len(Am.fill_stages)}/"
        f"{len(Am.perm_stages)}/{len(Am.scan_stages)}/"
        f"{len(Am.compact_stages)}")
    if Am.N != 1 << 21:
        fail(f"mac_econ_fwd500: BFLY N={Am.N}, want 2^21")
    Am = Am.to(dev)
    xm = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, mac.n)
    v = BF._spread_x(torch.as_tensor(xm, dtype=torch.float32, device=dev),
                     Am.n, Am.N, Am.sigma_x)
    for name, args, after in (
            ("bfly_xor_net", (Am.widen_B, Am.widen_stages), None),
            ("bfly_fill", (Am.fill_words, Am.fill_stages), None),
            ("bfly_xor_net", (Am.perm_B, Am.perm_stages), Am.vals),
            ("bfly_scan", (Am.scan_guards, Am.scan_stages), None),
            ("bfly_xor_net", (Am.compact_B, Am.compact_stages), None)):
        v = equal(f"mac_econ_fwd500 {name}",
                  lambda f=getattr(KF, name), a=(v, *args): f(*a),
                  lambda f=getattr(KF, name + "_torch"), a=(v, *args): f(*a))
        v = v if after is None else v * after
    log("# mac_econ_fwd500: B9 equals its plain versions on every stage")
    # B10 at N = 2^21 (T = 14: the strided tiling serves k >= 12)
    v0 = BF._spread_x(torch.as_tensor(xm, dtype=torch.float32, device=dev),
                      Am.n, Am.N, Am.sigma_x)
    chain = v * Am.out_valid
    equal("mac_econ_fwd500 bfly_full vs the B9 chain",
          lambda: KF.bfly_full(v0, *Am.planes()), lambda: chain)
    equal("mac_econ_fwd500 bfly_full vs the plain version",
          lambda: KF.bfly_full(v0, *Am.planes()),
          lambda: KF.bfly_full_torch(v0, *Am.planes()))
    phases = KF.phase_table(Am.planes()[7:], Am.L)
    ms = timer.ms(lambda: KF.bfly_full(v0, *Am.planes()))
    log(f"# mac_econ_fwd500 B10 in {len(phases)} phases (T = "
        f"{KF.tile_log(Am.L)}, {len(phases)} launches per SpMV): {ms:.4f} "
        f"ms; equals B9's chain and the plain version")
    y = spmv_bfly_cuda_fused(Am, torch.as_tensor(xm, dtype=torch.float32,
                                                 device=dev))
    check_gold("mac_econ_fwd500 BFLY/cuda fused (B10)", mac, xm, y)
    y, launches = counted_spmv(Am, torch.as_tensor(
        xm, dtype=torch.float32, device=dev), KF)
    b9_want = b9_launches(KF, Am)
    log(f"# launches during one mac_econ_fwd500 BFLY/cuda SpMV: "
        f"{launches}; B9 plans at T = {KF.tile_log(Am.L)}: " + "; ".join(
            f"{key} {KF.b9_phase_table(key, st, Am.L)}"
            for key, st in b9_calls(Am) if st))
    if launches != {**b9_want, "bfly_full": 0}:
        fail(f"one mac_econ_fwd500 BFLY/cuda SpMV launched {launches}, not "
             f"one launch a phase of its B9 plans {b9_want}")
    check_gold("mac_econ_fwd500 BFLY/cuda", mac, xm, y)
    del Am, v, v0, chain, y
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as out_dir:
        with contextlib.redirect_stdout(out):
            results = run_sweep([MAC_ECON_LINE], formats=("clos", "bfly"),
                                out_dir=out_dir, config=cfg, device=dev)
        log(out.getvalue().rstrip())
        if "# clos build refused mac_econ_fwd500: ClosRoutingError" not in (
                out.getvalue()):
            fail("the mac_econ_fwd500 sweep did not skip clos as unsuitable")
        check_csvs(out_dir, csv_labels(synthetic=True), {"bfly_spmv": 1})
    check_rows(results, ["BFLY/cuda"], {"mac_econ_fwd500": mac}, xm)
    log(f"# phase 16 done in {time.perf_counter() - t_phase:.0f}s")
    return [*k_b2, *k_b8, *k_closm, *k_b9, k_b10]


def ilu_phase(timer, dev, cfg) -> None:
    """Phase 17, IC(0)/ILU(0) and the level-scheduled trisolve (plain
    PyTorch on the card, no hand kernel: the JAX package solves in XLA):
    the trisolve workload on the shipsec1_spd twin cut to a quarter of
    its rows (``SHIPSEC1_QUARTER_LINE``, RCM as phase 15's CG), once
    through the
    sweep; a CG job with ``precond=ic0`` on the same twin (SELLW) and a
    BiCGStab job with ``precond=ilu0`` on scircuit_dd (CLOSG). Each
    gated (the trisolve's residual at 1e-2, the solves converged below
    1e-5), each schedule's kind and step count logged, and for each
    solver one preconditioner apply's device kernels counted under
    torch.profiler and timed (the builders are wrapped to keep what the
    sweep built)."""
    import dataclasses
    import torch
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch import solvers
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness.workloads import schedule_kind
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.solvers import ilu

    def kept(module, name, store):
        orig = getattr(module, name)

        def keep(*args, **kw):
            out = orig(*args, **kw)
            store.append(out)
            return out
        setattr(module, name, keep)
        return orig

    def describe(scheds):
        return ", ".join(
            f"{'L' if s.lower else 'U'} {schedule_kind(s)} "
            f"{s.n_levels} steps"
            + (f" (B {s.B}, Q {s.Q}, outliers {s.olvals.shape[1]} a block)"
               if schedule_kind(s) == "band" else "")
            for s in scheds)

    def apply_launches(label, fn, r):
        kinds = device_kernels(lambda: fn(r), n=1)
        n = int(round(sum(kinds.values())))
        ms = timer.ms(lambda: fn(r), iters=3)
        log(f"# {label}: one preconditioner apply, {n} device kernels "
            f"(plain PyTorch: no kernel wrapper counts), {ms:.3f} ms "
            f"(host-bound: the enqueue of each step); top: " + "; ".join(
                f"{k[:40]} {v:g}" for k, v in sorted(
                    kinds.items(), key=lambda kv: -kv[1])[:4]))
        if n <= 0:
            fail(f"{label}: a preconditioner apply ran no device kernel")

    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(cfg, use_rcm_reordering=True,
                               matrix_transform="spd", min_num_loops=8,
                               warmup_iters=2, inner_iters=8, min_time_s=0.5)
    # 1. the trisolve, once per matrix through the sweep
    built = []
    orig = kept(ilu, "build_schedule", built)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            results = run_sweep([SHIPSEC1_QUARTER_LINE], formats=("csr",),
                                workloads=("trisolve",), out_dir=out_dir,
                                config=tcfg, device=dev)
            torch.cuda.synchronize()
            check_csvs(out_dir, WORKLOAD_LABELS, {"trisolve": 1})
    finally:
        ilu.build_schedule = orig
    if len(results) != 1 or len(built) != 2:
        fail(f"the trisolve sweep gave {len(results)} rows from "
             f"{len(built)} schedules, not one row from L's and U's")
    r = results[0]
    e = r.extra
    if not (r.mape <= 1e-2 and np.isfinite(r.out).all()
            and r.out.shape == (r.out.size,)):
        fail(f"trisolve on {r.matrix_name}: residual {r.mape}")
    log(f"# trisolve {r.matrix_name} {r.format_name}/{r.impl}: residual "
        f"‖LUx - b‖/‖b‖ = {r.mape}, one solve "
        f"{r.time_iter_median * 1e3:.3f} ms ({r.num_loops} timed), "
        f"{r.gflops:.4f} GFLOPS; ILU(0) {e['t_factorize']:.1f}s, schedules "
        f"{e['t_schedule']:.1f}s; " + describe(built))
    del built, results
    log(f"# phase 17 trisolve done in {time.perf_counter() - t_phase:.0f}s")

    # 2. CG + IC(0) on shipsec1_spd, 3. BiCGStab + ILU(0) on scircuit_dd
    for workload, line, transform, fmt, precond, lib, row in (
            ("cg", SHIPSEC1_QUARTER_LINE, "spd", "sellw", "ic0", KS,
             "SELLW/cuda+ic0"),
            ("bicgstab", bench.SCIRCUIT_LINE, "dd", "closg", "ilu0", K,
             "CLOSG/cuda+ilu0")):
        scfg = dataclasses.replace(
            cfg, use_rcm_reordering=True if workload == "cg" else "auto",
            matrix_transform=transform, cg_max_num_iters=50,
            solver_precond=precond)
        states = []
        orig = kept(solvers, "make_precond_state", states)
        try:
            with tempfile.TemporaryDirectory() as out_dir:
                lib.reset_launch_counts()
                results = run_sweep([line], formats=(fmt,),
                                    workloads=(workload,), out_dir=out_dir,
                                    config=scfg, device=dev)
                torch.cuda.synchronize()
                launches = {k: v for k, v in lib.LAUNCHES.items() if v}
                check_csvs(out_dir, WORKLOAD_LABELS,
                           {f"{fmt}_{workload}": 1})
        finally:
            solvers.make_precond_state = orig
        got = [f"{r.format_name}/{r.impl}" for r in results]
        if got != [row] or len(states) != 1:
            fail(f"{workload} + {precond} sweep rows {got} from "
                 f"{len(states)} preconditioners, want [{row!r}] from one")
        r = results[0]
        e = r.extra
        apply_fn, (Ls, Us) = states[0]
        log(f"# {workload} + {precond} {r.matrix_name} {row}: converged="
            f"{e['converged']} iterations={r.num_loops} (loop "
            f"{e['loop_iterations']}) relative residual="
            f"{e['relative_residual']}, solve {e['solve_time'] * 1e3:.3f} "
            f"ms, per iteration {r.time_iter_median * 1e3:.3f} ms, "
            f"{r.gflops:.4f} GFLOPS, first solve {e['compile_time']:.2f}s, "
            f"preconditioner {e['precond_setup_time']:.1f}s ("
            + describe((Ls, Us)) + f"); kernel launches in the sweep "
            f"{launches}")
        if not (e["converged"] and e["relative_residual"] < 1e-5):
            fail(f"{workload} + {precond} {row} did not converge below "
                 f"1e-5: {e}")
        if not launches:
            fail(f"the {workload} + {precond} sweep launched no kernel")
        rv = torch.ones(Ls.m, dtype=torch.float32, device=dev)
        apply_launches(f"{precond} {r.matrix_name}",
                       lambda v: apply_fn((Ls, Us), v), rv)
        del states, results, Ls, Us, apply_fn
    log(f"# phase 17 done in {time.perf_counter() - t_phase:.0f}s")


def classic_phase(timer, dev, cfg) -> None:
    """Phase 18, SpGEMM and the classic formats (plain PyTorch on the
    card, no hand kernel: the JAX package computes them in XLA), on the
    scircuit and raefsky3 twins at full size. The plans and the formats
    the sweeps build are kept (their builders wrapped) so that each
    format's call can be timed alone and each SpGEMM block profiled."""
    import contextlib
    import dataclasses
    import io
    import torch
    from spmv_research_tpu_torch import sweep as cli
    from spmv_research_tpu_torch.convert import build_dia, build_ldu
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness import sweep as sweep_mod
    from spmv_research_tpu_torch.harness.bench import csv_labels
    from spmv_research_tpu_torch.harness.workloads import (sddmm_gold,
                                                           sddmm_inputs,
                                                           spmm_inputs)
    from spmv_research_tpu_torch.ops import sddmm, spgemm as sg, spmm, spmv

    t_phase = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           TWINS)) as f:
        twins = f.read().splitlines()
    lines = {"scircuit": twins[4], "raefsky3": twins[6]}
    ccfg = dataclasses.replace(cfg, min_num_loops=32, min_time_s=0.3)

    class Tee(io.StringIO):
        """stdout kept as it is printed, to assert the refusal lines."""

        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    @contextlib.contextmanager
    def keeping(obj, name, store, many=False):
        """``obj.name`` (a function, or with ``many`` each function of the
        dict ``obj``) wrapped to append (args, result) to ``store``."""
        def wrap(fn, key=None):
            def keep(*args, **kw):
                out = fn(*args, **kw)
                store.append((key, args, out))
                return out
            return keep
        if many:
            orig = dict(obj)
            obj.update({k: wrap(v, k) for k, v in orig.items()})
        else:
            orig = getattr(obj, name)
            setattr(obj, name, wrap(orig))
        try:
            yield
        finally:
            if many:
                obj.update(orig)
            else:
                setattr(obj, name, orig)

    one_call = functools.partial(call_times, timer)

    # (a) SpGEMM through the sweep, the plans kept
    kept = []
    with keeping(sg, "spgemm_device_plans", kept), \
            tempfile.TemporaryDirectory() as out_dir:
        results = run_sweep(list(lines.values()), formats=(),
                            workloads=("spgemm",), out_dir=out_dir,
                            config=ccfg, device=dev)
        torch.cuda.synchronize()
        check_csvs(out_dir, WORKLOAD_LABELS, {"spgemm": 2})
    if [r.matrix_name for r in results] != list(lines) or len(kept) != 2:
        fail(f"the spgemm sweep gave rows {[r.matrix_name for r in results]}"
             f" from {len(kept)} plan builds, want {list(lines)}")
    for r, (_, (A, B, *_), plans), want_blocks in zip(results, kept,
                                                       (1, 8)):
        e = r.extra
        pairs = sum(bp.npairs for bp in plans)
        want_pairs = int(A.row_lengths()[A.ja].sum())
        log(f"# spgemm {r.matrix_name} {r.format_name}/{r.impl}: "
            f"{r.gflops:.4f} GFLOPS median={r.time_iter_median * 1e3:.3f} ms "
            f"({r.num_loops} timed), pairs {pairs}, nnz(C) {e['nnz_c']}, "
            f"blocks {e['n_blocks']}, plans {e['t_symbolic']:.1f}s, max "
            f"|C - gold| / max |gold| = {r.max_ae}, checked_frac "
            f"{e['checked_frac']}")
        if e["n_blocks"] != want_blocks or pairs != want_pairs:
            fail(f"spgemm {r.matrix_name}: {e['n_blocks']} blocks and "
                 f"{pairs} pairs, want {want_blocks} and {want_pairs}")
        if not (r.max_ae <= 1e-5 and e["checked_frac"] > 0):
            fail(f"spgemm {r.matrix_name}: C off its gold by {r.max_ae} of "
                 f"max |gold| over {e['checked_frac']} of C")
        for i, bp in enumerate(p for p in plans if p.nnz_c):
            ev, n_launch = device_events(bp.numeric_plane)
            log(f"# spgemm {r.matrix_name} block {i} (rows {bp.r0}:{bp.r1},"
                f" {bp.npairs} pairs, plane {tuple(bp.guard.shape)}, stages "
                f"{bp.stages}, carry stages {bp.cstages}): numeric phase "
                f"{n_launch:g} launches, {timer.warm_ms(bp.numeric_plane):.4f}"
                f" ms warm; profiled: {sum(c for c, _ in ev.values()):g} "
                f"device kernels, {sum(us for _, us in ev.values()):.2f} us; "
                + "; ".join(f"{k[:48]} {c:g}x {us:.2f} us" for k, (c, us) in
                            sorted(ev.items(), key=lambda kv: -kv[1][1])))
    del kept, results, plans
    log(f"# phase 18 spgemm done in {time.perf_counter() - t_phase:.0f}s")

    # (b) the SpMV rows, each format kept and timed alone
    formats = ("coo", "csc", "ell", "sellcs", "bsr", "csr", "csr_sym")
    built, out = [], Tee()
    with keeping(sweep_mod.FORMAT_BUILDERS, None, built, many=True), \
            tempfile.TemporaryDirectory() as out_dir, \
            contextlib.redirect_stdout(out):
        results = run_sweep(list(lines.values()), formats=formats,
                            out_dir=out_dir, config=ccfg, device=dev)
        torch.cuda.synchronize()
        check_csvs(out_dir, csv_labels(synthetic=True), {
            "coo_spmv": 2, "csc_spmv": 2, "ell_spmv": 2, "sellcs_spmv": 2,
            "bsr_spmv": 1, "csr_spmv": 4})
        if os.path.exists(os.path.join(out_dir, "csr_sym_spmv.csv")):
            fail("CSR_SYM gave rows on an unsymmetric twin")
    for name in lines:
        for fmt, err in (("bsr", "BSRBuildError"),
                         ("csr_sym", "CSRSymBuildError")):
            if fmt == "bsr" and name == "raefsky3":
                continue
            if f"# {fmt} build refused {name}: {err}" not in out.getvalue():
                fail(f"{fmt} on {name}: no refusal line")
    hosts = {}                      # the sweep builds each matrix in turn
    for _, (h, *_), _ in built:
        if all(h is not v for v in hosts.values()):
            hosts[list(lines)[len(hosts)]] = h
    golds = {name: (np.random.Generator(np.random.PCG64(7)).uniform(
        0.0, 1.0, h.n), None) for name, h in hosts.items()}
    check_rows(results, [f"{f}/torch" for f in (
        "COO", "CSC", "ELL", "SELL-C-s", "CSR")] * 2 + ["BSR/torch"]
        + ["CSR/sparse"] * 2, hosts, None, golds)
    for _, (h, *_), A in built:
        name = next(k for k, v in hosts.items() if v is h)
        A = A.to(dev)
        xd = torch.as_tensor(golds[name][0], dtype=torch.float32, device=dev)
        impls = ("torch", "sparse") if A.format_name == "CSR" else ("torch",)
        for impl in impls:
            log(f"# classic {name} {A.format_name}/{impl} SpMV: "
                f"{one_call(lambda: spmv(A, xd, impl=impl))}; footprint "
                f"{A.mem_footprint_bytes() / 1e6:.2f} MB")
        del A
    del built, results
    log(f"# phase 18 spmv rows done in {time.perf_counter() - t_phase:.0f}s")

    # the CSR_SYM job: raefsky3's SPD transform, through the command line
    os.environ.update(MIN_NUM_LOOPS="32", MIN_TIME_S="0.3",
                      USE_RCM_REORDERING="auto")
    built = []
    try:
        with keeping(sweep_mod.FORMAT_BUILDERS, None, built, many=True), \
                tempfile.TemporaryDirectory() as out_dir:
            results = cli.main(["--matrix", lines["raefsky3"], "--job",
                                "formats=csr_sym,csr;workloads=spmv;"
                                f"transform=spd;out={out_dir}"])
            torch.cuda.synchronize()
            check_csvs(out_dir, csv_labels(synthetic=True),
                       {"csr_sym_spmv": 1, "csr_spmv": 2})
    finally:
        for k in ("MIN_NUM_LOOPS", "MIN_TIME_S", "USE_RCM_REORDERING"):
            del os.environ[k]
    spd = built[0][1][0]
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, spd.n)
    check_rows(results, ["CSR_SYM/torch", "CSR/torch", "CSR/sparse"],
               {"raefsky3_spd": spd}, x)
    A = built[0][2].to(dev)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    log(f"# classic raefsky3_spd CSR_SYM/torch SpMV: "
        f"{one_call(lambda: spmv(A, xd))}; {A.nnz} stored of "
        f"{A.nnz_expanded} nnz")
    del A, built, results

    # (c) SpMM and SDDMM at K = 128 on raefsky3
    k = 128
    built = []
    with keeping(sweep_mod.FORMAT_BUILDERS, None, built, many=True), \
            tempfile.TemporaryDirectory() as out_dir:
        # BSR's mxu and CSR's gather SDDMM are phase 19's
        results = run_sweep([lines["raefsky3"]],
                            formats=("ell", "bsr", "sellcs", "coo", "csr"),
                            workloads=("spmm", "sddmm"), impls=("torch",),
                            out_dir=out_dir,
                            config=dataclasses.replace(ccfg, k_dim=k),
                            device=dev)
        torch.cuda.synchronize()
        check_csvs(out_dir, WORKLOAD_LABELS, {
            "ell_spmm": 1, "bsr_spmm": 1, "sellcs_spmm": 1, "coo_spmm": 1,
            "coo_sddmm": 1, "csr_spmm": 1, "csr_sddmm": 1})
    want = sorted(["ELL/torch spmm", "BSR/torch spmm", "SELL-C-s/torch spmm",
                   "COO/torch spmm", "COO/torch sddmm", "CSR/torch spmm",
                   "CSR/torch sddmm"])
    got = sorted(f"{r.format_name}/{r.impl} {r.workload}" for r in results)
    if got != want:
        fail(f"K = 128 sweep rows {got}, want {want}")
    host = built[0][1][0]
    X = spmm_inputs(host, k)
    Am, Bm = sddmm_inputs(host, k)
    gold = sddmm_gold(host, Am, Bm)     # = Σ|a||b|: a, b ≥ 0
    for r in results:
        key = f"raefsky3 {r.format_name}/{r.impl} {r.workload}"
        log(f"# sweep {key}: {r.gflops:.2f} GFLOPS median="
            f"{r.time_iter_median * 1e6:.1f}us loops={r.num_loops}")
        if r.workload == "spmm":
            check_y(f"sweep {key}", host, X, r.out)
        else:
            rel = float(np.max(np.abs(r.out - gold) / (gold + 1e-30)))
            if not (r.out.shape == (host.nnz,) and rel <= 1e-5):
                fail(f"sweep {key}: shape {r.out.shape}, max |C-gold|/"
                     f"(Σ|a||b|) = {rel}")
            log(f"# sweep {key} vs fp64 gold: max rel (Σ|a||b|) = {rel}")
    Xd = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Ad, Bd = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (Am, Bm))
    for _, _, A in built:
        A = A.to(dev)
        line = (f"# classic raefsky3 {A.format_name}/torch K = {k}: SpMM "
                f"{one_call(lambda: spmm(A, Xd))}")
        if A.format_name in ("COO", "CSR"):
            line += f"; SDDMM {one_call(lambda: sddmm(A, Ad, Bd))}"
        log(line)
        del A
    del built, results, Xd, Ad, Bd
    log(f"# phase 18 K = {k} done in {time.perf_counter() - t_phase:.0f}s")

    # (d) DIA and LDU on phase 7's tridiagonal matrix
    tri = stream_tridiagonal(np.random.Generator(np.random.PCG64(11)))
    tri_host = HostCSR.from_scipy(tri)
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0, STREAM_N)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    gold = tri_host.spmv_gold_fast(x).astype(np.float64)
    for build in (build_dia, build_ldu):
        t0 = time.perf_counter()
        A = build(tri_host).to(dev)
        t_build = time.perf_counter() - t0
        y = spmv(A, xd)
        torch.cuda.synchronize()
        check_gold(f"tridiagonal {A.format_name}/torch", tri_host, x, y, gold)
        ev, n_launch = device_events(lambda: spmv(A, xd))
        log(f"# classic tridiagonal n={STREAM_N} {A.format_name}/torch SpMV: "
            f"build {t_build:.2f}s, {one_call(lambda: spmv(A, xd))}, "
            f"{n_launch:g} launches ({sum(c for c, _ in ev.values()):g} "
            f"device kernels profiled); footprint "
            f"{A.mem_footprint_bytes() / 1e6:.2f} MB")
        del A, y
    A = cusparse(tri_host, dev)
    log(f"# classic tridiagonal cuSPARSE SpMV: "
        f"{one_call(lambda: A @ xd.unsqueeze(1))}")
    log(f"# phase 18 done in {time.perf_counter() - t_phase:.0f}s")


def xla_engines_phase(timer, dev, cfg) -> None:
    """Phase 19, the XLA-only engines and real-matrix input (plain PyTorch
    on the card, no hand kernel: the JAX package computes them in XLA), on
    the scircuit (validation_twins.txt:5), raefsky3 (:7) and shipsec1 (:27)
    twins at full size, no RCM, and the chunked CSR baseline on
    shipsec1. Each call is checked against its float64 gold and timed
    alone, cold and warm, with its host µs, beside cuSPARSE's call of the
    same function on the same matrix."""
    import dataclasses
    import torch
    from spmv_research_tpu_torch import mtx_sweep
    from spmv_research_tpu_torch.convert import (BSRBuildError, build_bsr,
                                                 build_csr)
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.harness import run_sweep
    from spmv_research_tpu_torch.harness.bench import csv_labels
    from spmv_research_tpu_torch.harness.workloads import (sddmm_gold,
                                                           sddmm_inputs,
                                                           spmm_inputs)
    from spmv_research_tpu_torch.io import mtx_read, native
    from spmv_research_tpu_torch.ops import (bsr_sddmm_to_csr_values,
                                             build_bsrg, build_csr_chunked,
                                             build_csr_lut, build_sellg,
                                             sddmm, spmm, spmv)

    t_phase = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           TWINS)) as f:
        twins = f.read().splitlines()
    lines = {"scircuit": twins[4], "raefsky3": twins[6],
             "shipsec1": twins[26]}
    hosts = {name: generate_from_line(line)[0] for name, line in lines.items()}
    log(f"# phase 19 twins generated in {time.perf_counter() - t_phase:.0f}s")
    call = functools.partial(call_times, timer)
    k = 128

    def as_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def spmv_case(label, A, host, lib):
        x = np.random.Generator(np.random.PCG64(7)).uniform(0, 1, host.n)
        xd = as_dev(x)
        y = spmv(A, xd)
        torch.cuda.synchronize()
        check_gold(label, host, x, y)
        log(f"# {label} SpMV: {call(lambda: spmv(A, xd))}; cuSPARSE "
            f"{call(lambda: torch.mv(lib, xd))}")

    def spmm_case(label, A, host, lib):
        X = spmm_inputs(host, k)
        Xd = as_dev(X)
        Y = spmm(A, Xd)
        torch.cuda.synchronize()
        check_y(f"{label} SpMM K = {k}", host, X, Y.double().cpu().numpy())
        log(f"# {label} SpMM K = {k}: {call(lambda: spmm(A, Xd))}; cuSPARSE "
            f"{call(lambda: torch.sparse.mm(lib, Xd))}")

    def sddmm_case(label, S, host, lib, impl, csr_order):
        Am, Bm = sddmm_inputs(host, k)
        gold = sddmm_gold(host, Am, Bm)        # = Σ|a||b|: a, b ≥ 0
        Ad, Bd = as_dev(Am), as_dev(Bm)
        C = sddmm(S, Ad, Bd, impl=impl)
        torch.cuda.synchronize()
        vals = csr_order(C)
        rel = float(np.max(np.abs(vals - gold) / (gold + 1e-30)))
        if not (vals.shape == (host.nnz,) and rel <= 1e-5):
            fail(f"{label} SDDMM: shape {vals.shape}, max |C-gold|/"
                 f"(Σ|a||b|) = {rel}")
        library = lambda: torch.sparse.sampled_addmm(  # noqa: E731
            lib, Ad, Bd.t(), beta=0.0)
        log(f"# {label} SDDMM K = {k} vs fp64 gold: max rel (Σ|a||b|) = "
            f"{rel}; {call(lambda: sddmm(S, Ad, Bd, impl=impl))}; cuSPARSE "
            f"{call(library)}")

    def built(label, build, host):
        t0 = time.perf_counter()
        A = build(host)
        log(f"# {label}: built in {time.perf_counter() - t0:.2f}s, footprint "
            f"{A.mem_footprint_bytes() / 1e6:.2f} MB")
        return A.to(dev)

    # (a) CSR_LUT on scircuit: its own values, and phase 9's 64 levels
    sc = hosts["scircuit"]
    rng = np.random.Generator(np.random.PCG64(13))
    levels = rng.uniform(-1.0, 1.0, 64)
    sq = HostCSR.from_arrays(sc.ia, sc.ja,
                             levels[rng.integers(0, 64, sc.nnz)], sc.m, sc.n)
    for label, host, idx_dtype in (("scircuit", sc, torch.int32),
                                   ("scircuit 64 levels", sq, torch.int8)):
        A = built(f"{label} CSR_LUT", build_csr_lut, host)
        log(f"# {label} CSR_LUT: {A.n_unique} distinct values, val_idx "
            f"{A.val_idx.dtype}")
        if A.val_idx.dtype != idx_dtype:
            fail(f"{label} CSR_LUT: val_idx {A.val_idx.dtype}, want "
                 f"{idx_dtype}")
        lib = cusparse(host, dev)
        spmv_case(f"{label} CSR_LUT/torch", A, host, lib)
        spmm_case(f"{label} CSR_LUT/torch", A, host, lib)
        del A, lib
    del sq

    # (b) SELLG SpMM, (c) BSRG and BSR/mxu, (d) CSR/gather
    for name in ("raefsky3", "shipsec1"):
        host = hosts[name]
        lib = cusparse(host, dev)
        A = built(f"{name} SELLG", build_sellg, host)
        log(f"# {name} SELLG: widths {A.widths}, rows {A.counts}")
        spmm_case(f"{name} SELLG/torch", A, host, lib)
        del A
        S = build_csr(host).to(dev)
        sddmm_case(f"{name} CSR/gather", S, host, lib, "gather",
                   lambda C: C.double().cpu().numpy()[: host.nnz])
        del S
        if name == "raefsky3":
            A = built(f"{name} BSRG", build_bsrg, host)
            log(f"# {name} BSRG: {A.n_blocks} blocks, widths {A.widths}")
            spmv_case(f"{name} BSRG/torch", A, host, lib)
            spmm_case(f"{name} BSRG/torch", A, host, lib)
            del A
            S = build_bsr(host).to(dev)
            sddmm_case(f"{name} BSR/mxu", S, host, lib, "mxu",
                       lambda C: bsr_sddmm_to_csr_values(S, C, host))
            del S
        del lib
    try:
        build_bsrg(sc)
        fail("BSRG built the scircuit twin: BSR refuses it")
    except BSRBuildError as e:
        log(f"# scircuit BSRG refused, as BSR: {e}")

    # (g) the chunked CSR baseline (CSR/torchc) on shipsec1, at the default
    # block of 2^21 nonzeros and at 2^20, beside CSR/torch and cuSPARSE
    t_chunked = time.perf_counter()
    ship = hosts["shipsec1"]
    lib = cusparse(ship, dev)
    S = build_csr(ship).to(dev)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0, 1, ship.n)
    xd = as_dev(x)
    X = spmm_inputs(ship, k)                # ≥ 0: |A|·|X| = |A|·X
    Xd = as_dev(X)
    mat = ship.to_scipy()
    gold, Y_gold, Y_scale = (ship.spmv_gold_fast(x).astype(np.float64),
                             mat @ X, np.abs(mat) @ X + 1e-30)
    del mat
    log(f"# shipsec1 CSR/torch SpMV: {call(lambda: spmv(S, xd))}; SpMM K = "
        f"{k}: {call(lambda: spmm(S, Xd))}; cuSPARSE SpMV "
        f"{call(lambda: torch.mv(lib, xd))}, SpMM "
        f"{call(lambda: torch.sparse.mm(lib, Xd))}")
    del S
    for block in (1 << 21, 1 << 20):
        label = f"shipsec1 CSR/torchc (block 2^{block.bit_length() - 1})"
        A = built(label, lambda h: build_csr_chunked(h, block=block), ship)
        n_blocks = A.data.shape[0]
        log(f"# {label}: {n_blocks} blocks of {A.data.shape[1]}, R = {A.R}")
        if n_blocks < (4 if block == 1 << 21 else 8):
            fail(f"{label}: {n_blocks} blocks for {ship.nnz} nnz")
        y = spmv(A, xd, impl="torchc")
        Y = spmm(A, Xd, impl="torchc")
        torch.cuda.synchronize()
        check_gold(label, ship, x, y, gold)
        Y = Y.double().cpu().numpy()
        rel = float(np.max(np.abs(Y - Y_gold) / Y_scale))
        if not (Y.shape == Y_gold.shape and rel <= 1e-5):
            fail(f"{label} SpMM K = {k}: shape {Y.shape}, max |Y-gold|/"
                 f"(|A||X|) = {rel}")
        log(f"# {label} SpMM K = {k} vs fp64 gold: max rel (|A||X|) = {rel}")
        log(f"# {label} SpMV: {call(lambda: spmv(A, xd, impl='torchc'))}; "
            f"SpMM K = {k}: {call(lambda: spmm(A, Xd, impl='torchc'))}")
        del A, y, Y
    del lib, X, Xd, gold, Y_gold, Y_scale
    log(f"# phase 19 chunked CSR done in "
        f"{time.perf_counter() - t_chunked:.0f}s")
    log(f"# phase 19 calls done in {time.perf_counter() - t_phase:.0f}s")

    # (e) the SDDMM sweep rows: CSR/torch, CSR/gather and BSR/mxu
    pcfg = dataclasses.replace(cfg, min_num_loops=32, min_time_s=0.3,
                               use_rcm_reordering=False, k_dim=k)
    raef = hosts["raefsky3"]
    with tempfile.TemporaryDirectory() as out_dir:
        results = run_sweep([lines["raefsky3"]], formats=("csr", "bsr"),
                            workloads=("sddmm",), out_dir=out_dir,
                            config=pcfg, device=dev)
        check_csvs(out_dir, WORKLOAD_LABELS, {"csr_sddmm": 2,
                                              "bsr_sddmm": 1})
    got = sorted(f"{r.format_name}/{r.impl}" for r in results)
    if got != ["BSR/mxu", "CSR/gather", "CSR/torch"]:
        fail(f"the raefsky3 SDDMM sweep gave rows {got}")
    gold = sddmm_gold(raef, *sddmm_inputs(raef, k))
    for r in results:
        rel = float(np.max(np.abs(r.out - gold) / (gold + 1e-30)))
        log(f"# sweep raefsky3 {r.format_name}/{r.impl} sddmm: "
            f"{r.gflops:.2f} GFLOPS median={r.time_iter_median * 1e6:.1f}us"
            f" loops={r.num_loops}; max rel (Σ|a||b|) = {rel}")
        if not (r.out.shape == (raef.nnz,) and rel <= 1e-5):
            fail(f"sweep raefsky3 {r.format_name}/{r.impl} sddmm: shape "
                 f"{r.out.shape}, max rel {rel}")
        log_metrics(f"raefsky3 {r.format_name}/{r.impl} sddmm", r.metrics)
    del results
    log(f"# phase 19 SDDMM sweep done in {time.perf_counter() - t_phase:.0f}s")

    # (f) the .mtx round trip: scircuit and raefsky3 written as .mtx, swept
    # from disk and from memory, rows equal; short timed chains (a
    # scircuit SELLG SpMM is ≈ 50 ms of host, its widths up to 512) and K
    # = 16, since each SpMM row's float64 gold is host time
    rcfg = dataclasses.replace(pcfg, min_num_loops=8, min_time_s=0.05,
                               warmup_iters=2, k_dim=16)
    with tempfile.TemporaryDirectory() as out_dir:
        mem, disk, bad = mtx_sweep.round_trip(
            [lines["scircuit"], lines["raefsky3"]], out_dir, config=rcfg,
            device=dev)
        torch.cuda.synchronize()
        if bad:
            fail(f".mtx round trip: rows differ from the in-memory ones: "
                 f"{bad}")
        disk_dir = os.path.join(out_dir, "disk")
        check_csvs(disk_dir, csv_labels(synthetic=False), {
            "csr_spmv": 2, "csr_lut_spmv": 2, "bsrg_spmv": 1})
        check_csvs(disk_dir, WORKLOAD_LABELS, {
            "csr_spmm": 2, "csr_lut_spmm": 2, "sellg_spmm": 2,
            "bsrg_spmm": 1})
        for name in ("scircuit", "raefsky3"):
            path = os.path.join(out_dir, "mtx", f"{name}.mtx")
            t0 = time.perf_counter()
            fast = mtx_read(path)
            t_native = time.perf_counter() - t0
            saved = native._LIB, native._TRIED
            native._LIB, native._TRIED = None, True
            try:
                t0 = time.perf_counter()
                slow = mtx_read(path)
                t_numpy = time.perf_counter() - t0
            finally:
                native._LIB, native._TRIED = saved
            same = all(np.array_equal(getattr(fast, f), getattr(slow, f))
                       for f in ("rows", "cols", "vals"))
            log(f"# {name}.mtx ({os.path.getsize(path) / 1e6:.1f} MB, "
                f"{fast.nnz} entries): parse {t_native:.2f}s native "
                f"(loaded: {native.have_native()}), {t_numpy:.2f}s numpy; "
                f"same arrays: {same}")
            if not same:
                fail(f"{name}.mtx: the native and numpy parsers differ")
    want = sorted([f"{n} {r}" for n in ("scircuit", "raefsky3") for r in (
        "CSR/torch spmv", "CSR/torch spmm", "CSR_LUT/torch spmv",
        "CSR_LUT/torch spmm", "SELLG/torch spmm")]
        + ["raefsky3 BSRG/torch spmv", "raefsky3 BSRG/torch spmm"])
    got = sorted(f"{f[0]} {f[1]}/{f[2]} {f[3]}"
                 for f in map(mtx_sweep.row_fields, disk))
    if got != want or len(mem) != len(disk):
        fail(f".mtx round trip rows {got}, want {want}")
    for r in disk:
        host = hosts[r.matrix_name]
        key = (f"{r.matrix_name}.mtx {r.format_name}/{r.impl} "
               f"{getattr(r, 'workload', 'spmv')}")
        if hasattr(r, "workload"):
            check_y(f"sweep {key}", host, spmm_inputs(host, rcfg.k_dim),
                    r.out)
        else:
            x = np.random.Generator(np.random.PCG64(7)).uniform(0, 1, host.n)
            check_gold(f"sweep {key}", host, x, r.y)
        log_metrics(key, r.metrics)
    log(f"# .mtx round trip: {len(disk)} disk rows equal to the in-memory "
        f"rows in m, n, nnz and the 8 metrics")
    log(f"# phase 19 done in {time.perf_counter() - t_phase:.0f}s")


def tooling_sweeps(run_dir, dev) -> list:
    """For phase 20 alone: CSV directories like those of phases 8, 12, 14
    and 16, from short sweeps of the scircuit twin (csr and closg SpMV;
    csr SpMM and SDDMM at K = 16)."""
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
    cfg = BenchConfig(min_num_loops=16, min_time_s=0.2,
                      use_rcm_reordering="auto", k_dim=16)
    dirs = [kept_dir(run_dir, "alone_spmv"), kept_dir(run_dir, "alone_k")]
    run_sweep([bench.SCIRCUIT_LINE], formats=("csr", "closg"),
              out_dir=dirs[0], config=cfg, device=dev)
    run_sweep([bench.SCIRCUIT_LINE], formats=("csr",),
              workloads=("spmm", "sddmm"), out_dir=dirs[1], config=cfg,
              device=dev)
    return dirs


def leaves_of(fmt) -> list:
    from spmv_research_tpu_torch.core.formats import tree_map
    out = []
    tree_map(out.append, fmt)
    return out


def captured(fn, *args) -> list:
    """The lines ``fn(*args)`` prints on stdout, also logged."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    lines = out.getvalue().rstrip().splitlines()
    for ln in lines:
        log(f"#   {ln}")
    return lines


def tooling_phase(timer, dev, run_dir, csv_dirs, smi_line) -> None:
    """Phase 20, at the main path's full size: (a) the format cache
    (``build_best`` on the scircuit twin cold and loaded: every tensor
    equal, the loaded CLOSG program's y on the card bit for bit the fresh
    one's; ``bench.run`` twice on one cache directory, the second loading);
    (b) k-means row clustering (k = 16) on the shipsec1 and scircuit twins
    as generated: host seconds, the row-local features, CSR/torch and
    CSR/sparse in both orders, each y mapped back and held to the gold;
    (c) a CLOSG/cuda SpMV inside ``trace_region`` under ``utils.trace.
    profile`` (in a child process: the profiler drops device events late
    in a long process); (d) the CLIs: machine_info (the card's name and
    power limit as phase 1 read them), mat_feat, twin_fidelity, the
    locality statistics of shipsec1 after RCM, collect_results over
    ``csv_dirs``; (e) ``tools.xl_run`` on pwtk (validation_twins.txt:33,
    11.5M nnz, no RCM): CLOSGX, B1, ``clos_r2`` and B15 launched, y held
    to the gold, the JSON line and the real-matrix CSV row."""
    import torch
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.convert import (build_csr, extract_features,
                                                 kmeans_reorder, rcm_reorder)
    from spmv_research_tpu_torch.convert.build_best import build_best
    from spmv_research_tpu_torch.convert.cache import CACHE_ENV
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.harness.bench import csv_labels
    from spmv_research_tpu_torch.ops import spmv
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.tools import (collect_results,
                                               locality_stats, machine_info,
                                               mat_feat, twin_fidelity,
                                               xl_run)

    t_phase = time.perf_counter()
    run_cache = os.environ[CACHE_ENV]

    # (a) the cache: build_best cold, then again with the same directory
    raw, _ = generate_from_line(bench.SCIRCUIT_LINE)
    host, _ = rcm_if_beneficial(raw)
    own = os.path.join(run_dir, "phase20_cache")
    os.environ[CACHE_ENV] = own
    try:
        fresh, loaded = build_best(host), build_best(host)
    finally:
        os.environ[CACHE_ENV] = run_cache
    if list(fresh) != list(loaded) or "CLOSG" not in fresh:
        fail(f"build_best on scircuit gave {list(fresh)}, then "
             f"{list(loaded)}")
    for key in fresh:
        (A, cold), (B, hit) = fresh[key], loaded[key]
        a, b = leaves_of(A), leaves_of(B)
        if (cold["from_cache"] or not hit["from_cache"]
                or hit["cold_build_s"] != cold["build_s"]
                or type(A) is not type(B) or len(a) != len(b)
                or not all(x.dtype == y.dtype and torch.equal(x, y)
                           for x, y in zip(a, b))):
            fail(f"scircuit {key}: the cached program differs from the "
                 f"fresh build ({cold}, {hit})")
        mb = sum(os.path.getsize(os.path.join(own, f)) for f in
                 os.listdir(own) if f"_{key.lower()}_" in f) / 1e6
        log(f"# phase 20 cache: scircuit {key} cold build "
            f"{cold['build_s']:.3f}s, load {hit['build_s']:.3f}s, {mb:.2f} "
            f"MB on disk, {len(a)} tensors equal")
    A, B = fresh["CLOSG"][0].to(dev), loaded["CLOSG"][0].to(dev)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y_fresh, (y_loaded, launches) = (spmv(A, xd, impl="cuda"),
                                     counted_spmv(B, xd, K))
    if not torch.equal(y_fresh, y_loaded) or launches["closg_front"] != 1:
        fail(f"the loaded scircuit CLOSG/cuda y differs from the fresh "
             f"program's (launches {launches})")
    check_gold("phase 20 loaded scircuit CLOSG/cuda", host, x, y_loaded)
    del A, B, fresh, loaded
    os.environ[CACHE_ENV] = os.path.join(run_dir, "phase20_bench_cache")
    try:
        runs = [bench.run(dev) for _ in range(2)]
    finally:
        os.environ[CACHE_ENV] = run_cache
    for i, r in enumerate(runs):
        d = r.json["detail"]
        c = r.results["CLOSG/cuda"]
        log(f"# phase 20 bench.run {i + 1}: best {d['best_format']}/"
            f"{d['best_impl']}, time_convert_s {d['time_convert_s']}, "
            f"time_convert_cold_s {d['time_convert_cold_s']}; CLOSG/cuda "
            f"convert {c.time_convert:.4f}s (cold {c.time_convert_cold:.4f}s)"
            f", {c.nnz_per_s / 1e9:.4f} Gnnz/s")
    first, second = (r.results["CLOSG/cuda"] for r in runs)
    if not (first.time_convert == first.time_convert_cold
            and second.time_convert_cold == first.time_convert
            and second.time_convert < second.time_convert_cold):
        fail("the second bench.run did not load CLOSG from the cache")
    d = runs[1].json["detail"]
    if d["best_format"] == "CLOSG" and (d["time_convert_s"]
                                        == d["time_convert_cold_s"]):
        fail(f"the second bench.run's JSON reports the load as the cold "
             f"build ({d['time_convert_s']} s)")
    check_gold("phase 20 second bench.run CLOSG/cuda", runs[1].host, x,
               second.y)
    del runs, first, second
    log(f"# phase 20 (a) done at {time.perf_counter() - t_phase:.0f}s")

    # (b) k-means row clustering on the twins as generated
    ship, _ = generate_from_line(SHIPSEC1_LINE)
    for label, h in (("shipsec1", ship), ("scircuit", raw)):
        t0 = time.perf_counter()
        hk, perm = kmeans_reorder(h, k=16)
        t_km = time.perf_counter() - t0
        f0, f1 = extract_features(h), extract_features(hk)
        log(f"# phase 20 k-means {label} (m={h.m} nnz={h.nnz}): "
            f"kmeans_reorder {t_km:.2f}s of host; bw_avg {f0.bw_avg:.2f} -> "
            f"{f1.bw_avg:.2f}, scatter_avg {f0.scatter_avg:.6f} -> "
            f"{f1.scatter_avg:.6f}, cross_row_similarity_avg "
            f"{f0.cross_row_similarity_avg:.4f} -> "
            f"{f1.cross_row_similarity_avg:.4f}")
        x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, h.n)
        xd = torch.as_tensor(x, dtype=torch.float32, device=dev)
        gold = h.spmv_gold_fast(x).astype(np.float64)
        times = []
        for order, hh in (("as generated", h), ("k-means", hk)):
            csr = build_csr(hh).to(dev)
            for impl in ("torch", "sparse"):
                y = spmv(csr, xd, impl=impl).double().cpu().numpy()
                if order == "k-means":        # new row i is old row perm[i]
                    y_old = np.empty_like(y)
                    y_old[perm] = y
                    y = y_old
                check_gold(f"phase 20 {label} CSR/{impl} ({order})", h, x,
                           y, gold)
                fn = (lambda c=csr, i=impl: spmv(c, xd, impl=i))
                times.append(f"CSR/{impl} {order} {timer.ms(fn):.4f} ms "
                             f"cold, {timer.warm_ms(fn):.4f} warm")
            del csr
        log(f"# phase 20 k-means {label} SpMV device times: "
            + "; ".join(times))
    log(f"# phase 20 (b) done at {time.perf_counter() - t_phase:.0f}s")

    # (c) the trace, in a child process (the cache holds phase 3's program)
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--trace-check"], capture_output=True, text=True,
                         timeout=600)
    for ln in out.stdout.rstrip().splitlines():
        log(f"#   {ln}")
    if out.returncode != 0:
        fail(f"the trace check exited {out.returncode}: "
             f"{out.stderr.strip()[-2000:]}")
    log(f"# phase 20 (c) done at {time.perf_counter() - t_phase:.0f}s")

    # (d) the tools
    info = machine_info.info()
    log(f"# phase 20 machine_info: {json.dumps(info)}")
    if info["name_power_limit"] != smi_line or info["backend"] != "cuda":
        fail(f"machine_info gives {info.get('name_power_limit')}, phase 1 "
             f"read {smi_line}")
    feat = captured(mat_feat.main, [bench.SCIRCUIT_LINE])
    if not (len([ln for ln in feat if not ln.startswith("#")])
            == len(mat_feat.FIELDS) + 1 and feat[-1].startswith("twin line:")):
        fail("mat_feat on the scircuit line printed another table")
    twins = os.path.join(os.path.dirname(os.path.abspath(__file__)), TWINS)
    fid = captured(twin_fidelity.main, ["--twins", twins, "--limit", "3"])
    if len(fid) != 1 + 3 * 6:
        fail(f"twin_fidelity --limit 3 printed {len(fid)} lines, not 19")
    loc = captured(locality_stats.report, rcm_reorder(ship)[0])
    if not (loc[0] == f"m={ship.m} nnz={ship.nnz}" and len(loc) == 9):
        fail(f"locality_stats on shipsec1 printed {loc}")
    res = os.path.join(run_dir, "phase20_results")
    wrote = captured(collect_results.main,
                     [*csv_dirs, "--results-dir", res, "--card", smi_line])
    summary = open(os.path.join(res, "SUMMARY.md")).read().splitlines()
    for ln in summary:
        log(f"#   {ln}")
    corpus = sorted(f for f in os.listdir(res) if f.startswith("corpus_"))
    if not {"corpus_spmv.csv", "corpus_spmm.csv",
            "corpus_sddmm.csv"} <= set(corpus):
        fail(f"collect_results wrote {corpus}")
    with open(os.path.join(res, "corpus_spmv.csv")) as f:
        names = {ln.split(",")[0] for ln in f.read().splitlines()[1:]}
    names = {n for n in names if not n.endswith(("_spd", "_dd"))}
    table = summary[4:4 + len(names)]
    if not (smi_line.split(",")[0] in summary[0] and "TPU" not in summary[0]
            and {ln.split(" | ")[0][2:] for ln in table} == names
            and all(ln.endswith("x |") and ln.count("x |") == 2
                    for ln in table)):
        fail(f"SUMMARY.md lacks the card or a speedup over CSR/torch and "
             f"CSR/sparse for one of {sorted(names)}")
    log(f"# phase 20 (d) done at {time.perf_counter() - t_phase:.0f}s "
        f"({wrote[-1]})")

    # (e) the XL entry point on pwtk, no RCM
    xl_dir = os.path.join(run_dir, "phase20_xl")
    line = open(twins).read().splitlines()[32]
    K.reset_launch_counts()
    host, A, r, js = xl_run.main(["--line", line, "--out", xl_dir])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(f"# phase 20 xl_run {line.split()[-1]}: {A.n_chunks} chunks of "
        f"{A.N} slots, W={A.W}, {A.mem_footprint_bytes() / 1e6:.1f} MB; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (A.format_name == "CLOSGX" and A.n_chunks > 1
            and all(launches[n] > 0 for n in ("closg_front", "clos_r2",
                                               "closgx_r3_scan_yext"))):
        fail(f"xl_run: {A.format_name} of {A.n_chunks} chunks, launches "
             f"{launches}")
    if set(js) != {"matrix", "m", "nnz", "format", "nnz_per_s", "gflops",
                   "median_us", "roofline_frac", "mape", "passed",
                   "build_s"} or js["roofline_frac"] is None:
        fail(f"xl_run's JSON line: {js}")
    log(f"# phase 20 xl_run gate (1e-7 of the reference) passed="
        f"{js['passed']}, max_rel_err {r.metrics.max_rel_err}")
    check_gold("phase 20 xl_run CLOSGX/cuda", host, np.random.Generator(
        np.random.PCG64(7)).uniform(0.0, 1.0, host.n), r.y)
    with open(os.path.join(xl_dir, "closgx_spmv.csv")) as f:
        rows = f.read().splitlines()
    if not (rows[0] == csv_labels(synthetic=False) and len(rows) == 2
            and rows[1].split(",")[14] == "CLOSGX_cuda"):
        fail(f"xl_run's CSV: {rows}")
    del host, A, r
    log(f"# phase 20 done in {time.perf_counter() - t_phase:.0f}s")


def counted_call(fn, *libs):
    """fn() between a reset and a read of the launch counters of ``libs``
    (and of the bytes staged through host memory): (out, the non-zero
    launch counts, staged bytes)."""
    import torch
    from spmv_research_tpu_torch.parallel import comm
    for lib in libs:
        lib.reset_launch_counts()
    comm.reset_staged()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for lib in libs for k, v in lib.LAUNCHES.items()
                 if v}, comm.STAGED["bytes"]


def dist_times(timer, label, fn_dist, fn_single) -> dict:
    """The distributed SpMV's device ms beside the single-device SpMV of
    the same program (each the median of 5 means of 6 calls alone: one
    stalled call must not move it), and the host µs a call of each,
    logged."""
    def ms(fn):
        return float(np.median([timer.ms(fn, iters=6) for _ in range(5)]))

    t = {"ms": ms(fn_dist), "single_ms": ms(fn_single),
         "host_us": host_us(fn_dist, n=100),
         "single_host_us": host_us(fn_single, n=100)}
    log(f"# phase 21 {label}: dist SpMV {t['ms']:.4f} ms, the single-device "
        f"SpMV of the same program {t['single_ms']:.4f} ms; host "
        f"{t['host_us']:.1f} us a call (single {t['single_host_us']:.1f})")
    return t


def dist_phase(timer, dev, run_dir) -> dict:
    """Phase 21: the distributed layer on the card (see the module's
    docstring). Returns {kernel name: {path: launches a SpMV}}."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from spmv_research_tpu_torch import parallel as tp
    from spmv_research_tpu_torch.convert.cache import cached_build
    from spmv_research_tpu_torch.convert.coo_csr import make_spd
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops import (build_clos_gather_auto,
                                             build_clos_gather_xl, spmv)
    from spmv_research_tpu_torch.ops.clos_route import LANES
    from spmv_research_tpu_torch.ops.sellr import build_sellr
    from spmv_research_tpu_torch.parallel import comm
    from spmv_research_tpu_torch.parallel import dist_closgx as tdx
    from spmv_research_tpu_torch.parallel import dist_sellr as tds
    from spmv_research_tpu_torch.parallel.dist_closg import (
        build_sharded_best, distributed_spmv_closg)

    t_phase = time.perf_counter()
    tp.init_multihost()                       # one rank, NCCL
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        fail(f"init_multihost() gave {dist.get_world_size()} ranks on "
             f"{dist.get_backend()}, not one on nccl")
    mesh = tp.make_sparse_mesh(1)
    launches_of = {}
    rng_x = lambda n: np.random.Generator(np.random.PCG64(7)).uniform(  # noqa
        0.0, 1.0, n)
    try:
        # (a) SELLR on shipsec1 after RCM, k = 1
        ship, _ = generate_from_line(SHIPSEC1_LINE)
        ship, _ = rcm_if_beneficial(ship)
        x = rng_x(ship.n)
        gold = ship.spmv_gold_fast(x).astype(np.float64)
        n_pad = -(-ship.n // LANES) * LANES
        part = dataclasses.replace(tds._rows_slice(ship, 0, ship.m), n=n_pad)
        t0 = time.perf_counter()
        As = cached_build(build_sellr, part, "sellr", dtype=np.float32,
                          max_slot_factor=6.0).to(dev)
        log(f"# phase 21 (a) shipsec1 m={ship.m} nnz={ship.nnz}: the "
            f"shard's SELLR {time.perf_counter() - t0:.2f}s (nchunks "
            f"{As.nchunks}, {As.mem_footprint_bytes() / 1e6:.2f} MB)")
        xs = torch.zeros(n_pad, dtype=torch.float32)
        xs[: ship.n] = torch.as_tensor(x, dtype=torch.float32)
        xs = xs.to(dev)
        y_single = spmv(As, xs)[: ship.m].cpu().numpy()
        D_ag = None
        for strategy in ("allgather", "ring", "psum_scatter"):
            t0 = time.perf_counter()
            D = tp.build_dist_sellr(ship, mesh, strategy=strategy)
            t_build = time.perf_counter() - t0
            xp = tds._pad_x(D, x)
            _, launches, _ = counted_call(lambda: tds.dist_spmv_sellr(D, xp),
                                          K, KS)
            if launches != {"sellr_place": 1, "sellr_flush": 1}:
                fail(f"a k = 1 {strategy} SELLR SpMV launched {launches}, "
                     "not B14's place and flush once each")
            for name, n in launches.items():
                launches_of.setdefault(name, {})[f"sellr_{strategy}"] = n
            y = tp.dist_spmv_sellr_host(D, x)
            check_gold(f"phase 21 (a) SELLR {strategy}", ship, x, y, gold)
            if not np.array_equal(y.astype(np.float32), y_single):
                fail(f"phase 21 (a) {strategy}: y differs from the "
                     "single-device SELLR/cuda SpMV of the same program")
            b = 0 if strategy == "ring" else None
            sel = (lambda t: t[b]) if b is not None else (lambda t: t)
            xk = comm.all_gather(xp, D.group) if (
                strategy == "allgather") else xp
            p_args = (sel(D.word), sel(D.vals), sel(D.smeta), xk,
                      sel(D.nchunks) if b is not None else D.nchunks,
                      D.meta["stages"], D.meta["rolls"])
            R = KS.sellr_place(*p_args)
            f_args = (R, sel(D.gptr), sel(D.gchunk))
            if not (torch.equal(R, KS.sellr_place_torch(*p_args))
                    and torch.equal(KS.sellr_flush(*f_args),
                                    KS.sellr_flush_torch(*f_args))):
                fail(f"phase 21 (a) {strategy}: B14 on the padded program "
                     "differs from its plain versions")
            log(f"# phase 21 (a) {strategy}: plan {t_build:.2f}s, "
                f"{D.word.shape[-2] // 8} chunks padded ({D.nchunks} live), "
                f"stages {D.meta['stages']}, {len(D.meta['rolls'])} rolls; "
                f"launches a SpMV {launches}; B14 exact to its plain "
                f"versions on the padded program")
            dist_times(timer, f"(a) SELLR {strategy}",
                       lambda: tds.dist_spmv_sellr(D, xp),
                       lambda: spmv(As, xs))
            if strategy == "allgather":
                D_ag = D
        del As
        xg = tds._pad_x(D_ag, x)
        buf = torch.empty_like(xg)
        raw = lambda: dist.all_gather_into_tensor(  # noqa: E731
            buf, xg, group=D_ag.group)
        log(f"# phase 21 (a) one NCCL all_gather_into_tensor of x "
            f"({xg.numel() * 4} B, one rank) alone: {timer.ms(raw):.4f} ms, "
            f"host {host_us(raw, n=100):.1f} us a call; comm.all_gather "
            f"{host_us(lambda: comm.all_gather(xg, D_ag.group), n=100):.1f}"
            f" us, dist.get_backend "
            f"{host_us(lambda: dist.get_backend(D_ag.group), n=100):.1f} "
            f"us, the SELLR body alone "
            f"{host_us(lambda: tds._kern(D_ag)(xg), n=100):.1f} us")
        log(f"# phase 21 (a) done at {time.perf_counter() - t_phase:.0f}s")

        # (b) CLOSGX on pwtk, no RCM, k = 1
        twins = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             TWINS)
        pw, _ = generate_from_line(open(twins).read().splitlines()[32])
        xw = rng_x(pw.n)
        gold_w = pw.spmv_gold_fast(xw).astype(np.float64)
        t0 = time.perf_counter()
        Ax = cached_build(build_clos_gather_xl, tdx._rows_slice(pw, 0, pw.m),
                          "closgx", chunk_N=1 << 20, max_chunks=256).to(dev)
        log(f"# phase 21 (b) pwtk m={pw.m} nnz={pw.nnz}: the shard's "
            f"CLOSGX {time.perf_counter() - t0:.2f}s ({Ax.n_chunks} chunks, "
            f"W={Ax.W}, {Ax.mem_footprint_bytes() / 1e6:.1f} MB)")
        xwd = torch.as_tensor(xw, dtype=torch.float32, device=dev)
        yw_single = spmv(Ax, xwd).cpu().numpy()
        for ov in (False, True):
            t0 = time.perf_counter()
            D = tp.build_dist_closgx(pw, mesh, axis="rows", overlap=ov)
            t_build = time.perf_counter() - t0
            xl = tdx.shard_x(D, xw)
            _, launches, _ = counted_call(
                lambda: tdx.dist_spmv_closgx(D, xl), K, KS)
            if not all(launches.get(n, 0) > 0 for n in (
                    "closg_front", "clos_r2", "closgx_r3_scan_yext")):
                fail(f"a k = 1 CLOSGX SpMV (overlap={ov}) launched "
                     f"{launches}")
            label = "closgx_overlap" if ov else "closgx"
            for name, n in launches.items():
                launches_of.setdefault(name, {})[label] = n
            y = tp.dist_spmv_closgx_host(D, xw)
            check_gold(f"phase 21 (b) CLOSGX overlap={ov}", pw, xw, y,
                       gold_w)
            if not ov and not np.array_equal(y.astype(np.float32),
                                             yw_single):
                fail("phase 21 (b): y differs from the single-device "
                     "CLOSGX/cuda SpMV of the same program")
            log(f"# phase 21 (b) overlap={ov}: plan {t_build:.2f}s, "
                f"{D.prog.n_chunks} chunks"
                + (f" + {D.prog_loc.n_chunks} local" if ov else "")
                + f"; launches a SpMV {launches}")
            dist_times(timer, f"(b) CLOSGX overlap={ov}",
                       lambda: tdx.dist_spmv_closgx(D, xl),
                       lambda: spmv(Ax, xwd))
        del Ax, D
        log(f"# phase 21 (b) done at {time.perf_counter() - t_phase:.0f}s")

        # (c) two ranks on the one card over gloo
        t0 = time.perf_counter()
        tds.plan_dist_sellr(ship, 2, "ring")            # warm the cache
        tdx.plan_dist_closgx(pw, 2, overlap=True)
        np.savez(os.path.join(run_dir, "dist_mats.npz"),
                 **{f"{p}_{f}": getattr(h, f) for p, h in (("ship", ship),
                                                          ("pw", pw))
                    for f in ("ia", "ja", "a")},
                 ship_mn=[ship.m, ship.n], pw_mn=[pw.m, pw.n], gold=gold,
                 gold_w=gold_w)
        log(f"# phase 21 (c) k = 2 programs built in "
            f"{time.perf_counter() - t0:.1f}s")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--dist-rank", str(r), run_dir])
                 for r in (0, 1)]
        try:
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            fail(f"phase 21 (c): the two gloo ranks exited {rcs}")
        with open(os.path.join(run_dir, "dist_k2.json")) as f:
            res = json.load(f)
        for key, r in res["paths"].items():
            log(f"# phase 21 (c) k = 2 on one card, backend "
                f"{res['backend']}: {key} y vs gold max rel {r['rel']}, "
                f"{r['staged_bytes']} B staged through host memory a SpMV "
                f"(rank 0), launches a SpMV on rank 0 {r['launches']}, "
                f"{r['wall_ms']:.3f} ms wall a SpMV (host-staged; no "
                "scaling claim)")
        log(f"# phase 21 (c) done at {time.perf_counter() - t_phase:.0f}s")

        # (d) per-shard engines on gupta3, two shards on the one card
        gup, _ = generate_from_line(GUPTA3_LINE)
        gup, _ = rcm_if_beneficial(gup)
        t0 = time.perf_counter()
        A = build_sharded_best(gup, devices=[dev, dev])
        engines = [f"{type(s).__name__}" + (
            f"({len(s.chunks)} chunks, W={[c.W for c in s.chunks]})"
            if hasattr(s, "chunks") else "") for s in A.shards]
        log(f"# phase 21 (d) gupta3 m={gup.m} nnz={gup.nnz}: shards "
            f"{engines} on {[str(d) for d in A.devices]}, row splits "
            f"{A.row_splits.tolist()} ({time.perf_counter() - t0:.1f}s)")
        xg = rng_x(gup.n)
        xgd = torch.as_tensor(xg, dtype=torch.float32, device=dev)
        y, launches, _ = counted_call(lambda: distributed_spmv_closg(A, xgd),
                                      K, KS)
        for name, n in launches.items():
            launches_of.setdefault(name, {})["sharded_best"] = n
        check_gold("phase 21 (d) sharded best", gup, xg, y)
        Ag = cached_build(build_clos_gather_auto, gup, "closg").to(dev)
        log(f"# phase 21 (d) launches a SpMV {launches}")
        dist_times(timer, "(d) gupta3 sharded best",
                   lambda: distributed_spmv_closg(A, xgd),
                   lambda: spmv(Ag, xgd))
        del A, Ag, gup

        # (e) CG steps
        spd = make_spd(ship)
        _, rr = tp.distributed_cg_step(spd, mesh)()
        step, xp = tds.dist_cg_step_sellr(D_ag, x)
        ys = step(xp)
        torch.cuda.synchronize()
        if not (np.isfinite(float(rr)) and bool(torch.isfinite(ys).all())):
            fail(f"phase 21 (e): r·r {float(rr)}, the SELLR step finite "
                 f"{bool(torch.isfinite(ys).all())}")
        log(f"# phase 21 (e) distributed_cg_step on shipsec1_spd (nnz "
            f"{spd.nnz}): r·r = {float(rr)}; dist_cg_step_sellr on (a)'s "
            f"allgather program: finite, |y| {float(ys.norm())}")
        del spd, D_ag
    finally:
        dist.destroy_process_group()

    # (f) the weak-scaling tool, two ranks on the one card over gloo
    wdir = os.path.join(run_dir, "weak_scaling")
    out = subprocess.run(
        [sys.executable, "-m", "spmv_research_tpu_torch.tools.weak_scaling",
         "--device", "cuda", "--ranks", "2", "--backend", "gloo",
         "--out-dir", wdir], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    for ln in out.stdout.splitlines():
        log(f"# phase 21 (f) {ln}")
    if out.returncode:
        fail(f"tools.weak_scaling exited {out.returncode}: {out.stderr}")
    with open(os.path.join(wdir, "weak_scaling_cuda2.csv")) as f:
        rows = f.read().splitlines()
    if not (rows[0] == ("strategy,devices,rows_per_device,nnz,time_iter_s,"
                        "efficiency,efficiency_overhead") and len(rows) == 5
            and "host-staged" in out.stdout):
        fail(f"tools.weak_scaling's CSV: {rows}")
    for ln in rows:
        log(f"#   {ln}")
    log(f"# phase 21 done in {time.perf_counter() - t_phase:.0f}s")
    return launches_of


def dist_child(rank: int, run_dir: str) -> None:
    """Phase 21 (c), one of two ranks on the one card over gloo
    (``chip_smoke.py --dist-rank R RUN_DIR``): the shipsec1 ring and the
    pwtk CLOSGX with overlap, from the programs the parent cached; rank 0
    writes ``dist_k2.json``. Exits non-zero on a failed check."""
    import torch
    import torch.distributed as dist
    from spmv_research_tpu_torch import parallel as tp
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.parallel import dist_closgx as tdx
    from spmv_research_tpu_torch.parallel import dist_sellr as tds

    tp.init_multihost(f"file://{os.path.join(run_dir, 'dist_store')}", 2,
                      rank, backend="gloo")
    try:
        mesh = tp.make_sparse_mesh(2)
        z = np.load(os.path.join(run_dir, "dist_mats.npz"))
        hosts = {p: HostCSR(ia=z[f"{p}_ia"], ja=z[f"{p}_ja"], a=z[f"{p}_a"],
                            m=int(z[f"{p}_mn"][0]), n=int(z[f"{p}_mn"][1]))
                 for p in ("ship", "pw")}
        res = {"backend": dist.get_backend(), "paths": {}}
        for key, p, gold_key, build, run, pad in (
                ("sellr_ring", "ship", "gold",
                 lambda h: tp.build_dist_sellr(h, mesh, strategy="ring"),
                 tds.dist_spmv_sellr, tds._pad_x),
                ("closgx_overlap", "pw", "gold_w",
                 lambda h: tp.build_dist_closgx(h, mesh, axis="rows",
                                                overlap=True),
                 tdx.dist_spmv_closgx, tdx.shard_x)):
            h = hosts[p]
            D = build(h)
            x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0,
                                                                 h.n)
            xl = pad(D, x)
            _, launches, staged = counted_call(lambda: run(D, xl), K, KS)
            y = (tp.dist_spmv_sellr_host if p == "ship"
                 else tp.dist_spmv_closgx_host)(D, x)
            scale = np.abs(h.to_scipy()) @ np.abs(x) + 1e-30
            rel = float(np.max(np.abs(y - z[gold_key]) / scale))
            t0 = time.perf_counter()
            for _ in range(20):
                run(D, xl)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20 * 1e3
            if not (rel <= 1e-5 and launches):
                print(f"chip_smoke: FAIL: rank {rank} {key}: rel {rel}, "
                      f"launches {launches}", file=sys.stderr, flush=True)
                sys.exit(1)
            res["paths"][key] = {"rel": rel, "launches": launches,
                                 "staged_bytes": staged, "wall_ms": wall}
        if rank == 0:
            with open(os.path.join(run_dir, "dist_k2.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def program_kinds() -> None:
    """Phase 13, run as ``chip_smoke.py --program-kinds`` in a child
    process beside phase 14 (host work only, no card): the program kind
    ``build_clos_gather_auto`` gives each twin of ``KINDS`` (RCM where the
    matrix is square), one line each; exit 1 on the first other kind."""
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.ops import (ClosGChunked, ClosGX, RowSplit,
                                             build_clos_gather_auto)
    from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError
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
            print(f"chip_smoke: FAIL: {TWINS}:{no}: program {got}, want "
                  f"{want}", flush=True)
            sys.exit(1)


def trace_check() -> None:
    """Phase 20 (c), run as ``chip_smoke.py --trace-check`` in a process of
    its own: the scircuit CLOSG program (from the run's format cache), one
    CLOSG/cuda SpMV inside ``trace_region("COMPUTATION-SpMV")`` under
    ``utils.trace.profile``; the region is among the profiler's events,
    B1, ``clos_r2``, the phased scan and the extraction ran inside its
    window, and a Chrome trace was written."""
    import torch
    from torch.autograd import DeviceType
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.convert.build_best import build_best
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.ops import spmv
    from spmv_research_tpu_torch.utils import trace
    host, _ = rcm_if_beneficial(generate_from_line(bench.SCIRCUIT_LINE)[0])
    A, info = build_best(host)["CLOSG"]
    A = A.to("cuda")
    xd = torch.ones(A.n, device="cuda")
    spmv(A, xd, impl="cuda")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tdir:
        with trace.profile(tdir) as prof:
            with trace.trace_region("COMPUTATION-SpMV"):
                spmv(A, xd, impl="cuda")
                torch.cuda.synchronize()
        files = os.listdir(tdir)
        size = sum(os.path.getsize(os.path.join(tdir, f)) for f in files)
    events = prof.events()
    region = [e for e in events if e.name == "COMPUTATION-SpMV"
              and e.device_type == DeviceType.CPU]
    if len(region) != 1:
        fail(f"the trace holds {len(region)} COMPUTATION-SpMV regions")
    t0, t1 = region[0].time_range.start, region[0].time_range.end
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and "kernel" in e.name]
    inside = [e.name for e in kernels
              if t0 <= e.time_range.start and e.time_range.end <= t1]
    want = ("front_kernel<0>", "layer_kernel<true>", "scan_contig_kernel",
            "yext_kernel")
    print(f"program ({'from the cache' if info['from_cache'] else 'built'}); "
          f"region {t1 - t0:.1f} us; {len(kernels)} device kernels, "
          f"{len(inside)} inside the region: "
          + "; ".join(n[:60] for n in inside)
          + f"; Chrome trace {files} ({size} B)", flush=True)
    if not (len(files) == 1 and files[0].endswith(".json") and size > 0):
        fail(f"no Chrome trace written: {files}")
    if not all(any(w in n for n in inside) for w in want):
        fail(f"the region's window lacks one of {want}: {inside}")


def stream_tridiagonal(rng):
    """Phase 7's seeded tridiagonal matrix, n = ``STREAM_N``."""
    import scipy.sparse as sp
    return sp.diags([rng.uniform(-1, 1, STREAM_N - 1),
                     rng.uniform(-1, 1, STREAM_N),
                     rng.uniform(-1, 1, STREAM_N - 1)], [-1, 0, 1],
                    shape=(STREAM_N, STREAM_N), format="csr")


def b9_calls(A):
    """The five B9 calls of one BFLY SpMV: (wrapper, stages)."""
    return (("bfly_xor_net", A.widen_stages), ("bfly_fill", A.fill_stages),
            ("bfly_xor_net", A.perm_stages), ("bfly_scan", A.scan_stages),
            ("bfly_xor_net", A.compact_stages))


def b9_launches(KF, A) -> dict:
    """B9's launches per BFLY SpMV of program A: one a phase of each
    call's plan (a call without stages launches nothing)."""
    want = {"bfly_xor_net": 0, "bfly_fill": 0, "bfly_scan": 0}
    for key, st in b9_calls(A):
        if st:
            want[key] += len(KF.b9_phase_table(key, st, A.L))
    return want


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
