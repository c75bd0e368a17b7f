"""Real-matrix input end to end: twins written as Matrix Market files, swept
from disk, each row held to the in-memory row of the same twin.

    python -m spmv_research_tpu_torch.mtx_sweep [--matrices FILE] \
        [--twins N] [--out DIR] [--device cuda]

The counterpart of ``tools/mtx_sweep.py``. The reference crosses Matrix
Market I/O on every run (``bench.cpp:560`` → ``matrix_market.c:258``);
this drives the same layer: generator → ``mtx_write`` → ``mtx_read``
(the native parser where the library is built) → ``coo_to_csr`` → format
build → bench → CSV, for the formats ``csr``, ``csr_lut``, ``bsrg`` and
``sellg``, SpMV and SpMM, their ``torch`` impls. The first ``--twins``
parameter lines of ``--matrices`` (default
``datasets/validation_twins.txt``) are written to
``<out>/mtx/<name>.mtx`` (``%.17g``: the values come back exactly, which
is checked), swept once from their parameter lines into ``<out>/memory``
and once from the files into ``<out>/disk``, and every disk row must
equal its in-memory row in m, n, nnz (an SpMM or SDDMM row: its output's
shape) and the 8 error metrics; the disk rows carry the real-matrix CSV
labels. Both sweeps run with torch's deterministic algorithms
(``index_add_`` on a card adds with atomics otherwise, so two runs may
round differently), which their times include. Pairs that differ are
printed, and the command exits non-zero if any does or no row ran (a
stale ``done.log`` in ``<out>`` skips them). The config comes from the
environment, as the sweep command's does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .convert import coo_to_csr
from .core.host import HostCOO, HostCSR
from .gen import generate_from_line
from .harness import BenchConfig
from .harness.bench import BenchResult
from .harness.sweep import run_sweep
from .io import mtx_read, mtx_write

TWINS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "datasets", "validation_twins.txt")


def write_mtx(host: HostCSR, path: str) -> None:
    """``host`` as a general real coordinate file."""
    rows = np.repeat(np.arange(host.m, dtype=np.int32), host.row_lengths())
    mtx_write(path, HostCOO(rows=rows, cols=host.ja.copy(),
                            vals=host.a.copy(), m=host.m, n=host.n))


def write_twin(line: str, mtx_dir: str) -> str:
    """Generate the twin of ``line``, write it to ``<mtx_dir>/<name>.mtx``
    and check that reading it back gives the same CSR; returns the path."""
    name = line.split()[-1]
    path = os.path.join(mtx_dir, f"{name}.mtx")
    t0 = time.time()
    host, _ = generate_from_line(line)
    write_mtx(host, path)
    back = coo_to_csr(mtx_read(path, expand_symmetry=True))
    for f in ("ia", "ja", "a"):
        if not np.array_equal(getattr(back, f), getattr(host, f)):
            raise ValueError(f"{path}: {f} read back differs from the twin")
    print(f"# {name}: wrote and read back {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, {time.time() - t0:.1f}s)",
          flush=True)
    return path


def row_fields(r) -> tuple:
    """What a disk row must share with its in-memory row: the row's key,
    its dims (SpMV: m, n, nnz; SpMM/SDDMM: the output's shape) and the 8
    error metrics."""
    if isinstance(r, BenchResult):
        key, dims = (r.format_name, r.impl, "spmv"), (r.m, r.n, r.nnz)
    else:
        key, dims = (r.format_name, r.impl, r.workload), r.out.shape
    return (r.matrix_name, *key, *dims, *r.metrics.as_csv_fields())


@contextlib.contextmanager
def deterministic():
    """Torch's deterministic algorithms on (warnings only where an op has
    none), the previous setting restored after."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def round_trip(lines, out_dir, formats=("csr", "csr_lut", "bsrg", "sellg"),
               workloads=("spmv", "spmm"), config=None, device="cuda"):
    """Write the twins of ``lines``, sweep them (the ``torch`` impls) from
    memory and from disk; returns (in-memory results, disk results, the
    pairs that differ)."""
    mtx_dir = os.path.join(out_dir, "mtx")
    os.makedirs(mtx_dir, exist_ok=True)
    paths = [write_twin(ln, mtx_dir) for ln in lines]
    kw = dict(formats=formats, workloads=workloads, impls=("torch",),
              config=config or BenchConfig.from_env(), device=device)
    with deterministic():
        mem = run_sweep(lines, out_dir=os.path.join(out_dir, "memory"), **kw)
        disk = run_sweep(paths, out_dir=os.path.join(out_dir, "disk"), **kw)
    want = sorted(row_fields(r) for r in mem)
    got = sorted(row_fields(r) for r in disk)
    bad = [(w, g) for w, g in zip(want, got) if w != g]
    if len(want) != len(got):
        bad.append((len(want), len(got)))
    return mem, disk, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrices", default=TWINS,
                    help="file of twin parameter lines (# starts a comment)")
    ap.add_argument("--twins", type=int, default=5,
                    help="the first N lines of that file")
    ap.add_argument("--out", default="out_logs_mtx")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(args.matrices) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")][: args.twins]
    _, disk, bad = round_trip(lines, args.out, device=args.device)
    for want, got in bad:
        print(f"# MISMATCH in-memory {want} disk {got}", flush=True)
    print(f"# {len(disk)} disk rows, {len(bad)} differ from the in-memory "
          "rows", flush=True)
    return 1 if bad or not disk else 0


if __name__ == "__main__":
    sys.exit(main())
