"""XL-tier run: build CLOSGX for a large synthetic matrix and bench its
SpMV on the card, emitting a JSON line and a CSV row (reference bar: the
kmer_V2a / cage15 tier, ``run.sh:137-191``).

Counterpart of the JAX repository's ``tools/xl_run.py``: the same flags,
default line (160M nnz, a scattered band), JSON fields and real-matrix CSV
row (``closgx_spmv.csv``), on the port's ``build_clos_gather_xl`` and
``bench_spmv`` with the ``cuda`` impl (B1, ``clos_r2`` and B15);
``roofline_frac`` is over the card's data-sheet rate
(``utils/roofline.py``)::

    python -m spmv_research_tpu_torch.tools.xl_run [--name pwtk] \\
        [--line "11 args"] [--out out_logs_xl] [--chunk-n 1048576]

``run(..., device="cpu")`` runs the plain PyTorch pipeline (impl
``torch``; no roofline there, ``roofline_frac`` null).
"""

import argparse
import json
import os
import time

DEFAULT_LINE = ("16000000 16000000 10.0 3.0 normal random 0.02 2.0 "
                "0.8 0.5 14 xl160m")
TWINS = "datasets/validation_twins.txt"


def twin_line(name: str, twins: str = TWINS) -> str:
    """The line of ``twins`` that ends with `` name``."""
    with open(twins) as f:
        for ln in f:
            if ln.strip().endswith(" " + name):
                return ln.strip()
    raise SystemExit(f"twin {name} not found")


def run(line: str, out: str, chunk_n: int = 1 << 20, device="cuda"):
    """Generate ``line``'s twin, build its CLOSGX program, bench its SpMV on
    ``device`` (impl ``cuda`` on a card, ``torch`` on the CPU), print the
    JSON line and append the CSV row; returns ``(host, the program on
    the device, the BenchResult, the JSON line's dict)``."""
    import torch

    from ..gen import generate_from_line
    from ..harness import BenchConfig, bench_spmv, csv_labels, csv_row_real
    from ..ops.clos_xl import build_clos_gather_xl
    from ..utils import roofline as rl

    device = torch.device(device)
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    host, _ = generate_from_line(line)
    name = line.split()[-1]
    print(f"# generated {name}: m={host.m} nnz={host.nnz} "
          f"({time.time()-t0:.1f}s)", flush=True)

    t0 = time.time()
    A = build_clos_gather_xl(host, chunk_N=chunk_n)
    t_build = time.time() - t0
    print(f"# CLOSGX build: {A.n_chunks} chunks x N={chunk_n} "
          f"({A.n_chunks*chunk_n/host.nnz:.2f} slots/nnz, "
          f"{A.mem_footprint_bytes() / 1e6:.1f} MB, {t_build:.1f}s)",
          flush=True)
    A = A.to(device)

    cfg = BenchConfig(min_num_loops=16, min_time_s=0.5)
    impl = "cuda" if device.type == "cuda" else "torch"
    r = bench_spmv(host, A, config=cfg, impl=impl, matrix_name=name,
                   time_convert=t_build, time_convert_cold=t_build)
    sol = rl.csr_roofline_nnz_per_s(host.nnz, host.m, host.n, 4,
                                    rl.device_spec(device))
    line_json = {
        "matrix": name, "m": host.m, "nnz": host.nnz,
        "format": "CLOSGX", "nnz_per_s": round(r.nnz_per_s / 1e9, 3),
        "gflops": round(r.gflops, 2),
        "median_us": round(r.time_iter_median * 1e6, 1),
        "roofline_frac": round(r.nnz_per_s / sol, 4) if sol else None,
        "mape": r.metrics.mape, "passed": r.metrics.passed,
        "build_s": round(t_build, 1),
    }
    print(json.dumps(line_json), flush=True)
    csv_path = os.path.join(out, "closgx_spmv.csv")
    new = not os.path.exists(csv_path)
    with open(csv_path, "a") as f:
        if new:
            f.write(csv_labels(synthetic=False) + "\n")
        f.write(csv_row_real(r) + "\n")
    print(f"# wrote {csv_path}", flush=True)
    return host, A, r, line_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", help="twin name from validation_twins.txt")
    ap.add_argument("--line", default=DEFAULT_LINE)
    ap.add_argument("--out", default="out_logs_xl")
    ap.add_argument("--chunk-n", type=int, default=1 << 20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the GPU")
    line = twin_line(args.name) if args.name else args.line
    return run(line, args.out, args.chunk_n)


if __name__ == "__main__":
    main()
