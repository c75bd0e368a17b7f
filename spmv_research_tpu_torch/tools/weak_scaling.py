"""Weak-scaling artifact: the row-sharded CSR SpMV over ``--ranks``
processes, the problem growing with the ranks (each rank's rows fixed).

Counterpart of the JAX repository's ``tools/weak_scaling.py`` (its
``cpu8`` run: 8 virtual devices on one socket). Spawns the ranks (one
process each, ``torch.distributed`` on a ``file://`` store, ``gloo`` by
default on the CPU, ``nccl`` on cards unless ``--backend gloo``), runs
``weak_scaling_efficiency`` for both halo strategies and writes
``<out-dir>/weak_scaling_<device><ranks>.csv``:
``strategy,devices,rows_per_device,nnz,time_iter_s,efficiency,
efficiency_overhead``::

    python -m spmv_research_tpu_torch.tools.weak_scaling --device cpu \\
        [--ranks 8] [--rows 100000] [--out-dir results_torch]
    python -m spmv_research_tpu_torch.tools.weak_scaling --device cuda \\
        --ranks 2 --backend gloo     # two ranks on one card

Several ranks on one card, or on one socket, share it: read
``efficiency_overhead`` there, not ``efficiency``; with gloo on cards x
goes through host memory (the run is labelled host-staged).
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

LABELS = ("strategy,devices,rows_per_device,nnz,time_iter_s,efficiency,"
          "efficiency_overhead")


def run_rank(args) -> None:
    import torch
    import torch.distributed as dist

    from ..parallel import comm, init_multihost, weak_scaling_efficiency

    torch.set_num_threads(1 if args.device == "cpu" else 2)
    init_multihost(args.coordinator, args.ranks, args.rank,
                   backend=args.backend)
    try:
        comm.reset_staged()
        rows = []
        for strategy in ("allgather", "ring"):
            res = weak_scaling_efficiency(rows_per_device=args.rows,
                                          strategy=strategy,
                                          device=args.device)
            for k, r in res.items():
                rows.append(f"{strategy},{k},{args.rows},{r['nnz']},"
                            f"{r['time']:.6f},{r['efficiency']:.4f},"
                            f"{r['efficiency_overhead']:.4f}")
                if args.rank == 0:
                    print(f"{strategy:12s} k={k}: t={r['time']*1e3:.3f} ms "
                          f"eff={r['efficiency']:.3f} "
                          f"eff_ovh={r['efficiency_overhead']:.3f}",
                          flush=True)
        if args.rank == 0:
            os.makedirs(args.out_dir, exist_ok=True)
            path = os.path.join(args.out_dir, f"weak_scaling_{args.device}"
                                f"{args.ranks}.csv")
            with open(path, "w") as f:
                f.write(LABELS + "\n" + "\n".join(rows) + "\n")
            staged = (f", host-staged ({args.backend} on cuda: "
                      f"{comm.STAGED['bytes']} B through host memory on "
                      "rank 0)" if args.device == "cuda"
                      and args.backend == "gloo" else "")
            print(f"wrote {path}{staged}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--rows", type=int, default=100_000,
                    help="rows per rank")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: gloo on the CPU, nccl on "
                         "cards)")
    ap.add_argument("--out-dir", default="results_torch")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()
    args.backend = args.backend or ("gloo" if args.device == "cpu"
                                    else "nccl")
    if args.rank is not None:
        run_rank(args)
        return 0
    tmp = tempfile.mkdtemp(prefix="weak_scaling_")
    coord = f"file://{os.path.join(tmp, 'store')}"
    argv = [sys.executable, "-m", __spec__.name, "--device", args.device,
            "--ranks", str(args.ranks), "--rows", str(args.rows),
            "--backend", args.backend, "--out-dir", args.out_dir,
            "--coordinator", coord]
    procs = [subprocess.Popen(argv + ["--rank", str(r)])
             for r in range(args.ranks)]
    try:
        rcs = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return max(rcs, key=abs)


if __name__ == "__main__":
    sys.exit(main())
