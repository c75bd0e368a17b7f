"""The port's sweep command line — the counterpart of ``tools/sweep.py``.

    python -m spmv_research_tpu_torch.sweep --matrix "<11-arg line>" \
        [--matrices FILE] --formats csr sellr sellw closg dense --out DIR \
        [--device cuda]

Matrix list files hold one synthetic parameter line per line (``#`` starts
a comment), e.g. ``datasets/validation_twins.txt``. The config comes from
the reference's env vars (``BenchConfig.from_env``: ``USE_RCM_REORDERING``
= 0, 1 or auto, ``FIX_DIAGONAL_ZEROS``, ``MIN_NUM_LOOPS``, ``MIN_TIME_S``).
Formats and workloads the port does not have raise before any work starts.
"""

from __future__ import annotations

import argparse

import torch

from .harness import BenchConfig
from .harness.sweep import check_sweep_args, run_sweep


def _read_specs(path):
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrices", help="file with one matrix spec per line")
    ap.add_argument("--matrix", action="append", default=[],
                    help="inline matrix spec (repeatable)")
    ap.add_argument("--formats", nargs="+", default=["csr", "closg"])
    ap.add_argument("--workloads", nargs="+", default=["spmv"])
    ap.add_argument("--out", default="out_logs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    try:
        check_sweep_args(args.formats, args.workloads)
    except NotImplementedError as e:
        ap.error(str(e))
    specs = list(args.matrix)
    if args.matrices:
        specs += _read_specs(args.matrices)
    if not specs:
        ap.error("no matrices given")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the GPU, or pass "
                         "--device cpu for the plain PyTorch path")
    run_sweep(specs, formats=args.formats, workloads=args.workloads,
              out_dir=args.out, config=BenchConfig.from_env(), device=device)


if __name__ == "__main__":
    main()
