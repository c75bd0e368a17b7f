"""The port's sweep command line — the counterpart of ``tools/sweep.py``.

    python -m spmv_research_tpu_torch.sweep --matrix "<11-arg line>" \
        [--matrices FILE] --formats csr sellr sellw closg dense btile \
        csrds sellwds [--workloads spmv spmm sddmm cg bicgstab] --out DIR \
        [--device cuda]
    python -m spmv_research_tpu_torch.sweep --matrix "<11-arg line>" \
        --job "formats=csr,sellw,sellwds;workloads=cg;transform=spd" \
        [--job ...]

Matrix list files hold one synthetic parameter line per line (``#`` starts
a comment), e.g. ``datasets/validation_twins.txt``. The config comes from
the reference's env vars (``BenchConfig.from_env``: ``USE_RCM_REORDERING``
= 0, 1 or auto, ``FIX_DIAGONAL_ZEROS``, ``MIN_NUM_LOOPS``, ``MIN_TIME_S``,
``K_DIM``, the SpMM/SDDMM K, default 128, and ``CG_MAX_NUM_ITERS``, the
solvers' iteration cap, default 50). Each (format, workload) pair writes
``<fmt>_<workload>.csv``; a pair the format has no impl for is skipped.

``--job`` (repeatable) is a semicolon-separated spec of one sweep, as in
``tools/sweep.py``: ``mats=FILE`` (default: the ``--matrix`` and
``--matrices`` specs), ``formats=a,b``, ``workloads=x,y``, ``kdim=K``,
``transform=spd|dd`` (the solver-dataset analogs), ``precond=jacobi``,
``maxiters=N`` and ``out=DIR`` (default ``--out``). The JAX CLI's
``impls`` key is left out: the port's impl follows the device. The jobs run
in order in one process; unlike the JAX CLI, a job that fails stops the
command. Formats, workloads and preconditioners the port does not have
raise before any work starts.
"""

from __future__ import annotations

import argparse

import torch

from .harness import BenchConfig
from .harness.sweep import check_sweep_args, run_sweep

JOB_KEYS = ("mats", "formats", "workloads", "kdim", "transform", "precond",
            "maxiters", "out")


def _read_specs(path):
    with open(path) as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")]


def parse_job(spec: str, args) -> dict:
    """One ``--job`` spec → the keyword arguments of its ``run_sweep``."""
    kv = dict(part.split("=", 1) for part in spec.split(";") if part)
    bad = sorted(set(kv) - set(JOB_KEYS))
    if bad:
        raise ValueError(f"job {spec!r}: unknown keys {bad} (have "
                         f"{', '.join(JOB_KEYS)})")
    cfg = BenchConfig.from_env()
    if "kdim" in kv:
        cfg.k_dim = int(kv["kdim"])
    if kv.get("transform"):
        if kv["transform"] not in ("spd", "dd"):
            raise ValueError(f"job {spec!r}: transform must be spd or dd")
        cfg.matrix_transform = kv["transform"]
    if kv.get("precond"):
        cfg.solver_precond = kv["precond"]
    if kv.get("maxiters"):
        cfg.cg_max_num_iters = int(kv["maxiters"])
    specs = _read_specs(kv["mats"]) if kv.get("mats") else _specs(args)
    job = dict(matrices=specs,
               formats=kv.get("formats", ",".join(args.formats)).split(","),
               workloads=kv.get("workloads",
                                ",".join(args.workloads)).split(","),
               out_dir=kv.get("out", args.out), config=cfg)
    check_sweep_args(job["formats"], job["workloads"], cfg.solver_precond)
    return job


def _specs(args):
    specs = list(args.matrix)
    if args.matrices:
        specs += _read_specs(args.matrices)
    return specs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrices", help="file with one matrix spec per line")
    ap.add_argument("--matrix", action="append", default=[],
                    help="inline matrix spec (repeatable)")
    ap.add_argument("--formats", nargs="+", default=["csr", "closg"])
    ap.add_argument("--workloads", nargs="+", default=["spmv"])
    ap.add_argument("--out", default="out_logs")
    ap.add_argument("--job", action="append", default=[],
                    help="semicolon-separated job spec (see the module "
                         "docstring); repeatable, run in order")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    try:
        if args.job:
            jobs = [parse_job(js, args) for js in args.job]
        else:
            check_sweep_args(args.formats, args.workloads)
            jobs = [dict(matrices=_specs(args), formats=args.formats,
                         workloads=args.workloads, out_dir=args.out,
                         config=BenchConfig.from_env())]
    except (NotImplementedError, ValueError, OSError) as e:
        ap.error(str(e))
    if not all(job["matrices"] for job in jobs):
        ap.error("no matrices given")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the GPU, or pass "
                         "--device cpu for the plain PyTorch path")
    for spec, job in zip(args.job or [None], jobs):
        if spec is not None:
            print(f"### job: {spec}", flush=True)
        run_sweep(device=device, **job)


if __name__ == "__main__":
    main()
