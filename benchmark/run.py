"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the checkout's root. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled slice of the window. The last line of standard output is the
result's JSON; the last lines of standard error give each number the
check compared beside its limit. It exits with a code other than 0, and
prints no result, without a CUDA device, or where the process has loaded
JAX or the JAX package by the time the window has closed.

A workload whose ``chips`` is k > 1 runs on k cards, one rank process a
card: this process is rank 0 and starts the others (``ranks.py``); it
prints the result, and exits with another code than 0 and no result where
any rank fails or loads JAX. Options for the tests only: ``--place
one_card`` runs the k ranks on one card over gloo, ``--place cpu`` runs a
cell on the CPU (k ranks over gloo), and ``--answers <file.npz>`` keeps
the compared inputs and outputs, made whole. ``--rank``, ``--store`` and
``--parent`` are what rank 0 gives the ranks it starts.
"""

from __future__ import annotations

import time

T_PERF = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (its start
    since boot, from ``/proc/self/stat``, against ``CLOCK_BOOTTIME``);
    this module's import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
            "SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return T_PERF


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return "; ".join(out.stdout.strip().splitlines()) or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from benchmark.ranks import PLACES
    hidden = argparse.SUPPRESS
    ap.add_argument("--place", default="cards", choices=PLACES, help=hidden)
    ap.add_argument("--answers", default=None, help=hidden)
    ap.add_argument("--rank", type=int, default=0, help=hidden)
    ap.add_argument("--store", default=None, help=hidden)
    ap.add_argument("--parent", type=int, default=None, help=hidden)
    args = ap.parse_args(argv)
    if args.rank:
        from benchmark import ranks
        ranks.guard(args.parent)

    from benchmark import harness
    harness.use_format_cache()
    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    if args.rank:
        return run_rank(args, bench, chips, t_start)

    import torch
    cards = chips if args.place == "cards" else 1
    if args.place != "cpu" and (not torch.cuda.is_available()
                                or torch.cuda.device_count() < cards):
        print(f"benchmark: the cell needs {cards} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2

    t_imports = time.perf_counter() - t_start
    if chips > 1:
        return run_ranks(args, bench, chips, t_start, t_imports)
    device = "cpu" if args.place == "cpu" else "cuda"
    cell = harness.prepare(bench, args.workload, device, bool(args.trace))
    cell.setup_spans.insert(0, ("process start to imports", t_imports))
    out = harness.run_seed(cell, args.seed, args.seconds, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    return report(args, cell, out)


def rank_args(args) -> list:
    """The arguments that rank 0 gives every rank it starts, besides its
    rank."""
    return ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace),
            "--place", args.place]


def run_ranks(args, bench, chips: int, t_start: float,
              t_imports: float) -> int:
    """Rank 0 of a cell over ``chips`` ranks: start the others, run its own
    part, and report once every rank has ended with code 0."""
    from benchmark import harness, ranks
    launch = ranks.Launch(rank_args(args), chips, harness.ROOT)
    print(f"# ranks: {chips}, pids {[p.pid for p in launch.procs]}",
          file=sys.stderr, flush=True)
    try:
        control = ranks.Ranks(0, chips, args.place, launch.store)
        control.launch = launch
        cell = harness.prepare(bench, args.workload, control.device_type,
                               bool(args.trace), control=control)
        cell.setup_spans.insert(0, ("process start to imports", t_imports))
        out = harness.run_seed(cell, args.seed, args.seconds, t_start)
    except Exception as e:    # any error of rank 0's ends the run
        import traceback
        traceback.print_exc()
        launch.fail_after(e)
    launch.finish()
    bad = {f"rank {r['rank']}: {m}" for r in cell.rank_info
           for m in r["forbidden"]}
    bad |= {f"rank 0: {m}" for m in harness.forbidden_modules()}
    if bad:
        print(f"benchmark: the ranks loaded {', '.join(sorted(bad))}; "
              "no result", file=sys.stderr)
        return 3
    return report(args, cell, out)


def run_rank(args, bench, chips: int, t_start: float) -> int:
    """Rank ``args.rank`` of a cell over ``chips`` ranks, started by rank
    0: its part of the run; its summary goes to rank 0."""
    from benchmark import harness, ranks
    control = ranks.Ranks(args.rank, chips, args.place, args.store)
    cell = harness.prepare(bench, args.workload, control.device_type,
                           bool(args.trace), control=control)
    harness.run_seed(cell, args.seed, args.seconds, t_start)
    return 0


def report(args, cell, out: dict) -> int:
    """The card, the set-up, the op's notes and each compared number
    beside its limit on standard error, then the result's line."""
    checks = out.pop("checks")
    out["card"] = power_limit()
    out["checks"] = checks
    print(f"# card: {out['card']}", file=sys.stderr)
    print("# setup: " + ", ".join(
        [f"{k} {v:.3f}s" for k, v in cell.setup_spans]
        + [f"{k} {v:.3f}" for k, v in cell.build_info.items()]),
        file=sys.stderr)
    for line in getattr(cell.op, "notes", lambda c: [])(cell):
        print(f"# {line}", file=sys.stderr)
    if args.answers:
        save_answers(args.answers, cell)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def save_answers(path: str, cell) -> None:
    """The compared inputs and outputs (``cell.state["kept"]``, whole) as
    ``a<i>_<j>`` arrays of an ``.npz``."""
    import numpy as np
    np.savez(path, **{f"a{i}_{j}": t.detach().cpu().numpy()
                      for i, pair in enumerate(cell.state["kept"])
                      for j, t in enumerate(pair)})


if __name__ == "__main__":
    sys.exit(main())
