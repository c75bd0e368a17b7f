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
    args = ap.parse_args(argv)

    from benchmark import harness
    harness.use_format_cache()
    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2

    t_imports = time.perf_counter() - t_start
    cell = harness.prepare(bench, args.workload, "cuda", bool(args.trace))
    cell.setup_spans.insert(0, ("process start to imports", t_imports))
    out = harness.run_seed(cell, args.seed, args.seconds, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
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
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
