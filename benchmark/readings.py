"""The readings that a cell's limits are set from, in one process.

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 \\
        --seconds <s> [--control]

runs the cell's window and check once a seed, with the program built once,
and prints each seed's compared numbers as a JSON line. ``--control`` puts
the plain reference, computed in bfloat16 (the precision below the
configurations' float32), in the program's place: its readings have to
fail the limits. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from benchmark import harness
    from benchmark.program import ReferenceProgram
    harness.use_format_cache()
    bench = harness.Bench()
    cell = harness.prepare(bench, args.workload, "cuda", False,
                           ReferenceProgram if args.control else None)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_seed(cell, seed, args.seconds, time.perf_counter(),
                               release=False)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "checks": out["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
