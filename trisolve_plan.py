#!/usr/bin/env python3
"""Host-only plan of a twin's ILU(0) or IC(0) triangular solves: which
schedule ``build_schedule`` takes for each factor, and why.

    python3 trisolve_plan.py [--line "<11-arg line>"] [--transform spd|dd]
                             [--factor ilu0|ic0]

Loads the twin as the sweep does (``load_matrix``: the transform, then
RCM, as ``chip_smoke.py``'s phase 17), factors it (``solvers/ilu.py``),
and prints for L and U: why the band-block build refused the factor (its
``BandScheduleError``, which gives the share of entries past the band the
budget allows), then the schedule taken, its steps (blocks, levels or
chunks: one Python step each in ``sptrsv``) and its build time. Everything
runs on the CPU (the schedules are built on device "cpu"): its times are
host times, and nothing is timed on a card. Default: the shipsec1 line of
``chip_smoke.py``, SPD, RCM, ILU(0).
"""

import argparse
import time

from chip_smoke import SHIPSEC1_LINE
from spmv_research_tpu_torch.convert import fix_diagonal_zeros
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.config import BenchConfig
from spmv_research_tpu_torch.harness.sweep import load_matrix
from spmv_research_tpu_torch.harness.workloads import schedule_kind
from spmv_research_tpu_torch.solvers import ilu


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--line", default=SHIPSEC1_LINE)
    ap.add_argument("--transform", default="spd", choices=("spd", "dd"))
    ap.add_argument("--factor", default="ilu0", choices=("ilu0", "ic0"))
    args = ap.parse_args()
    host, name, _ = load_matrix(args.line, BenchConfig(
        use_rcm_reordering=True, matrix_transform=args.transform))
    t0 = time.perf_counter()
    if args.factor == "ic0":
        L = ilu.ic0(host)
        U = HostCSR.from_scipy(L.to_scipy().T.tocsr())
    else:
        L, U = ilu.ilu0(fix_diagonal_zeros(host))
    print(f"# {name}: m={host.m} nnz={host.nnz}; {args.factor} "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    for label, T, lower in (("L", L, True), ("U", U, False)):
        t0 = time.perf_counter()
        try:
            s = ilu.build_band_block_schedule(T, lower=lower, device="cpu")
            why = "band-block accepted"
        except ilu.BandScheduleError as e:
            why = f"band-block refused: {e}"
            s = ilu.build_schedule(T, lower=lower, device="cpu")
        print(f"# {label}: nnz={T.nnz}; {why}; {schedule_kind(s)} schedule "
              f"of {s.n_levels} steps, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
