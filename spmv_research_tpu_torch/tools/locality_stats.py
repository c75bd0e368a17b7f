"""Post-RCM column-locality statistics for a matrix: decides whether the
window-SELL kernel applies and with what window policy.

Counterpart of the JAX repository's ``tools/locality_stats.py``, on the
port's generator and RCM. Its geometry (8-row groups, 1024-wide windows
aligned to 128) is the one the port's SELLW keeps (``ops/sellw.py``), so
its verdict holds for the port. For C=8 row-group packing (rows striped
over 8 sublanes, each sublane a packed run of its rows' nonzeros), reports
per chunking granularity:
  - fraction of nnz whose column falls inside the best 1024-wide window of
    its 128-slot lane-run (per-sublane windows), and of its 1024-slot chunk
    (shared window).

Run:  python -m spmv_research_tpu_torch.tools.locality_stats [twin-line]
"""

import argparse

import numpy as np

LINE = "170998 170998 5.6 4.39 normal random 0.297 61.9 0.803 0.633 14 scircuit_twin"


def window_cover_frac(cols_run, W=1024):
    """Max fraction of entries of cols_run coverable by one aligned window of
    width W (windows aligned to 128)."""
    if len(cols_run) == 0:
        return 1.0
    base = np.unique(cols_run // 128 * 128)
    cs = np.sort(cols_run)
    best = int((np.searchsorted(cs, base + W) - np.searchsorted(cs, base)).max())
    return best / len(cols_run)


def report(host) -> None:
    """Print the statistics of ``host`` (already reordered)."""
    m, nnz = host.m, host.nnz
    indptr, indices = host.ia, host.ja
    rows = np.repeat(np.arange(m), np.diff(indptr))
    disp = indices - rows
    print(f"m={m} nnz={nnz}")
    print(f"|col-row| percentiles post-RCM: "
          f"{np.percentile(np.abs(disp), [50, 90, 99, 99.9, 100]).astype(int)}")
    for W in (512, 1024, 2048, 4096):
        frac = np.mean(np.abs(disp) < W / 2)
        print(f"  |disp| < {W//2}: {frac:.4f}")

    # per-sublane-run windows: stripe rows over 8 sublanes in row order
    # (round-robin by row blocks of 1), pack each sublane's nnz, cut runs of
    # 128, ask window coverage of each run.
    for stripe in ("block", "rr"):
        if stripe == "rr":
            lane_of_row = np.arange(m) % 8
        else:
            lane_of_row = (np.arange(m) * 8) // m
        tot_in = 0
        for s in range(8):
            rws = np.where(lane_of_row == s)[0]
            cols = np.concatenate([indices[indptr[r]:indptr[r + 1]] for r in rws]) \
                if len(rws) else np.array([], np.int32)
            for st in range(0, len(cols), 128):
                run = cols[st:st + 128]
                tot_in += window_cover_frac(run) * len(run)
        print(f"per-sublane 1024-window coverage ({stripe} striping): "
              f"{tot_in / nnz:.4f}")
        # shared chunk window: approximate by 1024-nnz chunks of global order
    cols_all = indices
    tot = 0
    for st in range(0, nnz, 1024):
        run = cols_all[st:st + 1024]
        tot += window_cover_frac(run) * len(run)
    print(f"shared-window (1024-nnz row-major chunks) coverage: {tot / nnz:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("line", nargs="?", default=LINE,
                    help="11-arg synthetic line (default: the scircuit twin)")
    args = ap.parse_args(argv)

    from ..convert import rcm_reorder
    from ..gen import generate_from_line

    host, _ = generate_from_line(args.line)
    host, _ = rcm_reorder(host)
    report(host)


if __name__ == "__main__":
    main()
