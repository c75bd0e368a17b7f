"""Twin fidelity report.

Counterpart of the JAX repository's ``tools/twin_fidelity.py`` (the same
table, from the port's generator): generate synthetic twins and compare
their measured structural features against the requested parameters (the
reference validates its generator exactly this way — SURVEY.md §4 point 4;
twins table config.sh:399-455)::

    python -m spmv_research_tpu_torch.tools.twin_fidelity [--limit 3]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--twins", default="datasets/validation_twins.txt")
    ap.add_argument("--max-rows", type=int, default=300_000,
                    help="skip twins larger than this (host time)")
    ap.add_argument("--limit", type=int, default=10)
    args = ap.parse_args(argv)

    from ..gen import ArtificialParams, artificial_matrix_generation

    with open(args.twins) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]

    print(f"{'matrix':22s} {'feature':10s} {'requested':>12s} {'measured':>12s} {'rel.err':>8s}")
    done = 0
    for line in lines:
        p = ArtificialParams.from_args(line.split())
        if p.nr_rows > args.max_rows or done >= args.limit:
            continue
        _, f = artificial_matrix_generation(p)
        pairs = [
            ("avg_nnz", p.avg_nnz_per_row, f.nnz_per_row_avg),
            ("std_nnz", p.std_nnz_per_row, f.nnz_per_row_std),
            ("bw", p.bw, f.bw_scaled_avg),
            ("skew", p.skew, f.skew),
            ("neigh", p.avg_num_neighbours, f.num_neighbours_avg),
            ("crs", p.cross_row_similarity, f.cross_row_similarity_avg),
        ]
        for name, req, meas in pairs:
            rel = abs(meas - req) / max(abs(req), 1e-9)
            print(f"{p.name:22s} {name:10s} {req:12.4f} {meas:12.4f} {rel:8.2f}")
        done += 1


if __name__ == "__main__":
    main()
