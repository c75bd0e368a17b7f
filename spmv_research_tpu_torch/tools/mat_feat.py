"""Matrix feature extractor CLI.

Counterpart of the JAX repository's ``tools/mat_feat.py`` (the same fields
and twin line), role of the reference's
validation_matrices/matrix_features/mat_feat.cpp: read a matrix (a ``.mtx``
path or an 11-arg synthetic line, through the sweep's ``load_matrix``),
print its structural features and the 11-arg synthetic-twin parameter
line::

    python -m spmv_research_tpu_torch.tools.mat_feat "<11-arg line>" \\
        [--rcm] [--spy spy.png]
"""

import argparse

FIELDS = ("m", "n", "nnz", "density", "mem_footprint_mb", "mem_range",
          "nnz_per_row_min", "nnz_per_row_max", "nnz_per_row_avg",
          "nnz_per_row_std", "bw_avg", "bw_scaled_avg", "scatter_avg",
          "skew", "num_neighbours_avg", "cross_row_similarity_avg")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", help=".mtx path or 11-arg synthetic line")
    ap.add_argument("--rcm", action="store_true", help="apply RCM first")
    ap.add_argument("--spy", help="save spy plot to this path")
    args = ap.parse_args(argv)

    from ..convert import extract_features
    from ..harness import BenchConfig, load_matrix

    cfg = BenchConfig()
    cfg.use_rcm_reordering = args.rcm
    host, name, _ = load_matrix(args.matrix, cfg)
    f = extract_features(host)
    for field in FIELDS:
        print(f"{field:28s} {getattr(f, field)}")
    print("twin line:", " ".join(str(v) for v in f.twin_params()), name)
    if args.spy:
        from ..utils.plot import save_spy
        save_spy(host, args.spy, title=name)
        print("spy plot:", args.spy)


if __name__ == "__main__":
    main()
