"""Synthetic-sweep parameter-file generator.

Counterpart of the JAX repository's ``tools/create_param_file.py``, line for
line the same output. Reference role:
``matrix_generation_parameters/create_param_file.py`` — builds the
16k/26k-line synthetic corpora as a grid over CSR memory-footprint classes
× structural-feature lists. Line format is the 11-field generator input
consumed by the sweep and ``gen.generate_from_line``:

  nr_rows nr_cols avg_nnz std_nnz distribution placement bw skew
  neighbours cross_row_similarity seed [name]

Row count is derived from the target CSR footprint exactly as the
reference does (``create_param_file.py:27-29``): a double-precision CSR
costs 12 B/nnz + 4 B/row, so nr_rows = (MB·2^20 − 4) / (12·avg_nnz + 4);
std_nnz = avg_nnz / 3.

Example (the reference's medium dataset grid):
  python -m spmv_research_tpu_torch.tools.create_param_file \\
      --out datasets/synthetic_medium \\
      --mem-ranges 4-32 32-512 512-2048 --per-range 5 \\
      --avg-nnz 5 10 20 50 100 500 --bw 0.05 0.3 0.6 \\
      --skew 0 100 1000 10000 100000 \\
      --neighbours 0.05 0.5 0.95 1.4 1.9 \\
      --similarity 0.05 0.25 0.5 0.75 0.95
"""

import argparse


def param_lines(mem_ranges, per_range, avg_nnz_list, bw_list, skew_list,
                neigh_list, sim_list, distribution="normal",
                placement="random", seed=14):
    seen = set()
    out = {}
    for mem_range in mem_ranges:
        lines = out.setdefault(mem_range, [])
        lo, hi = (int(v) for v in mem_range.split("-"))
        step = max((hi - lo) // per_range, 1)
        sizes = list(range(lo, hi, step))[:per_range]
        for size in sizes:
            for avg in avg_nnz_list:
                std = round(avg / 3, 4)
                nr_rows = int((size * (1 << 20) - 4) // (12 * avg + 4))
                if nr_rows < 1:
                    continue
                for bw in bw_list:
                    for skew in skew_list:
                        for neigh in neigh_list:
                            for sim in sim_list:
                                line = (f"{nr_rows} {nr_rows} {avg} {std} "
                                        f"{distribution} {placement} {bw} "
                                        f"{skew} {neigh} {sim} {seed}")
                                if line not in seen:
                                    seen.add(line)
                                    lines.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="output file prefix (one file per mem range)")
    ap.add_argument("--mem-ranges", nargs="+", default=["4-32"],
                    help="CSR footprint classes in MB, e.g. 4-32 32-512")
    ap.add_argument("--per-range", type=int, default=5)
    ap.add_argument("--avg-nnz", nargs="+", type=float,
                    default=[5, 10, 20, 50, 100, 500])
    ap.add_argument("--bw", nargs="+", type=float, default=[0.05, 0.3, 0.6])
    ap.add_argument("--skew", nargs="+", type=float,
                    default=[0, 100, 1000, 10000, 100000])
    ap.add_argument("--neighbours", nargs="+", type=float,
                    default=[0.05, 0.5, 0.95, 1.4, 1.9])
    ap.add_argument("--similarity", nargs="+", type=float,
                    default=[0.05, 0.25, 0.5, 0.75, 0.95])
    ap.add_argument("--distribution", default="normal",
                    choices=["normal", "gamma"])
    ap.add_argument("--placement", default="random",
                    choices=["random", "diagonal", "simple"])
    ap.add_argument("--seed", type=int, default=14)
    args = ap.parse_args(argv)

    total = 0
    files = param_lines(args.mem_ranges, args.per_range, args.avg_nnz,
                        args.bw, args.skew, args.neighbours, args.similarity,
                        args.distribution, args.placement, args.seed)
    for mem_range, lines in files.items():
        path = f"{args.out}_{mem_range}.txt"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {path} ({len(lines)} matrices)")
        total += len(lines)
    print(f"{total} total matrices")


if __name__ == "__main__":
    main()
