"""Merge sweep CSVs from out_logs directories into a results directory and
render a per-matrix best-engine summary (``<results_dir>/SUMMARY.md``).

Counterpart of the JAX repository's ``tools/collect_results.py``, with its
rules: the last row wins per (matrix, format_name, impl, K), a later
directory winning over an earlier one; a row whose accuracy columns are not
finite numbers is dropped; CSR_SYM rows are left out; the csr32/csr64
roofline kinds of one (matrix, format) family must agree. Where it
differs, on purpose:

* the SpMV summary's speedup divides by the ``CSR_torch`` row, the label
  matched exactly (the JAX tool's ``startswith("CSR_xla")`` also matches
  ``CSR_xlac``), and a second column divides by ``CSR_sparse``
  (cuSPARSE);
* the title names the card (``--card``, by default ``nvidia-smi``'s name
  and power limit where it runs), never a TPU;
* the corpus files and ``SUMMARY.md`` go to ``--results-dir`` (default
  ``results_torch/``; the JAX tool writes ``results/SUMMARY.md`` whatever
  directory ``merge`` was given)::

    python -m spmv_research_tpu_torch.tools.collect_results out_logs \\
        [more_dirs ...] [--results-dir results_torch] [--card "..."]
"""

import argparse
import csv
import math
import os
from collections import OrderedDict

BASELINES = ("CSR_torch", "CSR_sparse")   # the speedup columns' rows


def merge(out_dirs="out_logs", results_dir="results_torch"):
    """out_dirs: one dir or a list; later dirs win on key collisions.
    K-sweep dirs (…_kNN) tag their rows' K from the dir name. Returns
    ``(merged, best)``: merged rows by workload, and per SpMV matrix its
    best row and each baseline's, as (gflops, format, roofline_frac)."""
    if isinstance(out_dirs, str):
        out_dirs = [out_dirs]
    os.makedirs(results_dir, exist_ok=True)
    merged = {}
    for out_dir in out_dirs:
        if not os.path.isdir(out_dir):
            continue
        for fname in sorted(os.listdir(out_dir)):
            if not fname.endswith(".csv"):
                continue
            wl = fname.rsplit("_", 1)[-1][:-4]       # spmv/spmm/...
            with open(os.path.join(out_dir, fname)) as f:
                rows = list(csv.DictReader(f))
            dst = merged.setdefault(wl, OrderedDict())
            for r in rows:
                # CSR_SYM rows are retired from the evidence set (the JAX
                # tool's rule: they overstated symmetric coverage)
                if str(r.get("format_name", "")).startswith("CSR_SYM"):
                    continue
                # accuracy gate: a non-finite error metric is a failed run,
                # never corpus evidence. Parse numerically so -inf/+nan
                # spellings can't slip through.
                bad = False
                for col in ("mape", "spmv_mape", "max_ae", "spmv_max_ae"):
                    if col not in r:
                        continue
                    try:
                        v = float(r[col])
                    except (TypeError, ValueError):
                        bad = True
                        break
                    if not math.isfinite(v):
                        bad = True
                        break
                if bad:
                    print(f"  dropped non-finite-accuracy row: "
                          f"{r.get('matrix_name')}/{r.get('format_name')} "
                          f"({out_dir}/{fname})")
                    continue
                key = (r.get("matrix_name"), r.get("format_name"),
                       r.get("impl", ""), r.get("K", ""))
                dst[key] = r
    # roofline-denominator consistency: a merge must never silently mix
    # csr32/csr64 fractions for the same (matrix, format) family. Rows
    # without the roofline_kind column are inferred from the format name
    # (double-single formats are the only csr64 emitters).
    for wl, rows in merged.items():
        kinds = {}
        for r in rows.values():
            kind = (r.get("roofline_kind") or "").strip()
            if not kind:
                fmt = r.get("format_name", "")
                kind = "csr64" if "DS" in fmt.split("_")[0] or \
                    fmt.startswith(("CSRDS", "SELLWDS")) else "csr32"
                r["roofline_kind"] = kind
            fam = (r.get("matrix_name"), r.get("format_name"))
            prev = kinds.setdefault(fam, kind)
            if prev != kind:
                raise SystemExit(
                    f"mixed roofline denominators for {fam} in workload "
                    f"{wl}: {prev} vs {kind} — regenerate one side")
    for wl, rows in merged.items():
        path = os.path.join(results_dir, f"corpus_{wl}.csv")
        rows = list(rows.values())
        fields = list(OrderedDict(
            (k, None) for r in rows for k in r.keys()))
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {path} ({len(rows)} rows)")
    # summary: best engine per matrix for spmv
    spmv = list(merged.get("spmv", {}).values())
    best = {}
    for r in spmv:
        name = r["matrix_name"]
        if name.endswith(("_spd", "_dd")):
            continue      # solver-analog rows, not the SpMV corpus
        try:
            g = float(r["gflops"])
        except (ValueError, KeyError):
            continue
        cur = best.setdefault(name, {"best": None,
                                     **dict.fromkeys(BASELINES)})
        fmt = r["format_name"]
        entry = (g, fmt, float(r.get("roofline_frac", 0) or 0))
        if fmt in BASELINES:
            cur[fmt] = entry
        if cur["best"] is None or g > cur["best"][0]:
            cur["best"] = entry
    return merged, best


def workloads_summary(merged):
    """Markdown rows for the non-spmv workload tables (cg/bicgstab/spmm/
    sddmm/spgemm/trisolve CSVs share the compact schema)."""
    lines = []
    for wl in sorted(merged):
        if wl == "spmv":
            continue
        rows = list(merged[wl].values())
        if not rows:
            continue
        lines.append(f"\n## {wl}\n")
        lines.append("| matrix | format | impl | K | gflops | iters/loops |"
                     " mape |")
        lines.append("|---|---|---|---|---|---|---|")
        for r in rows:
            lines.append(
                f"| {r.get('matrix_name')} | {r.get('format_name')} "
                f"| {r.get('impl','')} | {r.get('K','')} "
                f"| {float(r.get('gflops',0) or 0):.3f} "
                f"| {r.get('num_loops','')} "
                f"| {float(r.get('mape',0) or 0):.2e} |")
    return lines


def _row_kind(fmt: str) -> str:
    """Per-twin coverage class: an ENGINE row, a labeled DENSE fallback, or
    the CSR baseline standing in."""
    if fmt.startswith("DENSE"):
        return "fallback:dense"
    if fmt.startswith("CSR_"):
        return "baseline"
    return "engine"


def summary_lines(best, merged, card):
    """SUMMARY.md's lines: the SpMV table (best row per matrix, speedups
    over CSR/torch and CSR/sparse) and the other workloads' tables."""
    lines = [f"# Corpus summary — SpMV on the validation twins ({card})", "",
             "| matrix | best row | kind | Gnnz/s | GFLOPS | roofline frac |"
             " speedup vs CSR/torch | speedup vs CSR/sparse |",
             "|---|---|---|---|---|---|---|---|"]
    geo = dict.fromkeys(BASELINES, 0.0)
    geo_n = dict.fromkeys(BASELINES, 0)
    for name in sorted(best):
        b = best[name]["best"]
        if b is None:
            continue
        sp = []
        for base_name in BASELINES:
            base = best[name][base_name]
            if base and base[0] > 0:
                sp.append(f"{b[0] / base[0]:.2f}x")
                geo[base_name] += math.log(b[0] / base[0])
                geo_n[base_name] += 1
            else:
                sp.append("-")
        lines.append(f"| {name} | {b[1]} | {_row_kind(b[1])} | "
                     f"{b[0] / 2:.2f} | {b[0]:.2f} | "
                     f"{b[2]:.4f} | {sp[0]} | {sp[1]} |")
    for base_name in BASELINES:
        if geo_n[base_name]:
            lines.append("")
            lines.append(
                f"Geomean speedup of the best row over {base_name} over "
                f"{geo_n[base_name]} matrices: "
                f"**{math.exp(geo[base_name] / geo_n[base_name]):.2f}x**.")
    geo_rf, geo_rf_n = 0.0, 0
    for name in sorted(best):
        b2 = best[name]["best"]
        if b2 is not None and b2[2] > 0:
            geo_rf += math.log(b2[2]); geo_rf_n += 1
    if geo_rf_n:
        lines.append("")
        lines.append(f"**Corpus geomean** best-row roofline fraction over "
                     f"{geo_rf_n} matrices: "
                     f"**{math.exp(geo_rf / geo_rf_n):.3f}** "
                     "(every twin counted: engine rows, labeled DENSE "
                     "fallbacks, and CSR-baseline stand-ins alike).")
    lines.extend(workloads_summary(merged))
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dirs", nargs="*", default=["out_logs"],
                    help="sweep output directories, later ones winning")
    ap.add_argument("--results-dir", default="results_torch")
    ap.add_argument("--card", help="the card's name and power limit "
                    "(default: nvidia-smi's, where it runs)")
    args = ap.parse_args(argv)
    from .machine_info import card
    name = args.card or card() or "card not recorded"
    merged, best = merge(args.out_dirs, results_dir=args.results_dir)
    path = os.path.join(args.results_dir, "SUMMARY.md")
    with open(path, "w") as f:
        f.write("\n".join(summary_lines(best, merged, name)) + "\n")
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
