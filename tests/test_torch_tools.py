"""The port's tracing, plotting, config fields and command-line tools
(``utils/trace.py``, ``utils/plot.py``, ``harness/config.py``,
``spmv_research_tpu_torch/tools/``) against the JAX package's and the JAX
repository's ``tools/`` scripts on the CPU.

The JAX scripts are loaded from their files and run with ``sys.argv``
patched, their output captured; the port's CLIs take an argument list.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from spmv_research_tpu.gen import generate_from_line as jax_generate
from spmv_research_tpu.harness.bench import csv_labels as jax_csv_labels
from spmv_research_tpu.harness.config import BenchConfig as JaxBenchConfig
from spmv_research_tpu.utils import plot as jax_plot

from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.ops import build_clos_gather_auto, spmv
from spmv_research_tpu_torch.tools import (collect_results, create_param_file,
                                           locality_stats, machine_info,
                                           mat_feat, twin_fidelity, xl_run)
from spmv_research_tpu_torch.utils import plot, trace

from torch_cases import BANDED_LINE, TWIN_LINE

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _jax_tool(name):
    """The JAX repository's ``tools/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch, capsys):
    """stdout of the JAX tool's main with ``sys.argv`` patched."""
    mod = _jax_tool(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))   # the tool adds "."
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _run_port(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _no_comments(text):
    """The lines a tool prints, without ``#`` lines (load_matrix's timings)."""
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


# ------------------------------------------------------- trace, plot, config

def test_trace_region_in_profiler(tmp_path):
    """The region is a profiler event spanning the SpMV's ops, and the
    Chrome trace is written into the logdir."""
    A = build_clos_gather_auto(generate_from_line(TWIN_LINE)[0])
    x = torch.ones(A.n)
    with trace.profile(str(tmp_path)) as prof:
        with trace.trace_region("COMPUTATION-SpMV"):
            spmv(A, x)
    events = prof.events()
    (region,) = [e for e in events if e.name == "COMPUTATION-SpMV"]
    inside = [e for e in events if e.name != region.name
              and region.time_range.start <= e.time_range.start
              and e.time_range.end <= region.time_range.end]
    assert inside
    (path,) = os.listdir(tmp_path)
    assert path.endswith(".json")
    with open(tmp_path / path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "COMPUTATION-SpMV" in names


def test_start_and_stop_profiler(tmp_path):
    trace.start_profiler(str(tmp_path / "tb"))
    with trace.trace_region("r"):
        torch.ones(4).sum()
    path = trace.stop_profiler()
    assert os.path.dirname(path) == str(tmp_path / "tb")
    assert os.path.getsize(path) > 0


@pytest.mark.parametrize("bins", [16, 512])
def test_spy_density_matches_jax(bins):
    got = plot.spy_density(generate_from_line(BANDED_LINE)[0], bins)
    want = jax_plot.spy_density(jax_generate(BANDED_LINE)[0], bins)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_plots_write_pngs(tmp_path):
    host = generate_from_line(TWIN_LINE)[0]
    plot.save_spy(host, str(tmp_path / "spy.png"), bins=64)
    plot.save_degree_histogram(host, str(tmp_path / "deg.png"))
    for name in ("spy.png", "deg.png"):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_config_output_fields_match_jax(monkeypatch):
    """The port's config holds JAX's fields at JAX's defaults and env
    overrides, less the distribution fields (the distributed layer's) and
    the output fields that nothing reads in either package."""
    port = {f.name: f.default for f in dataclasses.fields(BenchConfig)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxBenchConfig)}
    assert set(jax_fields) - set(port) == {"mesh_shape", "halo_strategy",
                                           "print_statistics",
                                           "csv_to_stderr"}
    assert {f: jax_fields[f] for f in port} == port
    for name, v in (("MIN_NUM_LOOPS", "7"), ("MIN_TIME_S", "0.25"),
                    ("PRINT_STATISTICS", "1")):
        monkeypatch.setenv(name, v)
    c, cj = BenchConfig.from_env(), JaxBenchConfig.from_env()
    assert {f: getattr(cj, f) for f in port} == dataclasses.asdict(c)
    assert (c.min_num_loops, c.min_time_s) == (7, 0.25)


# ------------------------------------------------------------------ tools

def test_param_lines_and_files_match_jax(tmp_path, monkeypatch, capsys):
    grid = (["4-32", "32-512"], 3, [5, 10.0, 500], [0.05, 0.3], [0, 100],
            [0.5, 1.9], [0.25])
    assert (create_param_file.param_lines(*grid, placement="diagonal")
            == _jax_tool("create_param_file").param_lines(
                *grid, placement="diagonal"))
    argv = ["--mem-ranges", "4-32", "512-2048", "--per-range", "2",
            "--avg-nnz", "5", "50", "--seed", "3"]
    want = _run_jax("create_param_file",
                    ["--out", str(tmp_path / "jax"), *argv], monkeypatch,
                    capsys)
    got = _run_port(create_param_file.main,
                    ["--out", str(tmp_path / "port"), *argv], capsys)
    assert got.replace("port", "jax") == want
    for mem in ("4-32", "512-2048"):
        with open(tmp_path / f"port_{mem}.txt") as a, \
                open(tmp_path / f"jax_{mem}.txt") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("rcm", [False, True])
def test_mat_feat_matches_jax(rcm, tmp_path, monkeypatch, capsys):
    argv = [TWIN_LINE] + (["--rcm"] if rcm else [])
    want = _run_jax("mat_feat", argv, monkeypatch, capsys)
    got = _run_port(mat_feat.main, argv, capsys)
    assert _no_comments(got) == _no_comments(want)
    assert len(_no_comments(got)) == len(mat_feat.FIELDS) + 1
    out = _run_port(mat_feat.main, [BANDED_LINE, "--spy",
                                    str(tmp_path / "s.png")], capsys)
    assert out.splitlines()[-1] == f"spy plot: {tmp_path / 's.png'}"
    assert os.path.getsize(tmp_path / "s.png") > 0


def test_twin_fidelity_matches_jax(tmp_path, monkeypatch, capsys):
    twins = tmp_path / "twins.txt"
    twins.write_text(f"# a comment\n{TWIN_LINE}\n\n"
                     f"300001 300001 5 1 normal random 0.1 1 1 0.5 14 big\n"
                     f"{BANDED_LINE}\n{TWIN_LINE}\n")
    argv = ["--twins", str(twins), "--limit", "2"]
    want = _run_jax("twin_fidelity", argv, monkeypatch, capsys)
    got = _run_port(twin_fidelity.main, argv, capsys)
    assert got == want and len(got.splitlines()) == 1 + 2 * 6


def test_locality_stats_matches_jax(monkeypatch, capsys):
    want = _run_jax("locality_stats", [TWIN_LINE], monkeypatch, capsys)
    got = _run_port(locality_stats.main, [TWIN_LINE], capsys)
    assert got == want


def test_window_cover_frac_matches_jax():
    jax_tool = _jax_tool("locality_stats")
    rng = np.random.Generator(np.random.PCG64(3))
    for n in (0, 1, 128, 1024):
        run = rng.integers(0, 20000, n)
        assert (locality_stats.window_cover_frac(run)
                == jax_tool.window_cover_frac(run))


def test_machine_info_on_the_cpu(capsys):
    info = json.loads(_run_port(machine_info.main, [], capsys))
    assert info["backend"] == "cpu" and info["torch"] == torch.__version__


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """A directory of port-written CSVs: the cut scircuit twin's spmv rows
    (CSR/torch, CSR/sparse, CLOSG/torch), csr SpMM and SDDMM rows at K = 4,
    and a CSR_torchx row that is not the baseline."""
    out = tmp_path_factory.mktemp("logs")
    cfg = BenchConfig(min_num_loops=2, min_time_s=0.0, warmup_iters=1,
                      use_rcm_reordering="auto", k_dim=4)
    run_sweep([TWIN_LINE], formats=("csr", "closg"),
              workloads=("spmv", "spmm", "sddmm"), out_dir=str(out),
              config=cfg, device="cpu")
    lines = (out / "csr_spmv.csv").read_text().splitlines()
    fake = [ln.replace(",CSR_torch,", ",CSR_torchx,") for ln in lines
            if ",CSR_torch," in ln]
    (out / "fake_spmv.csv").write_text("\n".join([lines[0], *fake]) + "\n")
    return out


def test_collect_results_corpus_matches_jax(sweep_dir, tmp_path, capsys):
    jax_tool = _jax_tool("collect_results")
    merged, best = collect_results.merge([str(sweep_dir)],
                                         results_dir=str(tmp_path / "port"))
    jax_merged, _ = jax_tool.merge([str(sweep_dir)],
                                   results_dir=str(tmp_path / "jax"))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "corpus_sddmm.csv", "corpus_spmm.csv", "corpus_spmv.csv"]
    for name in files:
        with open(tmp_path / "port" / name) as a, \
                open(tmp_path / "jax" / name) as b:
            assert a.read() == b.read(), name
    assert {k: list(v) for k, v in merged.items()} == {
        k: list(v) for k, v in jax_merged.items()}
    (entry,) = best.values()
    rows = {r["format_name"]: r for r in merged["spmv"].values()}
    for base in ("CSR_torch", "CSR_sparse"):   # never CSR_torchx's row
        assert entry[base][:2] == (float(rows[base]["gflops"]), base)


def test_collect_results_summary(sweep_dir, tmp_path, capsys):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    path = collect_results.main([str(sweep_dir), "--results-dir",
                                 str(tmp_path / "res"), "--card", card])
    assert path == str(tmp_path / "res" / "SUMMARY.md")
    text = open(path).read()
    lines = text.splitlines()
    assert lines[0] == f"# Corpus summary — SpMV on the validation twins ({card})"
    assert "TPU" not in text
    assert "speedup vs CSR/torch | speedup vs CSR/sparse |" in lines[2]
    row = lines[4]                        # the SpMV table's one matrix
    assert row.startswith("| scircuit_twin |") and lines[5] == ""
    assert row.count("x |") == 2          # a speedup over each baseline
    for wl in ("spmm", "sddmm"):
        assert f"## {wl}" in text
    assert sorted(os.listdir(tmp_path / "res")) == [
        "SUMMARY.md", "corpus_sddmm.csv", "corpus_spmm.csv",
        "corpus_spmv.csv"]


def test_xl_run_on_the_cpu(tmp_path, capsys):
    line = "6000 6000 8.0 3.0 normal random 0.02 2.0 0.8 0.5 14 xl_small"
    host, A, r, got = xl_run.run(line, str(tmp_path), 8192, device="cpu")
    assert A.format_name == "CLOSGX" and A.n_chunks > 1
    out = json.loads(_no_comments(capsys.readouterr().out)[0])
    assert out == got
    assert list(out) == ["matrix", "m", "nnz", "format", "nnz_per_s",
                         "gflops", "median_us", "roofline_frac", "mape",
                         "passed", "build_s"]
    assert (out["matrix"], out["format"], out["nnz"]) == ("xl_small",
                                                          "CLOSGX", host.nnz)
    assert out["roofline_frac"] is None and out["mape"] < 1e-6
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    mat = host.to_scipy()
    assert np.max(np.abs(r.y - mat @ x) / (abs(mat) @ x + 1e-30)) <= 1e-5
    lines = (tmp_path / "closgx_spmv.csv").read_text().splitlines()
    assert lines[0] == jax_csv_labels(synthetic=False)
    assert len(lines) == 2 and ",CLOSGX_torch," in lines[1]
    xl_run.run(line, str(tmp_path), 8192, device="cpu")   # appends a row
    assert len((tmp_path / "closgx_spmv.csv").read_text().splitlines()) == 3


def test_xl_run_by_name(tmp_path):
    twins = tmp_path / "twins.txt"
    twins.write_text("1 1 1 1 normal random 0 0 0 0 14 other\n")
    assert xl_run.twin_line("other", str(twins)).endswith(" other")
    with pytest.raises(SystemExit):
        xl_run.twin_line("xl_small", str(twins))


def test_xl_run_main_needs_the_card(tmp_path, monkeypatch):
    """The CLI runs on the card only: without one it refuses before it
    generates anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        xl_run.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
