"""The port's sweep entry point, config, transforms and build_best, against
the JAX package.

``run_sweep`` runs on the CPU (the plain PyTorch impls) over a 2000-row
banded twin with a tiny timing config and must write the JAX package's CSV
labels; the config, the three ``load_matrix`` transforms and ``build_best``'s
format choice must match the JAX package's.
"""

import numpy as np
import pytest
import torch

import spmv_research_tpu.convert.cache as jax_cache
from spmv_research_tpu.convert import coo_csr as jax_coo_csr
from spmv_research_tpu.convert.build_pallas import build_best as jax_best
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import bench as jax_bench
from spmv_research_tpu.harness.config import BenchConfig as JaxBenchConfig
from spmv_research_tpu.harness.sweep import load_matrix as jax_load_matrix

from spmv_research_tpu_torch import sweep as cli
from spmv_research_tpu_torch.convert import coo_csr
from spmv_research_tpu_torch.convert.build_best import build_best
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness.sweep import (SweepDoneLog,
                                                   check_sweep_args,
                                                   load_matrix)

from torch_cases import BANDED_LINE, TWIN_LINE, banded_matrix

# 6 nnz per row scattered over 200,000 columns: no column locality
SCATTERED_LINE = "2000 200000 6 1 normal random 1.0 0 0 0 14 wide_scatter"
TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1,
            use_rcm_reordering="auto")


def _same_csr(a, b):
    assert (a.m, a.n, a.nnz, a.nnz_expanded, a.symmetric_storage) == (
        b.m, b.n, b.nnz, b.nnz_expanded, b.symmetric_storage)
    for f in ("ia", "ja", "a"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def sweep_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep")
    res = run_sweep([BANDED_LINE, TWIN_LINE],
                    formats=("csr", "sellr", "sellw", "closg"),
                    out_dir=str(out), config=BenchConfig(**TINY),
                    device="cpu")
    return out, res


def test_sweep_writes_jax_csv(sweep_out):
    out, res = sweep_out
    labels = jax_bench.csv_labels(synthetic=True)
    for fmt in ("csr", "sellr", "sellw", "closg"):
        lines = (out / f"{fmt}_spmv.csv").read_text().splitlines()
        assert lines[0] == labels
        assert len(lines) == 1 + 2
        assert all(len(ln.split(",")) == len(labels.split(","))
                   for ln in lines[1:])
    assert sorted((r.matrix_name, r.format_name, r.impl) for r in res) == \
        sorted((m, f, "torch") for m in ("shipsec1_twin", "scircuit_twin")
               for f in ("CSR", "SELLR", "SELLW", "CLOSG"))
    for r in res:
        assert r.metrics.max_rel_err < 1e-5 and r.num_loops >= 2


def test_sweep_skips_refused_formats(tmp_path, capsys):
    """A builder's suitability error is printed and the format skipped."""
    cfg = BenchConfig(**dict(TINY, use_rcm_reordering=False))  # m != n
    res = run_sweep([SCATTERED_LINE], formats=("sellr", "sellw"),
                    out_dir=str(tmp_path), config=cfg, device="cpu")
    out = capsys.readouterr().out
    assert res == [] and not list(tmp_path.glob("*.csv"))
    assert "sellr build refused wide_scatter: SellRBuildError" in out
    assert "sellw build refused wide_scatter: SellWBuildError" in out


def test_sweep_rowsplit_and_dense_rows(tmp_path, monkeypatch, capsys):
    """``closg`` yields an RSPLIT row where rows are long (the split
    threshold and part size lowered to 16 nnz for the 2000-row twin),
    ``dense`` a DENSE row, and a dense plane past the budget is refused and
    skipped."""
    import spmv_research_tpu_torch.ops.clos_gather as cg
    from spmv_research_tpu_torch.harness import sweep as sweep_mod
    from spmv_research_tpu_torch.ops import build_dense, rowsplit
    monkeypatch.setattr(cg, "SPLIT_ROW_NNZ", 16)
    monkeypatch.setattr(rowsplit, "DEFAULT_T", 16)
    res = run_sweep([TWIN_LINE], formats=("closg", "dense"),
                    out_dir=str(tmp_path), config=BenchConfig(**TINY),
                    device="cpu")
    assert [(r.format_name, r.impl) for r in res] == [("RSPLIT", "torch"),
                                                      ("DENSE", "torch")]
    for r in res:
        assert r.metrics.max_rel_err < 1e-5 and r.num_loops >= 2
    for fmt in ("closg", "dense"):
        lines = (tmp_path / f"{fmt}_spmv.csv").read_text().splitlines()
        assert lines[0] == jax_bench.csv_labels(synthetic=True)
        assert len(lines) == 2
        assert f",{'RSPLIT' if fmt == 'closg' else 'DENSE'}_torch," in lines[1]
    monkeypatch.setitem(sweep_mod.FORMAT_BUILDERS, "dense",
                        lambda h: build_dense(h, max_bytes=1 << 20))
    assert run_sweep([TWIN_LINE], formats=("dense",),
                     out_dir=str(tmp_path / "refused"),
                     config=BenchConfig(**TINY), device="cpu") == []
    assert ("dense build refused scircuit_twin: DenseBuildError"
            in capsys.readouterr().out)


def test_sweep_resumes_from_done_log(sweep_out):
    out, _ = sweep_out
    log = SweepDoneLog(str(out))
    assert log.skip("shipsec1_twin", "sellr", "torch", "spmv")
    again = run_sweep([BANDED_LINE], formats=("csr",), out_dir=str(out),
                      config=BenchConfig(**TINY), device="cpu")
    assert again == []


def test_sweep_refuses_unported_names(tmp_path):
    with pytest.raises(NotImplementedError, match="bfly"):
        check_sweep_args(["csr", "bfly"], ["spmv"])
    with pytest.raises(NotImplementedError, match="spgemm"):
        run_sweep([BANDED_LINE], formats=("csr",), workloads=("spgemm",),
                  out_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="Matrix Market"):
        load_matrix("matrix.mtx", BenchConfig())
    with pytest.raises(SystemExit):
        cli.main(["--matrix", BANDED_LINE, "--formats", "ell"])


def test_cli_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("MIN_NUM_LOOPS", "2")
    monkeypatch.setenv("MIN_TIME_S", "0")
    monkeypatch.setenv("USE_RCM_REORDERING", "auto")
    specs = tmp_path / "twins.txt"
    specs.write_text(f"# a comment line\n{TWIN_LINE}\n")
    cli.main(["--matrices", str(specs), "--formats", "csr", "closg",
              "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert "scircuit_twin closg/torch spmv" in capsys.readouterr().out
    for fmt in ("csr", "closg"):
        lines = (tmp_path / "out" / f"{fmt}_spmv.csv").read_text()
        assert lines.splitlines()[0] == jax_bench.csv_labels(synthetic=True)
        assert len(lines.splitlines()) == 2


def test_cli_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--matrix", BANDED_LINE])


@pytest.mark.parametrize("rcm", [False, True, "auto"])
def test_load_matrix_matches_jax(rcm):
    cfg = BenchConfig(use_rcm_reordering=rcm, fix_diagonal_zeros=True)
    jcfg = JaxBenchConfig(use_rcm_reordering=rcm, fix_diagonal_zeros=True)
    host, name, params = load_matrix(BANDED_LINE, cfg)
    hj, name_j, params_j = jax_load_matrix(BANDED_LINE, jcfg)
    _same_csr(host, hj)
    assert name == name_j and vars(params) == vars(params_j)


def test_config_from_env_matches_jax(monkeypatch):
    for env in ({"USE_RCM_REORDERING": "auto", "MIN_NUM_LOOPS": "7"},
                {"USE_RCM_REORDERING": "1", "FIX_DIAGONAL_ZEROS": "1",
                 "MIN_TIME_S": "0.5", "K_DIM": "64"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        c, cj = BenchConfig.from_env(), JaxBenchConfig.from_env()
        for f in ("use_rcm_reordering", "fix_diagonal_zeros",
                  "matrix_transform", "min_num_loops", "min_time_s",
                  "warmup_iters", "dtype", "k_dim", "inner_iters"):
            assert getattr(c, f) == getattr(cj, f), f


@pytest.mark.parametrize("transform", ["fix_diagonal_zeros", "make_spd",
                                       "make_diag_dominant"])
def test_transforms_match_jax(transform):
    mat = banded_matrix(600, 600, 40, 6, 11).tolil()
    mat.setdiag(0.0)           # zeros and gaps on the diagonal
    mat[3, 3] = 2.0
    mat = mat.tocsr()
    mat.sort_indices()
    got = getattr(coo_csr, transform)(HostCSR.from_scipy(mat))
    want = getattr(jax_coo_csr, transform)(JaxHostCSR.from_scipy(mat))
    _same_csr(got, want)


@pytest.mark.parametrize("which", ["banded", "twin"])
def test_build_best_keys_match_jax(which, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    line = BANDED_LINE if which == "banded" else TWIN_LINE
    host, _, _ = load_matrix(line, BenchConfig(use_rcm_reordering="auto"))
    hj, _, _ = jax_load_matrix(line,
                               JaxBenchConfig(use_rcm_reordering="auto"))
    got, want = build_best(host), jax_best(hj)
    assert list(got) == list(want)
    if which == "banded":
        assert list(got) == ["SELLR", "SELLW", "CLOSG"]
    for _, info in got.values():
        assert info["build_s"] == info["cold_build_s"] > 0


@pytest.mark.parametrize("workload, transform", [("cg", "spd"),
                                                 ("bicgstab", "dd")])
def test_sweep_solver_rows_on_ds_formats(tmp_path, workload, transform):
    """The solvers through the sweep on the double-single formats: one row
    per format under the JAX workload labels, each converged."""
    from spmv_research_tpu.harness.sweep import _labels_for as jax_labels_for
    cfg = BenchConfig(**dict(TINY, matrix_transform=transform,
                             cg_max_num_iters=100))
    res = run_sweep([BANDED_LINE], formats=("csrds", "sellwds"),
                    workloads=(workload,), out_dir=str(tmp_path),
                    config=cfg, device="cpu")
    assert sorted((r.format_name, r.impl, r.workload) for r in res) == [
        ("CSRDS", "torch", workload), ("SELLWDS", "torch", workload)]
    labels = jax_labels_for(workload, True)
    for fmt in ("csrds", "sellwds"):
        lines = (tmp_path / f"{fmt}_{workload}.csv").read_text().splitlines()
        assert lines[0] == labels and len(lines) == 2
        row = lines[1].split(",")
        assert len(row) == len(labels.split(","))
        assert row[0] == f"shipsec1_twin_{transform}" and row[3] == "0"
    for r in res:
        assert r.extra["converged"] and r.mape < 1e-5


def test_sweep_ds_spmv_rows_carry_fp64_metrics(tmp_path):
    res = run_sweep([BANDED_LINE], formats=("csrds", "sellwds"),
                    out_dir=str(tmp_path), config=BenchConfig(**TINY),
                    device="cpu")
    assert sorted(r.format_name for r in res) == ["CSRDS", "SELLWDS"]
    for r in res:
        assert r.roofline_kind == "csr64" and r.metrics.passed
        assert r.metrics.max_rel_err < 1e-10
    for fmt in ("csrds", "sellwds"):
        lines = (tmp_path / f"{fmt}_spmv.csv").read_text().splitlines()
        assert lines[0] == jax_bench.csv_labels(synthetic=True)
        assert ",csr64," in lines[1]


def test_sweep_refuses_ic0_before_any_work(tmp_path):
    out = tmp_path / "out"
    for p in ("ic0", "ilu0"):
        with pytest.raises(NotImplementedError, match="solvers/ilu.py"):
            run_sweep([BANDED_LINE], formats=("csr",), workloads=("cg",),
                      out_dir=str(out), device="cpu",
                      config=BenchConfig(**dict(TINY, solver_precond=p)))
    assert not out.exists()
    with pytest.raises(SystemExit):
        cli.main(["--matrix", BANDED_LINE, "--device", "cpu", "--job",
                  "formats=csr;workloads=cg;precond=ic0"])


def test_sweep_skips_ds_range_refusal(tmp_path, monkeypatch, capsys):
    from spmv_research_tpu_torch.harness import sweep as sweep_mod
    from spmv_research_tpu_torch.ops import compensated
    monkeypatch.setattr(compensated, "DS_MAX_ABS", 1e-3)
    assert run_sweep([BANDED_LINE], formats=("csrds", "sellwds"),
                     out_dir=str(tmp_path), config=BenchConfig(**TINY),
                     device="cpu") == []
    out = capsys.readouterr().out
    assert "csrds build refused shipsec1_twin: DSRangeError" in out
    assert "sellwds build refused shipsec1_twin: SellWBuildError" in out
    assert sweep_mod.SUITABILITY_ERRORS[-1] is compensated.DSRangeError


def test_cli_jobs_run_in_order(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("MIN_NUM_LOOPS", "2")
    monkeypatch.setenv("MIN_TIME_S", "0")
    specs = tmp_path / "twins.txt"
    specs.write_text(f"{BANDED_LINE}\n")
    cli.main(["--matrix", BANDED_LINE, "--device", "cpu", "--job",
              f"formats=csr,sellwds;workloads=cg;transform=spd;maxiters=40;"
              f"out={tmp_path / 'cg'}", "--job",
              f"mats={specs};formats=csr;workloads=bicgstab;transform=dd;"
              f"out={tmp_path / 'bicg'}"])
    out = capsys.readouterr().out
    assert out.index("### job: formats=csr,sellwds") < out.index(
        "### job: mats=")
    for d, fmt, w in (("cg", "csr", "cg"), ("cg", "sellwds", "cg"),
                      ("bicg", "csr", "bicgstab")):
        lines = (tmp_path / d / f"{fmt}_{w}.csv").read_text().splitlines()
        assert len(lines) == 2 and lines[1].startswith("shipsec1_twin_")
    with pytest.raises(SystemExit):
        cli.main(["--matrix", BANDED_LINE, "--job", "formats=csr;impls=xla"])


def test_config_solver_fields_match_jax(monkeypatch):
    c, cj = BenchConfig(), JaxBenchConfig()
    assert (c.cg_max_num_iters, c.solver_precond) == (cj.cg_max_num_iters,
                                                      cj.solver_precond)
    monkeypatch.setenv("CG_MAX_NUM_ITERS", "77")
    assert (BenchConfig.from_env().cg_max_num_iters
            == JaxBenchConfig.from_env().cg_max_num_iters == 77)
