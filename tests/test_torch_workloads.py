"""The K-dimension workloads (SpMM, SDDMM) in the port against the JAX
package.

``bench_spmm`` / ``bench_sddmm`` run on the CPU (the plain PyTorch impls)
with the JAX runners' inputs and must pass their float64 gold; the engines
whose SpMM is a column loop of their SpMV (CLOSG, RSPLIT, CLOSGX, SELLR)
and DENSE's matrix product must match the JAX ``spmm(..., impl="xla")``
within 1e-6 of |A|·|X|; CSR's SpMM and SDDMM the JAX reference impls; and
the sweep must write ``<fmt>_spmm.csv`` / ``<fmt>_sddmm.csv`` under the JAX
labels, skipping the pairs a format has no impl for.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_research_tpu.convert.build as jax_build
import spmv_research_tpu.ops.clos_gather as jax_cg
import spmv_research_tpu.ops.clos_xl as jax_xl
import spmv_research_tpu.ops.densemv as jax_dense
import spmv_research_tpu.ops.sellr as jax_sellr
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import workloads as jax_workloads
from spmv_research_tpu.harness.sweep import _labels_for as jax_labels_for
from spmv_research_tpu.ops import sddmm as jax_sddmm, spmm as jax_spmm

import spmv_research_tpu_torch.ops.clos_gather as cg
from spmv_research_tpu_torch.convert import build_csr
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import (BenchConfig, bench_sddmm,
                                             bench_spmm, bench_spmv,
                                             run_sweep)
from spmv_research_tpu_torch.harness.sweep import BenchGateError
from spmv_research_tpu_torch.harness.workloads import (sddmm_gold,
                                                       sddmm_inputs,
                                                       spmm_inputs)
from spmv_research_tpu_torch.ops import (build_btile, build_clos_gather,
                                         build_clos_gather_xl, build_dense,
                                         build_sellr, sddmm, spmm, spmv)
from spmv_research_tpu_torch.utils.timing import fold

from torch_cases import (BANDED_LINE, banded_matrix, btile_banded,
                         random_matrix, skewed_matrix)

TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1, inner_iters=2,
            k_dim=8, use_rcm_reordering="auto")


def _X(n, k, seed=21):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.uniform(-1.0, 1.0, (n, k)).astype(np.float32)


def _near(mat, X, got, want, tol=1e-6):
    scale = np.abs(mat) @ np.abs(X).astype(np.float64) + 1e-30
    assert got.shape == np.shape(want) == (mat.shape[0], X.shape[1])
    assert np.max(np.abs(got - np.asarray(want)) / scale) <= tol


def _pair(kind):
    """(matrix, the port's program, the JAX program) of one engine."""
    if kind == "closg":
        mat = random_matrix(700, 600, 0.01, 3)
        return (mat, build_clos_gather(HostCSR.from_scipy(mat)),
                jax_cg.build_clos_gather(JaxHostCSR.from_scipy(mat)))
    if kind == "rsplit":
        mat = skewed_matrix()
        mp = pytest.MonkeyPatch()
        mp.setattr(cg, "SPLIT_ROW_NNZ", 512)
        mp.setattr(jax_cg, "SPLIT_ROW_NNZ", 512)
        try:
            return (mat, cg.build_clos_gather_auto(HostCSR.from_scipy(mat)),
                    jax_cg.build_clos_gather_auto(
                        JaxHostCSR.from_scipy(mat)))
        finally:
            mp.undo()
    if kind == "closgx":
        from spmv_research_tpu.io import native as jax_native
        jax_native.get_lib()    # before the JAX two-thread chunk build
        mat = random_matrix(2500, 700, 0.008, 5)
        return (mat, build_clos_gather_xl(HostCSR.from_scipy(mat),
                                          chunk_N=8192),
                jax_xl.build_clos_gather_xl(JaxHostCSR.from_scipy(mat),
                                            chunk_N=8192))
    if kind == "sellr":
        mat = banded_matrix(1200, 1200, 160, 14, 2)
        return (mat, build_sellr(HostCSR.from_scipy(mat)),
                jax_sellr.build_sellr(JaxHostCSR.from_scipy(mat)))
    mat = random_matrix(500, 420, 0.02, 4)
    return (mat, build_dense(HostCSR.from_scipy(mat)),
            jax_dense.build_dense(JaxHostCSR.from_scipy(mat)))


@pytest.mark.parametrize("kind, fmt", [
    ("closg", "CLOSG"), ("rsplit", "RSPLIT"), ("closgx", "CLOSGX"),
    ("sellr", "SELLR"), ("dense", "DENSE")])
def test_spmm_matches_jax_xla(kind, fmt):
    mat, A, Aj = _pair(kind)
    assert A.format_name == Aj.format_name == fmt
    X = _X(mat.shape[1], 3)
    got = spmm(A, torch.from_numpy(X))              # CPU tensor: "torch"
    _near(mat, X, got.numpy(), jax_spmm(Aj, jnp.asarray(X), impl="xla"))
    if fmt != "DENSE":      # the column loop: each column is one SpMV
        for k in range(3):
            assert torch.equal(got[:, k], spmv(A, torch.from_numpy(X[:, k])))
        with pytest.raises(ValueError, match="CUDA"):
            spmm(A, torch.from_numpy(X), impl="cuda")


def test_csr_spmm_and_sddmm_match_jax():
    mat = random_matrix(600, 500, 0.02, 6)
    host, hj = HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)
    C, Cj = build_csr(host), jax_build.build_csr(hj)
    X, Am, Bm = _X(500, 5), _X(600, 5, 22), _X(500, 5, 23)
    _near(mat, X, spmm(C, torch.from_numpy(X)).numpy(),
          jax_spmm(Cj, jnp.asarray(X), impl="xla"))
    got = sddmm(C, torch.from_numpy(Am), torch.from_numpy(Bm)).numpy()
    want = np.asarray(jax_sddmm(Cj, jnp.asarray(Am), jnp.asarray(Bm),
                                impl="xla"))
    assert got.shape == want.shape and not got[mat.nnz:].any()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("build", ["csr", "btile"])
def test_bench_spmm_and_sddmm_on_cpu(build):
    mat = btile_banded(1100, 1300, 9, 64, 3)
    host = HostCSR.from_scipy(mat)
    A = {"csr": build_csr, "btile": build_btile}[build](host)
    cfg = BenchConfig(**TINY)
    X = spmm_inputs(host, 8)
    Am, Bm = sddmm_inputs(host, 8)
    # the JAX runners' seeds and draws
    assert np.array_equal(X, np.random.Generator(np.random.PCG64(11))
                          .uniform(0, 1, (1300, 8)))
    r = bench_spmm(host, A, config=cfg, impl="torch", matrix_name="b")
    assert (r.workload, r.format_name, r.impl, r.k) == (
        "spmm", A.format_name, "torch", 8)
    assert r.out.shape == (1100, 8) and r.num_loops >= 2 and r.gflops > 0
    _near(mat, X, r.out, mat @ X, tol=1e-6)
    assert r.metrics.max_rel_err < 1e-5 and r.mape == r.metrics.mape
    s = bench_sddmm(host, A, config=cfg, impl="torch", matrix_name="b")
    assert s.workload == "sddmm" and s.out.shape == (mat.nnz,)
    gold = sddmm_gold(host, Am, Bm)
    rows = np.repeat(np.arange(1100), np.diff(mat.indptr))
    assert np.allclose(gold, np.sum(Am[rows] * Bm[mat.indices], axis=1),
                       rtol=1e-14, atol=0)
    assert np.max(np.abs(s.out - gold) / gold) < 1e-5
    assert s.gflops == pytest.approx(2.0 * mat.nnz * 8 / s.time_iter_median
                                     * 1e-9)


@pytest.mark.parametrize("inner", [None, 3])
def test_inner_iters_sets_the_timed_batch(inner):
    """One rule for the SpMV, SpMM and SDDMM chains: ``inner_iters`` calls
    per timed batch, 64 when unset."""
    mat = btile_banded(300, 300, 5, 40, 4)
    host = HostCSR.from_scipy(mat)
    A = build_csr(host)
    cfg = BenchConfig(min_num_loops=1, min_time_s=0.0, warmup_iters=1,
                      inner_iters=inner, k_dim=2)
    runs = (bench_spmv(host, A, config=cfg, impl="torch"),
            bench_spmm(host, A, config=cfg, impl="torch"),
            bench_sddmm(host, A, config=cfg, impl="torch"))
    assert [r.num_loops for r in runs] == [inner or 64] * 3


def test_fold_resizes_2d():
    X = torch.ones((5, 3))
    for Y in (torch.arange(12.0).view(4, 3), torch.arange(21.0).view(7, 3),
              torch.arange(6.0)):
        F = fold(X, Y)
        assert F.shape == X.shape
        flat = Y.reshape(-1).repeat(3)[:15]
        assert torch.equal(F, X + flat.view(5, 3) * 1e-30)
    x = torch.ones(5)                    # the 1-D fold is as before
    assert torch.equal(fold(x, torch.arange(2.0)),
                       x + torch.tensor([0., 1., 0., 1., 0.]) * 1e-30)
    assert torch.equal(fold(x, torch.arange(7.0)),        # cut to x's size
                       x + torch.arange(5.0) * 1e-30)


def test_sweep_writes_workload_csvs(tmp_path, capsys):
    fmts = ("csr", "btile", "dense", "sellw")
    res = run_sweep([BANDED_LINE], formats=fmts, workloads=("spmm", "sddmm"),
                    out_dir=str(tmp_path), config=BenchConfig(**TINY),
                    device="cpu")
    labels = jax_labels_for("spmm", True)
    assert labels == jax_labels_for("sddmm", True)
    pairs = [("csr", "spmm"), ("csr", "sddmm"), ("btile", "spmm"),
             ("btile", "sddmm"), ("dense", "spmm"), ("sellw", "spmm")]
    assert sorted(p.name for p in tmp_path.glob("*.csv")) == sorted(
        f"{f}_{w}.csv" for f, w in pairs)
    for f, w in pairs:
        # CSR's SDDMM has two impls, gather (JAX's name) and torch
        impls = ["gather", "torch"] if (f, w) == ("csr", "sddmm") else [
            "torch"]
        lines = (tmp_path / f"{f}_{w}.csv").read_text().splitlines()
        assert lines[0] == labels and len(lines) == 1 + len(impls)
        for line, impl in zip(lines[1:], impls):
            cells = line.split(",")
            assert len(cells) == len(labels.split(","))
            assert cells[:4] == ["shipsec1_twin", f.upper(), impl, "8"]
    assert sorted((r.format_name, r.workload) for r in res) == sorted(
        [(f.upper(), w) for f, w in pairs] + [("CSR", "sddmm")])
    for r in res:
        assert r.metrics.max_rel_err < 1e-5 and r.num_loops >= 2
    out = capsys.readouterr().out
    assert "DENSE/torch has no sddmm: skipped" in out
    assert "SELLW/torch has no sddmm: skipped" in out


def test_sweep_skips_btile_spmv_and_keeps_the_gate(tmp_path):
    """BTILE has no SpMV: the pair is skipped; and the gate class is the
    workloads module's (re-exported by the sweep, as in the JAX package)."""
    assert run_sweep([BANDED_LINE], formats=("btile",), workloads=("spmv",),
                     out_dir=str(tmp_path), config=BenchConfig(**TINY),
                     device="cpu") == []
    assert BenchGateError.__module__.endswith("harness.workloads")
    assert jax_workloads.BenchGateError.__name__ == BenchGateError.__name__
