"""SpGEMM in the port against the JAX package.

The host plans (``spgemm_symbolic``, the row blocks, ``device_plan``) must
give the JAX package's arrays (``np.array_equal``, dtypes too) on the
cases of ``tests/test_spgemm_ilu.py``, on a pair budget that cuts A into
several blocks (one of them empty), and on a matrix whose output segment
spans more than two lane rows (two carry stages); the numeric phase must
match JAX's on the same planes within 1e-6 of max |C|, ``spgemm`` scipy's
product and JAX's; ``bench_spgemm`` on the CPU JAX's ``nnz_c``,
``n_blocks`` and ``checked_frac``; and the sweep's ``spgemm`` workload
must run once per matrix into ``spgemm.csv`` under the JAX labels.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import workloads as jax_workloads
from spmv_research_tpu.harness.config import BenchConfig as JaxBenchConfig
from spmv_research_tpu.harness.sweep import _labels_for as jax_labels_for

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness.sweep import SweepDoneLog
from spmv_research_tpu_torch.harness.workloads import bench_spgemm
from spmv_research_tpu_torch.ops import spgemm as sg

from torch_cases import TWIN_LINE, random_matrix

jax_sg = importlib.import_module("spmv_research_tpu.ops.spgemm")

PLAN_FIELDS = ("c_ia", "c_ja", "a_idx", "b_idx", "seg")
DEVICE_FIELDS = ("av", "bv", "guard", "rowg", "cross_lane", "headmask",
                 "head", "c_ia", "c_ja")
META_FIELDS = ("nnz_c", "npairs", "stages", "cstages", "r0", "r1")
TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1, inner_iters=2)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want, fields):
    for f in fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def long_segment_matrix():
    """A 600 × 600 sparse background plus a dense row 0 and a dense column
    0: C(0, 0) of A·A sums 600 pairs, a segment over five lane rows of the
    numeric plane, so the row carries take two scan stages."""
    mat = random_matrix(600, 600, 0.01, 41).tolil()
    mat[0, :] = np.linspace(0.5, 1.0, 600)
    mat[:, 0] = np.linspace(-1.0, -0.5, 600)[:, None]
    mat = mat.tocsr()
    mat.sort_indices()
    return mat


def trailing_empty_matrix():
    """200 × 200, 3% dense, row 179 dense and the last 20 rows empty: under
    a pair budget below row 179's ≈ 1,200 pairs the empty rows form a
    block of their own."""
    mat = random_matrix(200, 200, 0.03, 43).tolil()
    mat[179, :] = np.linspace(-1.0, 1.0, 200) + 0.001
    mat[180:, :] = 0.0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat


# (A, B, pair budget): test_spgemm_ilu.py's shapes, a squares, a budget
# that forces blocks, the long segment
CASES = {
    "ab_50x40x60": (random_matrix(50, 40, 0.1, 1),
                    random_matrix(40, 60, 0.1, 2), sg.PAIR_BUDGET),
    "ab_80": (random_matrix(80, 80, 0.05, 3),
              random_matrix(80, 80, 0.08, 4), sg.PAIR_BUDGET),
    "a_squared_64": (random_matrix(64, 64, 0.08, 5), None, sg.PAIR_BUDGET),
    "plan_reuse_40": (random_matrix(40, 40, 0.1, 6), None, sg.PAIR_BUDGET),
    "blocks_with_empty": (trailing_empty_matrix(), None, 1000),
    "long_segment": (long_segment_matrix(), None, sg.PAIR_BUDGET),
}


def _hosts(case):
    a, b, budget = CASES[case]
    b = a if b is None else b
    return (HostCSR.from_scipy(a), HostCSR.from_scipy(b),
            JaxHostCSR.from_scipy(a), JaxHostCSR.from_scipy(b), budget, a, b)


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    """Both packages' device plans of one case, built once."""
    A, B, Aj, Bj, budget, a, b = _hosts(request.param)
    got = sg.spgemm_device_plans(A, B, torch.float32, budget, device="cpu")
    want = jax_sg.spgemm_device_plans(Aj, Bj, jnp.float32, budget)
    return request.param, got, want, a, b


@pytest.mark.parametrize("case", sorted(CASES))
def test_symbolic_plan_matches_jax(case):
    A, B, Aj, Bj, budget, _, _ = _hosts(case)
    got, want = sg.spgemm_symbolic(A, B), jax_sg.spgemm_symbolic(Aj, Bj)
    _same(got, want, PLAN_FIELDS)
    assert (got.nnz_c, got.shape) == (want.nnz_c, want.shape)
    assert sg._row_blocks_by_pairs(A, B, budget) == \
        jax_sg._row_blocks_by_pairs(Aj, Bj, budget)


def test_device_plans_match_jax(plans):
    case, got, want, _, _ = plans
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w, DEVICE_FIELDS)
        assert [getattr(g, f) for f in META_FIELDS] == \
            [getattr(w, f) for f in META_FIELDS]
    if case == "blocks_with_empty":
        assert len(got) >= 3 and any(g.npairs == 0 for g in got)
    if case == "long_segment":
        assert max(g.cstages for g in got) >= 2


def test_numeric_plane_matches_jax(plans):
    """The same planes through both numeric phases: within 1e-6 of max |C|
    (XLA on the CPU may contract the first product into its adds)."""
    _, got, want, _, _ = plans
    for g, w in zip(got, want):
        if g.nnz_c == 0:
            continue
        pg, pw = g.numeric_plane().numpy(), np.asarray(w.numeric_plane())
        assert pg.shape == pw.shape
        assert np.max(np.abs(pg - pw)) <= 1e-6 * np.max(np.abs(pw))
        assert np.array_equal(pg != 0, pw != 0)


def test_spgemm_matches_scipy_and_jax(plans):
    case, _, _, a, b = plans
    A, B, Aj, Bj, budget, _, _ = _hosts(case)
    C = sg.spgemm(A, B, pair_budget=budget, device="cpu")
    Cj = jax_sg.spgemm(Aj, Bj, pair_budget=budget)
    ref = (a @ b).tocsr()
    ref.sort_indices()
    assert np.array_equal(C.ia, ref.indptr) and np.array_equal(C.ja,
                                                               ref.indices)
    assert np.array_equal(C.ia, Cj.ia) and np.array_equal(C.ja, Cj.ja)
    scale = np.max(np.abs(ref.data))
    assert np.max(np.abs(C.a - ref.data)) <= 1e-6 * scale
    assert np.max(np.abs(C.a - Cj.a)) <= 1e-6 * scale


def test_plan_numeric_reuse():
    """test_spgemm_plan_reuse: new values through the same plan, and the
    plan's numeric against JAX's."""
    a = CASES["plan_reuse_40"][0]
    A = HostCSR.from_scipy(a)
    plan = sg.spgemm_symbolic(A, A)
    jplan = jax_sg.spgemm_symbolic(JaxHostCSR.from_scipy(a),
                                   JaxHostCSR.from_scipy(a))
    av = torch.as_tensor(A.a, dtype=torch.float32)
    v1 = plan.numeric(av, av).numpy()
    v2 = plan.numeric(2 * av, 2 * av).numpy()
    vj = np.asarray(jplan.numeric(jnp.asarray(A.a, jnp.float32),
                                  jnp.asarray(A.a, jnp.float32)))
    np.testing.assert_allclose(v2, 4 * v1, rtol=1e-6)
    assert np.max(np.abs(v1 - vj)) <= 1e-6 * np.max(np.abs(vj))


@pytest.mark.parametrize("case", ["a_squared_64", "blocks_with_empty"])
def test_bench_spgemm_matches_jax(case, monkeypatch):
    """bench_spgemm on the CPU: JAX's nnz_c, n_blocks and checked_frac,
    C within 1e-6 of max |gold|, the CSR-ESC/torch row (the small budget
    through the module function both runners call)."""
    a, _, budget = CASES[case]
    for mod in (sg, jax_sg):
        monkeypatch.setattr(mod, "spgemm_device_plans", functools.partial(
            mod.spgemm_device_plans, pair_budget=budget))
    r = bench_spgemm(HostCSR.from_scipy(a), config=BenchConfig(**TINY),
                     matrix_name=case, device="cpu")
    rj = jax_workloads.bench_spgemm(JaxHostCSR.from_scipy(a),
                                    config=JaxBenchConfig(**TINY),
                                    matrix_name=case)
    for f in ("nnz_c", "n_blocks", "checked_frac"):
        assert r.extra[f] == rj.extra[f], f
    assert set(r.extra) == set(rj.extra)
    assert r.max_ae == r.mape <= 1e-6 and r.extra["checked_frac"] == 1.0
    assert (r.workload, r.format_name, r.impl, r.k) == (
        "spgemm", "CSR-ESC", "torch", 0)
    assert (rj.format_name, rj.impl) == ("CSR-ESC", "xla")
    npairs = sum(p.npairs for p in sg.spgemm_device_plans(
        HostCSR.from_scipy(a), HostCSR.from_scipy(a), device="cpu"))
    assert r.gflops == pytest.approx(2 * npairs / r.time_iter_median * 1e-9)
    if case == "blocks_with_empty":
        assert r.extra["n_blocks"] >= 2


def test_sweep_spgemm_once_per_matrix(tmp_path):
    """``spgemm`` runs once per matrix, whatever the formats: one row in
    spgemm.csv under the JAX labels, the done-log key (matrix, spgemm),
    and a rerun skips it."""
    cfg = BenchConfig(**TINY)
    res = run_sweep([TWIN_LINE], formats=("csr",),
                    workloads=("spgemm", "spmv"), out_dir=str(tmp_path),
                    config=cfg, device="cpu")
    gemm = [r for r in res if getattr(r, "workload", "") == "spgemm"]
    assert len(gemm) == 1 and len(res) == 1 + 2      # CSR torch + sparse
    lines = (tmp_path / "spgemm.csv").read_text().splitlines()
    assert lines[0] == jax_labels_for("spgemm", True) and len(lines) == 2
    assert lines[1].split(",")[:4] == ["scircuit_twin", "CSR-ESC", "torch",
                                       "0"]
    r = gemm[0]
    assert r.max_ae <= 1e-6 and r.extra["checked_frac"] == 1.0
    assert SweepDoneLog(str(tmp_path)).skip("scircuit_twin", "spgemm")
    assert run_sweep([TWIN_LINE], formats=("csr",), workloads=("spgemm",),
                     out_dir=str(tmp_path), config=cfg, device="cpu") == []
