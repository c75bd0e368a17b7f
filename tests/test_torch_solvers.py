"""CG and BiCGStab in the PyTorch port against the JAX solvers, and the
port's ``bench_cg``.

Solver parity, on the CPU: the same SPD system (``make_spd``) or
diagonally dominant one (``make_diag_dominant``), the same b, each package
on its own CSR. The iteration count and the ``converged`` flag must be
equal and x must agree within 1e-5 of max |x| (fp32 throughout; the dot
products reduce in another order than XLA's). The cases stop well away
from the tolerance (no borderline stop), one of them fires the
explicit-residual check, one stops at ``max_iters``. The device-side loop
(masked updates, the host polling every few iterations) must give the same
result whatever the poll interval.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spmv_research_tpu.convert import (build_csr as jax_build_csr,
                                       make_diag_dominant as jax_dd,
                                       make_spd as jax_spd)
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.solvers import (solve_bicgstab as jax_bicgstab,
                                       solve_cg as jax_cg)

from spmv_research_tpu_torch.convert import (build_csr, make_diag_dominant,
                                             make_spd)
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.harness import BenchConfig, bench_cg
from spmv_research_tpu_torch.harness.workloads import BenchGateError
from spmv_research_tpu_torch.ops import build_csrds, build_sellwds, spmv
from spmv_research_tpu_torch.solvers import (bicgstab, cg, make_precond,
                                             make_precond_state,
                                             solve_bicgstab, solve_cg)

from torch_cases import TWIN_LINE, banded_matrix

CG_CASES = {
    # converges in ~10 iterations; the explicit residual fires at 4 and 9
    "check_fires": dict(max_iters=200, rtol=1e-6, check_every=5),
    # stopped by max_iters
    "max_iters": dict(max_iters=3, rtol=1e-30),
    # the defaults: the cap of 50 sets the check cadence to 50
    "defaults": dict(),
}
JAX_EXTRA_KEYS = {"converged", "relative_residual", "solve_time",
                  "precond_setup_time", "compile_time"}


def _systems(transform, m=400, seed=1):
    """(port host, JAX host, b): the transform of a seeded random square
    matrix with a diagonal, and b uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    mat = (sp.random(m, m, 0.02, random_state=np.random.RandomState(seed))
           + sp.diags(rng.uniform(1, 2, m))).tocsr()
    port, jax_tf = {"spd": (make_spd, jax_spd),
                    "dd": (make_diag_dominant, jax_dd)}[transform]
    return (port(HostCSR.from_scipy(mat)), jax_tf(JaxHostCSR.from_scipy(mat)),
            rng.uniform(0, 1, m))


def _agree(x, info, xj, info_j):
    assert int(info["iterations"]) == int(info_j["iterations"])
    assert bool(info["converged"]) == bool(info_j["converged"])
    xj = np.asarray(xj, np.float64)
    assert np.abs(x.double().numpy() - xj).max() <= 1e-5 * np.abs(xj).max()


@pytest.mark.parametrize("case", sorted(CG_CASES))
def test_cg_matches_jax(case):
    h, hj, b = _systems("spd")
    kw = CG_CASES[case]
    x, info = solve_cg(h, build_csr(h), b, **kw)
    xj, info_j = jax_cg(hj, jax_build_csr(hj, dtype=jnp.float32), b,
                        impl="xla", **kw)
    _agree(x, info, xj, info_j)
    assert bool(info["converged"]) == (case != "max_iters")
    if case == "max_iters":
        assert int(info["iterations"]) == info["loop_iterations"] == 3


def test_cg_explicit_residual_check_runs_its_spmvs():
    """With check_every = 5 the check's extra SpMV runs at iterations 4, 9,
    …: one SpMV for r0, one per loop iteration, one per check."""
    h, _, b = _systems("spd")
    A = build_csr(h)
    calls = []

    def mv(v):
        calls.append(1)
        return spmv(A, v)

    inv = make_precond_state(h, "jacobi", device="cpu")[1]
    x, info = cg(A, torch.as_tensor(b, dtype=torch.float32), inv_diag=inv,
                 max_iters=200, rtol=1e-6, check_every=5, spmv_fn=mv)
    loops = info["loop_iterations"]
    assert bool(info["converged"]) and loops >= 10
    assert len(calls) == 1 + loops + loops // 5


@pytest.mark.parametrize("m, seed", [(400, 1), (300, 4)])
def test_bicgstab_matches_jax(m, seed):
    h, hj, b = _systems("dd", m, seed)
    x, info = solve_bicgstab(h, build_csr(h), b, max_iters=100)
    xj, info_j = jax_bicgstab(hj, jax_build_csr(hj, dtype=jnp.float32), b,
                              impl="xla", max_iters=100)
    _agree(x, info, xj, info_j)
    assert bool(info["converged"])


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_poll_interval_does_not_change_the_result(solver, monkeypatch):
    # the module (the package's ``cg`` attribute is the function)
    cg_mod = importlib.import_module("spmv_research_tpu_torch.solvers.cg")
    h, _, b = _systems("spd" if solver == "cg" else "dd")
    fn = solve_cg if solver == "cg" else solve_bicgstab
    A = build_csr(h)
    monkeypatch.setattr(cg_mod, "POLL_EVERY", 1)
    x1, i1 = fn(h, A, b)
    monkeypatch.setattr(cg_mod, "POLL_EVERY", 9)
    x9, i9 = fn(h, A, b)
    assert torch.equal(x1, x9) and int(i1["iterations"]) == int(
        i9["iterations"])
    assert i1["loop_iterations"] == int(i1["iterations"])
    assert i9["loop_iterations"] >= int(i9["iterations"])


@pytest.mark.parametrize("build", [build_sellwds, build_csrds])
def test_cg_on_double_single_formats(build):
    """The DS formats' fp32 entries drive the solver like CSR."""
    h = make_spd(HostCSR.from_scipy(banded_matrix(1200, 1200, 150, 9, 3)))
    b = np.random.default_rng(0).uniform(0, 1, h.m)
    x, info = solve_cg(h, build(h), b)
    xc, info_c = solve_cg(h, build_csr(h), b)
    assert bool(info["converged"]) and bool(info_c["converged"])
    assert abs(int(info["iterations"]) - int(info_c["iterations"])) <= 1
    res = np.linalg.norm(h.to_scipy() @ x.double().numpy() - b)
    assert res <= 1e-5 * np.linalg.norm(b)


TINY = BenchConfig(min_num_loops=2, min_time_s=0.0, cg_max_num_iters=100)


@pytest.mark.parametrize("workload", ["cg", "bicgstab"])
def test_bench_cg_converges(workload):
    h, _, _ = _systems("spd" if workload == "cg" else "dd")
    r = bench_cg(h, build_csr(h), config=TINY, matrix_name="t",
                 bicgstab=workload == "bicgstab")
    assert r.workload == workload and r.k == 0 and r.impl == "auto"
    assert set(r.extra) == JAX_EXTRA_KEYS | {"loop_iterations",
                                             "time_divisor"}
    assert r.extra["converged"]
    assert r.mape == r.max_ae == r.extra["relative_residual"] < 1e-5
    assert r.num_loops > 0 and r.time_iter_median > 0 and r.gflops > 0
    assert r.out.shape == (h.m,)


@pytest.mark.parametrize("workload", ["cg", "bicgstab"])
def test_bench_cg_divides_by_the_loop_iterations(workload, monkeypatch):
    """The host loop polls every POLL_EVERY iterations and may run past
    convergence: the row divides the solve by the iterations it ran and
    records them; num_loops stays the counted iterations (the JAX
    schema's)."""
    cg_mod = importlib.import_module("spmv_research_tpu_torch.solvers.cg")
    monkeypatch.setattr(cg_mod, "POLL_EVERY", 9)
    h, _, _ = _systems("spd" if workload == "cg" else "dd")
    r = bench_cg(h, build_csr(h), config=TINY, matrix_name="t",
                 bicgstab=workload == "bicgstab")
    loops = r.extra["loop_iterations"]
    assert r.extra["time_divisor"] == "loop_iterations"
    assert loops % 9 == 0 and loops > r.num_loops > 0
    assert r.time_iter_median == r.extra["solve_time"] / loops
    flops_iter = (2.0 * h.nnz_expanded * (2 if workload == "bicgstab" else 1)
                  + 10.0 * h.m)
    assert r.gflops == pytest.approx(
        flops_iter * loops / r.extra["solve_time"] * 1e-9, rel=1e-12)


def test_bench_cg_gates_a_nonsymmetric_twin():
    """CG on the (nonsymmetric) scircuit twin makes no progress: a
    BenchGateError, as the JAX runner raises."""
    host = generate_from_line(TWIN_LINE)[0]
    with pytest.raises(BenchGateError, match="no progress"):
        bench_cg(host, build_csr(host), config=TINY, matrix_name="twin")


def test_ic0_and_ilu0_are_not_ported():
    """The preconditioners the port has: IC(0) and ILU(0) build and run
    through ``bench_cg`` (their impl label carries ``+ic0``/``+ilu0``), an
    unknown name raises, and Jacobi's apply is its inverse diagonal."""
    h, _, _ = _systems("spd", 50)
    for p in ("ic0", "ilu0"):
        r = torch.ones(h.m)
        assert torch.isfinite(make_precond(h, p, device="cpu")(r)).all()
        res = bench_cg(h, build_csr(h), config=TINY, impl="torch",
                       precond=p)
        assert res.impl == f"torch+{p}" and res.extra["converged"]
    with pytest.raises(ValueError, match="unknown"):
        make_precond(h, "ssor")
    r = torch.ones(h.m)
    assert torch.equal(make_precond(h, "jacobi", device="cpu")(r),
                       make_precond_state(h, "jacobi", device="cpu")[1])


def test_solvers_need_a_preconditioner():
    h, _, b = _systems("spd", 50)
    bt = torch.as_tensor(b, dtype=torch.float32)
    for fn in (cg, bicgstab):
        with pytest.raises(ValueError, match="inv_diag"):
            fn(build_csr(h), bt)


def test_preconditioners_default_to_the_card():
    """make_precond, make_precond_state and the Jacobi diagonal put their
    arrays on the card unless the caller asks for the CPU, as the JAX
    versions put them on the default device."""
    import inspect
    cg_mod = importlib.import_module("spmv_research_tpu_torch.solvers.cg")
    for fn in (make_precond, make_precond_state, cg_mod._jacobi_inv_diag):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
