"""IC(0)/ILU(0), the three triangular-solve schedules and their solves in
the PyTorch port against the JAX package, on the CPU.

* The factors (``ilu0``, ``ic0``) and every schedule (level, chunked, band
  blocks, with and without the outlier channel, lower and upper) are built
  by both packages from the same matrix, on the cases of
  ``tests/test_spgemm_ilu.py`` and ``tests/test_band_trisolve.py``, and
  must hold equal arrays.
* Each solve kind (``sptrsv``) against the JAX package's on the same b,
  within 1e-5 of max |x|: both sum a row's terms in float32, XLA and
  PyTorch in their own orders; the band solve's block products are float32
  ``torch.mv`` with TF32 off against XLA's float32 dot.
* A zero diagonal in the band-block build raises ``BandScheduleError``, so
  ``build_schedule`` falls back to the level schedule (the JAX package
  raises a plain ``ValueError`` there).
* CG + IC(0) and BiCGStab + ILU(0) take the JAX package's iteration counts
  and agree on x within 1e-5 of max |x|, on the systems of
  ``tests/test_solvers.py``; ``make_precond_state``'s band schedules give
  the same iterations as the level schedules.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spmv_research_tpu.convert import build_csr as jax_build_csr
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.solvers import ilu as J
from spmv_research_tpu.solvers.cg import (solve_bicgstab_ilu0 as jax_bicg,
                                          solve_cg_ic0 as jax_cg)

from spmv_research_tpu_torch.convert import build_csr
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.solvers import (make_precond,
                                             make_precond_state, cg,
                                             solve_bicgstab_ilu0,
                                             solve_cg_ic0)
from spmv_research_tpu_torch.solvers import ilu as P

from torch_cases import banded_matrix

CPU = torch.device("cpu")


def _dd_matrix(m, seed=1234):
    """``test_spgemm_ilu.py``'s diagonally dominant matrix."""
    rng = np.random.Generator(np.random.PCG64(seed))
    B = sp.random(m, m, 0.06, random_state=np.random.RandomState(2),
                  data_rvs=lambda k: rng.uniform(-1, 1, k))
    A = (B + sp.identity(m) * (m * 0.2)).tocsr()
    A.sort_indices()
    return A


def _banded_lower(m, band, seed=0, unit_diag=False):
    """``test_band_trisolve.py``'s banded lower factor."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(m):
        lo = max(0, i - band)
        js = rng.choice(np.arange(lo, i), size=min(4, i - lo),
                        replace=False) if i > lo else []
        for j in js:
            rows.append(i)
            cols.append(j)
        rows.append(i)
        cols.append(i)
    vals = rng.uniform(0.5, 1.5, len(rows))
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    d = A.diagonal()
    A.setdiag(1.0 if unit_diag else d + 4.0)
    return A


def _outliers(m, band, seed, lo_rows, hi_cols, k, rseed):
    A = _banded_lower(m, band, seed=seed).tolil()
    rng = np.random.default_rng(rseed)
    for i in rng.integers(lo_rows, m, k):
        A[int(i), int(rng.integers(0, hi_cols))] = rng.uniform(0.1, 0.5)
    return A.tocsr()


def _outliers_upper():
    L = _banded_lower(900, 50, seed=31).tolil()
    rng = np.random.default_rng(5)
    for i in rng.integers(0, 150, 10):
        L[int(rng.integers(750, 900)), int(i)] = rng.uniform(0.1, 0.5)
    return sp.csr_matrix(L.tocsr().T)


def _ilu_factors(m):
    A = _dd_matrix(m)
    return J.ilu0(JaxHostCSR.from_scipy(A))


# name -> (matrix, lower, builder keyword arguments)
BAND_CASES = {
    "lower_300_40": (lambda: _banded_lower(300, 40, seed=300), True,
                     dict(B=128)),
    "lower_700_300": (lambda: _banded_lower(700, 300, seed=700), True,
                      dict(B=128)),
    "lower_1000_129": (lambda: _banded_lower(1000, 129, seed=1000), True,
                       dict(B=128)),
    "upper_500_100": (lambda: sp.csr_matrix(_banded_lower(500, 100,
                                                          seed=11).T),
                      False, dict(B=128)),
    "outlier_lower": (lambda: _outliers(1200, 60, 21, 700, 80, 15, 4), True,
                      dict(B=128, max_bytes=10 * 128 * 128 * 4 * 2 + 64)),
    "outlier_upper": (_outliers_upper, False,
                      dict(B=128, max_bytes=8 * 128 * 128 * 4 * 2 + 64)),
}


def _factor(name):
    """(scipy matrix, lower) of a named triangular case."""
    if name in BAND_CASES:
        make, lower, _ = BAND_CASES[name]
        return make(), lower
    L, U = _ilu_factors(100)
    return (L if name == "ilu_L" else U).to_scipy().tocsr(), name == "ilu_L"


def _hosts(mat):
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


def _same_fields(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, torch.Tensor):
            assert a.device == CPU, f
            assert np.array_equal(a.numpy(), np.asarray(b)), f
        else:
            assert a == b, f


def _same_csr(got, want):
    assert (got.m, got.n) == (want.m, want.n)
    for f in ("ia", "ja", "a"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


LEVEL = ("rows", "cols", "vals", "inv_diag", "n_levels", "m", "lower")
CHUNK = ("cols", "vals", "sid", "rows", "invd", "cont", "tail", "last_sid",
         "n_chunks", "m", "C", "lower")
BAND = ("invD", "C", "olcols", "olvals", "olrow", "m", "B", "Q", "K",
        "lower")


# ------------------------------------------------------------- factors

def _banded(spd):
    """A 600-row banded matrix (random normal values, diagonal filled),
    or its ``make_spd`` transform."""
    from spmv_research_tpu_torch.convert import fix_diagonal_zeros, make_spd
    h = HostCSR.from_scipy(banded_matrix(600, 600, 40, 12, 5))
    return (make_spd(h) if spd else fix_diagonal_zeros(h)).to_scipy()


def _near_singular():
    """Pivots that vanish: ILU(0) floors them at 1e-4 of the row scale."""
    A = sp.diags([np.ones(49), np.ones(50), np.ones(49)], [-1, 0, 1]).tolil()
    for i in range(1, 50, 2):
        A[i, i] = 2.0 + 1e-9 if i % 4 == 1 else 2.0
    return A.tocsr()


FACTOR_CASES = {"dd60": lambda: _dd_matrix(60), "dd100": lambda: _dd_matrix(100),
                "banded": lambda: _banded(False),
                "banded_spd": lambda: _banded(True),
                "near_singular": _near_singular}


@pytest.mark.parametrize("name", sorted(FACTOR_CASES))
def test_ilu0_factors_identical(name):
    """The port's ilu0 (each row's pattern work at once) equals the JAX
    package's row sweep bit for bit, perturbed pivots included."""
    h, hj = _hosts(FACTOR_CASES[name]())
    for got, want in zip(P.ilu0(h), J.ilu0(hj)):
        _same_csr(got, want)


def test_ilu0_exact_on_full_pattern():
    rng = np.random.Generator(np.random.PCG64(1234))
    D = rng.uniform(-1, 1, (12, 12)) + np.eye(12) * 12
    h, hj = _hosts(sp.csr_matrix(D))
    L, U = P.ilu0(h)
    for got, want in zip((L, U), J.ilu0(hj)):
        _same_csr(got, want)
    np.testing.assert_allclose((L.to_scipy() @ U.to_scipy()).toarray(), D,
                               rtol=1e-10, atol=1e-10)


def _random_spd():
    B = sp.random(60, 60, 0.08, random_state=np.random.RandomState(3))
    A = (B @ B.T + sp.identity(60) * 60).tocsr()
    A.sort_indices()
    return A


@pytest.mark.parametrize("name", ["random_spd", "banded_spd"])
def test_ic0_identical_on_spd(name):
    A = _random_spd() if name == "random_spd" else _banded(True)
    h, hj = _hosts(A)
    _same_csr(P.ic0(h), J.ic0(hj))


def test_factor_guards_match_jax():
    """A missing diagonal and a non-SPD matrix raise as in the JAX
    package; ic0 refuses unsorted rows, which HostCSR never holds."""
    A = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 0.0]]))
    A.eliminate_zeros()
    h, hj = _hosts(A)
    for ilu in (P.ilu0, J.ilu0):
        with pytest.raises(ValueError, match="missing diagonal in row 1"):
            ilu(h if ilu is P.ilu0 else hj)
    B = sp.csr_matrix(np.array([[1.0, 2.0], [2.0, 1.0]]))
    h, hj = _hosts(B)
    for ic in (P.ic0, J.ic0):
        with pytest.raises(ValueError, match="IC0 breakdown at row 1"):
            ic(h if ic is P.ic0 else hj)
    bad = HostCSR(a=np.ones(3), ia=np.array([0, 2, 3], np.int32),
                  ja=np.array([1, 0, 1], np.int32), m=2, n=2)
    with pytest.raises(ValueError, match="sorted"):
        P.ic0(bad)


# ----------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["ilu_L", "ilu_U", "lower_700_300",
                                  "upper_500_100"])
def test_level_schedule_identical(name):
    mat, lower = _factor(name)
    h, hj = _hosts(mat)
    got = P.build_level_schedule(h, lower=lower, device=CPU)
    _same_fields(got, J.build_level_schedule(hj, lower=lower), LEVEL)
    assert got.vals.dtype == torch.float32 and got.rows.dtype == torch.int32


@pytest.mark.parametrize("C", [3, 16, 512])
@pytest.mark.parametrize("name", ["ilu_L", "ilu_U", "lower_300_40"])
def test_chunk_schedule_identical(name, C):
    """At C = 3 rows straddle chunks (the carry), at 16 and 512 none do."""
    mat, lower = _factor(name)
    h, hj = _hosts(mat)
    got = P.build_chunk_schedule(h, lower=lower, C=C, device=CPU)
    want = J.build_chunk_schedule(hj, lower=lower, C=C)
    _same_fields(got, want, CHUNK)
    widest = int(np.diff(mat.indptr).max()) - 1     # off-diagonal slots
    assert bool(got.tail.any()) == (C < widest)


@pytest.mark.parametrize("name", sorted(BAND_CASES))
def test_band_schedule_identical(name):
    make, lower, kw = BAND_CASES[name]
    h, hj = _hosts(make())
    got = P.build_band_block_schedule(h, lower=lower, device=CPU, **kw)
    _same_fields(got, J.build_band_block_schedule(hj, lower=lower, **kw),
                 BAND)
    assert (got.olvals.shape[1] > 0) == name.startswith("outlier")


@pytest.mark.parametrize("name", ["ilu_L", "ilu_U", "lower_700_300"])
def test_build_schedule_picks_as_jax(name):
    mat, lower = _factor(name)
    h, hj = _hosts(mat)
    got = P.build_schedule(h, lower=lower, device=CPU)
    want = J.build_schedule(hj, lower=lower)
    assert type(got).__name__ == type(want).__name__
    assert got.n_levels == want.n_levels


def test_budget_gates_match_jax():
    """The band budget and the level schedule's padding budget refuse the
    same matrices, and build_schedule falls back as JAX's does."""
    h, hj = _hosts(_banded_lower(400, 300, seed=3))
    with pytest.raises(P.BandScheduleError):
        P.build_band_block_schedule(h, B=128, max_bytes=1000, device=CPU)
    with pytest.raises(J.BandScheduleError):
        J.build_band_block_schedule(hj, B=128, max_bytes=1000)
    assert issubclass(P.SchedulePaddingError, ValueError)


def test_zero_diagonal_band_falls_back_to_levels():
    """A zero diagonal entry stored in the band: the port's band builder
    raises BandScheduleError and build_schedule takes the level schedule,
    which refuses the zero pivot itself (the JAX band builder raises a
    ValueError that its build_schedule lets through)."""
    A = _banded_lower(300, 40, seed=300).tolil()
    A[5, 5] = 0.0
    h, hj = _hosts(A.tocsr())
    with pytest.raises(P.BandScheduleError, match="zero diagonal"):
        P.build_band_block_schedule(h, B=128, device=CPU)
    with pytest.raises(ValueError, match="zero diagonal") as e:
        J.build_band_block_schedule(hj, B=128)
    assert not isinstance(e.value, J.BandScheduleError)
    with pytest.raises(ValueError, match="missing/zero diagonal at row 5"):
        P.build_schedule(h, lower=True, device=CPU)


# -------------------------------------------------------------- solves

SOLVE_CASES = [("level", "ilu_L"), ("level", "ilu_U"),
               ("chunk3", "ilu_L"), ("chunk3", "ilu_U"),
               ("chunk512", "lower_300_40"),
               *(("band", n) for n in sorted(BAND_CASES))]


@pytest.mark.parametrize("kind, name", SOLVE_CASES)
def test_sptrsv_matches_jax(kind, name):
    mat, lower = _factor(name)
    h, hj = _hosts(mat)
    if kind == "level":
        s = P.build_level_schedule(h, lower=lower, device=CPU)
        sj = J.build_level_schedule(hj, lower=lower)
    elif kind.startswith("chunk"):
        C = int(kind[5:])
        s = P.build_chunk_schedule(h, lower=lower, C=C, device=CPU)
        sj = J.build_chunk_schedule(hj, lower=lower, C=C)
    else:
        kw = BAND_CASES[name][2]
        s = P.build_band_block_schedule(h, lower=lower, device=CPU, **kw)
        sj = J.build_band_block_schedule(hj, lower=lower, **kw)
    b = np.random.default_rng(5).uniform(-1, 1, mat.shape[0])
    x = P.sptrsv(s, torch.as_tensor(b, dtype=torch.float32))
    xj = np.asarray(J.sptrsv(sj, jnp.asarray(b, jnp.float32)), np.float64)
    assert x.shape == (mat.shape[0],) and x.dtype == torch.float32
    assert np.abs(x.double().numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    ref = sp.linalg.spsolve_triangular(mat.tocsr(), b, lower=lower)
    np.testing.assert_allclose(x.double().numpy(), ref, rtol=2e-4,
                               atol=2e-4)


def test_ilu0_solve_matches_jax():
    L, U = P.ilu0(HostCSR.from_scipy(_dd_matrix(100)))
    Lj, Uj = _ilu_factors(100)
    b = np.random.default_rng(2).uniform(-1, 1, 100)
    x = P.ilu0_solve(P.build_schedule(L, True, device=CPU),
                     P.build_schedule(U, False, device=CPU),
                     torch.as_tensor(b, dtype=torch.float32))
    xj = np.asarray(J.ilu0_solve(J.build_schedule(Lj, True),
                                 J.build_schedule(Uj, False),
                                 jnp.asarray(b, jnp.float32)), np.float64)
    assert np.abs(x.double().numpy() - xj).max() <= 1e-5 * np.abs(xj).max()


# ------------------------------------------------------------- solvers

def _cg_system():
    m = 400
    A = sp.diags([-np.ones(m), 4.2 * np.ones(m), -np.ones(m),
                  -0.5 * np.ones(m), -0.5 * np.ones(m)],
                 [-1, 0, 1, -20, 20], shape=(m, m), format="csr")
    return A


def _bicg_system():
    m = 300
    return sp.diags([-1.3 * np.ones(m), 5.0 * np.ones(m), -0.7 * np.ones(m),
                     -0.9 * np.ones(m)], [-1, 0, 1, 15], shape=(m, m),
                    format="csr")


@pytest.mark.parametrize("solver", ["cg_ic0", "bicgstab_ilu0"])
def test_preconditioned_solvers_match_jax(solver):
    A = _cg_system() if solver == "cg_ic0" else _bicg_system()
    h, hj = _hosts(A)
    b = np.random.Generator(np.random.PCG64(1234)).uniform(0, 1, A.shape[0])
    ours, theirs = ((solve_cg_ic0, jax_cg) if solver == "cg_ic0"
                    else (solve_bicgstab_ilu0, jax_bicg))
    x, info = ours(h, build_csr(h), b, max_iters=200, rtol=1e-5)
    xj, info_j = theirs(hj, jax_build_csr(hj, dtype=jnp.float32), b,
                        max_iters=200, rtol=1e-5)
    assert int(info["iterations"]) == int(info_j["iterations"])
    assert bool(info["converged"]) and bool(info_j["converged"])
    xj = np.asarray(xj, np.float64)
    assert np.abs(x.double().numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    res = np.linalg.norm(A @ x.double().numpy() - b) / np.linalg.norm(b)
    assert res < 1e-4


@pytest.mark.parametrize("precond", ["ic0", "ilu0"])
def test_precond_state_applies_its_factors(precond):
    """``make_precond_state`` (band schedules here) and ``make_precond``
    (level schedules) apply the same M⁻¹ within 1e-5, and CG on them takes
    the same iterations."""
    A = _cg_system()
    h = HostCSR.from_scipy(A)
    apply_fn, state = make_precond_state(h, precond, device="cpu")
    assert all(isinstance(s, P.BandBlockSchedule) for s in state)
    plain = make_precond(h, precond, device="cpu")
    r = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, A.shape[0]),
                        dtype=torch.float32)
    want = plain(r)
    assert (apply_fn(state, r) - want).abs().max() <= 1e-5 * want.abs().max()
    bd = torch.as_tensor(np.ones(A.shape[0]), dtype=torch.float32)
    its = [int(cg(build_csr(h), bd, precond_fn=f, max_iters=200,
                  rtol=1e-5)[1]["iterations"])
           for f in (plain, lambda v: apply_fn(state, v))]
    assert its[0] == its[1]
