"""The classic formats in the port against the JAX package.

Each builder (COO, ELL, SELL-C-σ, BSR, DIA, LDU, CSC, CSR_SYM) must give
the JAX builder's arrays (``np.array_equal``, dtypes too), meta fields and
``mem_footprint_bytes``; each of the 13 plain impls must be within 1e-5
of max |y| of JAX's ``xla`` impl on the very arrays JAX built
(``format_from_jax``), on ``tests/test_ops_reference.py``'s cases and
DIA's banded case; each refusal must raise the port's subclass of
``ValueError`` where JAX raises its own; and the sweep on the CPU must
write rows under JAX's format names and skip a refused BSR or CSR_SYM.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import spmv_research_tpu.convert.build as jax_build
from spmv_research_tpu.convert import csr_drop_upper as jax_drop_upper
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import bench as jax_bench
from spmv_research_tpu.ops import sddmm as jax_sddmm, spmm as jax_spmm
from spmv_research_tpu.ops import spmv as jax_spmv

import spmv_research_tpu_torch.convert.build as build
from spmv_research_tpu_torch.convert import (csr_drop_upper,
                                             csr_expand_symmetric,
                                             sigma_sort_rows)
from spmv_research_tpu_torch.core.formats import format_from_jax
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness import sweep as sweep_mod
from spmv_research_tpu_torch.ops import default_impl, sddmm, spmm, spmv
from spmv_research_tpu_torch.ops.dispatch import PLAIN_FORMATS

from torch_cases import BANDED_LINE, random_matrix

TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1, inner_iters=2,
            use_rcm_reordering="auto")


def _pathological():
    """test_ops_reference.py's: empty rows interleaved, one dense row,
    tall skinny, wide short."""
    rng = np.random.Generator(np.random.PCG64(1234))
    rows = np.array([0, 0, 4, 4, 4])
    cols = np.array([1, 3, 0, 2, 4])
    out = [sp.csr_matrix((rng.uniform(-1, 1, 5), (rows, cols)), shape=(6, 5))]
    r = np.concatenate([np.zeros(40, int), np.arange(1, 40)])
    c = np.concatenate([np.arange(40), rng.integers(0, 40, 39)])
    out.append(sp.csr_matrix((rng.uniform(-1, 1, r.size), (r, c)),
                             shape=(40, 40)))
    out += [random_matrix(200, 3, 0.3, 7), random_matrix(3, 200, 0.3, 8)]
    for m in out:
        m.sum_duplicates()
        m.sort_indices()
    return out


def _symmetric(m, seed):
    """test_ops_reference.py's CSR_SYM case: B + Bᵀ + a positive diagonal."""
    rng = np.random.Generator(np.random.PCG64(seed))
    B = sp.random(m, m, 0.06, random_state=np.random.RandomState(seed))
    mat = (B + B.T + sp.diags(rng.uniform(1, 2, m))).tocsr()
    mat.sort_indices()
    return mat


def _ldu(m=50, seed=1):
    """test_spmv_ldu's: a strict upper pattern, its mirror with other
    values, a diagonal."""
    rng = np.random.Generator(np.random.PCG64(seed))
    up = sp.triu(sp.random(m, m, 0.05, random_state=seed), k=1)
    low = sp.coo_matrix((rng.uniform(-1, 1, up.nnz), (up.col, up.row)),
                        shape=(m, m))
    mat = (up + low + sp.diags(rng.uniform(1, 2, m))).tocsr()
    mat.sort_indices()
    return mat


def _banded(m=64, n=64, offsets=(-1, 0, 1), seed=2):
    """test_spmv_dia_banded's tridiagonal matrix, or other diagonals."""
    rng = np.random.Generator(np.random.PCG64(seed))
    mat = sp.diags([rng.uniform(-1, 1, min(m, n)) for _ in offsets],
                   list(offsets), shape=(m, n), format="csr")
    mat.sort_indices()
    return mat


GENERAL = [random_matrix(100, 80, 0.05, 1), random_matrix(64, 64, 0.2, 2),
           *_pathological()]
SYMMETRIC = [_symmetric(90, 3), _symmetric(40, 5)]
# (port builder, JAX builder, matrices): the JAX test's builder table,
# DIA's banded case, LDU's and CSR_SYM's
BUILDERS = {
    "coo": (build.build_coo, jax_build.build_coo, GENERAL),
    "csc": (build.build_csc, jax_build.build_csc, GENERAL),
    "ell": (build.build_ell, jax_build.build_ell, GENERAL),
    "sellcs": (build.build_sellcs, jax_build.build_sellcs, GENERAL),
    "sellcs_c8s1": (lambda h: build.build_sellcs(h, C=8, sigma=1),
                    lambda h: jax_build.build_sellcs(h, C=8, sigma=1),
                    GENERAL),
    "bsr": (lambda h: build.build_bsr(h, br=4, bc=8),
            lambda h: jax_build.build_bsr(h, br=4, bc=8), GENERAL),
    "bsr_8x128": (build.build_bsr, jax_build.build_bsr, GENERAL),
    "dia": (build.build_dia, jax_build.build_dia,
            [_banded(), _banded(64, 48, (-3, 0, 2, 7))]),
    "ldu": (build.build_ldu, jax_build.build_ldu,
            [_ldu(), _banded(), SYMMETRIC[0]]),
    "csr_sym": (build.build_csr_sym, jax_build.build_csr_sym, SYMMETRIC),
}


@pytest.fixture(scope="module")
def built():
    """(name, matrix index) → (matrix, the port's format, JAX's format)."""
    out = {}
    for name, (ours, theirs, mats) in BUILDERS.items():
        for i, mat in enumerate(mats):
            out[name, i] = (mat, ours(HostCSR.from_scipy(mat)),
                            theirs(JaxHostCSR.from_scipy(mat)))
    return out


def _leaves(jf):
    return {f.name: np.asarray(getattr(jf, f.name))
            for f in dataclasses.fields(jf)
            if not isinstance(getattr(jf, f.name), (int, tuple))}


def _meta(jf):
    return {f.name: getattr(jf, f.name) for f in dataclasses.fields(jf)
            if isinstance(getattr(jf, f.name), (int, tuple))}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_jax(built, name):
    for i in range(len(BUILDERS[name][2])):
        _, ours, theirs = built[name, i]
        assert ours.format_name == theirs.format_name
        leaves = _leaves(theirs)
        assert sorted(leaves) == sorted(ours.data_fields)
        for f, want in leaves.items():
            got = getattr(ours, f).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert {f: getattr(ours, f) for f in ours.meta_fields} == \
            _meta(theirs)
        assert ours.mem_footprint_bytes() == theirs.mem_footprint_bytes()


def _jax_xla(op):
    """JAX's ``xla`` impl of ``op`` as one jitted call (one compile a
    shape, where op-by-op dispatch compiles every primitive)."""
    return jax.jit(functools.partial(op, impl="xla"))


def _close(got, want, tol=1e-5):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                   1e-30)


def _x(n, seed=9, k=None):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.uniform(-1, 1, n if k is None else (n, k)).astype(np.float32)


@pytest.mark.parametrize("name", ["coo", "csc", "ell", "sellcs",
                                  "sellcs_c8s1", "bsr", "bsr_8x128", "dia",
                                  "ldu", "csr_sym"])
def test_spmv_matches_jax_xla(built, name):
    """The port's SpMV on the arrays JAX built, against JAX's xla impl."""
    for i, mat in enumerate(BUILDERS[name][2]):
        _, _, theirs = built[name, i]
        A = format_from_jax(theirs.format_name, _leaves(theirs),
                            _meta(theirs))
        x = _x(mat.shape[1])
        y = spmv(A, torch.from_numpy(x))
        _close(y, _jax_xla(jax_spmv)(theirs, jnp.asarray(x)))
        scale = np.abs(mat) @ np.abs(x) + 1e-30
        assert np.max(np.abs(y.double().numpy() - mat @ x) / scale) <= 1e-5


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("name", ["coo", "ell", "sellcs", "bsr_8x128"])
def test_spmm_matches_jax_xla(built, name, k):
    """test_spmm_matches_scipy's matrix and K, for the four SpMMs."""
    mat = random_matrix(96, 72, 0.08, 10)
    ours, theirs = (f(h) for f, h in zip(
        BUILDERS[name][:2], (HostCSR.from_scipy(mat),
                             JaxHostCSR.from_scipy(mat))))
    X = _x(72, 11, k)
    Y = spmm(ours, torch.from_numpy(X))
    _close(Y, _jax_xla(jax_spmm)(theirs, jnp.asarray(X)))


@pytest.mark.parametrize("k", [8, 64])
def test_coo_sddmm_matches_jax_xla(k):
    mat = random_matrix(60, 50, 0.1, 12)
    ours = build.build_coo(HostCSR.from_scipy(mat))
    theirs = jax_build.build_coo(JaxHostCSR.from_scipy(mat))
    A, B = _x(60, 13, k), _x(50, 14, k)
    C = sddmm(ours, torch.from_numpy(A), torch.from_numpy(B))
    _close(C, _jax_xla(jax_sddmm)(theirs, jnp.asarray(A), jnp.asarray(B)))
    assert torch.all(C[mat.nnz:] == 0)


def test_classic_formats_take_torch_on_the_card():
    """No hand kernel: the classic formats' plain impl (and the XLA-only
    engines', since they were ported) is the default on a CUDA tensor
    too."""
    classic = {"COO", "CSC", "ELL", "SELL-C-s", "BSR", "Custom_DIA", "LDU",
               "CSR_SYM"}
    assert PLAIN_FORMATS == classic | {"SELLG", "BSRG", "CSR_LUT"}
    for fmt in PLAIN_FORMATS:
        assert default_impl(fmt, torch.device("cuda")) == "torch"
    for fmt in classic:
        assert sweep_mod.sweep_impls("spmv", fmt, torch.device("cuda")) == \
            ["torch"]


def _scattered_blocks():
    """20,000 rows, one entry each over 2M columns: ≈ 20,000 blocks of
    8 × 128, 80 MiB dense against CSR's 0.3 MiB."""
    rng = np.random.Generator(np.random.PCG64(15))
    m = 20_000
    return sp.csr_matrix((rng.uniform(-1, 1, m),
                          (np.arange(m), rng.integers(0, 2_000_000, m))),
                         shape=(m, 2_000_000))


@pytest.mark.parametrize("name, mat, error", [
    ("bsr_8x128", _scattered_blocks(), build.BSRBuildError),
    ("dia", random_matrix(600, 600, 0.03, 16), build.DIABuildError),
    ("ldu", random_matrix(40, 30, 0.2, 17), build.LDUBuildError),
    ("ldu", random_matrix(40, 40, 0.2, 18), build.LDUBuildError),
    ("csr_sym", random_matrix(40, 30, 0.2, 19), build.CSRSymBuildError),
    ("csr_sym", random_matrix(40, 40, 0.2, 20), build.CSRSymBuildError),
])
def test_refusals_raise_value_errors(name, mat, error):
    """Where JAX refuses with a plain ValueError the port raises its
    subclass, with JAX's message."""
    mat.sort_indices()
    ours, theirs, _ = BUILDERS[name]
    with pytest.raises(ValueError) as want:
        theirs(JaxHostCSR.from_scipy(mat))
    with pytest.raises(error) as got:
        ours(HostCSR.from_scipy(mat))
    assert issubclass(error, ValueError) and str(got.value) == \
        str(want.value)
    assert error in sweep_mod.SUITABILITY_ERRORS or name in ("dia", "ldu")


def test_host_helpers_match_jax():
    """``sigma_sort_rows`` and the symmetric drop/expand, array for array."""
    from spmv_research_tpu.convert import csr_expand_symmetric as jax_expand
    from spmv_research_tpu.convert.reorder import sigma_sort_rows as jax_sig
    mat = _symmetric(90, 21)
    h, hj = HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)
    for sigma in (1, 7, 32, 1000):
        assert np.array_equal(sigma_sort_rows(h, sigma), jax_sig(hj, sigma))
    low, lowj = csr_drop_upper(h), jax_drop_upper(hj)
    full, fullj = csr_expand_symmetric(low), jax_expand(lowj)
    for a, b in ((low, lowj), (full, fullj)):
        for f in ("ia", "ja", "a"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.nnz_expanded, a.symmetric_storage) == (
            b.nnz_expanded, b.symmetric_storage)
    assert np.array_equal(full.to_scipy().toarray(), mat.toarray())
    # symmetric storage goes into CSR_SYM as it is
    S = build.build_csr_sym(low)
    Sj = jax_build.build_csr_sym(lowj)
    assert np.array_equal(S.data.numpy(), np.asarray(Sj.data))


SWEEP_FORMATS = ("coo", "csc", "ell", "sellcs", "bsr", "csr")


def test_sweep_classic_formats_rows(tmp_path, capsys):
    """The six sweep formats on the banded twin: one row each under JAX's
    format names (CSR's two impls), each y within 1e-5 of |A|·|x|; CSR_SYM
    refuses the unsymmetric twin and runs its SPD transform."""
    res = run_sweep([BANDED_LINE], formats=SWEEP_FORMATS + ("csr_sym",),
                    out_dir=str(tmp_path), config=BenchConfig(**TINY),
                    device="cpu")
    assert sorted(f"{r.format_name}_{r.impl}" for r in res) == sorted(
        ["COO_torch", "CSC_torch", "ELL_torch", "SELL-C-s_torch",
         "BSR_torch", "CSR_torch", "CSR_sparse"])
    assert ("csr_sym build refused shipsec1_twin: CSRSymBuildError"
            in capsys.readouterr().out)
    labels = jax_bench.csv_labels(synthetic=True)
    for fmt in SWEEP_FORMATS:
        lines = (tmp_path / f"{fmt}_spmv.csv").read_text().splitlines()
        assert lines[0] == labels
        assert len(lines) == (3 if fmt == "csr" else 2)
    assert not (tmp_path / "csr_sym_spmv.csv").exists()
    for r in res:
        assert r.metrics.max_rel_err < 1e-5 and r.num_loops >= 2
    spd = run_sweep([BANDED_LINE], formats=("csr_sym",),
                    out_dir=str(tmp_path / "spd"),
                    config=BenchConfig(**dict(TINY, matrix_transform="spd")),
                    device="cpu")
    assert [(r.matrix_name, r.format_name) for r in spd] == [
        ("shipsec1_twin_spd", "CSR_SYM")]
    assert spd[0].metrics.max_rel_err < 1e-5


def test_sweep_skips_refused_bsr(tmp_path, capsys):
    """BSR's fill guard refuses a scattered matrix and the sweep goes on."""
    line = "20000 2000000 2 0 normal random 1.0 0 0 0 14 bsr_scatter"
    cfg = BenchConfig(**dict(TINY, use_rcm_reordering=False))
    res = run_sweep([line], formats=("bsr", "coo"), out_dir=str(tmp_path),
                    config=cfg, device="cpu")
    assert [r.format_name for r in res] == ["COO"]
    assert ("bsr build refused bsr_scatter: BSRBuildError: BSR fill too low"
            in capsys.readouterr().out)
