"""BTILE in the PyTorch port against the JAX package.

Program parity: for the same matrix both builders must emit identical
program arrays (``np.array_equal``) and meta fields, on the banded cases of
``tests/test_btile.py``. Semantic parity: the port's ``"torch"`` SpMM and
SDDMM impls against the JAX ``xla`` impls (and once against the pallas
impls in interpret mode), within rtol = atol = 2e-5 (float32 products
summed in other orders); the float64 host executors and the slab-to-CSR
extraction must agree exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spmv_research_tpu.ops.btile as jax_btile
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import btile, btile_cuda as K, sddmm, spmm

from torch_cases import btile_banded, scattered_matrix

# tests/test_btile.py's CASES: (m, n, nnz per row, half-band, seed)
CASES = [(300, 300, 8, 30, 0), (2500, 2500, 12, 200, 1),
         (1500, 900, 16, 300, 2), (1100, 1300, 9, 64, 3)]
TOL = dict(rtol=2e-5, atol=2e-5)


def _leaves(Aj):
    return ({f: np.asarray(getattr(Aj, f)) for f in btile.DATA_FIELDS},
            {f: getattr(Aj, f) for f in btile.META_FIELDS})


def _builds(mat):
    return (btile.build_btile(HostCSR.from_scipy(mat)),
            jax_btile.build_btile(JaxHostCSR.from_scipy(mat)))


def _assert_same_program(A, Aj):
    leaves, meta = _leaves(Aj)
    for f in btile.DATA_FIELDS:
        got = getattr(A, f).numpy()
        assert got.dtype == leaves[f].dtype, f
        assert np.array_equal(got, leaves[f]), f
    assert {f: getattr(A, f) for f in btile.META_FIELDS} == meta


@pytest.mark.parametrize("case", CASES)
def test_program_identical(case):
    A, Aj = _builds(btile_banded(*case))
    _assert_same_program(A, Aj)
    step_g = A.step_g.numpy()
    for g in range(A.ngroups):        # band g's steps, in order
        lo, hi = A.band_ptr[g], A.band_ptr[g + 1]
        assert hi > lo and (step_g[lo:hi] == g).all()
    assert A.band_ptr[-1] == A.nsteps


@pytest.fixture(scope="module", params=[CASES[0], CASES[3]],
                ids=["300", "1100x1300"])
def case(request):
    """(matrix, JAX program, the port's copy of it, X, Am, Bm), K = 16."""
    mat = btile_banded(*request.param)
    Aj = jax_btile.build_btile(JaxHostCSR.from_scipy(mat))
    A = btile.btile_from_jax(*_leaves(Aj))
    rng = np.random.Generator(np.random.PCG64(request.param[-1] + 100))
    m, n = mat.shape
    X, Am, Bm = (rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((n, 16), (m, 16), (n, 16)))
    return mat, Aj, A, X, Am, Bm


def test_btile_from_jax_carries_the_program(case):
    mat, Aj, A, *_ = case
    _assert_same_program(A, Aj)
    _assert_same_program(btile.build_btile(HostCSR.from_scipy(mat)), Aj)


def test_spmm_torch_matches_jax_xla(case):
    mat, Aj, A, X, _, _ = case
    want = np.asarray(jax_btile.spmm_btile_xla(Aj, jnp.asarray(X)))
    got = spmm(A, torch.from_numpy(X))               # CPU tensor: "torch"
    assert got.shape == (mat.shape[0], X.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), mat @ X.astype(np.float64), **TOL)


def test_sddmm_torch_matches_jax_xla(case):
    mat, Aj, A, _, Am, Bm = case
    want = np.asarray(jax_btile.sddmm_btile_xla(Aj, jnp.asarray(Am),
                                                jnp.asarray(Bm)))
    got = sddmm(A, torch.from_numpy(Am), torch.from_numpy(Bm)).numpy()
    assert got.shape == want.shape == (A.nsteps * A.tg * 8, 128)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[A.patt.numpy() == 0].any()        # masked slots are 0


def test_pallas_interpret_agrees():
    """One case against the JAX pallas impls, run in interpret mode."""
    mat = btile_banded(*CASES[0])
    Aj = jax_btile.build_btile(JaxHostCSR.from_scipy(mat))
    A = btile.btile_from_jax(*_leaves(Aj))
    rng = np.random.Generator(np.random.PCG64(9))
    X, Am = (rng.uniform(-1, 1, (300, 8)).astype(np.float32)
             for _ in range(2))
    np.testing.assert_allclose(
        spmm(A, torch.from_numpy(X)).numpy(),
        np.asarray(jax_btile.spmm_btile_pallas(Aj, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(
        sddmm(A, torch.from_numpy(Am), torch.from_numpy(X)).numpy(),
        np.asarray(jax_btile.sddmm_btile_pallas(Aj, jnp.asarray(Am),
                                                jnp.asarray(X))), **TOL)


def test_slab_to_csr_values_identical(case):
    mat, Aj, A, _, Am, Bm = case
    slab = sddmm(A, torch.from_numpy(Am), torch.from_numpy(Bm))
    host = HostCSR.from_scipy(mat)
    got = btile.sddmm_slab_to_csr_values(A, slab, host)
    want = jax_btile.sddmm_slab_to_csr_values(Aj, slab.numpy(),
                                              JaxHostCSR.from_scipy(mat))
    assert np.array_equal(got, want)
    rows = np.repeat(np.arange(mat.shape[0]), np.diff(mat.indptr))
    gold = np.sum(Am[rows].astype(np.float64) * Bm[mat.indices], axis=1)
    np.testing.assert_allclose(got, gold, **TOL)


def test_execute_btile_numpy_identical(case):
    _, Aj, A, X, _, _ = case
    X64 = X.astype(np.float64)
    assert np.array_equal(btile.execute_btile_numpy(A, X64),
                          jax_btile.execute_btile_numpy(Aj, X64))


def test_empty_band_comes_out_as_zeros():
    """A matrix whose middle band (rows [1024, 2048)) is empty: the band has
    only the builder's filler step (0 tiles), and its rows of Y are 0."""
    rng = np.random.Generator(np.random.PCG64(5))
    m = n = 2600
    base = np.concatenate([np.arange(0, 1024), np.arange(2048, m)])
    rows = np.repeat(base, 12)
    cols = np.clip(rows + rng.integers(-30, 31, rows.size), 0, n - 1)
    mat = sp.coo_matrix((rng.uniform(0.5, 1.0, rows.size), (rows, cols)),
                        shape=(m, n)).tocsr()
    mat.sum_duplicates()
    A, Aj = _builds(mat)
    _assert_same_program(A, Aj)
    lo, hi = int(A.band_ptr[1]), int(A.band_ptr[2])
    assert hi - lo == 1 and A.step_nt[lo] == 0
    X = np.ones((n, 4), np.float32)
    Y = spmm(A, torch.from_numpy(X)).numpy()
    assert not Y[1024:2048].any()
    np.testing.assert_allclose(Y, mat @ X.astype(np.float64), **TOL)


@pytest.mark.parametrize("ngroups, slices, nsteps, most", [
    (17, 4, 4484, 300), (138, 4, 17035, 130), (1, 1, 1, 1), (3, 2, 7, 4),
    (2, 1, 1000, 999), (4000, 8, 40000, 2000)])
def test_spmm_band_chunks(ngroups, slices, nsteps, most):
    """The SpMM kernel's (chunks per band, steps per chunk): every step of
    the largest band in a chunk, no chunk without steps, chunks of about
    nsteps · slices / blocks steps, partials within their budget (blocks:
    8 per SM of a 132-SM card)."""
    blocks = K.SPMM_BLOCKS_PER_SM * 132
    nchunk, ch = K._chunks(ngroups, slices, nsteps, most, 32 * slices, blocks)
    assert nchunk * ch >= most > (nchunk - 1) * ch
    assert ch >= nsteps * slices // blocks
    assert (nchunk == 1 or ngroups * nchunk * 1024 * 32 * slices * 4
            <= K.SPMM_PART_BYTES)


def test_scattered_matrix_refused():
    with pytest.raises(btile.BTileBuildError, match="slots/nnz"):
        btile.build_btile(HostCSR.from_scipy(scattered_matrix()))


def test_wrappers_take_plain_versions_on_cpu(case):
    _, _, A, X, Am, Bm = case
    K.reset_launch_counts()
    xp = torch.nn.functional.pad(torch.from_numpy(X),
                                 (0, 0, 0, A.ncb * 128 - X.shape[0]))
    args = (A.tiles, A.tgt, A.step_g, A.step_cb, A.step_nt, A.band_ptr, xp,
            A.ngroups, A.max_band_steps)
    assert torch.equal(K.btile_spmm(*args), K.btile_spmm_torch(*args))
    ap = torch.nn.functional.pad(torch.from_numpy(Am),
                                 (0, 0, 0, A.ngroups * 1024 - Am.shape[0]))
    bp = torch.nn.functional.pad(torch.from_numpy(Bm),
                                 (0, 0, 0, A.ncb * 128 - Bm.shape[0]))
    sargs = (A.patt, A.tgt, A.step_g, A.step_cb, A.step_nt, ap, bp)
    assert torch.equal(K.btile_sddmm(*sargs), K.btile_sddmm_torch(*sargs))
    assert not any(K.LAUNCHES.values())


def test_program_moves_whole_and_refuses_cuda_impl_on_cpu(case):
    _, _, A, X, Am, Bm = case
    B = A.to("meta")
    assert all(getattr(B, f).device.type == "meta"
               for f in (*btile.DATA_FIELDS, "band_ptr"))
    assert B.device.type == "meta" and B.nsteps == A.nsteps
    with pytest.raises(ValueError, match="CUDA"):
        spmm(A, torch.from_numpy(X), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        sddmm(A, torch.from_numpy(Am), torch.from_numpy(Bm), impl="cuda")
