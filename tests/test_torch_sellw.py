"""SELLW in the PyTorch port against the JAX package.

Program parity: for the same matrix both builders must emit identical
program arrays (``np.array_equal``) and meta fields, on both packer tiers
(the native packer at G = 2, the Python packer at G ∈ {1, 2, 4}) and for a
``stream_wins`` program. Semantic parity: the port's ``"torch"`` impl on the
identical program (carried over with ``sellw_from_jax``) against the JAX
pallas impl in interpret mode, within 1e-6 of |A|·|x| (the kernel sums
sublanes in order; XLA's reduction order is unspecified); the float64 host
executors must agree exactly. SpMM: the port's ``"torch"`` impl (the SpMV's
plain version per column, one combine) against ``spmm_sellw_xla`` and,
once, the pallas SpMM kernel in interpret mode, at K not a multiple of 8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_research_tpu.io.native as jax_native
import spmv_research_tpu.ops.sellw as jax_sellw
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmm as jax_spmm, spmv as jax_spmv

import spmv_research_tpu_torch.io.native as native
import spmv_research_tpu_torch.ops.sellw as sellw
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import sell_cuda as K
from spmv_research_tpu_torch.ops import spmm, spmv

from torch_cases import banded_matrix, scattered_matrix


def _hosts(mat):
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


def _leaves(Aj):
    return ({f: np.asarray(getattr(Aj, f)) for f in sellw.DATA_FIELDS},
            {f: getattr(Aj, f) for f in sellw.META_FIELDS})


def _assert_same_program(A, Aj):
    leaves, meta = _leaves(Aj)
    for f in sellw.DATA_FIELDS:
        got = getattr(A, f).numpy()
        assert got.dtype == leaves[f].dtype, f
        assert np.array_equal(got, leaves[f]), f
    assert {f: getattr(A, f) for f in sellw.META_FIELDS} == meta


def _scale(mat, x):
    return np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30


@pytest.fixture
def python_tier(monkeypatch):
    """Both packages take the Python packer, as without the native library."""
    monkeypatch.setattr(native, "have_sellw_pack", lambda cap=128: False)
    monkeypatch.setattr(jax_native, "have_sellw_pack", lambda cap=128: False)


def test_native_tier_program_identical():
    assert native.have_sellw_pack(), "the native host library is built"
    h, hj = _hosts(banded_matrix(1500, 1500, 200, 12, 0))
    _assert_same_program(sellw.build_sellw(h), jax_sellw.build_sellw(hj))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_python_tier_program_identical(python_tier, G):
    h, hj = _hosts(banded_matrix(1100, 1300, 120, 9, 1))
    A = sellw.build_sellw(h, group=G)
    _assert_same_program(A, jax_sellw.build_sellw(hj, group=G))
    assert A.G == G


def test_native_and_python_tiers_agree(monkeypatch):
    h, _ = _hosts(banded_matrix(1500, 1500, 200, 12, 0))
    A_native = sellw.build_sellw(h)
    monkeypatch.setattr(native, "have_sellw_pack", lambda cap=128: False)
    A_python = sellw.build_sellw(h)
    for f in sellw.DATA_FIELDS:
        assert torch.equal(getattr(A_native, f), getattr(A_python, f)), f


@pytest.fixture(scope="module")
def stream_case():
    mp = pytest.MonkeyPatch()
    mp.setattr(sellw, "_X_VMEM_LIMIT", 512)
    mp.setattr(jax_sellw, "_X_VMEM_LIMIT", 512)
    try:
        mat = banded_matrix(400, 1030, 60, 8, 3)
        h, hj = _hosts(mat)
        yield mat, sellw.build_sellw(h), jax_sellw.build_sellw(hj)
    finally:
        mp.undo()


def test_stream_wins_program_identical(stream_case):
    _, A, Aj = stream_case
    assert A.stream_wins and Aj.stream_wins
    _assert_same_program(A, Aj)


@pytest.fixture(scope="module", params=["banded", "g4", "stream"])
def case(request, stream_case):
    """(scipy matrix, JAX program, the port's copy of it, x)."""
    if request.param == "stream":
        mat, _, Aj = stream_case
    else:
        mat = banded_matrix(1200, 1200, 160, 14, 2)
        Aj = jax_sellw.build_sellw(JaxHostCSR.from_scipy(mat),
                                   group=4 if request.param == "g4" else 2)
    A = sellw.sellw_from_jax(*_leaves(Aj))
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return mat, Aj, A, x.astype(np.float32)


def test_torch_impl_matches_jax_pallas(case):
    mat, Aj, A, x = case
    want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    got = spmv(A, torch.from_numpy(x)).numpy()        # CPU tensor: "torch"
    assert np.max(np.abs(got - want) / _scale(mat, x)) <= 1e-6


def _X(n, k, seed=8):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.uniform(-1.0, 1.0, (n, k)).astype(np.float32)


def _near_spmm(mat, X, got, want, tol=1e-6):
    scale = np.abs(mat) @ np.abs(X).astype(np.float64) + 1e-30
    assert got.shape == np.shape(want) == (mat.shape[0], X.shape[1])
    assert np.max(np.abs(got - np.asarray(want)) / scale) <= tol


def test_spmm_torch_impl_matches_jax_xla(case):
    mat, Aj, A, _ = case
    X = _X(mat.shape[1], 3)
    want = jax_spmm(Aj, jnp.asarray(X), impl="xla")
    _near_spmm(mat, X, spmm(A, torch.from_numpy(X)).numpy(), want)


def test_spmm_torch_impl_matches_jax_pallas(monkeypatch):
    """The JAX SpMM kernel in interpret mode, K = 10: a full k-tile of 8
    and a ragged one of 2. Chunks are padded to 8, not 64, so that the
    interpreter unrolls 64 row copies per column and not 512."""
    monkeypatch.setattr(jax_sellw, "CHUNK_PAD", 8)
    mat = banded_matrix(300, 300, 40, 6, 1)
    Aj = jax_sellw.build_sellw(JaxHostCSR.from_scipy(mat))
    A = sellw.sellw_from_jax(*_leaves(Aj))
    assert A.wrow.shape[0] == 8 * 8
    X = _X(mat.shape[1], 10)
    want = jax_spmm(Aj, jnp.asarray(X), impl="pallas")
    _near_spmm(mat, X, spmm(A, torch.from_numpy(X)).numpy(), want)


def test_spmm_wrapper_takes_plain_version_on_cpu(case):
    mat, _, A, _ = case
    X = _X(mat.shape[1], 3)
    xt = torch.from_numpy(X).t().contiguous()
    args = (A.word, A.vals, A.wrow, xt, sellw.class_plan(A), A.G)
    K.reset_launch_counts()
    planes = K.sellw_spmm_planes(*args)
    assert torch.equal(planes, K.sellw_spmm_planes_torch(*args))
    assert not any(K.LAUNCHES.values())
    for k in range(3):      # column k's planes are the SpMV's on X[:, k]
        assert torch.equal(planes[k], K.sellw_planes_torch(
            A.word, A.vals, A.wrow, xt[k], sellw.class_plan(A), A.G))


def test_execute_sellw_numpy_identical(case):
    _, Aj, A, x = case
    x64 = x.astype(np.float64)
    assert np.array_equal(sellw.execute_sellw_numpy(A, x64),
                          jax_sellw.execute_sellw_numpy(Aj, x64))


def test_wrapper_takes_plain_version_on_cpu(case):
    _, _, A, x = case
    args = (A.word, A.vals, A.wrow, torch.from_numpy(x), sellw.class_plan(A),
            A.G)
    K.reset_launch_counts()
    planes = K.sellw_planes(*args, stream_wins=A.stream_wins)
    assert torch.equal(planes, K.sellw_planes_torch(*args))
    assert not any(K.LAUNCHES.values())
    npad = A.wrow.shape[0] // 8
    assert planes.shape == (A.G * npad + 1, 128)
    assert not planes[-1].any()                        # the zero row


def test_program_moves_whole_and_refuses_cuda_impl_on_cpu(case):
    _, _, A, x = case
    B = A.to("meta")
    assert all(getattr(B, f).device.type == "meta" for f in sellw.DATA_FIELDS)
    assert B.classes == A.classes and B.device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A, torch.from_numpy(x), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        spmm(A, torch.from_numpy(x)[:, None], impl="cuda")


def test_scattered_matrix_refused():
    with pytest.raises(sellw.SellWBuildError, match="no column locality"):
        sellw.build_sellw(HostCSR.from_scipy(scattered_matrix()))
