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
The combine's plain version (``sell_cuda.sellw_combine_torch``, which the
kernel B12c equals bit for bit on the card) against the float64 executor
and the JAX impls at 1, 3 and 128 columns, G ∈ {1, 2, 4} (K = 1 at G = 1)
and m not a multiple of 128; the yidx padding its early stop rests on.
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


# ------------------------------------------------------------- the combine

@pytest.fixture(scope="module", params=[1, 2, 4], ids=["g1", "g2", "g4"])
def combine_case(request):
    """(scipy matrix, JAX program at group G, the port's copy of it): m =
    1100, not a multiple of 128; at G = 1 each y block has one chunk."""
    mat = banded_matrix(1100, 1300, 120, 9, 1)
    Aj = jax_sellw.build_sellw(JaxHostCSR.from_scipy(mat),
                               group=request.param)
    A = sellw.sellw_from_jax(*_leaves(Aj))
    assert (A.K == 1) == (request.param == 1) and A.m % 128
    return mat, Aj, A


def _combined(A, X):
    """The planes of X's columns and their combine, Y (m, cols)."""
    xt = torch.from_numpy(X).t().contiguous()
    planes = K.sellw_spmm_planes_torch(A.word, A.vals, A.wrow, xt,
                                       sellw.class_plan(A), A.G)
    return planes, K.sellw_combine_torch(planes, A.yidx, A.m)


@pytest.mark.parametrize("cols", [1, 3, 128])
def test_combine_matches_executor_and_jax_xla(combine_case, cols):
    mat, Aj, A = combine_case
    X = _X(mat.shape[1], cols)
    planes, Y = _combined(A, X)
    assert Y.shape == (A.m, cols) and Y.is_contiguous()
    want = np.stack([sellw.execute_sellw_numpy(A, X[:, k].astype(np.float64))
                     for k in range(cols)], axis=1)
    _near_spmm(mat, X, Y.numpy(), want)
    _near_spmm(mat, X, Y.numpy(), jax_spmm(Aj, jnp.asarray(X), impl="xla"))
    y = K.sellw_combine_torch(planes[0], A.yidx, A.m)   # the SpMV's y (m,)
    assert y.shape == (A.m,) and torch.equal(y, Y[:, 0])
    want_x = np.asarray(jax_spmv(Aj, jnp.asarray(X[:, 0]), impl="xla"))
    _near_spmm(mat, X[:, :1], y.numpy()[:, None], want_x[:, None])


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_combine_matches_jax_pallas(monkeypatch, G, cols):
    """The JAX kernels in interpret mode (SpMV at one column, SpMM at 3) on
    m = 300; chunks padded to 8, not 64, as in the SpMM test above."""
    monkeypatch.setattr(jax_sellw, "CHUNK_PAD", 8)
    mat = banded_matrix(300, 300, 40, 6, 1)
    Aj = jax_sellw.build_sellw(JaxHostCSR.from_scipy(mat), group=G)
    A = sellw.sellw_from_jax(*_leaves(Aj))
    X = _X(mat.shape[1], cols)
    planes, Y = _combined(A, X)
    if cols == 1:
        want = np.asarray(jax_spmv(Aj, jnp.asarray(X[:, 0]),
                                   impl="pallas"))[:, None]
    else:
        want = jax_spmm(Aj, jnp.asarray(X), impl="pallas")
    _near_spmm(mat, X, Y.numpy(), want)


def test_combine_wrapper_takes_plain_version_on_cpu(case):
    mat, _, A, _ = case
    planes, Y = _combined(A, _X(mat.shape[1], 3))
    K.reset_launch_counts()
    assert torch.equal(K.sellw_combine(planes, A.yidx, A.m), Y)
    assert torch.equal(K.sellw_combine(planes[1], A.yidx, A.m), Y[:, 1])
    assert not any(K.LAUNCHES.values())


def test_spmm_returns_contiguous_y(case):
    mat, _, A, _ = case
    X = _X(mat.shape[1], 5)
    Y = spmm(A, torch.from_numpy(X))                  # CPU tensor: "torch"
    assert Y.shape == (A.m, 5) and Y.is_contiguous()
    assert torch.equal(Y, _combined(A, X)[1])


def _assert_padding_is_a_tail(A):
    """In each yidx column the entries naming the zero row G·npad come
    after every live one (the combine kernel stops at the last live)."""
    pad = A.yidx == A.G * (A.wrow.shape[0] // 8)
    assert torch.equal(pad, pad.cummax(dim=0).values)
    assert not pad[0].any()                           # no empty y block


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_yidx_padding_is_a_tail_python_tier(python_tier, G):
    h, _ = _hosts(banded_matrix(1100, 1300, 120, 9, 1))
    _assert_padding_is_a_tail(sellw.build_sellw(h, group=G, part_cap=4))


@pytest.mark.parametrize("kind", ["native", "stream", "long_rows"])
def test_yidx_padding_is_a_tail(kind, stream_case):
    if kind == "stream":
        A = stream_case[1]
    elif kind == "long_rows":           # K = 11 chunks for some y blocks
        A = sellw.build_sellw(HostCSR.from_scipy(banded_matrix(
            2000, 2000, 400, 80, 0)), part_cap=128)
    else:
        A = sellw.build_sellw(_hosts(banded_matrix(1500, 1500, 200, 12,
                                                   0))[0])
    assert A.K > 1
    _assert_padding_is_a_tail(A)


def test_scattered_matrix_refused():
    with pytest.raises(sellw.SellWBuildError, match="no column locality"):
        sellw.build_sellw(HostCSR.from_scipy(scattered_matrix()))


@pytest.mark.parametrize("n_chunks, n_sms, per_sm, want", [
    (11456, 132, 4, 528),      # shipsec1's class: 21 waves and 368 chunks
    (4736, 132, 5, 660),       # the streamed tridiagonal at 5 an SM
    (192, 132, 4, 192),        # fewer chunks than the card holds blocks
    (1, 132, 8, 1),
])
def test_persistent_grid(n_chunks, n_sms, per_sm, want):
    """The SpMV kernels' grid: the card's resident blocks, at most one a
    chunk; block b walks chunks b, b + grid, ..., so every chunk is taken
    once."""
    grid = K.persistent_grid(n_chunks, n_sms, per_sm)
    assert grid == want
    walked = np.concatenate([np.arange(b, n_chunks, grid)
                             for b in range(grid)])
    assert np.array_equal(np.sort(walked), np.arange(n_chunks))


@pytest.mark.parametrize("args", [(0, 132, 4), (10, 132, 0), (10, 0, 4)])
def test_persistent_grid_refuses_empty_launches(args):
    with pytest.raises(ValueError, match="no persistent grid"):
        K.persistent_grid(*args)
