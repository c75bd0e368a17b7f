"""The long-row split (RSPLIT) in the port against the JAX package.

Rows past a threshold are cut into sub-rows of at most T nnz, the inner
CLOSG program runs on the split matrix, and the combine adds each heavy
row's partials into its y. The split, the wrapper's arrays and the inner
program must be identical to the JAX package's; the combine is checked
against both float64 executors, and y against the JAX pallas path within
1e-6 of |A|·|x|. ``SPLIT_ROW_NNZ`` is lowered in both packages so that a
600-row matrix takes the split route, as ``tests/test_rowsplit.py`` does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_research_tpu.ops.clos_gather as jax_cg
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.rowsplit import (
    execute_rowsplit_numpy as jax_execute_rowsplit)
from spmv_research_tpu.ops.rowsplit import split_long_rows as jax_split

import spmv_research_tpu_torch.ops.clos_gather as cg
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import (ClosG, RowSplit,
                                         execute_rowsplit_numpy,
                                         rowsplit_from_jax, spmv,
                                         split_long_rows)
from spmv_research_tpu_torch.ops.clos_gather import (DATA_FIELDS,
                                                     META_FIELDS,
                                                     from_jax_program)
from spmv_research_tpu_torch.ops.rowsplit import _combine

from torch_cases import random_matrix, rel_err, skewed_matrix


@pytest.fixture(scope="module")
def split():
    """(matrix, JAX RowSplit, the port's own RowSplit, x), with both
    packages' split threshold lowered to 512 nnz."""
    mat = skewed_matrix()
    mp = pytest.MonkeyPatch()
    mp.setattr(cg, "SPLIT_ROW_NNZ", 512)
    mp.setattr(jax_cg, "SPLIT_ROW_NNZ", 512)
    try:
        Aj = jax_cg.build_clos_gather_auto(JaxHostCSR.from_scipy(mat))
        A = cg.build_clos_gather_auto(HostCSR.from_scipy(mat))
    finally:
        mp.undo()
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return mat, Aj, A, x.astype(np.float32)


@pytest.mark.parametrize("T, threshold", [(64, 128), (256, 512), (64, None)])
def test_split_long_rows_matches_jax(T, threshold):
    mat = skewed_matrix()
    got = split_long_rows(HostCSR.from_scipy(mat), T, threshold=threshold)
    want = jax_split(JaxHostCSR.from_scipy(mat), T, threshold=threshold)
    for f in ("ia", "ja", "a"):
        assert np.array_equal(getattr(got[0], f), getattr(want[0], f)), f
    assert (got[0].m, got[0].n, got[0].nnz) == (want[0].m, want[0].n,
                                                 want[0].nnz)
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    # the split matrix holds the original's nnz, sub-rows of at most T
    assert got[0].nnz == mat.nnz
    assert np.diff(got[0].ia)[mat.shape[0]:].max() <= T


def test_split_below_part_size_keeps_rows():
    """A threshold below the part size T makes rows of (threshold, T] nnz
    heavy with no extra sub-row: they keep their own length (the JAX split
    gives them T nnz, reading into the next rows). Reassembling the split
    matrix's partials gives A·x."""
    mat = skewed_matrix()
    csr2, heavy, seg_ptr = split_long_rows(HostCSR.from_scipy(mat), 256,
                                           threshold=64)
    assert (np.diff(mat.indptr)[heavy] <= 256).any()
    m = mat.shape[0]
    x = np.random.Generator(np.random.PCG64(2)).uniform(-1, 1, mat.shape[1])
    y2 = csr2.to_scipy() @ x
    y = y2[:m].copy()
    for i, r in enumerate(heavy):
        y[r] += y2[m + seg_ptr[i]:m + seg_ptr[i + 1]].sum()
    assert np.allclose(y, mat @ x, rtol=1e-12, atol=1e-12)


def test_split_noop_below_threshold():
    host = HostCSR.from_scipy(random_matrix(300, 300, 0.01, 4))
    csr2, heavy, seg_ptr = split_long_rows(host, 64, threshold=10**9)
    assert csr2 is host and heavy is None and seg_ptr is None


def test_auto_routes_long_rows_through_the_split(split):
    mat, Aj, A, _ = split
    assert isinstance(A, RowSplit) and Aj.format_name == A.format_name
    assert isinstance(A.inner, ClosG) and A.inner_format == "CLOSG"
    assert (A.shape, A.nnz, A.nnz_expanded, A.n_extra) == (
        tuple(Aj.shape), Aj.nnz, Aj.nnz_expanded, Aj.n_extra)
    assert A.inner.m == mat.shape[0] + A.n_extra + 128
    assert np.array_equal(A.heavy_rows.numpy(), np.asarray(Aj.heavy_rows))
    assert np.array_equal(A.gidx.numpy(), np.asarray(Aj.gidx))
    for f in DATA_FIELDS:
        assert np.array_equal(getattr(A.inner, f).numpy(),
                              np.asarray(getattr(Aj.inner, f))), f
    assert ({f: getattr(A.inner, f) for f in META_FIELDS}
            == {f: getattr(Aj.inner, f) for f in META_FIELDS})


def test_combine_matches_float64_executors(split):
    """The combine on a seeded float64 inner y: the port's torch combine,
    its float64 executor and the JAX executor agree."""
    _, Aj, A, _ = split
    y2 = np.random.Generator(np.random.PCG64(3)).uniform(
        -1, 1, A.inner.shape[0])
    got = _combine(A, torch.from_numpy(y2)).numpy()
    want = execute_rowsplit_numpy(A, y2)
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    assert np.allclose(want, jax_execute_rowsplit(Aj, y2), rtol=1e-12,
                       atol=1e-12)


def test_y_matches_jax_pallas(split):
    mat, Aj, A, x = split
    want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    got = spmv(A, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert got.shape == (mat.shape[0],)
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    assert rel_err(mat, x, got) <= 1e-6


def test_rowsplit_from_jax(split):
    _, Aj, A, x = split
    inner = from_jax_program(
        {f: np.asarray(getattr(Aj.inner, f)) for f in DATA_FIELDS},
        {f: getattr(Aj.inner, f) for f in META_FIELDS})
    B = rowsplit_from_jax({"heavy_rows": np.asarray(Aj.heavy_rows),
                           "gidx": np.asarray(Aj.gidx)},
                          {"shape": Aj.shape, "nnz": Aj.nnz,
                           "nnz_expanded": Aj.nnz_expanded,
                           "n_extra": Aj.n_extra}, inner)
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))


def test_rowsplit_moves_whole(split):
    _, _, A, _ = split
    B = A.to("meta")
    assert B.device.type == "meta" and B.inner.device.type == "meta"
    assert all(getattr(B.inner, f).device.type == "meta"
               for f in DATA_FIELDS + ("acc_ptr", "acc_src"))
    assert A.inner.device.type == "cpu"


def test_cuda_impl_refuses_cpu_tensors(split):
    _, _, A, x = split
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A, torch.from_numpy(x), impl="cuda")
