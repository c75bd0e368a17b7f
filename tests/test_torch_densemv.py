"""The DENSE fallback in the port against the JAX package.

The builder densifies the matrix into a float32 plane padded to (8, 128)
tiles, summing duplicate (row, column) entries as the CSR gold does, and
refuses a plane past its byte budget. The planes of both packages must be
identical; y (``torch.matmul`` in the port, ``jnp.dot`` in the JAX package)
is held to 1e-6 of |A|·|x|.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.densemv import DenseBuildError as JaxDenseError
from spmv_research_tpu.ops.densemv import build_dense as jax_build_dense

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.bench import _scale_for_iteration
from spmv_research_tpu_torch.ops import (DenseBuildError, DenseMV,
                                         build_dense, spmv)

from torch_cases import random_matrix, rel_err


def _with_duplicates():
    """301 × 457 random matrix whose rows repeat some of their (row,
    column) entries: CSR arrays with duplicates, unsorted within rows."""
    mat = random_matrix(301, 457, 0.05, 3)
    rng = np.random.Generator(np.random.PCG64(4))
    ia, ja, a = [0], [], []
    for r in range(mat.shape[0]):
        cols = mat.indices[mat.indptr[r]:mat.indptr[r + 1]]
        vals = mat.data[mat.indptr[r]:mat.indptr[r + 1]]
        dup = rng.choice(cols.size, min(2, cols.size), replace=False)
        cols = np.concatenate([cols, cols[dup]])[::-1]
        vals = np.concatenate([vals, rng.uniform(-1, 1, dup.size)])[::-1]
        ja.append(cols)
        a.append(vals)
        ia.append(ia[-1] + cols.size)
    ia, ja, a = (np.asarray(ia), np.concatenate(ja), np.concatenate(a))
    summed = sp.csr_matrix((a, ja, ia), shape=mat.shape, copy=True)
    summed.sum_duplicates()
    return (ia, ja, a), summed


@pytest.mark.parametrize("dups", [False, True])
def test_plane_matches_jax(dups):
    if dups:
        (ia, ja, a), mat = _with_duplicates()
        m, n = mat.shape
        host = HostCSR.from_arrays(ia, ja, a, m, n)
        hj = JaxHostCSR(ia=ia.astype(np.int32), ja=ja.astype(np.int32),
                        a=a, m=m, n=n)
        assert host.nnz > mat.nnz               # the duplicates are kept
    else:
        mat = random_matrix(260, 300, 0.08, 8)
        host, hj = HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)
    D, Dj = build_dense(host), jax_build_dense(hj)
    assert isinstance(D, DenseMV) and D.format_name == Dj.format_name
    assert (D.shape, D.nnz, D.nnz_expanded) == (tuple(Dj.shape), Dj.nnz,
                                                Dj.nnz_expanded)
    assert np.array_equal(D.mat.numpy(), np.asarray(Dj.mat))
    assert D.mat.shape[0] % 8 == 0 and D.mat.shape[1] % 128 == 0
    assert D.mem_footprint_bytes() == Dj.mem_footprint_bytes()
    x = np.random.Generator(np.random.PCG64(5)).uniform(
        -1, 1, mat.shape[1]).astype(np.float32)
    got = spmv(D, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    want = np.asarray(jax_spmv(Dj, jnp.asarray(x), impl="xla"))
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert got.shape == (mat.shape[0],)
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    assert rel_err(mat, x, got) <= 1e-6


def test_budget_refusal_matches_jax():
    mat = random_matrix(64, 64, 0.2, 9)
    with pytest.raises(DenseBuildError, match="budget"):
        build_dense(HostCSR.from_scipy(mat), max_bytes=1024)
    with pytest.raises(JaxDenseError):
        jax_build_dense(JaxHostCSR.from_scipy(mat), max_bytes=1024)
    # a budget of exactly the plane's bytes takes it
    assert build_dense(HostCSR.from_scipy(mat),
                       max_bytes=64 * 128 * 4).mat.shape == (64, 128)


def test_dense_moves_and_scales():
    mat = random_matrix(100, 140, 0.1, 10)
    host = HostCSR.from_scipy(mat)
    D = build_dense(host)
    assert D.to("meta").mat.device.type == "meta"
    c = 1.0 / float(np.abs(mat).sum(axis=1).max())
    assert torch.equal(_scale_for_iteration(host, D).mat, D.mat * c)
    with pytest.raises(KeyError, match="DENSE"):
        spmv(D, torch.zeros(140), impl="cuda_missing")
    # with no impl named, a library format takes torch on the card
    from spmv_research_tpu_torch.ops.dispatch import _SPMV, _lookup
    assert _lookup(_SPMV, "DENSE", None, torch.device("cuda")) is \
        _SPMV[("DENSE", "torch")]
    assert _lookup(_SPMV, "CLOSG", None, torch.device("cuda")) is \
        _SPMV[("CLOSG", "cuda")]


def test_engine_without_cuda_impl_raises_on_the_card():
    """Only the library formats (CSR, DENSE) take the plain version on a
    CUDA tensor: an engine format with no cuda impl raises, it never runs
    its plain version on the card."""
    from spmv_research_tpu_torch.ops.dispatch import (LIBRARY_FORMATS,
                                                       _lookup, default_impl)
    assert LIBRARY_FORMATS == {"CSR", "DENSE"}
    table = {("ENGINE", "torch"): lambda A, x: x}
    with pytest.raises(KeyError, match="ENGINE"):
        _lookup(table, "ENGINE", None, torch.device("cuda"))
    assert _lookup(table, "ENGINE", None, torch.device("cpu")) is \
        table[("ENGINE", "torch")]
    for fmt in ("CLOSG", "RSPLIT", "CLOSGX", "SELLW", "SELLR"):
        assert default_impl(fmt, torch.device("cuda")) == "cuda"
        assert default_impl(fmt, torch.device("cpu")) == "torch"
    for fmt in LIBRARY_FORMATS:
        assert default_impl(fmt, torch.device("cuda")) == "torch"
