"""The chunked CSR baseline of the port (CSR/torchc) against the JAX
package's CSR/xlac.

``build_csr_chunked`` must give the arrays of JAX's (``np.array_equal``
and dtypes, the last block's padding in the overflow segment R included),
meta fields and footprint, on the four matrices of
``tests/test_csr_chunked.py`` (many blocks, a block of 4 with long empty
stretches, a long row) and on one row across all 16 blocks. The SpMV and the SpMM (a loop of
SpMVs over X's columns, as JAX's scan) must lie within 1e-6 of |A|·|x| and
|A|·|X| of JAX's on the same seeded inputs. A plain CSR never runs
``torchc``: the sweep's impls of CSR are as before.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmm as jax_spmm, spmv as jax_spmv
from spmv_research_tpu.ops.csr_chunked import (
    build_csr_chunked as jax_build)

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.sweep import sweep_impls
from spmv_research_tpu_torch.ops import (CSRChunked, available_impls,
                                         build_csr_chunked, spmm, spmv)


def _rand_csr(m, n, density, seed=3):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=density, format="csr", random_state=rng,
                  data_rvs=lambda k: rng.uniform(-1, 1, k))
    return A


def _empty_stretches():
    rng = np.random.default_rng(9)
    rows = np.array([0, 0, 5, 5, 5, 199, 200, 399])
    cols = rng.integers(0, 50, rows.size)
    vals = rng.uniform(-1, 1, rows.size)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(400, 50)).tocsr()
    A.sum_duplicates()
    return A


def _one_long_row():
    m, n, nnz = 3, 64, 4096
    rng = np.random.default_rng(11)
    cols = rng.integers(0, n, nnz)
    vals = rng.uniform(-1, 1, nnz)
    A = sp.coo_matrix((vals, (np.full(nnz, 1), cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    return A


def _row_across_blocks():
    """Row 1 with 4096 distinct columns: at a block of 256 it spans all 16
    blocks (test_csr_chunked.py's long row sums to 64 entries, one
    block)."""
    rng = np.random.default_rng(12)
    cols = rng.choice(5000, 4096, replace=False)
    A = sp.coo_matrix((rng.uniform(-1, 1, 4096), (np.full(4096, 1), cols)),
                      shape=(3, 5000)).tocsr()
    A.sort_indices()
    return A


# test_csr_chunked.py's matrices and blocks, and a row across every block:
# (matrix, block, x seed)
CASES = {
    "multi_block": (lambda: _rand_csr(900, 700, 0.05), 1 << 10, 5),
    "empty_rows": (_empty_stretches, 4, 9),
    "spmm": (lambda: _rand_csr(257, 123, 0.08), 1 << 10, 6),
    "row_boundary": (_one_long_row, 256, 11),
    "row_across_blocks": (_row_across_blocks, 256, 12),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, matrix, JAX CSRChunked, the port's own, block)."""
    make, block, _ = CASES[request.param]
    mat = make()
    Aj = jax_build(JaxHostCSR.from_scipy(mat), block=block)
    A = build_csr_chunked(HostCSR.from_scipy(mat), block=block)
    return request.param, mat, Aj, A, block


def test_arrays_identical(case):
    name, mat, Aj, A, block = case
    assert isinstance(A, CSRChunked) and A.format_name == Aj.format_name
    for f in A.data_fields:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ({f: getattr(A, f) for f in A.meta_fields}
            == {f: getattr(Aj, f) for f in A.meta_fields})
    assert A.mem_footprint_bytes() == Aj.mem_footprint_bytes()
    C, B = A.data.shape
    assert C == {"multi_block": 31, "empty_rows": 2, "spmm": 3,
                 "row_boundary": 1, "row_across_blocks": 16}[name]
    pad = C * B - mat.nnz
    assert bool((A.lrow[-1, B - pad:] == A.R).all())   # padding in bin R
    B2 = A.to("cpu")
    assert B2 is not A and B2.row0_host == tuple(A.row0.tolist())


@pytest.mark.parametrize("workload", ["spmv", "spmm"])
def test_matches_jax_xlac(case, workload):
    """CSR/torchc within 1e-6 of |A|·|x| (SpMV) and |A|·|X| (SpMM, 8
    columns) of JAX's CSR/xlac on the same seeded x or X."""
    name, mat, Aj, A, _ = case
    rng = np.random.default_rng(CASES[name][2])
    if workload == "spmv":
        x = rng.uniform(0, 1, mat.shape[1])
        got = spmv(A, torch.as_tensor(x, dtype=torch.float32), impl="torchc")
        want = np.asarray(jax_spmv(Aj, x.astype(np.float32), impl="xlac"))
        assert got.shape == (mat.shape[0],)
    else:
        x = rng.uniform(0, 1, (mat.shape[1], 8))
        got = spmm(A, torch.as_tensor(x, dtype=torch.float32), impl="torchc")
        want = np.asarray(jax_spmm(Aj, x.astype(np.float32), impl="xlac"))
        assert got.shape == (mat.shape[0], 8)
    got = got.numpy()
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    assert np.max(np.abs(got - mat @ x) / scale) <= 1e-6


@pytest.mark.parametrize("workload, impls", [("spmv", ["sparse", "torch"]),
                                             ("spmm", ["torch"])])
def test_sweep_impls_of_csr_unchanged(workload, impls):
    """``torchc`` is registered for CSR but is no sweep impl on any
    device: a plain CSR cannot run it (JAX's sweep tries ``xlac``, fails
    and writes no row)."""
    assert "torchc" in available_impls(workload, "CSR")
    for dev in ("cpu", "cuda"):
        assert sweep_impls(workload, "CSR", torch.device(dev)) == impls
