"""CSRDS, the double-single CSR, in the PyTorch port against the JAX
package.

Builder parity: for the same matrix both builders must emit identical
arrays (``np.array_equal``: the five planes, their dtypes and ``kseg``) and
refuse values past ``DS_MAX_ABS``. Semantic parity: the port's pair
(plain PyTorch, the only CSRDS impl) against the JAX ``spmv_csrds_pair``,
|Δ(s + e)| ≤ 1e-12 of |A|·|x| (both are TwoSum folds in one order, but XLA
may contract a product into an add where PyTorch rounds each step); and
the fp64 entry must pass the reference's fp64 gate, max relative error
< 1e-10 against the longdouble Kahan gold (``spmv_gold``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spmv_research_tpu.ops.compensated as jax_ds
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

from spmv_research_tpu_torch.core.formats import tree_map
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.metrics import check_accuracy
from spmv_research_tpu_torch.ops import compensated as ds
from spmv_research_tpu_torch.ops import default_impl, spmv

from torch_cases import ds_banded


def _skewed_rows(seed=5):
    """tests/test_compensated.py's long skewed rows: 40 rows of up to 900
    nnz over 3000 columns, so rows span several segments (kseg > 1)."""
    g = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(40):
        cs = np.unique(g.integers(0, 3000, int(g.integers(1, 900))))
        rows += [r] * len(cs)
        cols += cs.tolist()
        vals += g.standard_normal(len(cs)).tolist()
    return sp.csr_matrix((vals, (rows, cols)), shape=(40, 3000))


def _empty_rows():
    return sp.csr_matrix((np.array([1.5, -2.0]),
                          (np.array([0, 3]), np.array([1, 2]))), shape=(5, 4))


CASES = {
    "banded_lognormal": lambda: ds_banded(2500, 50, seed=0),
    "banded_uniform": lambda: ds_banded(1500, 40, seed=1, lognormal=False),
    "skewed_rows": _skewed_rows,
    "empty_rows": _empty_rows,
}


def _hosts(mat):
    mat = sp.csr_matrix(mat)
    mat.sort_indices()
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


def _x(n, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, n) * 7.3


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_csrds_matches_jax(case):
    h, hj = _hosts(CASES[case]())
    A, Aj = ds.build_csrds(h), jax_ds.build_csrds(hj)
    for f in ds.DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert {f: getattr(A, f) for f in ds.META_FIELDS} == {
        f: getattr(Aj, f) for f in ds.META_FIELDS}
    if case == "skewed_rows":
        assert A.kseg > 1


def test_csrds_refuses_overflow_values():
    h, hj = _hosts(ds_banded(500, 10, seed=5, lognormal=False))
    h.a[0] = hj.a[0] = 1e35
    with pytest.raises(ds.DSRangeError):
        ds.build_csrds(h)
    with pytest.raises(ValueError):
        jax_ds.build_csrds(hj)


@pytest.mark.parametrize("case", sorted(CASES))
def test_csrds_pair_matches_jax(case):
    mat = CASES[case]()
    h, hj = _hosts(mat)
    x = _x(h.n)
    xh, xl = ds._split_f64(x)
    Aj = jax_ds.build_csrds(hj)
    A = ds.csrds_from_jax({f: np.asarray(getattr(Aj, f))
                           for f in ds.DATA_FIELDS},
                          {f: getattr(Aj, f) for f in ds.META_FIELDS})
    s, e = ds.spmv_csrds_pair(A, torch.from_numpy(xh), torch.from_numpy(xl))
    sj, ej = jax_ds.spmv_csrds_pair(Aj, jnp.asarray(xh), jnp.asarray(xl))
    got = s.numpy().astype(np.float64) + e.numpy()
    want = np.asarray(sj, np.float64) + np.asarray(ej, np.float64)
    scale = np.abs(h.to_scipy()) @ np.abs(x) + 1e-300
    assert np.max(np.abs(got - want) / scale) <= 1e-12


@pytest.mark.parametrize("case", sorted(CASES))
def test_csrds_f64_passes_fp64_gate(case):
    h, _ = _hosts(CASES[case]())
    x = _x(h.n)
    y = ds.build_csrds(h).spmv_f64(x)
    gold = h.spmv_gold(x).astype(np.float64)
    assert y.shape == (h.m,)
    rel = np.abs(y - gold) / np.maximum(np.abs(gold), 1e-300)
    assert rel.max() < 1e-10
    assert check_accuracy(h, x, y, value_dtype=np.float64).passed


def test_csrds_beats_plain_f32():
    """tests/test_compensated.py's near-cancelling rows: fp32 fails the
    fp64 gate, CSRDS passes it."""
    m, k = 8, 2000
    pos = np.random.default_rng(11).uniform(1, 2, k // 2)
    vals = np.tile(np.r_[pos, -pos * (1 - 1e-4)], m)
    mat = sp.csr_matrix((vals, (np.repeat(np.arange(m), k),
                                np.tile(np.arange(k), m))), shape=(m, k))
    h, _ = _hosts(mat)
    x = np.ones(k)
    y32 = (mat.astype(np.float32) @ x.astype(np.float32)).astype(np.float64)
    assert not check_accuracy(h, x, y32, value_dtype=np.float64).passed
    y = ds.spmv_csrds_f64(ds.build_csrds(h), x)
    assert check_accuracy(h, x, y, value_dtype=np.float64).passed


def test_csrds_fp32_entry_and_dispatch():
    """The registered fp32 entry passes the fp32 gate; CSRDS takes
    ``torch`` on every device (no kernel: the JAX package computes it in
    XLA)."""
    h, _ = _hosts(ds_banded(1200, 30, seed=7))
    x = np.random.default_rng(0).uniform(-1, 1, h.n)
    x = x.astype(np.float32).astype(np.float64)     # fp32-representable
    A = ds.build_csrds(h)
    y = spmv(A, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (h.m,)
    assert check_accuracy(h, x, y.double().numpy(),
                          value_dtype=np.float32).passed
    for dev in ("cpu", "cuda"):
        assert default_impl("CSRDS", torch.device(dev)) == "torch"


def test_csrds_f64_takes_only_its_torch_pair():
    """CSRDS has one pair: the fp64 hook takes impl "torch" (or none) and
    refuses "cuda" rather than gating a pair the row does not time."""
    A = ds.build_csrds(HostCSR.from_scipy(ds_banded(300, 6, seed=1)))
    x = np.random.default_rng(2).uniform(-1, 1, 300)
    assert np.array_equal(ds.spmv_csrds_f64(A, x, impl="torch"),
                          ds.spmv_csrds_f64(A, x))
    with pytest.raises(ValueError, match="only the 'torch' pair"):
        ds.spmv_csrds_f64(A, x, impl="cuda")


def test_csrds_empty_rows_are_zero():
    h, _ = _hosts(_empty_rows())
    y = ds.spmv_csrds_f64(ds.build_csrds(h), np.array([1.0, 2.0, 3.0, 4.0]))
    assert np.allclose(y, _empty_rows() @ np.array([1.0, 2.0, 3.0, 4.0]))
    assert y[1] == 0 and y[2] == 0 and y[4] == 0


def test_csrds_moves_and_scales_whole():
    h, _ = _hosts(ds_banded(600, 20, seed=2))
    A = ds.build_csrds(h)
    B = A.to("cpu")
    assert B.device == torch.device("cpu") and B.kseg == A.kseg
    x = torch.as_tensor(_x(h.n), dtype=torch.float32)
    half = tree_map(lambda t: t * 0.5 if t.is_floating_point() else t, A)
    # the mask is a float plane too: scaled by 0.5 it scales the
    # products once more
    assert torch.allclose(spmv(half, x), 0.25 * spmv(A, x), rtol=1e-6,
                          atol=1e-6)
