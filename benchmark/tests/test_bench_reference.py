"""The plain reference against dense float64 products, its CG, and the two
comparisons that decide ``correct``."""

import numpy as np
import pytest
import torch

from benchmark import matrices, reference

LINE = "1500 1200 20 6 normal random 0.3 0.5 1.2 0.6 11"


@pytest.fixture(scope="module")
def csr():
    return matrices.generate_twin(LINE)


def _dense(csr):
    return csr.to_scipy().toarray()


def test_reference_spmv_equals_the_dense_product(csr, monkeypatch):
    x = np.random.default_rng(0).random(csr.n)
    want = _dense(csr) @ x
    for block in (1 << 24, 1000):     # one block and many
        monkeypatch.setattr(reference, "BLOCK_NNZ", block)
        y = reference.RefMatrix(csr, "cpu").spmv(torch.from_numpy(x))
        assert y.dtype == torch.float64
        assert np.allclose(y.numpy(), want, rtol=1e-13, atol=1e-13)


def test_reference_spmm_equals_the_dense_product(csr, monkeypatch):
    X = np.random.default_rng(1).random((csr.n, 7))
    monkeypatch.setattr(reference, "BLOCK_SLOTS", 7 * 500)
    Y = reference.RefMatrix(csr, "cpu").spmm(torch.from_numpy(X))
    assert np.allclose(Y.numpy(), _dense(csr) @ X, rtol=1e-13, atol=1e-13)


def test_absolute_product_and_inverse_diagonal(csr):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(csr.n))
    neg = matrices.Csr(csr.ia, csr.ja, -csr.a, csr.m, csr.n)
    got = reference.RefMatrix(neg, "cpu", absolute=True).spmv(x.abs())
    assert np.allclose(got.numpy(), np.abs(_dense(csr)) @ np.abs(x.numpy()))
    spd = matrices.make_spd(matrices.generate_twin("600 600 8 2 normal "
                                                   "random 0.5 0 0 0 3"))
    d = np.diag(_dense(spd))
    inv = reference.RefMatrix(spd, "cpu").inv_diag().numpy()
    assert np.allclose(inv, 1.0 / d)


def test_reference_cg_reaches_its_tolerance():
    spd = matrices.make_spd(matrices.generate_twin(
        "800 800 12 3 normal random 0.4 0.5 1.0 0.5 5"))
    A = reference.RefMatrix(spd, "cpu")
    b = torch.rand(spd.m, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    x, it = reference.cg(A, b, 1e-10, 200)
    assert 0 < it < 200
    assert reference.rel_residual(A, b, x) < 1e-9
    # in bfloat16 the same solve stalls far above float32's rounding
    A16 = reference.RefMatrix(spd, "cpu", torch.bfloat16)
    x16, _ = reference.cg(A16, b, 1e-6, 50)
    assert reference.rel_residual(A, b, x16) > 1e-4


def test_rel_err_reads_the_worst_row_and_inf_for_nan():
    want = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    scale = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    y = torch.tensor([1.0, 2.002, 4.0], dtype=torch.float32)
    assert reference.rel_err(y, want, scale) == pytest.approx(1e-3, rel=1e-3)
    y[0] = float("nan")
    assert reference.rel_err(y, want, scale) == float("inf")
