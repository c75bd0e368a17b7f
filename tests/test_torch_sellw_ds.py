"""SELLWDS, the double-single SELLW, and SELLW's source-index plane in the
PyTorch port against the JAX package.

Builder parity: ``build_sellw(..., want_idx=True)`` must return the JAX
program and index plane (``np.array_equal``) on both packer tiers, and
``build_sellwds`` the JAX base program and lo plane; both packages refuse
a non-fp32 dtype, values past ``DS_MAX_ABS`` and n > 2^20. Semantic
parity: the port's plain pair (B13's plain version and the TwoSum combine)
against the JAX ``spmv_sellwds_xla_pair`` and the interpret-mode Pallas
``spmv_sellwds_pair``, |Δ(s + e)| ≤ 1e-12 of |A|·|x| (the same TwoSum
folds in the same order; XLA may contract a product into an add where
PyTorch rounds each step); ``spmv_f64`` must pass the reference's fp64
gate (max relative error < 1e-10 against ``spmv_gold``) and the fp32 entry
lie within 1e-6 of the fp32-x gold, as ``tests/test_sellw_ds.py`` holds the
JAX engine.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import spmv_research_tpu.io.native as jax_native
import spmv_research_tpu.ops.sellw as jax_sellw
import spmv_research_tpu.ops.sellw_ds as jax_sellw_ds
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

import spmv_research_tpu_torch.io.native as native
from spmv_research_tpu_torch.core.formats import tree_map
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import BenchConfig, bench_spmv
from spmv_research_tpu_torch.ops import sell_cuda as K
from spmv_research_tpu_torch.ops import sellw, sellw_ds, spmv
from spmv_research_tpu_torch.ops.compensated import _split_f64
from spmv_research_tpu_torch.ops.sellw import SellWBuildError, class_plan

from torch_cases import banded_matrix, ds_banded


def _hosts(mat):
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


@pytest.fixture
def python_tier(monkeypatch):
    """Both packages take the Python packer, as without the native library."""
    monkeypatch.setattr(native, "have_sellw_pack", lambda cap=128: False)
    monkeypatch.setattr(jax_native, "have_sellw_pack", lambda cap=128: False)


def _assert_same(A, Aj):
    for f in sellw.DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ({f: getattr(A, f) for f in sellw.META_FIELDS}
            == {f: getattr(Aj, f) for f in sellw.META_FIELDS})


def _want_idx_case(G):
    h, hj = _hosts(banded_matrix(1500, 1500, 200, 12, 0))
    A, idx = sellw.build_sellw(h, group=G, want_idx=True)
    Aj, idxj = jax_sellw.build_sellw(hj, group=G, want_idx=True)
    _assert_same(A, Aj)
    assert idx.dtype == np.int32 and np.array_equal(idx, idxj)
    # the plane names each live slot's source nnz: its value is that nnz's
    live = idx >= 0
    assert np.array_equal(A.vals.numpy()[live],
                          h.a.astype(np.float32)[idx[live]])
    assert not A.vals.numpy()[~live].any()
    # without want_idx the program is the same
    _assert_same(sellw.build_sellw(h, group=G), Aj)


def test_want_idx_native_tier_matches_jax():
    assert native.have_sellw_pack(), "the native host library is built"
    _want_idx_case(2)


@pytest.mark.parametrize("G", [2, 4])
def test_want_idx_python_tier_matches_jax(python_tier, G):
    _want_idx_case(G)


def _ds_pair(mat, **kw):
    h, hj = _hosts(mat)
    return h, hj, sellw_ds.build_sellwds(h, **kw), jax_sellw_ds.build_sellwds(
        hj, **kw)


def _assert_same_ds(A, Aj):
    _assert_same(A.base, Aj.base)
    assert np.array_equal(A.vlo.numpy(), np.asarray(Aj.vlo))
    assert A.vlo.dtype == torch.float32


def test_build_sellwds_native_tier_matches_jax():
    _, _, A, Aj = _ds_pair(ds_banded(2500, 50, seed=0))
    _assert_same_ds(A, Aj)
    assert A.vlo.abs().max() > 0          # lognormal values have lo bits


def test_build_sellwds_python_tier_matches_jax(python_tier):
    _, _, A, Aj = _ds_pair(ds_banded(1500, 40, seed=1), group=4)
    _assert_same_ds(A, Aj)


@pytest.mark.parametrize("why", ["dtype", "overflow", "wide"])
def test_sellwds_refuses_what_jax_refuses(why):
    if why == "wide":          # n > 2^20: past the JAX kernel's x planes
        mat = sp.csr_matrix((np.ones(3), ([0, 1, 2], [0, 5, (1 << 20)])),
                            shape=(3, (1 << 20) + 1))
    else:
        mat = ds_banded(500, 10, seed=5, lognormal=False)
    h, hj = _hosts(mat)
    if why == "overflow":
        h.a[0] = hj.a[0] = 1e35
    kw = dict(dtype=np.float64) if why == "dtype" else {}
    with pytest.raises(SellWBuildError):
        sellw_ds.build_sellwds(h, **kw)
    with pytest.raises(jax_sellw.SellWBuildError):
        jax_sellw_ds.build_sellwds(hj, **kw)


def _from_jax(Aj):
    leaves = {f: np.asarray(getattr(Aj.base, f)) for f in sellw.DATA_FIELDS}
    leaves["vlo"] = np.asarray(Aj.vlo)
    return sellw_ds.sellwds_from_jax(
        leaves, {f: getattr(Aj.base, f) for f in sellw.META_FIELDS})


def _pair_gap(h, x, pair, pair_j):
    s, e = pair
    got = s.numpy().astype(np.float64) + e.numpy()
    want = (np.asarray(pair_j[0], np.float64)
            + np.asarray(pair_j[1], np.float64))
    scale = np.abs(h.to_scipy()) @ np.abs(x) + 1e-300
    return float(np.max(np.abs(got - want) / scale))


@pytest.mark.parametrize("seed, lognormal", [(0, True), (3, False)])
def test_plain_pair_matches_jax_xla_pair(seed, lognormal):
    h, _, _, Aj = _ds_pair(ds_banded(2000, 60, seed=seed,
                                     lognormal=lognormal))
    A = _from_jax(Aj)
    x = np.random.default_rng(1).uniform(-1, 1, h.n)
    xh, xl = _split_f64(x)
    pair = sellw_ds.spmv_sellwds_torch_pair(A, torch.from_numpy(xh),
                                            torch.from_numpy(xl))
    pair_j = jax.jit(jax_sellw_ds.spmv_sellwds_xla_pair)(
        Aj, jnp.asarray(xh), jnp.asarray(xl))
    assert _pair_gap(h, x, pair, pair_j) <= 1e-12


def test_plain_pair_matches_jax_pallas_interpret():
    h, _, A, Aj = _ds_pair(ds_banded(1500, 40, seed=2))
    x = np.random.default_rng(4).uniform(-1, 1, h.n)
    xh, xl = _split_f64(x)
    pair = sellw_ds.spmv_sellwds_torch_pair(A, torch.from_numpy(xh),
                                            torch.from_numpy(xl))
    pair_j = jax.jit(jax_sellw_ds.spmv_sellwds_pair)(
        Aj, jnp.asarray(xh), jnp.asarray(xl))
    assert _pair_gap(h, x, pair, pair_j) <= 1e-12


def test_sellwds_passes_fp64_gate():
    h, _, A, _ = _ds_pair(ds_banded(2500, 50, seed=0))
    x = np.random.default_rng(1).uniform(-1, 1, h.m)
    gold = h.spmv_gold(x).astype(np.float64)
    y = A.spmv_f64(x)                    # a CPU program: the plain pair
    assert y.dtype == np.float64 and y.shape == (h.m,)
    rel = np.abs(y - gold) / np.maximum(np.abs(gold), 1e-300)
    assert rel.max() < 1e-10
    assert np.array_equal(y, sellw_ds.spmv_sellwds_f64(A, x, impl="torch"))
    # the fp32 entry stays close (the cast of x is the only loss)
    y32 = spmv(A, torch.as_tensor(x, dtype=torch.float32)).double().numpy()
    gold32 = h.to_scipy() @ x.astype(np.float32).astype(np.float64)
    assert (np.abs(y32 - gold32) / np.maximum(np.abs(gold32), 1e-300)
            ).max() < 1e-6


def test_kernel_wrapper_takes_plain_version_on_the_cpu():
    _, _, A, _ = _ds_pair(ds_banded(1200, 30, seed=7))
    B = A.base
    x = np.random.default_rng(2).uniform(-1, 1, B.n)
    xh, xl = (torch.from_numpy(v) for v in _split_f64(x))
    args = (B.word, B.vals, A.vlo, B.wrow, xh, xl, class_plan(B), B.G)
    K.reset_launch_counts()
    planes = K.sellwds_planes(*args)
    assert torch.equal(planes, K.sellwds_planes_torch(*args))
    assert planes.shape == (2, B.G * (B.wrow.numel() // 8) + 1, 128)
    assert not planes[:, -1].any()            # the zero row
    assert K.LAUNCHES["sellwds"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        sellw_ds.spmv_sellwds_cuda_pair(A, xh, xl)


@pytest.mark.parametrize("build", ["sellwds", "csrds"])
def test_bench_spmv_judges_ds_formats_at_fp64_gate(build):
    from spmv_research_tpu_torch.ops import build_csrds
    h, _ = _hosts(ds_banded(1200, 30, seed=7))
    A = (sellw_ds.build_sellwds if build == "sellwds" else build_csrds)(h)
    cfg = BenchConfig(min_num_loops=2, min_time_s=0.0, warmup_iters=1,
                      inner_iters=2)
    r = bench_spmv(h, A, config=cfg, matrix_name="t")
    assert r.metrics.mape < 1e-10 and r.metrics.passed   # the fp64 gate
    assert r.roofline_kind == "csr64" and r.num_loops >= 2
    assert r.format_name == A.format_name


def test_sellwds_moves_and_scales_whole():
    h, _, A, _ = _ds_pair(ds_banded(600, 20, seed=2))
    assert A.to("cpu").device == torch.device("cpu")
    x = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, h.n),
                        dtype=torch.float32)
    half = tree_map(lambda t: t * 0.5 if t.is_floating_point() else t, A)
    assert half.base.word is A.base.word
    assert torch.allclose(spmv(half, x), 0.5 * spmv(A, x), rtol=1e-6,
                          atol=1e-6)
    assert A.mem_footprint_bytes() == (A.base.mem_footprint_bytes()
                                       + 4 * A.vlo.numel())
