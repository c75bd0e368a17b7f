"""The XLA-only engines in the port against the JAX package: SELLG (SpMM),
BSRG (SpMV, SpMM), CSR_LUT (SpMV, SpMM) and the two SDDMMs ``CSR/gather``
and ``BSR/mxu``.

Each builder must give the JAX builder's arrays (``np.array_equal``, the
dtype of every array), meta fields and ``mem_footprint_bytes``; each plain
impl must be within 1e-5 of max |y| of JAX's ``xla``/``gather``/``mxu``
impl on the same seeded inputs; ``bench_sddmm`` on ``BSR/mxu`` must
validate the block layout in CSR order (JAX's reads it as CSR order: the
test asserts its wrong error so that the divergence stays documented); and
the sweep must run ``sellg``, ``bsrg`` and ``csr_lut`` under JAX's names
and labels.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from spmv_research_tpu.convert import build_bsr as jax_build_bsr
from spmv_research_tpu.convert import build_csr as jax_build_csr
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import bench as jax_bench
from spmv_research_tpu.harness import sweep as jax_sweep
from spmv_research_tpu.harness import workloads as jax_workloads
from spmv_research_tpu.harness.config import BenchConfig as JaxBenchConfig
from spmv_research_tpu.ops import bsr_mxu as jax_bsr_mxu
from spmv_research_tpu.ops import gatherk as jax_gatherk
from spmv_research_tpu.ops import value_compress as jax_vc
from spmv_research_tpu.ops import sddmm as jax_sddmm, spmm as jax_spmm
from spmv_research_tpu.ops import spmv as jax_spmv

from spmv_research_tpu_torch.convert import BSRBuildError, build_bsr
from spmv_research_tpu_torch.convert import build_csr
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness.workloads import bench_sddmm
from spmv_research_tpu_torch.ops import (bsr_mxu, default_impl, gatherk,
                                         sddmm, spmm, spmv, value_compress)
from spmv_research_tpu_torch.ops.dispatch import PLAIN_FORMATS

from torch_cases import TWIN_LINE, random_matrix

TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1, inner_iters=2,
            k_dim=8)


def _blocked(mb=20, nb=12, br=8, bc=128, frac=0.15, seed=1234):
    """tests/test_bsr_mxu.py's _blocked_host: a random subset of the
    (br, bc) blocks is dense."""
    rng = np.random.Generator(np.random.PCG64(seed))
    mask = rng.random((mb, nb)) < frac
    mask[0, 0] = True
    dense = np.where(np.kron(mask, np.ones((br, bc), bool)),
                     rng.uniform(-1, 1, (mb * br, nb * bc)), 0.0)
    return sp.csr_matrix(dense)


def _twin():
    mat = generate_from_line(TWIN_LINE)[0].to_scipy()
    mat.sort_indices()
    return mat


def _levels(u, nnz=20_000, seed=3):
    """A 400 × 400 matrix of ``nnz`` entries taking exactly ``u`` distinct
    values (the CSR_LUT index dtype's boundaries)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    flat = rng.choice(400 * 400, nnz, replace=False)
    vals = rng.permutation(np.linspace(-1, 1, u))[np.arange(nnz) % u]
    mat = sp.csr_matrix((vals, (flat // 400, flat % 400)), shape=(400, 400))
    mat.sort_indices()
    return mat


def _with_empty_rows():
    """A 300 × 250 matrix with empty rows, one 200-entry row and a wide
    spread of row lengths (six width classes)."""
    mat = random_matrix(300, 250, 0.04, 5).tolil()
    mat[7, :200] = 0.5
    mat[40:60, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat


MATRICES = {"twin": _twin, "blocked": _blocked, "empty_rows": _with_empty_rows,
            "unaligned": lambda: random_matrix(500, 700, 0.02, 6)}
BUILDERS = {
    "sellg": (gatherk.build_sellg, jax_gatherk.build_sellg),
    "bsrg": (bsr_mxu.build_bsrg, jax_bsr_mxu.build_bsrg),
    "csr_lut": (value_compress.build_csr_lut, jax_vc.build_csr_lut),
}


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _pair(builder, mat):
    """(the port's format, JAX's) built from the same matrix."""
    ours, theirs = BUILDERS[builder]
    return ours(HostCSR.from_scipy(mat)), theirs(JaxHostCSR.from_scipy(mat))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _same_format(ours, theirs):
    assert ours.format_name == theirs.format_name
    for f in dataclasses.fields(theirs):
        want, got = getattr(theirs, f.name), getattr(ours, f.name)
        if isinstance(want, dict):
            assert list(got) == list(want), f.name
            for w in want:
                _same(got[w], want[w])
        elif isinstance(want, (int, tuple)):
            assert got == want, f.name
        else:
            _same(got, want)
    assert ours.mem_footprint_bytes() == theirs.mem_footprint_bytes()


@pytest.mark.parametrize("mat", sorted(MATRICES))
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builder_matches_jax(builder, mat):
    _same_format(*_pair(builder, _matrix(mat)))


@pytest.mark.parametrize("u, dtype", [(1, np.int8), (64, np.int8),
                                      (127, np.int8), (128, np.int16),
                                      (32767, np.int16), (32768, np.int32)])
def test_csr_lut_index_dtype_matches_jax(u, dtype):
    """The narrowest index dtype for the unique count, and the LUT's zero
    pad at index u, as JAX builds them."""
    ours, theirs = _pair("csr_lut", _levels(u, nnz=max(20_000, u)))
    _same_format(ours, theirs)
    assert ours.n_unique == u and ours.val_idx.numpy().dtype == dtype
    assert ours.lut[u] == 0 and torch.all(ours.val_idx[ours.nnz:] == u)


def test_bsrg_refuses_as_bsr():
    """BSRG goes through the port's build_bsr: the fill guard raises."""
    rng = np.random.Generator(np.random.PCG64(15))
    m = 20_000
    mat = sp.csr_matrix((rng.uniform(-1, 1, m),
                         (np.arange(m), rng.integers(0, 2_000_000, m))),
                        shape=(m, 2_000_000))
    mat.sort_indices()
    with pytest.raises(BSRBuildError) as got:
        bsr_mxu.build_bsrg(HostCSR.from_scipy(mat))
    with pytest.raises(ValueError) as want:
        jax_bsr_mxu.build_bsrg(JaxHostCSR.from_scipy(mat))
    assert str(got.value) == str(want.value)


def _x(shape, seed):
    return np.random.Generator(np.random.PCG64(seed)).uniform(
        -1, 1, shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                   1e-30)


def _jax(op, impl):
    return jax.jit(functools.partial(op, impl=impl))


@pytest.mark.parametrize("mat", sorted(MATRICES))
@pytest.mark.parametrize("builder", ["bsrg", "csr_lut"])
def test_spmv_matches_jax_xla(builder, mat):
    ours, theirs = _pair(builder, _matrix(mat))
    x = _x(ours.n, 9)
    y = spmv(ours, torch.from_numpy(x))
    _close(y, _jax(jax_spmv, "xla")(theirs, jnp.asarray(x)))


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("mat", ["twin", "blocked", "empty_rows"])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_spmm_matches_jax_xla(builder, mat, k):
    ours, theirs = _pair(builder, _matrix(mat))
    X = _x((ours.n, k), 10)
    Y = spmm(ours, torch.from_numpy(X))
    _close(Y, _jax(jax_spmm, "xla")(theirs, jnp.asarray(X)))


def test_bsrg_spmm_cut_into_pieces(monkeypatch):
    """A class's gather cut into many pieces gives the same Y."""
    A, _ = _pair("bsrg", _matrix("blocked"))
    X = torch.from_numpy(_x((A.n, 16), 11))
    whole = spmm(A, X)
    monkeypatch.setattr(bsr_mxu, "GATHER_ELEMS", 3 * 128 * 16)
    assert torch.equal(spmm(A, X), whole)


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("mat", ["twin", "empty_rows", "unaligned"])
def test_csr_gather_sddmm_matches_jax(mat, k):
    m = _matrix(mat)
    S = build_csr(HostCSR.from_scipy(m))
    Sj = jax_build_csr(JaxHostCSR.from_scipy(m), dtype=jnp.float32)
    A, B = _x((m.shape[0], k), 12), _x((m.shape[1], k), 13)
    C = sddmm(S, torch.from_numpy(A), torch.from_numpy(B), impl="gather")
    _close(C, _jax(jax_sddmm, "gather")(Sj, jnp.asarray(A), jnp.asarray(B)))
    assert torch.all(C[m.nnz:] == 0)
    assert torch.allclose(C, sddmm(S, torch.from_numpy(A),
                                   torch.from_numpy(B), impl="torch"),
                          rtol=1e-5, atol=1e-6)


def test_csr_gather_sddmm_chunks():
    """More than one 2^17-nnz chunk (here cut to 1000): the same values."""
    m = _matrix("twin")
    S = build_csr(HostCSR.from_scipy(m))
    A, B = (torch.from_numpy(_x((s, 8), 14 + i))
            for i, s in enumerate(m.shape))
    assert torch.equal(gatherk.sddmm_csr_gather(S, A, B, chunk=1000),
                       gatherk.sddmm_csr_gather(S, A, B))


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("mat", ["twin", "blocked", "unaligned"])
def test_bsr_mxu_sddmm_matches_jax(mat, k):
    m = _matrix(mat)
    S = build_bsr(HostCSR.from_scipy(m))
    Sj = jax_build_bsr(JaxHostCSR.from_scipy(m))
    A, B = _x((m.shape[0], k), 15), _x((m.shape[1], k), 16)
    C = sddmm(S, torch.from_numpy(A), torch.from_numpy(B), impl="mxu")
    _close(C, _jax(jax_sddmm, "mxu")(Sj, jnp.asarray(A), jnp.asarray(B)))
    # in CSR order, the per-nnz dots
    host = HostCSR.from_scipy(m)
    vals = bsr_mxu.bsr_sddmm_to_csr_values(S, C, host)
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    gold = np.einsum("ij,ij->i", A[rows].astype(np.float64),
                     B[m.indices].astype(np.float64))
    assert np.max(np.abs(vals - gold)) <= 1e-5 * np.max(np.abs(gold))


def test_bench_sddmm_bsr_mxu_validates_in_csr_order():
    """The port maps BSR/mxu's block layout to CSR order before the check;
    JAX's bench_sddmm reads the block layout as CSR order, so its error
    columns are wrong on the same matrix (a standing divergence)."""
    m = _blocked(mb=32, nb=2, frac=0.7, seed=17)
    host = HostCSR.from_scipy(m)
    r = bench_sddmm(host, build_bsr(host), config=BenchConfig(**TINY),
                    impl="mxu", matrix_name="blocked")
    assert r.format_name == "BSR" and r.impl == "mxu"
    assert r.out.shape == (m.nnz,) and r.mape < 1e-5
    rj = jax_workloads.bench_sddmm(
        JaxHostCSR.from_scipy(m), jax_build_bsr(JaxHostCSR.from_scipy(m)),
        config=JaxBenchConfig(**TINY), impl="mxu")
    assert rj.mape > 0.1


def test_xla_engines_take_torch_on_the_card():
    assert {"SELLG", "BSRG", "CSR_LUT"} <= PLAIN_FORMATS
    cuda = torch.device("cuda")
    for fmt in ("SELLG", "BSRG", "CSR_LUT"):
        assert default_impl(fmt, cuda) == "torch"
    from spmv_research_tpu_torch.harness.sweep import sweep_impls
    assert sweep_impls("spmm", "SELLG", cuda) == ["torch"]
    assert sweep_impls("spmv", "SELLG", cuda) == []
    assert sweep_impls("sddmm", "CSR", cuda) == ["gather", "torch"]
    assert sweep_impls("sddmm", "BSR", cuda) == ["mxu"]


def test_formats_move_with_their_slabs():
    """``.to`` moves the dict slabs too (the device of every tensor)."""
    A, _ = _pair("sellg", _matrix("twin"))
    B = A.to("meta")
    assert B.inv_perm.device.type == "meta"
    assert all(t.device.type == "meta" for d in (B.idx, B.val)
               for t in d.values())
    assert list(B.idx) == list(A.idx)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The port's and JAX's sweeps of sellg, bsrg and csr_lut (SpMV, SpMM)
    over the 2000-row scircuit twin, on the CPU."""
    base = tmp_path_factory.mktemp("xla_engines")
    fmts, wls = ("sellg", "bsrg", "csr_lut"), ("spmv", "spmm")
    ours = run_sweep([TWIN_LINE], formats=fmts, workloads=wls,
                     out_dir=str(base / "ours"), config=BenchConfig(**TINY),
                     device="cpu")
    theirs = jax_sweep.run_sweep([TWIN_LINE], formats=fmts, workloads=wls,
                                 impls=["xla"], out_dir=str(base / "jax"),
                                 config=JaxBenchConfig(**TINY))
    return base, ours, theirs


def test_sweep_rows_match_jax(sweeps):
    """The same CSVs, labels and row counts as JAX's sweep; the same
    matrix columns (SpMV: the synthetic schema up to the format name) and
    format names with the port's impl."""
    base, ours, theirs = sweeps
    names = sorted(p.name for p in (base / "jax").glob("*.csv"))
    assert names == sorted(p.name for p in (base / "ours").glob("*.csv"))
    assert names == ["bsrg_spmm.csv", "bsrg_spmv.csv", "csr_lut_spmm.csv",
                     "csr_lut_spmv.csv", "sellg_spmm.csv"]
    for name in names:
        want = (base / "jax" / name).read_text().splitlines()
        got = (base / "ours" / name).read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want) == 2
        g, w = got[1].split(","), want[1].split(",")
        assert len(g) == len(w)
        if name.endswith("spmv.csv"):
            assert w[23].endswith("_xla") and g[23] == w[23][:-4] + "_torch"
            assert g[:23] == w[:23]
        else:
            assert g[:2] + g[3:4] == w[:2] + w[3:4] and g[2] == "torch"
    assert sorted(f"{r.format_name}/{r.impl}" for r in ours) == [
        "BSRG/torch", "BSRG/torch", "CSR_LUT/torch", "CSR_LUT/torch",
        "SELLG/torch"]
    assert len(theirs) == len(ours)
    for r in ours:
        assert r.metrics.max_rel_err < 1e-5


def test_sweep_labels_are_jax_s(sweeps):
    base, _, _ = sweeps
    assert (base / "ours" / "csr_lut_spmv.csv").read_text().splitlines()[
        0] == jax_bench.csv_labels(synthetic=True)
