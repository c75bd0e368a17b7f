"""The XL tier (CLOSGX, kernel B15) in the port against the JAX package.

CLOSGX stacks C uniform CLOSG chunk programs (each forced to ``chunk_N``
slots, uncapped, with power-of-two extraction classes). Both packages build
the stacks from the same matrix at ``chunk_N = 8192`` and must give
identical arrays. The JAX package runs the stack as a ``lax.scan`` over
chunks (``spmv_closgx_pallas``, Pallas in interpret mode on the CPU, and the
``xla`` reference); the port runs every step once for all chunks with the
kernels' plain versions. y is held to 1e-6 of |A|·|x| against both, and
the port's float64 executor mirrors the ``xla`` impl.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_research_tpu.ops.clos_gather as jax_cg
import spmv_research_tpu.ops.clos_xl as jax_xl
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv

import spmv_research_tpu_torch.ops.clos_gather as cg
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.bench import _scale_for_iteration
from spmv_research_tpu_torch.ops import (ClosGX, RowSplit,
                                         build_clos_gather_auto,
                                         build_clos_gather_xl,
                                         closgx_from_jax,
                                         execute_closgx_numpy, spmv)
from spmv_research_tpu_torch.ops import clos_xl

from torch_cases import random_matrix, rel_err, skewed_xl_matrix

CHUNK_N = 8192


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    """Load the JAX package's native library before its two-thread chunk
    builds: its first load is not guarded against the second thread, which
    would take the numpy coloring and give other (valid) arrays."""
    from spmv_research_tpu.io import native as jax_native
    jax_native.get_lib()


def _same_stack(A, Aj):
    for f in clos_xl.DATA_FIELDS:
        assert np.array_equal(getattr(A, f).numpy(),
                              np.asarray(getattr(Aj, f))), f
    assert ({f: getattr(A, f) for f in clos_xl.META_FIELDS}
            == {f: getattr(Aj, f) for f in clos_xl.META_FIELDS})


def _near(mat, x, got, want, tol=1e-6):
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert got.shape == want.shape == (mat.shape[0],)
    assert np.max(np.abs(got - np.asarray(want)) / scale) <= tol


@pytest.fixture(scope="module")
def xl():
    """(matrix, JAX ClosGX, the port's own ClosGX, x): 4000 × 900, 4
    chunks of 8192 slots."""
    mat = random_matrix(4000, 900, 0.008, 5)
    Aj = jax_xl.build_clos_gather_xl(JaxHostCSR.from_scipy(mat),
                                     chunk_N=CHUNK_N)
    A = build_clos_gather_xl(HostCSR.from_scipy(mat), chunk_N=CHUNK_N)
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return mat, Aj, A, x.astype(np.float32)


def test_stack_identical(xl):
    _, Aj, A, _ = xl
    assert isinstance(A, ClosGX) and A.n_chunks == Aj.n_chunks >= 3
    _same_stack(A, Aj)
    # the derived window starts point into each chunk's own rows
    S = 8 * A.V
    offset = S * np.arange(A.n_chunks)[:, None]
    assert np.array_equal(A.wstart_abs.numpy(), A.wstart.numpy() + offset)


def test_y_matches_jax_pallas_and_xla(xl):
    mat, Aj, A, x = xl
    got = spmv(A, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    _near(mat, x, got, jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    _near(mat, x, got, jax_spmv(Aj, jnp.asarray(x), impl="xla"))


def test_float64_executor_mirrors_the_xla_impl(xl):
    mat, Aj, A, x = xl
    ref = execute_closgx_numpy(A, x.astype(np.float64))
    assert rel_err(mat, x, ref) <= 1e-7       # float32 values, float64 sums
    _near(mat, x, ref, jax_spmv(Aj, jnp.asarray(x), impl="xla"))


def test_back_end_matches_per_chunk_reference(xl):
    """B15's plain version runs every chunk of the stack at once: padded y
    rows read 0, the wrapper takes it for CPU tensors, and the rows that
    ``ymap`` picks are the SpMV's y."""
    _, _, A, x = xl
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
    V = A.V
    v = K.closg_front_torch(A.rowidx.view(-1), A.r1.view(-1, 128),
                            A.vals.view(-1, 128), torch.from_numpy(x))
    v = _t_bwd(K.clos_invreg_torch(_t_fwd(v, V), A.r2.view(-1, V // 8)), V)
    y = K.closgx_r3_scan_yext_torch(v, A.r3.view(-1, 128),
                                    A.ysel_w.view(-1, 128),
                                    A.wstart_abs.view(-1), A.stages, A.N)
    assert tuple(y.shape) == (A.n_chunks * A.mrp, 128)
    # padded rows carry the empty bit and read 0
    pad = ((A.ysel_w.view(-1, 128) >> 16) & 1).bool()
    assert torch.all(y[pad] == 0)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(
        K.closgx_r3_scan_yext(v, A.r3.view(-1, 128), A.ysel_w.view(-1, 128),
                              A.wstart_abs.view(-1), A.stages, A.N), y)
    assert torch.equal(y[A.ymap.long()].view(-1)[: A.m],
                       spmv(A, torch.from_numpy(x)))


def test_huge_n_front_end(monkeypatch):
    """Past the JAX package's VMEM limit for x its front end takes
    XLA-gathered windows (``_gmul_r1_kernel``); the port's K1 reads x from
    device memory at any n, so only the JAX side is patched."""
    monkeypatch.setattr(jax_xl, "_X_VMEM_BYTES", 1024)
    mat = random_matrix(2000, 1500, 0.01, 6)
    Aj = jax_xl.build_clos_gather_xl(JaxHostCSR.from_scipy(mat),
                                     chunk_N=CHUNK_N)
    A = build_clos_gather_xl(HostCSR.from_scipy(mat), chunk_N=CHUNK_N)
    assert A.n_chunks >= 2
    _same_stack(A, Aj)
    x = np.random.Generator(np.random.PCG64(8)).uniform(
        -1.0, 1.0, mat.shape[1]).astype(np.float32)
    _near(mat, x, spmv(A, torch.from_numpy(x)).numpy(),
          jax_spmv(Aj, jnp.asarray(x), impl="pallas"))


def test_auto_routes_to_the_xl_tier():
    mat = random_matrix(3000, 800, 0.01, 9)
    Aj = jax_cg.build_clos_gather_auto(JaxHostCSR.from_scipy(mat),
                                       max_N=CHUNK_N, max_chunks=2)
    A = build_clos_gather_auto(HostCSR.from_scipy(mat), max_N=CHUNK_N,
                               max_chunks=2)
    assert A.format_name == Aj.format_name == "CLOSGX"
    _same_stack(A, Aj)


@pytest.fixture(scope="module")
def split_xl():
    """(matrix, JAX RowSplit over ClosGX, the port's own, x)."""
    mat = skewed_xl_matrix()
    mp = pytest.MonkeyPatch()
    mp.setattr(cg, "SPLIT_ROW_NNZ", 512)
    mp.setattr(jax_cg, "SPLIT_ROW_NNZ", 512)
    try:
        Aj = jax_cg.build_clos_gather_auto(JaxHostCSR.from_scipy(mat),
                                           max_N=CHUNK_N, max_chunks=1)
        A = build_clos_gather_auto(HostCSR.from_scipy(mat), max_N=CHUNK_N,
                                   max_chunks=1)
    finally:
        mp.undo()
    x = np.random.Generator(np.random.PCG64(7)).uniform(
        -1.0, 1.0, mat.shape[1]).astype(np.float32)
    return mat, Aj, A, x


def test_rowsplit_over_closgx(split_xl):
    mat, Aj, A, x = split_xl
    assert isinstance(A, RowSplit) and isinstance(A.inner, ClosGX)
    assert Aj.inner.format_name == "CLOSGX" and A.inner.n_chunks > 1
    _same_stack(A.inner, Aj.inner)
    got = spmv(A, torch.from_numpy(x)).numpy()
    _near(mat, x, got, jax_spmv(Aj, jnp.asarray(x), impl="pallas"))


def test_closgx_from_jax(split_xl):
    from spmv_research_tpu_torch.ops import rowsplit_from_jax
    _, Aj, A, x = split_xl
    inner = closgx_from_jax(
        {f: np.asarray(getattr(Aj.inner, f)) for f in clos_xl.DATA_FIELDS},
        {f: getattr(Aj.inner, f) for f in clos_xl.META_FIELDS})
    B = rowsplit_from_jax({"heavy_rows": np.asarray(Aj.heavy_rows),
                           "gidx": np.asarray(Aj.gidx)},
                          {"shape": Aj.shape, "nnz": Aj.nnz,
                           "nnz_expanded": Aj.nnz_expanded,
                           "n_extra": Aj.n_extra}, inner)
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))


def _tensors(obj):
    """Every tensor a format holds, through nested dataclasses."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v)


def test_move_and_scaled_copy_reach_every_tensor(split_xl):
    """``.to`` and the bench's timing copy reach the stacked planes inside
    RowSplit.inner: every tensor moves, and y of the scaled copy is c·y."""
    mat, _, A, x = split_xl
    names = dict(_tensors(A))
    assert {"heavy_rows", "gidx", "vals", "r1", "r2", "r3", "ymap",
            "wstart_abs"} <= set(names)
    B = A.to("meta")
    assert all(t.device.type == "meta" for _, t in _tensors(B))
    assert all(t.device.type == "cpu" for _, t in _tensors(A))
    host = HostCSR.from_scipy(mat)
    c = 1.0 / float(np.abs(mat).sum(axis=1).max())
    xt = torch.from_numpy(x)
    y, y_s = spmv(A, xt).double(), spmv(_scale_for_iteration(host, A),
                                         xt).double()
    scale = torch.from_numpy(np.abs(mat) @ np.abs(x).astype(np.float64))
    assert torch.all((y_s - c * y).abs() <= 1e-6 * c * scale)
    assert not torch.allclose(y_s, y, rtol=1e-3)
