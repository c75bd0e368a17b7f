"""CLOSG kernel modules of the PyTorch port against the JAX pallas path.

Both sides run the identical program (built by the JAX package, carried over
with ``from_jax_program``) on the same seeded x. The JAX Pallas kernels run in
interpret mode on the CPU, as the JAX package's own tests run them; the port
runs each kernel's plain PyTorch version, which its wrapper takes for CPU
tensors. Tolerances: the two gather stages (front end, r2 layer) are pure
gathers and one product per slot, so they must match exactly; past the scan
the sums may differ in order, so y is held to 1e-6 of |A|·|x|.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spmv_research_tpu.convert.reorder import rcm_if_beneficial as jax_rcm
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.gen import generate_from_line as jax_generate
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos import _t_bwd as jax_t_bwd
from spmv_research_tpu.ops.clos import _t_fwd as jax_t_fwd
from spmv_research_tpu.ops.clos_gather import _gmul_dma
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build
from spmv_research_tpu.ops.clos_gather import (
    execute_closg_numpy as jax_execute_numpy)
from spmv_research_tpu.ops.clos_pallas import (_invreg_kernel,
                                               _r3_scan_yext_kernel)

from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops import spmv
from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
from spmv_research_tpu_torch.ops.clos_gather import (
    DATA_FIELDS, META_FIELDS, _accum_order, execute_closg_numpy,
    from_jax_program)
from spmv_research_tpu_torch.ops.clos_route import LANES, SUB

from torch_cases import TWIN_LINE, capped_scan_matrix


def _jax_host(case):
    if case == "twin":
        return jax_rcm(jax_generate(TWIN_LINE)[0])[0]
    return JaxHostCSR.from_scipy(capped_scan_matrix())


def _programs(case):
    """(JAX ClosG, the port's ClosG of the same program, JAX host CSR)."""
    hj = _jax_host(case)
    Aj = jax_build(hj)
    A = from_jax_program({f: np.asarray(getattr(Aj, f)) for f in DATA_FIELDS},
                         {f: getattr(Aj, f) for f in META_FIELDS})
    return Aj, A, hj


@pytest.fixture(scope="module", params=["twin", "capped_scan"])
def case(request):
    Aj, A, hj = _programs(request.param)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, hj.n)
    return Aj, A, hj, x.astype(np.float32)


def _jax_back_end(Aj, v):
    """The pallas call of spmv_closg_pallas's W>0 back end (clos_gather.py)."""
    S = SUB * Aj.V
    return pl.pallas_call(
        partial(_r3_scan_yext_kernel,
                (S, Aj.scan_cap or Aj.scan_stages, Aj.yext_classes)),
        out_shape=jax.ShapeDtypeStruct((Aj.ysel_w.shape[0], LANES), v.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4
        + [pl.BlockSpec(memory_space=pltpu.SMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((S, LANES), v.dtype)],
        interpret=True,
    )(v, Aj.perm_r3, Aj.scan_hi, Aj.ysel_w, Aj.wstart, Aj.border)


def test_program_shape(case):
    Aj, A, hj, _ = case
    assert A.W and A.scan_cap and A.acc_src.numel() > 0
    assert A.N == Aj.N and A.V == Aj.V


def test_front_matches_gmul_dma(case):
    Aj, A, _, x = case
    want = np.asarray(_gmul_dma(Aj, jnp.asarray(x)))
    got = K.closg_front_torch(A.rowidx, A.perm_r1, A.vals_cs,
                              torch.from_numpy(x))
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(K.closg_front(A.rowidx, A.perm_r1, A.vals_cs,
                                     torch.from_numpy(x)), got)


def test_invreg_r2_matches_invreg_kernel(case):
    Aj, A, _, x = case
    vj = jax_t_fwd(_gmul_dma(Aj, jnp.asarray(x)), Aj.V)
    assert vj.shape[1] == Aj.V // SUB < LANES       # narrow r2 lanes
    want = np.asarray(_call(_invreg_kernel, vj, Aj.perm_r2))
    v = torch.from_numpy(np.array(vj))
    got = K.clos_invreg_torch(v, A.perm_r2)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(K.clos_invreg(v, A.perm_r2), got)


def test_transposes_match(case):
    Aj, A, _, x = case
    vj = _gmul_dma(Aj, jnp.asarray(x))
    v = torch.from_numpy(np.array(vj))
    assert np.array_equal(_t_fwd(v, A.V).numpy(),
                          np.asarray(jax_t_fwd(vj, Aj.V)))
    w = _t_fwd(v, A.V)
    assert np.array_equal(_t_bwd(w, A.V).numpy(),
                          np.asarray(jax_t_bwd(jax_t_fwd(vj, Aj.V), Aj.V)))


def test_r3_scan_yext_matches_pallas_back_end(case):
    Aj, A, hj, x = case
    vj = jax_t_bwd(_call(_invreg_kernel, jax_t_fwd(_gmul_dma(
        Aj, jnp.asarray(x)), Aj.V), Aj.perm_r2), Aj.V)
    want = np.asarray(_jax_back_end(Aj, vj)).reshape(-1)[: Aj.m]
    args = (torch.from_numpy(np.array(vj)), A.perm_r3, A.scan_hi, A.ysel_w,
            A.wstart, A.acc_ptr, A.acc_src, A.scan_cap or A.scan_stages)
    got = K.closg_r3_scan_yext_torch(*args).reshape(-1)[: A.m].numpy()
    scale = np.abs(hj.to_scipy()) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    assert torch.equal(K.closg_r3_scan_yext(*args),
                       K.closg_r3_scan_yext_torch(*args))


def test_closg_torch_matches_jax_pallas(case):
    Aj, A, hj, x = case
    want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    got = spmv(A, torch.from_numpy(x)).numpy()      # CPU tensor: "torch"
    scale = np.abs(hj.to_scipy()) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_execute_closg_numpy_identical(case):
    Aj, A, _, x = case
    x64 = x.astype(np.float64)
    assert np.array_equal(execute_closg_numpy(A, x64),
                          jax_execute_numpy(Aj, x64))


def test_accum_order_keeps_class_order():
    # batches 0,1 are base; records 2..4 add into batch 1, 0, 1 in that order
    border = np.array([0 | 0 << 16, 1 | 1 << 16, 2 | 1 << 16, 3 | 0 << 16,
                       4 | 1 << 16], np.int32)
    classes = ((1, 0, 2, 0), (1, 2, 2, 1), (2, 4, 1, 1))
    acc_ptr, acc_src = _accum_order(border, classes)
    assert acc_ptr.tolist() == [0, 1, 3]
    assert acc_src.tolist() == [3, 2, 4]
    swapped = np.array([0 | 1 << 16, 1 | 0 << 16], np.int32)
    with pytest.raises(ValueError, match="every batch"):
        _accum_order(swapped, ((1, 0, 2, 0),))
    with pytest.raises(ValueError, match="follows"):
        _accum_order(border, ((1, 2, 3, 1), (1, 0, 2, 0)))


def test_cuda_impl_refuses_cpu_tensors(case):
    _, A, _, x = case
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A, torch.from_numpy(x), impl="cuda")


# ------------------------------------------------------- row-chunked CLOSG

CHUNK_N = 1 << 13       # a small max_N, so the 2000-row twin needs chunks


@pytest.fixture(scope="module")
def chunked():
    """(JAX ClosGChunked, the port's own build, JAX host, x)."""
    from spmv_research_tpu.ops.clos_gather import (
        build_clos_gather_auto as jax_auto)
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.ops import build_clos_gather_auto

    hj = _jax_host("twin")
    Aj = jax_auto(hj, max_N=CHUNK_N)
    A = build_clos_gather_auto(HostCSR.from_arrays(hj.ia, hj.ja, hj.a, hj.m,
                                                   hj.n), max_N=CHUNK_N)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, hj.n)
    return Aj, A, hj, x.astype(np.float32)


def test_chunked_program_identical(chunked):
    from spmv_research_tpu_torch.ops import ClosGChunked
    Aj, A, _, _ = chunked
    assert isinstance(A, ClosGChunked) and len(A.chunks) > 1
    assert (A.shape, A.nnz, A.nnz_expanded, A.row_split) == (
        Aj.shape, Aj.nnz, Aj.nnz_expanded, Aj.row_split)
    for c, cj in zip(A.chunks, Aj.chunks, strict=True):
        for f in DATA_FIELDS:
            assert np.array_equal(getattr(c, f).numpy(),
                                  np.asarray(getattr(cj, f))), f
        assert ({f: getattr(c, f) for f in META_FIELDS}
                == {f: getattr(cj, f) for f in META_FIELDS})


def test_chunked_torch_matches_jax_pallas(chunked):
    Aj, A, hj, x = chunked
    want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    got = spmv(A, torch.from_numpy(x)).numpy()
    scale = np.abs(hj.to_scipy()) @ np.abs(x).astype(np.float64) + 1e-30
    assert got.shape == (hj.m,)
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    x64 = x.astype(np.float64)
    assert np.array_equal(execute_closg_numpy(A, x64),
                          jax_execute_numpy(Aj, x64))


def test_chunked_program_moves_whole(chunked):
    """Tentpole repair: ``.to`` reaches the tensors of every chunk."""
    _, A, _, _ = chunked
    B = A.to("meta")
    assert B.device.type == "meta" and B.row_split == A.row_split
    for c in B.chunks:
        assert all(getattr(c, f).device.type == "meta"
                   for f in DATA_FIELDS + ("acc_ptr", "acc_src"))
    assert all(c.device.type == "cpu" for c in A.chunks)


def test_chunked_scaled_copy_gives_scaled_y(chunked):
    """Tentpole repair: the bench's timing copy scales every chunk's values,
    so y of the copy is c·y."""
    from spmv_research_tpu_torch.harness.bench import _scale_for_iteration
    from spmv_research_tpu_torch.core.host import HostCSR
    _, A, hj, x = chunked
    host = HostCSR.from_arrays(hj.ia, hj.ja, hj.a, hj.m, hj.n)
    c = 1.0 / float(np.abs(host.to_scipy()).sum(axis=1).max())
    xt = torch.from_numpy(x)
    y, y_s = spmv(A, xt).double(), spmv(_scale_for_iteration(host, A),
                                         xt).double()
    assert torch.allclose(y_s, c * y, rtol=1e-6, atol=0)
    assert not torch.allclose(y_s, y, rtol=1e-3)


def test_chunked_auto_refuses_the_xl_tier():
    """Past ``max_chunks`` the chunk loop is not taken: the matrix goes to
    the XL tier, as in the JAX builder (the port used to raise here)."""
    from spmv_research_tpu.ops.clos_gather import (
        build_clos_gather_auto as jax_auto)
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.ops import ClosGX, build_clos_gather_auto
    hj = _jax_host("twin")
    host = HostCSR.from_arrays(hj.ia, hj.ja, hj.a, hj.m, hj.n)
    A = build_clos_gather_auto(host, max_N=CHUNK_N, max_chunks=1)
    Aj = jax_auto(hj, max_N=CHUNK_N, max_chunks=1)
    assert isinstance(A, ClosGX) and Aj.format_name == "CLOSGX"
    assert A.n_chunks == Aj.n_chunks > 1
