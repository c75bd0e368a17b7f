"""CLOSG's W = 0 back end in the port (kernels B5 and B6) against the JAX
package.

A 128-row group whose row ends span more than 64 window octaves gets no
windowed extraction: the program runs the r3 layer and the full segmented
scan (``_r3_scan_kernel_noval``), then picks each y element from one of C
candidate scan rows (``_extract_y_kernel``). Two matrices: 130 rows of 520
nnz (W = 0, C = 128, no capping), and the same shape with one row of 33,000
nnz, whose scan needs stage 15 and so the ``scan_hi`` guard plane.

A third matrix, 600 such rows under ``max_N = 2^17``, builds a
``ClosGChunked`` of 3 W = 0 chunks. On the card its SpMV extracts every
chunk's y in one launch of B6, written in place
(``closg_cand_yext_chunked``); here its plain version equals the per-chunk
extraction and concatenation, and a numpy emulation of the kernel's
block-to-chunk walk writes every y element once.

Both packages build the program from the same matrix and must give
identical arrays. The Pallas kernels run in interpret mode on the CPU; the
port runs the plain PyTorch versions, which its wrappers take for CPU
tensors. B5 and B6 are shifts, adds in the same order and picks, so they
must match exactly; y is held to 1e-6 of |A|·|x| against the JAX pallas
path (the 130-row case; the scan_hi case against the float64 executor only,
as its interpret run is slow).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos_gather import _extract_y_kernel
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build
from spmv_research_tpu.ops.clos_gather import (
    build_clos_gather_auto as jax_build_auto)
from spmv_research_tpu.ops.clos_gather import (
    execute_closg_numpy as jax_execute_numpy)
from spmv_research_tpu.ops.clos_pallas import _r3_scan_kernel_noval

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import (ClosGChunked, build_clos_gather,
                                         build_clos_gather_auto, spmv)
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops import clos_gather as CG
from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
from spmv_research_tpu_torch.ops.clos_gather import (
    DATA_FIELDS, META_FIELDS, execute_closg_numpy)
from spmv_research_tpu_torch.ops.clos_route import LANES, SUB

from torch_cases import (W0_CHUNK_N, random_cand_parts, rel_err,
                         w0_chunked_matrix, w0_matrix)

MATRICES = {"w0": lambda: w0_matrix(130, 520),
            "scan_hi": lambda: w0_matrix(130, 600, heavy=33000)}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def case(request):
    """(name, matrix, JAX ClosG, the port's own ClosG, x)."""
    mat = MATRICES[request.param]()
    Aj = jax_build(JaxHostCSR.from_scipy(mat))
    A = build_clos_gather(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0,
                                                         mat.shape[1])
    return request.param, mat, Aj, A, x.astype(np.float32)


def _r3_input(A, x):
    """The plane that enters the back end (front end, r2 layer)."""
    v = K.closg_front_torch(A.rowidx, A.perm_r1, A.vals_cs,
                            torch.from_numpy(x))
    return _t_bwd(K.clos_invreg_torch(_t_fwd(v, A.V), A.perm_r2), A.V)


def _jax_scan(Aj, v):
    """spmv_closg_pallas's W = 0 scan call (clos_gather.py:807)."""
    return _call(partial(_r3_scan_kernel_noval, (SUB * Aj.V, Aj.scan_stages)),
                 jnp.asarray(v.numpy()), Aj.perm_r3, Aj.scan_hi)


def test_program_identical(case):
    name, _, Aj, A, _ = case
    assert A.W == 0 and A.yext_classes == () and A.C > 64
    for f in DATA_FIELDS:
        assert np.array_equal(getattr(A, f).numpy(),
                              np.asarray(getattr(Aj, f))), f
    assert ({f: getattr(A, f) for f in META_FIELDS}
            == {f: getattr(Aj, f) for f in META_FIELDS})
    # the scan_hi case scans past stage 14, so its guards need the full plane
    assert (len(A.scan_stages) > 15) == (name == "scan_hi")
    assert (A.scan_hi.numel() == A.N) == (name == "scan_hi")
    # no classes: zero y batches, and border is never read
    assert A.acc_ptr.tolist() == [0] and A.acc_src.numel() == 0


def test_r3_scan_matches_noval_kernel(case):
    _, _, Aj, A, x = case
    v = _r3_input(A, x)
    want = np.asarray(_jax_scan(Aj, v))
    got = K.closg_r3_scan_torch(v, A.perm_r3, A.scan_hi, A.scan_stages)
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(K.closg_r3_scan(v, A.perm_r3, A.scan_hi,
                                       A.scan_stages), got)


def test_cand_yext_matches_extract_kernel(case):
    _, _, Aj, A, x = case
    scr = _jax_scan(Aj, _r3_input(A, x))
    C, m_rows = Aj.C, Aj.ysel.shape[0]
    want = pl.pallas_call(
        partial(_extract_y_kernel, (C, m_rows)),
        out_shape=jax.ShapeDtypeStruct((m_rows, LANES), scr.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(scr.at[Aj.ycand].get(), Aj.ysel)
    scr_t = torch.from_numpy(np.array(scr))
    got = K.closg_cand_yext_torch(scr_t, A.ycand, A.ysel)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.closg_cand_yext(scr_t, A.ycand, A.ysel), got)


def test_y_matches_jax_and_float64_executor(case):
    name, mat, Aj, A, x = case
    got = spmv(A, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    assert got.shape == (mat.shape[0],)
    x64 = x.astype(np.float64)
    ref = execute_closg_numpy(A, x64)
    assert np.array_equal(ref, jax_execute_numpy(Aj, x64))
    assert rel_err(mat, x, ref) <= 1e-7      # float32 values, float64 sums
    scale = np.abs(mat) @ np.abs(x64) + 1e-30
    assert np.max(np.abs(got - ref) / scale) <= 1e-6
    if name == "w0":                         # interpret run of ~8 s
        want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
        assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_from_jax_program_runs_w0(case):
    _, _, Aj, A, x = case
    from spmv_research_tpu_torch.ops import from_jax_program
    B = from_jax_program({f: np.asarray(getattr(Aj, f)) for f in DATA_FIELDS},
                         {f: getattr(Aj, f) for f in META_FIELDS})
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))


# ------------------------------------------------ the chunked W = 0 program

@pytest.fixture(scope="module")
def chunked():
    """(matrix, JAX ClosGChunked, the port's own, x)."""
    mat = w0_chunked_matrix()
    Aj = jax_build_auto(JaxHostCSR.from_scipy(mat), max_N=W0_CHUNK_N)
    A = build_clos_gather_auto(HostCSR.from_scipy(mat), max_N=W0_CHUNK_N)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0,
                                                         mat.shape[1])
    return mat, Aj, A, x.astype(np.float32)


def test_chunked_program_identical(chunked):
    _, Aj, A, _ = chunked
    assert isinstance(A, ClosGChunked) and len(A.chunks) >= 3
    assert all(c.W == 0 for c in A.chunks)
    assert A.row_split == tuple(Aj.row_split)
    assert all((r1 - r0) % LANES for r0, r1 in zip(A.row_split,
                                                    A.row_split[1:]))
    for c, cj in zip(A.chunks, Aj.chunks):
        assert c.m == cj.m
        for f in DATA_FIELDS:
            assert np.array_equal(getattr(c, f).numpy(),
                                  np.asarray(getattr(cj, f))), f


def test_chunked_extraction_in_place(chunked):
    """The one-launch extraction's plain version equals the per-chunk
    extraction and concatenation exactly; the W = 0 dispatch through the
    plain versions equals the torch impl, and y is within 1e-6 of
    |A|·|x| of JAX's SpMV of the same program."""
    mat, Aj, A, x = chunked
    xt = torch.from_numpy(x)
    parts = [(CG._w0_scan(c, xt, CG._kernels(plain=True)), c.ycand, c.ysel)
             for c in A.chunks]
    got = K.closg_cand_yext_chunked_torch(parts, A.row_split)
    want = torch.cat([K.closg_cand_yext_torch(*p).reshape(-1)[:c.m]
                      for p, c in zip(parts, A.chunks)])
    assert torch.equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(K.closg_cand_yext_chunked(parts, A.row_split), got)
    y = CG._w0_chunks(A, xt, plain=True)
    assert torch.equal(y, got) and torch.equal(y, spmv(A, xt))
    want_j = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="xla"))
    scale = np.abs(mat) @ np.abs(x.astype(np.float64)) + 1e-30
    assert np.max(np.abs(y.numpy() - want_j) / scale) <= 1e-6


def _emulate_b6(parts, ms, row0s, n_y):
    """``csrc/closg.cu`` ``cand_yext_kernel`` in numpy, launch by launch of
    ``cand_yext_plan``: block b finds its program by walking the prefix of
    block counts; thread t takes the ysel quads at 4·(t + q·threads) of
    the block's elements; element e of program i, if e < ms[i], is
    y[row0s[i] + e]. Returns (y, the number of writes of each element)."""
    y = np.full(n_y, np.nan, np.float32)
    writes = np.zeros(n_y, np.int64)
    t = np.arange(K.YEXT_THREADS)
    for ids, block0 in K.cand_yext_plan(ms):
        assert len(ids) <= K.YEXT_MAX_CHUNKS and block0[0] == 0
        for b in range(block0[-1]):
            c = 0
            while b >= block0[c + 1]:
                c += 1
            i = ids[c]
            scr, ycand, ysel = (p.numpy() for p in parts[i])
            sel = ysel.reshape(-1).view(np.uint32)
            m_rows = ysel.shape[0]
            e0 = (b - block0[c]) * K.YEXT_BLOCK_ELEMS
            for q in range(K.YEXT_QUADS):
                e = (e0 + 4 * (t + q * K.YEXT_THREADS))[:, None] + np.arange(4)
                e = e[e < ms[i]]
                s = sel[e]
                row = ycand[((s >> 7) & 0x7F).astype(np.int64) * m_rows
                            + (e >> 7)]
                y[row0s[i] + e] = scr[row, s & 0x7F]
                np.add.at(writes, row0s[i] + e, 1)
    return y, writes


@pytest.mark.parametrize("ms", [
    [1000, 100, 4101],                 # ragged, and under 128 rows
    [128, 1, 1024, 1025, 127],         # whole and part blocks
    [77] * 40,                         # more chunks than the by-value cap
    list(range(1, 70)),                # 3 launches, every remainder
], ids=["ragged", "blocks", "past_cap", "many"])
def test_b6_block_walk_writes_each_row_once(ms):
    rng = np.random.Generator(np.random.PCG64(len(ms)))
    parts = random_cand_parts(rng, ms)
    row_split = np.concatenate([[0], np.cumsum(ms)]).tolist()
    y, writes = _emulate_b6(parts, ms, row_split[:-1], row_split[-1])
    assert (writes == 1).all()
    want = K.closg_cand_yext_chunked_torch(parts, row_split)
    assert np.array_equal(y, want.numpy())
    plan = K.cand_yext_plan(ms)
    assert len(plan) == -(-len(ms) // K.YEXT_MAX_CHUNKS)
    assert [i for ids, _ in plan for i in ids] == list(range(len(ms)))
