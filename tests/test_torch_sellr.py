"""SELLR in the PyTorch port against the JAX package.

Program parity: identical program arrays (``np.array_equal``) and meta
fields from both builders, on a multi-step program (> 64 chunks), a program
with dirty chunks and wrap rolls, and rectangular matrices. Semantic
parity: the port's ``"torch"`` impl on the identical program (carried over
with ``sellr_from_jax``) against the JAX pallas impl in interpret mode (the
xla impl on the rectangular cases), within 1e-6 of |A|·|x|; the float64
host executors must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spmv_research_tpu.ops.sellr as jax_sellr
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

import spmv_research_tpu_torch.ops.sellr as sellr
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import sell_cuda as K
from spmv_research_tpu_torch.ops import spmv

from torch_cases import banded_matrix, dirty_sellr_matrix, scattered_matrix

# (matrix, max_slot_factor): the factors of tests/test_sellr.py
CASES = {
    "multi_step": (lambda: banded_matrix(2000, 2000, 400, 80, 0), 4.0),
    "dirty": (dirty_sellr_matrix, 12.0),
    "tall": (lambda: banded_matrix(2000, 700, 120, 7, 4), 4.0),
    "wide": (lambda: banded_matrix(900, 2000, 500, 7, 5), 25.0),
}


def _leaves(Aj):
    return ({f: np.asarray(getattr(Aj, f)) for f in sellr.DATA_FIELDS},
            {f: getattr(Aj, f) for f in sellr.META_FIELDS})


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, scipy matrix, the port's own build, JAX program, x)."""
    make, factor = CASES[request.param]
    mat = make()
    A = sellr.build_sellr(HostCSR.from_scipy(mat), max_slot_factor=factor)
    Aj = jax_sellr.build_sellr(JaxHostCSR.from_scipy(mat),
                               max_slot_factor=factor)
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return request.param, mat, A, Aj, x.astype(np.float32)


def test_program_identical(case):
    name, _, A, Aj, _ = case
    leaves, meta = _leaves(Aj)
    for f in sellr.DATA_FIELDS:
        got = getattr(A, f).numpy()
        assert got.dtype == leaves[f].dtype, f
        assert np.array_equal(got, leaves[f]), f
    assert {f: getattr(A, f) for f in sellr.META_FIELDS} == meta
    if name == "multi_step":
        assert A.nchunks > sellr.NB
    if name == "dirty":       # rolls beyond the clean {+1, -1} set, wraps
        assert set(A.rolls) - {(1, 0), (7, 1)}
        assert any(wrap for _, wrap in A.rolls)


def test_torch_impl_matches_jax(case):
    """Against the pallas impl (interpret mode) where the program reaches
    the roll and flush paths that matter (each interpret-mode compile of the
    unrolled kernel takes ~25 s on the CPU); against the xla impl on the
    rectangular shapes."""
    name, mat, _, Aj, x = case
    A = sellr.sellr_from_jax(*_leaves(Aj))
    jax_impl = (jax_sellr.spmv_sellr_pallas if name in ("dirty", "multi_step")
                else jax_sellr.spmv_sellr_xla)
    want = np.asarray(jax_impl(Aj, jnp.asarray(x)))
    got = spmv(A, torch.from_numpy(x)).numpy()        # CPU tensor: "torch"
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_execute_sellr_numpy_identical(case):
    _, _, A, Aj, x = case
    x64 = x.astype(np.float64)
    assert np.array_equal(sellr.execute_sellr_numpy(A, x64),
                          jax_sellr.execute_sellr_numpy(Aj, x64))


def test_wrapper_takes_plain_version_on_cpu(case):
    _, _, A, _, x = case
    args = (A.word, A.vals, A.smeta, A.gptr, A.gchunk, torch.from_numpy(x),
            A.nchunks, A.stages, A.rolls)
    K.reset_launch_counts()
    y = K.sellr_y(*args)
    assert torch.equal(y, K.sellr_y_torch(*args))
    assert y.shape == (A.y_rows, 128) and not any(K.LAUNCHES.values())
    R = K.sellr_place(A.word, A.vals, A.smeta, torch.from_numpy(x), A.nchunks,
                      A.stages, A.rolls)
    assert R.shape == (A.nchunks * 8, 128)
    assert torch.equal(K.sellr_flush(R, A.gptr, A.gchunk), y)


def test_flush_order_lists_runs_per_group():
    # chunks: 0,1 group 0 (one run), 2 group 1, 3 group 0 (dirty, alone)
    cmeta = [(0 << 1) | 0, (0 << 1) | 1, (8 << 1) | 1, (0 << 1) | 1]
    smeta = np.zeros(sellr.SMEM_BLK, np.int32)
    smeta[512:516] = cmeta
    gptr, gchunk = sellr._flush_order(smeta, 4, 16)
    assert gptr.tolist() == [0, 3, 4]
    assert gchunk.tolist() == [0 << 1, 1 << 1 | 1, 3 << 1 | 1, 2 << 1 | 1]
    smeta[513] = 8 << 1 | 1         # a run that crosses into group 1
    with pytest.raises(sellr.SellRBuildError, match="spans"):
        sellr._flush_order(smeta, 4, 16)


def test_scattered_matrix_refused():
    with pytest.raises(sellr.SellRBuildError, match="no column locality"):
        sellr.build_sellr(HostCSR.from_scipy(scattered_matrix()))


def test_cuda_impl_refuses_cpu_tensors(case):
    _, _, A, _, x = case
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A, torch.from_numpy(x), impl="cuda")


def test_flush_plain_version_on_ragged_groups():
    """``sellr_flush_torch`` (the flush kernel's plain version) against a
    plain replay of the run-flush, cell by cell in list order: groups of 1
    chunk, none, 8, 9 and 100 chunks, flush marks anywhere (a group's last
    chunk unflushed: its run never reaches y). Exact: the same adds in the
    same order."""
    rng = np.random.default_rng(5)
    counts = [1, 0, 8, 9, 100, 3]
    n = sum(counts)
    R = (rng.uniform(-1, 1, (n * 8, 128))
         * rng.lognormal(0, 4, (n * 8, 128))).astype(np.float32)
    gchunk = ((rng.permutation(n) << 1)
              | (rng.random(n) < 0.3)).astype(np.int32)
    gptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    want = np.zeros((len(counts), 1024), np.float32)
    Rc = R.reshape(n, 1024)
    for g in range(len(counts)):
        acc = np.zeros(1024, np.float32)
        for e in gchunk[gptr[g]:gptr[g + 1]]:
            acc = acc + Rc[e >> 1]
            if e & 1:
                want[g] = want[g] + acc
                acc = np.zeros(1024, np.float32)
    got = K.sellr_flush_torch(*map(torch.from_numpy, (R, gptr, gchunk)))
    assert np.array_equal(got.numpy().reshape(len(counts), 1024), want)
