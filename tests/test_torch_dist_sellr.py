"""The port's SPMD distributed SELLR (``parallel/dist_sellr.py``) and the
raw calling form of B14 (``ops/sellr.py:sellr_raw``) against the JAX
package's ``dist_sellr.py``.

Host parity: ``plan_dist_sellr``'s stacked word, vals and smeta, its meta,
row splits and shard nnz equal JAX's ``build_dist_sellr`` on k virtual
devices. Semantic parity on the spawned gloo ranks (k = 2 and 4, the
plain versions of B14): every strategy within 2e-6 of max |y| of scipy's
(JAX's test's bound), and the ring at k = 2 within 1e-6 of JAX's own
``dist_spmv_sellr`` (one interpret-mode Pallas run, ~25 s: the other
strategies are not run through JAX).
"""

import numpy as np
import pytest
import torch

import spmv_research_tpu.parallel.dist as jd
import spmv_research_tpu.parallel.dist_sellr as jds
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops.sellr import SellRBuildError as JaxSellRBuildError

from spmv_research_tpu_torch.convert import cache
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import sell_cuda as K
from spmv_research_tpu_torch.ops.sellr import (SellRBuildError, build_sellr,
                                               raw_flush_order, sellr_raw,
                                               spmv_sellr_torch)
from spmv_research_tpu_torch.parallel import dist_sellr as tds

import torch_dist_cases as C

STRATEGIES = ["allgather", "ring", "psum_scatter"]


@pytest.fixture(scope="module")
def jax_problem():
    """tests/test_dist_sellr.py's problem (6000 rows, band 700), for the
    host parity at k = 8 (the 1000-row cut's ring blocks there hold too
    few nnz: both builders refuse them)."""
    from torch_cases import banded_matrix
    return banded_matrix(6000, 6000, 700, 8, 11)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return C.dist_runs(request, tmp_path_factory)


def _plans(mat, k, strategy, msf=30.0):
    P = tds.plan_dist_sellr(HostCSR.from_scipy(mat), k, strategy=strategy,
                            max_slot_factor=msf)
    D = jds.build_dist_sellr(JaxHostCSR.from_scipy(mat),
                             jd.make_sparse_mesh(k), strategy=strategy,
                             max_slot_factor=msf)
    return P, D


def _same(P, D):
    for f in ("word", "vals", "smeta"):
        assert np.array_equal(getattr(P, f), np.asarray(getattr(D, f))), f
    assert P.meta == D.meta
    assert np.array_equal(P.row_splits, D.row_splits)
    assert np.array_equal(P.shard_nnz, D.shard_nnz)
    assert P.word.shape[0] == D.k


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dist_sellr_matches_scipy(strategy, runs, jax_problem):
    mat = C.sellr_case()
    _same(*_plans(mat, 2, strategy))
    _same(*_plans(jax_problem, 8, strategy))
    for k in C.KS:
        C.near(runs[k][f"sellr_{strategy}"], mat @ C.x_for(mat), 2e-6)


def test_dist_sellr_ring_matches_jax(runs):
    """The one JAX run: its ring on 2 virtual devices (interpret-mode
    Pallas) against the spawned k = 2 ring."""
    mat = C.sellr_case()
    D = jds.build_dist_sellr(JaxHostCSR.from_scipy(mat),
                             jd.make_sparse_mesh(2), strategy="ring",
                             max_slot_factor=30.0)
    want = jds.dist_spmv_sellr_host(D, C.x_for(mat))
    C.near(runs[2]["sellr_ring"], want, 1e-6)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dist_sellr_empty_shards(strategy, runs):
    """Column blocks with no nnz: empty programs (no live chunk) in the
    stacks, equal to JAX's, and a y of zeros through their flush."""
    mat = C.sellr_empty_case()
    for k in C.KS:
        P, D = _plans(mat, k, strategy)
        _same(P, D)
        if strategy != "allgather":
            assert (P.nchunks == 0).any()
        C.near(runs[k][f"sellr_empty_{strategy}"], mat @ C.x_for(mat), 2e-6)


def test_ring_total_work_is_nnz_not_k_nnz(jax_problem):
    """Ring step j on rank d runs only the (d, (d+j) % k) block program:
    each nnz is touched once over the k steps."""
    mat = jax_problem
    P, D = _plans(mat, 8, "ring")
    nz = P.shard_nnz
    assert np.array_equal(nz, D.shard_nnz)
    assert nz.sum() == mat.nnz
    for d in range(8):
        assert sum(nz[d, (d + j) % 8] for j in range(8)) == nz[d].sum()
    diag = np.array([nz[d, d] for d in range(8)])
    assert diag.max() <= 3.0 * max(diag.mean(), 1)


def test_shape_uniformity(jax_problem):
    P, D = _plans(jax_problem, 8, "ring")
    _same(P, D)
    assert P.word.shape == (8, 8) + P.word.shape[2:]
    assert P.vals.shape == P.word.shape and P.nchunks.shape == (8, 8)
    # the 1000-row cut at k = 8: a ring block of one nnz, refused by both
    mat = C.sellr_case()
    with pytest.raises(SellRBuildError):
        tds.plan_dist_sellr(HostCSR.from_scipy(mat), 8, "ring",
                            max_slot_factor=30.0)
    with pytest.raises(JaxSellRBuildError):
        jds.build_dist_sellr(JaxHostCSR.from_scipy(mat),
                             jd.make_sparse_mesh(8), strategy="ring",
                             max_slot_factor=30.0)


def test_sellr_raw_on_a_padded_program(tmp_path, monkeypatch):
    """B14's raw form on a program padded as the distributed layer pads it
    (two steps more, a y plane 16 rows taller, the rolls a superset): the
    flush order from the live chunks gives the program's own y, the pad
    rows 0, and the plain place equals the float64 executor's; a program
    with no live chunk gives zeros. Each shard's build is cached: the
    three strategies at k = 1 build the matrix once."""
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
    mat = C.sellr_case()
    h = HostCSR.from_scipy(mat)
    A = build_sellr(h, max_slot_factor=30.0)
    prog = tds._program(A)
    rolls = tuple(sorted(set(A.rolls) | {(3, 1)}))
    word, vals, smeta = tds._pad_program(prog, A.word.shape[0] // 512 + 2,
                                         rolls)
    y_rows = A.y_rows + 16
    gptr, gchunk = raw_flush_order(smeta, A.nchunks, y_rows)
    x = torch.from_numpy(C.x_for(mat).astype(np.float32))
    t = [torch.from_numpy(a) for a in (word, vals, smeta)]
    y2 = sellr_raw(*t, gptr, gchunk, x, nchunks=A.nchunks,
                   stages=A.stages, rolls=rolls)
    assert y2.shape == (y_rows, 128)
    assert torch.equal(y2.reshape(-1)[: A.m], spmv_sellr_torch(A, x))
    assert not y2.reshape(-1)[A.y_rows * 128:].any()
    e = tds._empty_program(np.float32)
    g0, c0 = raw_flush_order(e.smeta, 0, y_rows)
    assert c0.numel() == 0 and g0.numel() == y_rows // 8 + 1
    z = sellr_raw(*(torch.from_numpy(a) for a in (e.word, e.vals, e.smeta)),
                  g0, c0, x, nchunks=0, stages=0, rolls=())
    assert z.shape == (y_rows, 128) and not z.any()
    assert torch.equal(K.sellr_place_torch(*t, x, A.nchunks, A.stages,
                                           rolls).sum(),
                       K.sellr_place_torch(A.word, A.vals, A.smeta, x,
                                           A.nchunks, A.stages,
                                           A.rolls).sum())
    cache.reset_stats()
    for strategy in STRATEGIES:
        tds.plan_dist_sellr(h, 1, strategy=strategy, max_slot_factor=30.0)
    assert (cache.STATS["misses"], cache.STATS["hits"]) == (1, 2)


def test_dist_cg_step_sellr(runs):
    """One CG-style step on the distributed engine: y·(1 + α·1e-30), that
    is y, within 2e-6 of scipy's (allgather, each rank's part gathered)."""
    mat = C.sellr_case()
    for k in C.KS:
        got = runs[k]["sellr_cg_step"]
        assert np.isfinite(got).all()
        rows = got.reshape(k, -1)
        P = tds.plan_dist_sellr(HostCSR.from_scipy(mat), k, "allgather",
                                max_slot_factor=30.0)
        y = np.concatenate([rows[j, : P.row_splits[j + 1] - P.row_splits[j]]
                            for j in range(k)])
        C.near(y, mat @ C.x_for(mat), 2e-6)
