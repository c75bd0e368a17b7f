"""The port's distributed layer (``spmv_research_tpu_torch/parallel/``)
against the JAX package's: row- and column-sharded CSR, the ring, the CG
step, weak scaling and the per-device CLOSG shards.

Host parity: each ``plan_*`` gives the arrays the JAX builder stacks on
its mesh of k virtual devices (k = 2, 4 and 8), ``np.array_equal``.
Semantic parity: the spawned gloo runs at k = 2 and 4
(``torch_dist_cases.dist_runs``, plain PyTorch versions on the CPU) give
each y within 1e-6 of max |y| of JAX's (1e-5 for psum_scatter, whose
reduce order differs) and within 2e-5 of max |y| of scipy's.
"""

import numpy as np
import pytest
import torch

import jax

import spmv_research_tpu.parallel as jp
import spmv_research_tpu.parallel.dist_closg as jdc
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.gen import (ArtificialParams as JaxParams,
                                   artificial_matrix_generation as jax_gen)

import spmv_research_tpu_torch.parallel as tp
import spmv_research_tpu_torch.parallel.dist_closg as tdc
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import clos_gather, sellw
from spmv_research_tpu_torch.ops.sellw import SellW

import torch_dist_cases as C
from torch_cases import banded_matrix, random_matrix

FIELDS = ("data", "cols", "rows")
BLK = ("data_blk", "cols_blk", "rows_blk")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return C.dist_runs(request, tmp_path_factory)


def _hosts(mat):
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


def _same_plan(P, S, fields):
    for f in fields:
        a, b = getattr(P, f), getattr(S, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, np.asarray(b)), f


def _jax_y(mat, k, strategy="allgather"):
    S = jp.build_sharded_csr(JaxHostCSR.from_scipy(mat),
                             jp.make_sparse_mesh(k))
    return S.unpad_vector(jp.distributed_spmv(S, S.pad_vector(C.x_for(mat)),
                                              strategy=strategy))


def _held(y, mat, want, tol=1e-6):
    C.near(y, want, tol)
    C.near(y, mat @ C.x_for(mat), 2e-5)


def test_device_count(runs):
    """The spawned worlds have k ranks on gloo, nothing staged on the
    CPU; a mesh without a process group of that size is refused."""
    assert jax.device_count() >= 8
    for k in C.KS:
        info = runs[k]["info"]
        assert info["world"] == info["mesh_size"] == k
        assert info["backend"] == "gloo" and info["staged_bytes"] == 0
    with pytest.raises(ValueError, match="need 2 devices"):
        tp.make_sparse_mesh(2, device="cpu")


@pytest.mark.parametrize("k", [2, 8])
def test_nnz_balanced_partition(k):
    h, hj = _hosts(random_matrix(500, 500, 0.05, 23))
    splits = tp.partition_rows_nnz_balanced(h, k)
    assert np.array_equal(splits, jp.partition_rows_nnz_balanced(hj, k))
    assert splits[0] == 0 and splits[-1] == 500
    nnz_per = np.diff(h.ia[splits])
    assert (nnz_per.max() - nnz_per.min()
            <= h.row_lengths().max() + h.nnz / k * 0.5)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_spmv_matches_scipy(strategy, ndev, runs):
    mat = C.csr_case()
    h, hj = _hosts(mat)
    P = tp.plan_sharded_csr(h, ndev)
    _same_plan(P, jp.build_sharded_csr(hj, jp.make_sparse_mesh(ndev)),
               FIELDS + BLK)
    assert P.data_blk is not None
    if ndev in runs:
        _held(runs[ndev][f"csr_{strategy}"], mat, _jax_y(mat, ndev,
                                                          strategy))


def test_distributed_spmv_skewed_rows(runs):
    mat = C.skewed_case()
    h, hj = _hosts(mat)
    _same_plan(tp.plan_sharded_csr(h, 8),
               jp.build_sharded_csr(hj, jp.make_sparse_mesh(8)),
               FIELDS + BLK)
    for k in C.KS:
        _held(runs[k]["skewed_allgather"], mat, _jax_y(mat, k))


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_distributed_cg_step_runs(strategy, runs):
    """The global r·r after one step, against JAX's step on the same
    mesh size (the ring through the masked body, as JAX's)."""
    hj = JaxHostCSR.from_scipy(C.spd_case())
    for k in C.KS:
        _, rr = jax.block_until_ready(jp.distributed_cg_step(
            hj, jp.make_sparse_mesh(k), strategy=strategy)())
        got = runs[k][f"cg_{strategy}"]
        assert got.shape == (1,) and np.isfinite(got).all()
        C.near(got, [float(rr)], 1e-5)


def test_dryrun_multichip_counterpart(runs):
    """``__graft_entry__.dryrun_multichip``'s checks on the spawned ranks:
    the SELLR ring and allgather on its m = 1024·k banded matrix within
    2e-6, CLOSGX plain and overlapped within 2e-5, a finite CG step."""
    for k in C.KS:
        r = runs[k]
        mat = C.dryrun_sellr_case(k)
        for strategy in ("ring", "allgather"):
            C.near(r[f"dryrun_sellr_{strategy}"], mat @ C.x_for(mat), 2e-6)
        mat = C.closgx_case()
        for ov in ("plain", "overlap"):
            C.near(r[f"closgx_{ov}"], mat @ C.x_for(mat), 2e-5)
        assert np.isfinite(r["cg_allgather"]).all()


def test_weak_scaling_runs(runs):
    """The dict over the first k ranks, and the problem the JAX package
    generates for each k (nnz)."""
    for k in C.KS:
        weak = runs[k]["weak"]
        assert set(weak) == {str(c) for c in (1, 2, 4) if c <= k}
        for c, r in weak.items():
            assert r["time"] > 0 and r["efficiency_overhead"] > 0
            m = 2000 * int(c)
            host, _ = jax_gen(JaxParams(m, m, 5.0, 5.0 / 3, "normal",
                                        "random", bw=0.05, skew=1.0,
                                        avg_num_neighbours=0.5,
                                        cross_row_similarity=0.3, seed=14))
            assert r["nnz"] == host.nnz
        assert weak["1"]["efficiency"] == 1.0


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_spmv_psum_scatter(ndev, runs):
    mat = C.col_case()
    h, hj = _hosts(mat)
    Sj = jp.build_col_sharded_csr(hj, jp.make_sparse_mesh(ndev))
    P = tp.plan_col_sharded_csr(h, ndev)
    _same_plan(P, Sj, FIELDS)
    assert np.array_equal(P.col_splits, Sj.col_splits)
    assert (P.rows_pad, P.cols_pad) == (Sj.rows_pad, Sj.cols_pad)
    if ndev in runs:
        want = Sj.unpad_y(jp.distributed_spmv_psum_scatter(
            Sj, Sj.pad_x(C.x_for(mat))))
        _held(runs[ndev]["psum_scatter"], mat, want, 1e-5)


def test_ring_blocked_layout_built_and_correct(runs):
    """The ring's build-time block layout (k = 8: within the budget on a
    uniform matrix, None past it on a column-skewed one), and the blocked
    ring's y at k = 2 and 4."""
    mat = C.ring_case()
    h, hj = _hosts(mat)
    P = tp.plan_sharded_csr(h, 8)
    _same_plan(P, jp.build_sharded_csr(hj, jp.make_sparse_mesh(8)),
               FIELDS + BLK)
    assert P.data_blk.shape[1] * P.k <= 4 * P.data.shape[1]
    h2, hj2 = _hosts(C.col_skewed_case())
    P2 = tp.plan_sharded_csr(h2, 8)
    _same_plan(P2, jp.build_sharded_csr(hj2, jp.make_sparse_mesh(8)),
               FIELDS + BLK)
    assert P2.data_blk is None
    for k in C.KS:
        _held(runs[k]["ring_ring"], mat, _jax_y(mat, k, "ring"))


def _same_shards(A, Aj, module):
    """Each shard's program arrays and meta equal to the JAX shard's."""
    assert A.k == Aj.k and np.array_equal(A.row_splits, Aj.row_splits)
    for s, sj in zip(A.shards, Aj.shards):
        assert type(s).__name__ == type(sj).__name__
        for f in module.DATA_FIELDS:
            assert np.array_equal(getattr(s, f).numpy(),
                                  np.asarray(getattr(sj, f))), f
        assert ({f: getattr(s, f) for f in module.META_FIELDS}
                == {f: getattr(sj, f) for f in module.META_FIELDS})


def test_distributed_closg_8dev():
    """Per-device CLOSG programs over an nnz-balanced row split (one
    process, 8 CPU devices): each shard's program the JAX package's, y
    within JAX's test's 1e-4 of scipy's."""
    mat = random_matrix(1600, 1200, 0.01, 11)
    h, hj = _hosts(mat)
    A = tp.build_sharded_closg(h, devices=["cpu"] * 8)
    _same_shards(A, jp.build_sharded_closg(hj, devices=jax.devices()[:8]),
                 clos_gather)
    x = np.random.default_rng(3).uniform(-1, 1, 1200).astype(np.float32)
    y = tp.distributed_spmv_closg(A, torch.from_numpy(x)).numpy()
    assert y.shape == (1600,)
    assert np.allclose(y, mat @ x.astype(np.float64), atol=1e-4)


def test_distributed_best_mixed_engines():
    """build_sharded_best picks SELLW on every shard of a banded matrix,
    each the JAX package's program; y within 1e-4 of scipy's."""
    mat = banded_matrix(1600, 1600, 60, 6, 9)
    h, hj = _hosts(mat)
    A = tdc.build_sharded_best(h, devices=["cpu"] * 4)
    assert all(isinstance(s, SellW) for s in A.shards)
    _same_shards(A, jdc.build_sharded_best(hj, devices=jax.devices()[:4]),
                 sellw)
    x = np.random.default_rng(4).uniform(-1, 1, 1600).astype(np.float32)
    y = tp.distributed_spmv_closg(A, torch.from_numpy(x)).numpy()
    assert np.allclose(y, mat @ x.astype(np.float64), atol=1e-4)
