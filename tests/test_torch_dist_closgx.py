"""The port's SPMD distributed CLOSGX (``parallel/dist_closgx.py``)
against the JAX package's ``dist_closgx.py`` (its tests
``test_dist_closgx.py`` and ``test_dist_overlap.py``).

Host parity: ``plan_dist_closgx``'s stacked leaves and statics (both
families with ``overlap``), row starts, shard nnz and slots equal JAX's
``build_dist_closgx`` on k virtual devices, at JAX's tests' sizes.
Semantic parity on the spawned gloo ranks (k = 2 and 4; B1, ``clos_r2``
and B15's plain versions) at 1000-row cuts, within 2e-5 of max |y| of
scipy's, and the empty-local-blocks case with overlap at k = 2 within
1e-6 of max |y| of JAX's own ``dist_spmv_closgx`` (one interpret-mode
Pallas run).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
from jax.sharding import Mesh

import spmv_research_tpu.parallel.dist_closgx as jdx
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops.clos_xl import ClosGX
from spmv_research_tpu_torch.parallel import dist_closgx as tdx

import torch_dist_cases as C


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return C.dist_runs(request, tmp_path_factory)


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("d",))


def _plans(mat, k, overlap=False, chunk_N=C.CHUNK_N):
    P = tdx.plan_dist_closgx(HostCSR.from_scipy(mat), k, chunk_N=chunk_N,
                             overlap=overlap)
    D = jdx.build_dist_closgx(JaxHostCSR.from_scipy(mat), _mesh(k),
                              chunk_N=chunk_N, overlap=overlap)
    return P, D


def _same(P, D):
    for mine, theirs in ((P.leaves, D.leaves), (P.leaves_loc, D.leaves_loc)):
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert set(mine) == set(theirs)
            for f in mine:
                assert np.array_equal(mine[f], np.asarray(theirs[f])), f
    assert P.statics == D.statics and P.statics_loc == D.statics_loc
    assert (P.row_starts, P.n_pad, P.shard_nnz, P.shard_slots) == (
        D.row_starts, D.n_pad, D.shard_nnz, D.shard_slots)


def _scattered(m, density, seed):
    rng = np.random.RandomState(seed)
    mat = sp.random(m, m, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.uniform(-1, 1, k))
    mat.sort_indices()
    return mat


def test_dist_closgx_scattered_matches_scipy(runs):
    """JAX's 3000-row scattered matrix: plans at k = 2 and 8; the 1000-row
    cut on the ranks, and each rank's program a port ClosGX."""
    big = _scattered(3000, 0.004, 3)
    for k in (2, 8):
        _same(*_plans(big, k))
    mat = C.closgx_case()
    for k in C.KS:
        C.near(runs[k]["closgx_plain"], mat @ C.x_for(mat), 2e-5)
    P = tdx.plan_dist_closgx(HostCSR.from_scipy(mat), 2, chunk_N=C.CHUNK_N)
    A = P.shard(1, "cpu").prog
    assert isinstance(A, ClosGX) and A.nnz == 0 and A.m == P.leaves[
        "ymap"].shape[1] * 128


def test_dist_closgx_shard_accounting(runs):
    big = _scattered(4000, 0.003, 5)
    P, D = _plans(big, 8)
    _same(P, D)
    assert len(P.shard_nnz) == 8 and sum(P.shard_nnz) == big.nnz
    assert max(P.shard_nnz) <= 2.0 * (big.nnz / 8) + 128 * 40
    assert all(s >= n for s, n in zip(P.shard_slots, P.shard_nnz))
    nnz = C.closgx_case().nnz
    for k in C.KS:
        got = runs[k]["closgx_shard_nnz"]
        assert got.shape == (k,) and got.sum() == nnz
        assert (runs[k]["closgx_shard_slots"] >= got).all()


def test_dist_closgx_skewed_rows_and_rect(runs):
    """Skewed row degrees and a non-square shape (1200 × 900)."""
    mat = C.closgx_rect_case()
    _same(*_plans(mat, 4))
    for k in C.KS:
        C.near(runs[k]["closgx_rect_plain"], mat @ C.x_for(mat), 1e-4)


@pytest.mark.parametrize("overlap", [False, True])
def test_dist_closgx_overlap_matches_scipy(overlap, runs):
    big = _scattered(3000, 0.003, 3)
    for k in (2, 8):
        P, D = _plans(big, k, overlap)
        _same(P, D)
        assert (P.leaves_loc is not None) == overlap
    mat = C.closgx_case()
    key = f"closgx_{'overlap' if overlap else 'plain'}"
    for k in C.KS:
        C.near(runs[k][key], mat @ C.x_for(mat), 2e-5)


def test_dist_closgx_overlap_empty_local_blocks(runs):
    """Every column in rank 0's x block: the other ranks' local families
    are the inert one-entry programs. The one JAX run (k = 2, overlap)."""
    mat = C.closgx_local_case()
    P, D = _plans(mat, 2, overlap=True, chunk_N=C.CHUNK_N_LOCAL)
    _same(P, D)
    want = jdx.dist_spmv_closgx_host(D, C.x_for(mat))
    for k in C.KS:
        C.near(runs[k]["closgx_local_overlap"], mat @ C.x_for(mat), 2e-5)
    C.near(runs[2]["closgx_local_overlap"], want, 1e-6)


def test_dist_closgx_refuses_small_matrices():
    """m < k·128 is refused by both builders."""
    mat = _scattered(300, 0.01, 1)
    with pytest.raises(ValueError, match="too small"):
        tdx.plan_dist_closgx(HostCSR.from_scipy(mat), 4)
    with pytest.raises(ValueError, match="too small"):
        jdx.build_dist_closgx(JaxHostCSR.from_scipy(mat), _mesh(4))


def test_dist_closgx_multichunk_shards_of_unequal_mrp(runs):
    """Shards of several chunks with unequal row counts: the padded stack
    renumbers each shard's ymap for the family's mrp (the JAX builder
    keeps the shard's own numbering, so its y is wrong there: a standing
    divergence). Every other leaf equals JAX's; y on the ranks within
    2e-5 of scipy's. No JAX SpMV is run: the JAX ymap on the port's plan
    shows the fault."""
    from spmv_research_tpu_torch.convert.cache import cached_build
    from spmv_research_tpu_torch.ops.clos_xl import (_pipeline,
                                                     build_clos_gather_xl)
    import torch

    mat = C.closgx_multichunk_case()
    x = C.x_for(mat)
    for ov in (False, True):
        P, D = _plans(mat, 2, ov, chunk_N=C.CHUNK_N_MULTI)
        for mine, theirs in ((P.leaves, D.leaves),
                             (P.leaves_loc or {}, D.leaves_loc or {})):
            for f in mine:
                if f != "ymap":
                    assert np.array_equal(mine[f], np.asarray(theirs[f]))
        assert P.statics == D.statics and P.statics_loc == D.statics_loc
        h = HostCSR.from_scipy(mat)
        mrps = []
        for d in range(2):
            part = tdx._rows_slice(h, P.row_starts[d], P.row_starts[d + 1])
            if ov:
                nloc = P.n_pad // 2
                part = tdx._split_cols(part, d * nloc, (d + 1) * nloc)[1]
            mrps.append(cached_build(
                build_clos_gather_xl, tdx._nonempty(part), "closgx",
                chunk_N=C.CHUNK_N_MULTI, max_chunks=256).mrp)
        mrp = P.statics["mrp"]
        assert len(set(mrps)) > 1
        jax_ymap = np.asarray(D.leaves["ymap"])
        for d in range(2):
            live = P.row_starts[d + 1] - P.row_starts[d]
            nrow = -(-live // 128)
            want = (jax_ymap[d, :nrow] // mrps[d]) * mrp + (
                jax_ymap[d, :nrow] % mrps[d])
            assert np.array_equal(P.leaves["ymap"][d, :nrow], want)
        # the JAX numbering on the port's plan: wrong rows of the stack
        xp = np.zeros(P.n_pad, np.float32)
        xp[: mat.shape[1]] = x
        bad = tdx.DistClosGXPlan(**{**P.__dict__, "leaves": {
            **P.leaves, "ymap": jax_ymap}})
        ys = [_pipeline(bad.shard(d, "cpu").prog,
                        torch.from_numpy(xp[: mat.shape[1]]), True).numpy()
              for d in range(2)]
        if not ov:
            y = np.concatenate([ys[d][: P.row_starts[d + 1]
                                      - P.row_starts[d]] for d in range(2)])
            gold = mat @ x
            assert np.abs(y - gold).max() > 0.1 * np.abs(gold).max()
        key = f"closgx_multi_{'overlap' if ov else 'plain'}"
        for k in C.KS:
            C.near(runs[k][key], mat @ x, 2e-5)
