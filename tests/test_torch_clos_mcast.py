"""The multicast Clos engine CLOSM of the port against the JAX package.

The router (``route_invreg_gather``, ``route_mcast``) and the builder are
numpy code whose greedy coloring depends on exact order, so the port's must
give the JAX package's planes and program arrays (``np.array_equal``), on
several seeds and on two matrices that spill (134 and 9 nonzeros to the
COO side path). The first eight tests mirror ``tests/test_clos_mcast.py`` case for
case on the port's functions. The JAX Pallas kernels run in interpret mode
on the CPU, as the JAX package's own tests run them; each B2 and B8 call of
a CLOSM SpMV (``clos_invreg`` and ``clos_r2`` on both networks,
``clos_r3_scan``, ``clos_r3_valid``) takes its plain PyTorch version on the
CPU, which must equal the Pallas kernel exactly on CLOSM's multicast
planes (gathers, one product per slot, adds in the same order). CLOSM/torch
is held to 1e-6 of |A|·|x| against JAX's ``CLOSM/xla`` and the float64
executor (the spill's segment sum adds in another order than JAX's).
"""

from functools import partial

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from conftest import random_host_csr

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops import clos_mcast as JM
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos_pallas import (_invreg_kernel,
                                               _r3_scan_kernel,
                                               _r3_valid_kernel)
from spmv_research_tpu.ops.clos_pallas import _t_bwd as jax_t_bwd
from spmv_research_tpu.ops.clos_pallas import _t_fwd as jax_t_fwd

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness.bench import _scale_for_iteration
from spmv_research_tpu_torch.ops import (ClosM, build_clos_mcast,
                                         closm_from_jax, execute_closm_numpy,
                                         spmv)
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops import clos_mcast as M
from spmv_research_tpu_torch.ops.clos_route import (ClosRoutingError,
                                                    apply_invreg_numpy)

from torch_cases import closm_spilling_matrix, random_matrix, rel_err


def _port_host(jax_host):
    return HostCSR.from_scipy(jax_host.to_scipy())


def _same_planes(p, q):
    for f in ("lane1", "subrot", "lane2"):
        a, b = getattr(p, f), getattr(q, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ---------------------------------- test_clos_mcast.py's cases, on the port

def test_invreg_gather_with_duplication(rng):
    n_vregs, W = 3, 128
    # every output slot reads a random source — heavy duplication
    tot = n_vregs * 8 * W
    vreg = np.arange(tot) // (8 * W)
    out_pos = np.arange(tot) % (8 * W)
    src_pos = rng.integers(0, 8 * W, tot)
    planes, spilled = M.route_invreg_gather(vreg, out_pos, src_pos, n_vregs,
                                            W)
    v = rng.uniform(size=(n_vregs * 8, W))
    out = apply_invreg_numpy(v, planes)
    flat_in = v.reshape(n_vregs, -1)
    flat_out = out.reshape(n_vregs, -1)
    ok = ~spilled
    got = flat_out[vreg[ok], out_pos[ok]]
    want = flat_in[vreg[ok], src_pos[ok]]
    assert np.allclose(got, want)
    # with full random fan-in, some spill is allowed but should be small
    assert spilled.mean() < 0.15
    jp, js = JM.route_invreg_gather(vreg, out_pos, src_pos, n_vregs, W)
    _same_planes(planes, jp)
    assert np.array_equal(spilled, js)


def test_route_mcast_roundtrip(rng):
    N = 8192
    K_ = 5000
    out = rng.choice(N, K_, replace=False)
    src = rng.integers(0, N // 4, K_) * 4   # spread-style sources, duplicated
    r = M.route_mcast(src, out, N)
    v = rng.uniform(size=N)
    got = M.apply_mcast_numpy(v, r)
    ok = ~r.spilled
    assert np.allclose(got[out[ok]], v[src[ok]])
    assert r.spilled.mean() < 0.05
    assert np.array_equal(got, JM.apply_mcast_numpy(v, JM.route_mcast(src,
                                                                      out, N)))


@pytest.mark.parametrize("m,n,density", [(300, 300, 0.01), (500, 200, 0.02),
                                         (64, 4000, 0.003)])
def test_closm_numpy_vs_scipy(rng, m, n, density):
    host = _port_host(random_host_csr(m, n, density, rng))
    A = build_clos_mcast(host)
    x = rng.uniform(-1, 1, n)
    y = execute_closm_numpy(A, x)
    mat = host.to_scipy()
    assert rel_err(mat, x, y) < 1e-6


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_closm_device_impls(rng, impl):
    """CLOSM/torch on the JAX test's matrix, against scipy as the JAX test
    holds its impls, and against that JAX impl's y."""
    jhost = random_host_csr(400, 400, 0.015, rng)
    A = build_clos_mcast(_port_host(jhost))
    x = rng.uniform(-1, 1, 400).astype(np.float32)
    y = spmv(A, torch.from_numpy(x)).numpy()          # CPU tensor: "torch"
    mat = jhost.to_scipy()
    assert np.allclose(y, mat @ x.astype(np.float64), atol=1e-4)
    yj = np.asarray(jax_spmv(JM.build_clos_mcast(jhost), jnp.asarray(x),
                             impl=impl))
    scale = np.abs(mat) @ np.abs(x.astype(np.float64)) + 1e-30
    assert np.max(np.abs(y - yj) / scale) <= 1e-6


def _pathological():
    """test_clos_mcast.py's pathological matrix: one column hammered by 200
    rows (the most duplication), a 30-nnz row, empty rows."""
    rng = np.random.Generator(np.random.PCG64(1234))
    m = n = 300
    rows = np.concatenate([np.arange(200), [250] * 30])
    cols = np.concatenate([np.full(200, 17), rng.integers(0, n, 30)])
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat, rng


def test_closm_pathological():
    mat, rng = _pathological()
    A = build_clos_mcast(HostCSR.from_scipy(mat))
    x = rng.uniform(-1, 1, mat.shape[1])
    assert rel_err(mat, x, execute_closm_numpy(A, x)) < 1e-6


# ----------------------------------------- identical arrays, same program

MATRICES = {
    "square": lambda: random_matrix(300, 300, 0.01, 1),
    "tall": lambda: random_matrix(500, 200, 0.02, 2),
    "wide": lambda: random_matrix(64, 4000, 0.003, 3),
    "pathological": lambda: _pathological()[0],
    "spilling": closm_spilling_matrix,
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def case(request):
    """(name, matrix, JAX ClosM, the port's own ClosM, x)."""
    mat = MATRICES[request.param]()
    Aj = JM.build_clos_mcast(JaxHostCSR.from_scipy(mat))
    A = build_clos_mcast(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return request.param, mat, Aj, A, x.astype(np.float32)


def test_program_identical(case):
    """Every leaf, meta field and the footprint equal JAX's; the spilled
    nonzeros' slots carry value 0 and ride the side path."""
    name, mat, Aj, A, _ = case
    for f in M.DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ({f: getattr(A, f) for f in M.META_FIELDS}
            == {f: getattr(Aj, f) for f in M.META_FIELDS})
    assert A.mem_footprint_bytes() == Aj.mem_footprint_bytes()
    assert A.n_spill == {"spilling": 134, "wide": 9}.get(name, 0)
    if name == "spilling":
        assert A.n_spill == 134 and A.spill_rows.numel() == 256
        assert bool((A.spill_rows[A.n_spill:] == A.m).all())
        sc = A.spill_cols[:A.n_spill].numpy().copy()
        sr = A.spill_rows[:A.n_spill].numpy().copy()
        assert np.array_equal(A.spill_vals[:A.n_spill].numpy(),
                              np.asarray(mat[sr, sc]).ravel()
                              .astype(np.float32))
    assert A.scan_hi.shape == (8, 128)          # no stage past 14 here


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_mcast_planes_identical(seed):
    """The global router's three layers and its spill mask equal JAX's on
    random multicast gathers at N = 8192, 2^14 and 2^15."""
    rng = np.random.Generator(np.random.PCG64(seed))
    N = 8192 << seed
    k = N * 3 // 5
    out = rng.choice(N, k, replace=False)
    src = rng.integers(0, N // 3, k) * 3
    r, rj = M.route_mcast(src, out, N), JM.route_mcast(src, out, N)
    for f in ("r1", "r2", "r3"):
        _same_planes(getattr(r, f), getattr(rj, f))
    assert r.V == rj.V and np.array_equal(r.spilled, rj.spilled)


def test_y_matches_jax_xla_and_float64_executor(case):
    """CLOSM/torch y within 1e-6 of |A|·|x| of JAX's CLOSM/xla and of the
    float64 executor, which equals JAX's."""
    name, mat, Aj, A, x = case
    got = spmv(A, torch.from_numpy(x)).numpy()
    assert got.shape == (mat.shape[0],) and got.dtype == np.float32
    x64 = x.astype(np.float64)
    ref = execute_closm_numpy(A, x64)
    assert np.array_equal(ref, JM.execute_closm_numpy(Aj, x64))
    assert rel_err(mat, x, ref) <= 1e-7       # float32 values, float64 sums
    scale = np.abs(mat) @ np.abs(x64) + 1e-30
    assert np.max(np.abs(got - ref) / scale) <= 1e-6
    yj = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="xla"))
    assert np.max(np.abs(got - yj) / scale) <= 1e-6


@pytest.mark.parametrize("name", ["pathological", "spilling"])
def test_b2_b8_plain_versions_match_pallas_on_closm_planes(name):
    """Each B2 and B8 call of a CLOSM SpMV, on its real input (the plain
    pipeline up to it), against the Pallas kernel in interpret mode,
    exactly: the multicast planes feed one source to several outputs. The
    wrappers take the plain versions for CPU tensors."""
    mat = MATRICES[name]()
    Aj = JM.build_clos_mcast(JaxHostCSR.from_scipy(mat))
    A = build_clos_mcast(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(
        -1.0, 1.0, mat.shape[1]).astype(np.float32)
    S, V = 8 * A.V, A.V

    def invreg(u, word, jword):
        got = K.clos_invreg_torch(u, word)
        want = _call(_invreg_kernel, jnp.asarray(u.numpy()), jword)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(K.clos_invreg(u, word), got)
        return got

    def r2(u, word, jword):
        got = K.clos_r2_torch(u, word, V)
        want = jax_t_bwd(_call(_invreg_kernel,
                               jax_t_fwd(jnp.asarray(u.numpy()), V), jword),
                         V)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(K.clos_r2(u, word, V), got)
        return got

    u = M._spread(torch.from_numpy(x), A.N, A.x_stride)
    assert np.array_equal(u.numpy(), np.asarray(
        JM._spread(jnp.asarray(x), A.N, A.x_stride, jnp.float32)))
    u = r2(invreg(u, A.g_r1, Aj.g_r1), A.g_r2, Aj.g_r2)
    got = K.clos_r3_scan_torch(u, A.g_r3, A.vals, A.scan_hi, A.scan_stages)
    want = _call(partial(_r3_scan_kernel, (S, Aj.scan_stages)),
                 jnp.asarray(u.numpy()), Aj.g_r3, Aj.vals, Aj.scan_hi)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.clos_r3_scan(u, A.g_r3, A.vals, A.scan_hi,
                                      A.scan_stages), got)
    u = r2(invreg(got, A.compact_r1, Aj.compact_r1), A.compact_r2,
           Aj.compact_r2)
    got = K.clos_r3_valid_torch(u, A.compact_r3)
    want = _call(_r3_valid_kernel, jnp.asarray(u.numpy()), Aj.compact_r3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.clos_r3_valid(u, A.compact_r3, A.m),
                       got[: -(-A.m // 1024) * 8])


def test_closm_from_jax_runs_the_same_program(case):
    _, _, Aj, A, x = case
    B = closm_from_jax({f: np.asarray(getattr(Aj, f)) for f in M.DATA_FIELDS},
                       {f: getattr(Aj, f) for f in M.META_FIELDS})
    assert isinstance(B, ClosM)
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))
    assert B.mem_footprint_bytes() == Aj.mem_footprint_bytes()


@pytest.mark.parametrize("kind", ["max_N", "spill"])
def test_build_refusals(kind):
    """Past ``max_N`` slots, or more than ``max_spill_frac`` of the nonzeros
    spilled: ``ClosRoutingError``, with JAX's message, as JAX refuses."""
    mat = closm_spilling_matrix()
    kw = {"max_N": 4096} if kind == "max_N" else {"max_spill_frac": 0.01}
    with pytest.raises(ClosRoutingError) as e:
        build_clos_mcast(HostCSR.from_scipy(mat), **kw)
    with pytest.raises(Exception) as ej:
        JM.build_clos_mcast(JaxHostCSR.from_scipy(mat), **kw)
    assert str(e.value) == str(ej.value)
    assert ("too large" if kind == "max_N" else "spill fraction") in str(
        e.value)


def test_closm_moves_and_scales_whole():
    """``.to`` copies every tensor; the bench's timing copy scales the
    values and the spilled values (‖A‖∞ ≤ 1), not the planes."""
    mat = closm_spilling_matrix()
    host = HostCSR.from_scipy(mat)
    A = build_clos_mcast(host)
    B = A.to("cpu")
    assert B is not A and B.device == torch.device("cpu")
    assert all(torch.equal(getattr(A, f), getattr(B, f))
               for f in M.DATA_FIELDS)
    As = _scale_for_iteration(host, A)
    c = 1.0 / np.abs(mat).sum(axis=1).max()
    assert torch.equal(As.g_r1, A.g_r1) and torch.equal(As.spill_rows,
                                                        A.spill_rows)
    for f in ("vals", "spill_vals"):
        assert torch.allclose(getattr(As, f), getattr(A, f) * c, rtol=1e-6,
                              atol=0.0), f
    x = np.random.Generator(np.random.PCG64(3)).uniform(0, 1, mat.shape[1])
    y = spmv(As, torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert rel_err(mat * c, x, y) <= 1e-6


def test_closm_cuda_refuses_cpu_tensors():
    """No hidden fallback: CLOSM/cuda never runs the plain versions."""
    A = build_clos_mcast(HostCSR.from_scipy(random_matrix(300, 300, 0.01, 1)))
    x = torch.ones(300)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A, x, impl="cuda")
    with pytest.raises(ValueError, match="CLOSM/cuda"):
        M.spmv_closm_cuda(A, x)
