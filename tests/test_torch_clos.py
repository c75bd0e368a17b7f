"""The exact-CLOS engine of the port (kernel B8) against the JAX package.

Both packages build the program from the same seeded matrix — the cases of
``tests/test_clos.py``, its pathological one included, and one whose column
run and row pass 2^15 slots, so that fill and scan stages 15 and up read the
``fill_hi`` and ``scan_hi`` planes — and must give identical arrays. The
Pallas kernels run in interpret mode on the CPU, as the JAX package's own
tests run them; the port runs each kernel's plain PyTorch version, which its
wrapper takes for CPU tensors. B8's three parts are a select by take bits,
one product per slot followed by adds in the same order, and a mask, so the
plain versions must equal the Pallas kernels exactly; so must the whole
CLOS/torch y equal the JAX ``xla`` and ``pallas`` impls' (it is held to
1e-6 of |A|·|x| against the float64 executor, the JAX tests' 1e-6).
"""

from functools import partial

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos import build_clos as jax_build
from spmv_research_tpu.ops.clos import execute_clos_numpy as jax_execute
from spmv_research_tpu.ops.clos_pallas import (_r3_fill_kernel,
                                               _r3_scan_kernel,
                                               _r3_valid_kernel)

from spmv_research_tpu_torch.convert import build_best as bb
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness import sweep as sweep_mod
from spmv_research_tpu_torch.ops import (RoutingError, build_clos,
                                         clos_from_jax, execute_clos_numpy,
                                         spmv)
from spmv_research_tpu_torch.ops import clos as C
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError

from torch_cases import (TWIN_LINE, clos_hi_matrix, random_matrix, rel_err,
                         scattered_matrix)


def _pathological():
    """test_clos.py's pathological matrix: empty rows, a 150-nnz row, and
    one column hammered by 50 rows."""
    rng = np.random.Generator(np.random.PCG64(4))
    m = n = 200
    rows = np.concatenate([np.zeros(150, int), [5], np.arange(50) + 100])
    cols = np.concatenate([rng.integers(0, n, 150), [7], [3] * 50])
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


MATRICES = {
    "square": lambda: random_matrix(300, 300, 0.01, 1),
    "tall": lambda: random_matrix(500, 200, 0.02, 2),
    "wide": lambda: random_matrix(64, 4000, 0.003, 3),
    "pathological": _pathological,
    "hi_planes": clos_hi_matrix,
}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def case(request):
    """(name, matrix, JAX Clos, the port's own Clos, x)."""
    mat = MATRICES[request.param]()
    Aj = jax_build(JaxHostCSR.from_scipy(mat))
    A = build_clos(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return request.param, mat, Aj, A, x.astype(np.float32)


def test_program_identical(case):
    name, _, Aj, A, _ = case
    for f in C.DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ({f: getattr(A, f) for f in C.META_FIELDS}
            == {f: getattr(Aj, f) for f in C.META_FIELDS})
    hi = name == "hi_planes"
    assert (max(A.fill_stages) >= 15) == hi and (len(A.scan_stages) > 15) == hi
    assert (A.fill_hi.numel() == A.scan_hi.numel() == A.N) == hi


def _net(A, v, r1, r2):
    """A network's r1 and r2 layers (plain versions): the r3 step's input."""
    v = _t_fwd(K.clos_invreg_torch(v, r1), A.V)
    return _t_bwd(K.clos_invreg_torch(v, r2), A.V)


def test_b8_plain_versions_match_pallas_kernels(case):
    """Each B8 part on its real input (the plain pipeline up to it)
    against the Pallas kernel in interpret mode, exactly; the wrappers
    take the plain versions for CPU tensors. Stages past 14 refuse the
    (8, 128) dummy hi plane."""
    name, _, Aj, A, x = case
    S = 8 * A.V
    v = torch.nn.functional.pad(torch.from_numpy(x),
                                (0, A.N - x.size)).view(S, 128)
    u = _net(A, v, A.widen_r1, A.widen_r2)
    got = K.clos_r3_fill_torch(u, A.widen_r3, A.fill_hi, A.fill_stages)
    want = _call(partial(_r3_fill_kernel, (S, Aj.fill_stages)),
                 jnp.asarray(u.numpy()), Aj.widen_r3, Aj.fill_hi)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.clos_r3_fill(u, A.widen_r3, A.fill_hi,
                                      A.fill_stages), got)

    u = _net(A, got, A.perm_r1, A.perm_r2)
    got = K.clos_r3_scan_torch(u, A.perm_r3, A.vals, A.scan_hi,
                               A.scan_stages)
    want = _call(partial(_r3_scan_kernel, (S, Aj.scan_stages)),
                 jnp.asarray(u.numpy()), Aj.perm_r3, Aj.vals, Aj.scan_hi)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.clos_r3_scan(u, A.perm_r3, A.vals, A.scan_hi,
                                      A.scan_stages), got)

    u = _net(A, got, A.compact_r1, A.compact_r2)
    got = K.clos_r3_valid_torch(u, A.compact_r3)
    want = _call(_r3_valid_kernel, jnp.asarray(u.numpy()), Aj.compact_r3)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.clos_r3_valid(u, A.compact_r3), got)

    if name == "hi_planes":
        dummy = torch.zeros((8, 128), dtype=torch.int32)
        with pytest.raises(ValueError, match="fill_hi"):
            K.clos_r3_fill(u, A.widen_r3, dummy, A.fill_stages)
        with pytest.raises(ValueError, match="scan_hi"):
            K.clos_r3_scan(u, A.perm_r3, A.vals, dummy, A.scan_stages)


def test_y_matches_jax_impls_and_float64_executor(case):
    """CLOS/torch y equals the JAX xla impl's and pallas impl's (interpret
    mode) exactly, and lies within 1e-6 of |A|·|x| of the float64
    executor, which equals the JAX one."""
    name, mat, Aj, A, x = case
    got = spmv(A, torch.from_numpy(x)).numpy()        # CPU tensor: "torch"
    assert got.shape == (mat.shape[0],) and got.dtype == np.float32
    x64 = x.astype(np.float64)
    ref = execute_clos_numpy(A, x64)
    assert np.array_equal(ref, jax_execute(Aj, x64))
    assert rel_err(mat, x, ref) <= 1e-7       # float32 values, float64 sums
    scale = np.abs(mat) @ np.abs(x64) + 1e-30
    assert np.max(np.abs(got - ref) / scale) <= 1e-6
    xj = jnp.asarray(x)
    assert np.array_equal(got, np.asarray(jax_spmv(Aj, xj, impl="xla")))
    if name in ("square", "pathological"):    # interpret runs of seconds;
        # B8 and B2 meet the Pallas kernels on every case above
        assert np.array_equal(got,
                              np.asarray(jax_spmv(Aj, xj, impl="pallas")))


def test_clos_from_jax_runs_the_same_program(case):
    _, _, Aj, A, x = case
    B = clos_from_jax({f: np.asarray(getattr(Aj, f)) for f in C.DATA_FIELDS},
                      {f: getattr(Aj, f) for f in C.META_FIELDS})
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))
    assert B.mem_footprint_bytes() == Aj.mem_footprint_bytes()


def test_build_clos_refuses_past_max_N():
    host = HostCSR.from_scipy(random_matrix(300, 300, 0.01, 1))
    with pytest.raises(ClosRoutingError, match="too large"):
        build_clos(host, max_N=4096)


def test_clos_moves_and_scales_whole():
    A = build_clos(HostCSR.from_scipy(random_matrix(300, 300, 0.01, 1)))
    B = A.to("cpu")
    assert B is not A and B.device == torch.device("cpu")
    from spmv_research_tpu_torch.harness.bench import _scale_for_iteration
    host = HostCSR.from_scipy(random_matrix(300, 300, 0.01, 1))
    As = _scale_for_iteration(host, A)
    assert torch.equal(As.widen_r1, A.widen_r1) and not torch.equal(As.vals,
                                                                    A.vals)


def test_build_best_fallback_order(monkeypatch, tmp_path):
    """CLOSG, else CLOS, else BFLY, else neither (the JAX format order);
    the scattered twin has no locality, so SELLR and SELLW refuse it. Each
    call has a format cache of its own: a program cached by the call
    before would load past the refusing builder."""
    host = HostCSR.from_scipy(scattered_matrix())
    calls = []

    def best():
        calls.append(1)
        monkeypatch.setenv("SPARSE_FORMAT_CACHE_TORCH",
                           str(tmp_path / str(len(calls))))
        return bb.build_best(host)

    assert list(best()) == ["CLOSG"]

    def refuse(err):
        def builder(_):
            raise err("refused")
        return builder

    monkeypatch.setattr(bb, "build_clos_gather_auto", refuse(ClosRoutingError))
    got = best()
    assert list(got) == ["CLOS"] and got["CLOS"][1]["build_s"] > 0
    monkeypatch.setattr(bb, "build_clos", refuse(ClosRoutingError))
    assert list(best()) == ["BFLY"]
    monkeypatch.setattr(bb, "build_bfly", refuse(RoutingError))
    assert best() == {}


def test_sweep_runs_clos_and_skips_refusals(tmp_path, monkeypatch, capsys):
    """A CPU sweep on the cut scircuit twin: CLOS/torch and BFLY/torch rows
    within 1e-5 of |A|·|x|; a BFLY refusal (RoutingError) is a suitability
    error: printed, the format skipped."""
    cfg = BenchConfig(min_num_loops=2, min_time_s=0.0, warmup_iters=1,
                      use_rcm_reordering="auto")
    res = run_sweep([TWIN_LINE], formats=("clos", "bfly"),
                    out_dir=str(tmp_path / "a"), config=cfg, device="cpu")
    assert [f"{r.format_name}/{r.impl}" for r in res] == ["CLOS/torch",
                                                         "BFLY/torch"]
    assert res[0].metrics.max_rel_err == res[1].metrics.max_rel_err
    host, _, _ = sweep_mod.load_matrix(TWIN_LINE, cfg)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    for r in res:
        assert rel_err(host.to_scipy(), x, r.y) <= 1e-5

    def too_large(_):
        raise RoutingError("matrix too large for single-block bfly")
    monkeypatch.setitem(sweep_mod.FORMAT_BUILDERS, "bfly", too_large)
    res = run_sweep([TWIN_LINE], formats=("clos", "bfly"),
                    out_dir=str(tmp_path / "b"), config=cfg, device="cpu")
    assert [r.format_name for r in res] == ["CLOS"]
    assert "bfly build refused" in capsys.readouterr().out
