"""The BFLY engine of the port (kernels B9 and B10) against the JAX package.

Both packages build the program from the same seeded matrix — the cases of
``tests/test_bfly.py``, its pathological one (an empty row and a dense row)
included — with the native Waksman router and with the numpy one, and must
give identical arrays; so must ``route_waksman`` and ``greedy_route`` alone.
The Pallas kernels run in interpret mode on the CPU; the port runs each
kernel's plain PyTorch version, which its wrapper takes for CPU tensors.
The exchange and fill stages are selects, the scan adds in the same order,
and × vals and × valid are one product per slot, so the plain B9 functions
must equal the Pallas kernels exactly, ``bfly_full_torch`` (B10's plain
version) must equal the plain B9 chain and ``spmv_bfly_pallas_fused``
exactly, and BFLY/torch's y must equal the JAX ``xla`` and ``pallas``
impls' exactly (it is held to 1e-6 of |A|·|x| against ``execute_numpy``;
the JAX tests allow 3e-5 relative and 2e-5 absolute).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.io import native as jax_native
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops import routing as jax_routing
from spmv_research_tpu.ops.bfly import build_bfly as jax_build
from spmv_research_tpu.ops.bfly_pallas import (_call, _fill_kernel,
                                               _scan_kernel, _xor_net,
                                               spmv_bfly_pallas_fused)
from spmv_research_tpu.ops.waksman import route_waksman as jax_route

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.io import native
from spmv_research_tpu_torch.ops import (bfly_from_jax, build_bfly, spmv,
                                         spmv_bfly_cuda_fused)
from spmv_research_tpu_torch.ops import bfly as BF
from spmv_research_tpu_torch.ops import bfly_cuda as K
from spmv_research_tpu_torch.ops import routing
from spmv_research_tpu_torch.ops.waksman import route_waksman

from torch_cases import bfly_pathological, random_matrix, rel_err


MATRICES = {
    "small": lambda: random_matrix(100, 80, 0.05, 1),
    "dense": lambda: random_matrix(64, 64, 0.25, 2),
    "wide": lambda: random_matrix(500, 700, 0.01, 3),
    "pathological": bfly_pathological,
}


@pytest.fixture(params=["native", "numpy"])
def router(request, monkeypatch):
    """Both packages route with the C++ router, or both with numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "have_native", lambda: False)
        monkeypatch.setattr(jax_native, "have_native", lambda: False)
    else:
        assert native.have_native() and jax_native.have_native()
    return request.param


@pytest.fixture(scope="module", params=sorted(MATRICES))
def case(request):
    """(name, matrix, JAX Bfly, the port's own Bfly, x), native router."""
    mat = MATRICES[request.param]()
    Aj = jax_build(JaxHostCSR.from_scipy(mat))
    A = build_bfly(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return request.param, mat, Aj, A, x.astype(np.float32)


def _same_program(A, Aj):
    for f in BF.DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert ({f: getattr(A, f) for f in BF.META_FIELDS}
            == {f: getattr(Aj, f) for f in BF.META_FIELDS})


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_program_identical(name, router):
    mat = MATRICES[name]()
    _same_program(build_bfly(HostCSR.from_scipy(mat)),
                  jax_build(JaxHostCSR.from_scipy(mat)))


def test_routers_identical(router):
    """route_waksman on permutations and partial maps (test_bfly.py's
    fuzz), and the greedy merge router, against the JAX package's."""
    for trial in range(8):
        rs = np.random.default_rng(trial)
        L = int(rs.integers(2, 9))
        N = 1 << L
        src = np.arange(N) if trial % 2 else rs.choice(N, N // 4, False)
        tgt = rs.permutation(N)[: src.size]
        got, want = route_waksman(src, tgt, L, N), jax_route(src, tgt, L, N)
        assert got.stages == want.stages
        assert np.array_equal(got.A, want.A) and np.array_equal(got.B, want.B)
        v = rs.uniform(1, 2, N)
        out = routing.apply_pass_numpy(np.where(np.isin(np.arange(N), src),
                                                v, 0.0), got)
        assert np.array_equal(out[tgt], v[src])
    rs = np.random.default_rng(5)
    src = np.sort(rs.choice(256, 120, replace=False))
    tgt = np.sort(rs.integers(0, 30, 120)) * 8
    got = routing.greedy_route(src, tgt, 8, 256, allow_merge=True)
    want = jax_routing.greedy_route(src, tgt, 8, 256, allow_merge=True)
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert p.stages == q.stages and np.array_equal(p.A, q.A)
        assert np.array_equal(p.B, q.B)


def test_b9_plain_versions_match_pallas_kernels(case):
    """Each B9 function on its real input (the plain chain up to it)
    against the Pallas kernel in interpret mode, exactly; the wrappers take
    the plain versions for CPU tensors."""
    _, _, Aj, A, x = case
    N = A.N
    S = N // 128
    v = BF._spread_x(torch.from_numpy(x), A.n, N, A.sigma_x)

    def jax_net(u, B, stages):
        return np.asarray(_xor_net(jnp.asarray(u.numpy()).reshape(S, 128),
                                   B, stages)).reshape(-1)

    def jax_shift(kernel, u, words, stages):
        if not stages:
            return u.numpy()
        return np.asarray(_call(partial(kernel, stages, S),
                                jnp.asarray(u.numpy()).reshape(S, 128),
                                words.reshape(S, 128))).reshape(-1)

    steps = (
        ("bfly_xor_net", (A.widen_B, A.widen_stages),
         lambda u: jax_net(u, Aj.widen_B, Aj.widen_stages)),
        ("bfly_fill", (A.fill_words, A.fill_stages),
         lambda u: jax_shift(_fill_kernel, u, Aj.fill_words,
                             Aj.fill_stages)),
        ("bfly_xor_net", (A.perm_B, A.perm_stages),
         lambda u: jax_net(u, Aj.perm_B, Aj.perm_stages)),
        ("bfly_scan", (A.scan_guards, A.scan_stages),
         lambda u: jax_shift(_scan_kernel, u, Aj.scan_guards,
                             Aj.scan_stages)),
        ("bfly_xor_net", (A.compact_B, A.compact_stages),
         lambda u: jax_net(u, Aj.compact_B, Aj.compact_stages)),
    )
    for i, (name, args, jax_fn) in enumerate(steps):
        got = getattr(K, name + "_torch")(v, *args)
        assert np.array_equal(got.numpy(), jax_fn(v)), (i, name)
        assert torch.equal(getattr(K, name)(v, *args), got)
        v = got * A.vals if i == 2 else got


def test_b10_plain_version_matches_chain_and_fused_pallas(case):
    _, _, Aj, A, x = case
    xt = torch.from_numpy(x)
    v = BF._spread_x(xt, A.n, A.N, A.sigma_x)
    full = K.bfly_full_torch(v, *A.planes())
    assert torch.equal(K.bfly_full(v, *A.planes()), full)
    y = spmv(A, xt)                                    # the B9 chain
    assert torch.equal(BF._y(A, full), y)
    want = np.asarray(spmv_bfly_pallas_fused(Aj, jnp.asarray(x)))
    assert np.array_equal(y.numpy(), want)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_bfly_cuda_fused(A, xt)


def test_y_matches_jax_impls_and_numpy_executor(case):
    """BFLY/torch y equals the JAX xla and pallas (interpret) impls' exactly
    and lies within 1e-6 of |A|·|x| of the float64 executor. (The pallas
    impl runs the B9 kernels, each held against its plain version on every
    case above: its whole y is checked on two cases, as its interpret run
    takes seconds.)"""
    name, mat, Aj, A, x = case
    got = spmv(A, torch.from_numpy(x)).numpy()         # CPU tensor: "torch"
    assert got.shape == (mat.shape[0],) and got.dtype == np.float32
    x64 = x.astype(np.float64)
    prog = routing.build_bfly_program(HostCSR.from_scipy(mat),
                                      dtype=np.float32)
    ref = routing.execute_numpy(prog, x64)
    assert np.array_equal(ref, jax_routing.execute_numpy(
        jax_routing.build_bfly_program(JaxHostCSR.from_scipy(mat),
                                       dtype=np.float32), x64))
    assert rel_err(mat, x, ref) <= 1e-7       # float32 values, float64 sums
    scale = np.abs(mat) @ np.abs(x64) + 1e-30
    assert np.max(np.abs(got - ref) / scale) <= 1e-6
    xj = jnp.asarray(x)
    for impl in ("xla", "pallas")[: 2 if name in ("dense", "pathological")
                                  else 1]:
        assert np.array_equal(got, np.asarray(jax_spmv(Aj, xj, impl=impl)))


def test_bfly_from_jax_runs_the_same_program(case):
    _, _, Aj, A, x = case
    B = bfly_from_jax({f: np.asarray(getattr(Aj, f)) for f in BF.DATA_FIELDS},
                      {f: getattr(Aj, f) for f in BF.META_FIELDS})
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))
    assert B.mem_footprint_bytes() == Aj.mem_footprint_bytes()


def test_build_bfly_refuses_past_max_N():
    host = HostCSR.from_scipy(random_matrix(300, 500, 0.01, 3))
    with pytest.raises(routing.RoutingError, match="too large"):
        build_bfly(host, max_N=256)


def test_b10_codes_fold_the_products():
    """B10's stage codes: × vals rides on the first stage after the perm
    network, or on the final pass when no stage follows it."""
    codes, n, premul_final = K._codes(((0, 1, 3),), (2,), ((1, 0, 5),), (0,),
                                      ((0, 2, 1),))
    assert n == 5 and premul_final == 0
    assert [c & ~K.PREMUL for c in codes] == [
        3 | 1 << 5, 2 | K.KIND_FILL << 16, 5 | 1 << 10 | K.NET_PERM << 18,
        0 | K.KIND_SCAN << 16, 1 | 2 << 5 | K.NET_COMPACT << 18]
    assert [bool(c & K.PREMUL) for c in codes] == [0, 0, 0, 1, 0]
    assert K._codes(((0, 0, 1),), (), (), (), ())[1:] == (1, 1)


# ------------------------------------------------ B10's phased schedule

def _phased_emulation(v, codes, T, nets=None, fill_words=None,
                      scan_guards=None, vals=None, out_valid=None,
                      premul_final=0):
    """The phase kernel's schedule (``csrc/bfly.cu`` ``full_kernel``) in
    plain PyTorch for the stage codes ``codes``: the phases of
    ``plan_phases`` at tiles of 2^T slots, each tiled phase run tile by
    tile on its window (halo included; all tiles at once, one row each),
    each global phase one stage over the whole plane, × vals where a code
    asks for it and, when ``out_valid`` is given (B10; a B9 call has none),
    × valid as the last phase writes out. ``nets`` maps a network code to
    its word planes."""
    N = v.numel()
    L = N.bit_length() - 1
    T = min(T, L)
    phases = K.plan_phases(codes, L, T)

    def stage(c):
        kind, k = (c >> 16) & 3, c & 31
        if kind == K.KIND_XOR:
            return kind, k, (c >> 5) & 31, nets[(c >> 18) & 3][(c >> 10) & 63]
        return kind, k, k, fill_words if kind == K.KIND_FILL else scan_guards

    src = v
    for pi, (first, count, tiling, halo) in enumerate(phases):
        if tiling == K.GLOBAL:
            c = codes[first]
            kind, k, bit, plane = stage(c)
            u = src * vals if c & K.PREMUL else src
            g = ((plane >> bit) & 1) != 0
            if kind == K.KIND_XOR:
                dst = torch.where(g, u[torch.arange(N) ^ (1 << k)], u)
            elif kind == K.KIND_FILL:
                dst = torch.where(g, torch.roll(u, 1 << k), u)
            else:
                dst = u + torch.where(g, torch.roll(u, 1 << k), 0.0)
        else:
            W = (1 << T) + halo
            i = torch.arange(W)
            tiles = torch.arange(N >> T)[:, None]
            if tiling == K.CONTIG:
                gi = ((tiles << T) + i - halo) & (N - 1)
            else:
                gi = (i >> 5) << (L - T + 5) | tiles << 5 | (i & 31)
            cur = src[gi]
            for c in codes[first:first + count]:
                kind, k, bit, plane = stage(c)
                if c & K.PREMUL:
                    cur = cur * vals[gi]
                g = ((plane[gi] >> bit) & 1) != 0
                dl = 1 << (k - L + T if tiling == K.STRIDED and k >= 5
                           else k)
                if kind == K.KIND_XOR:
                    inner = i >= halo
                    part = torch.where(inner, halo + ((i - halo) ^ dl), i)
                    cur = torch.where(g & inner, cur[:, part], cur)
                    continue
                q = i - dl
                if T == L:
                    q = q & (W - 1)
                take = g & (q >= 0)
                shifted = cur[:, q.clamp(min=0)]
                cur = (torch.where(take, shifted, cur)
                       if kind == K.KIND_FILL
                       else cur + torch.where(take, shifted, 0.0))
            dst = torch.empty_like(src)
            dst[gi[:, halo:]] = cur[:, halo:]
        if pi == len(phases) - 1 and out_valid is not None:
            dst = (dst * vals if premul_final else dst) * out_valid
        src = dst
    return src


def _b10_emulation(v, widen_B, fill_words, perm_B, vals, scan_guards,
                   compact_B, out_valid, *stages, T):
    """B10's whole program through ``_phased_emulation``."""
    codes, _, premul_final = K._codes(*map(tuple, stages))
    return _phased_emulation(
        v, codes, T, {K.NET_WIDEN: widen_B, K.NET_PERM: perm_B,
                      K.NET_COMPACT: compact_B}, fill_words, scan_guards,
        vals, out_valid, premul_final)


def _b9_emulation(key, v, plane, stages, T):
    """One B9 call (``key`` the wrapper) through ``_phased_emulation``:
    its own codes and its one plane, no × vals, no × valid."""
    codes = K.b9_codes(key, stages)
    if not codes:
        return v
    words = dict(nets={K.NET_WIDEN: plane}) if key == "bfly_xor_net" else (
        dict(fill_words=plane) if key == "bfly_fill"
        else dict(scan_guards=plane))
    return _phased_emulation(v, codes, T, **words)


def _b9_calls(v, widen_B, fill_words, perm_B, vals, scan_guards, compact_B,
              out_valid, widen, fill, perm, scan, compact):
    """The five B9 calls of one SpMV on their real inputs (the plain chain
    up to each): (wrapper, input, plane, stages)."""
    calls = []
    for key, plane, stages, after in (
            ("bfly_xor_net", widen_B, widen, None),
            ("bfly_fill", fill_words, fill, None),
            ("bfly_xor_net", perm_B, perm, vals),
            ("bfly_scan", scan_guards, scan, None),
            ("bfly_xor_net", compact_B, compact, None)):
        calls.append((key, v, plane, stages))
        v = getattr(K, key + "_torch")(v, plane, stages)
        v = v if after is None else v * after
    return calls


def _random_program(L, passes, fill, scan, seed):
    """Random word planes and stage lists of a program of 2^L slots: each
    network ``passes`` Waksman-ordered passes (k = 0..L−1..0), fill and
    scan stages 0..fill−1 and 0..scan−1."""
    rng = np.random.default_rng(seed)
    N = 1 << L
    order = list(range(L)) + list(range(L - 2, -1, -1))
    net = [(j // 32, j % 32, k) for j, k in enumerate(order * passes)]
    words = (len(net) + 31) // 32

    def bits(*shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                             dtype=np.int64).astype(np.int32))

    v = torch.from_numpy(rng.uniform(-1, 1, N).astype(np.float32))
    vals = torch.from_numpy(rng.uniform(-1, 1, N).astype(np.float32))
    valid = torch.from_numpy((rng.random(N) < 0.7).astype(np.float32))
    planes = (bits(words, N), bits(N), bits(words, N), vals, bits(N),
              bits(words, N), valid)
    return v, planes, (net, tuple(range(fill)), net, tuple(range(scan)), net)


def _check_plan(codes, phases, L, T):
    """Every code in exactly one phase, in order; each phase's stages
    served by its tiling, its halo the sum of its leading shifts."""
    assert [p[0] for p in phases] == list(
        np.cumsum([0] + [p[1] for p in phases[:-1]]))
    assert sum(p[1] for p in phases) == len(codes)
    for first, count, tiling, halo in phases:
        ks = [(c >> 16 & 3, c & 31) for c in codes[first:first + count]]
        shifts = [k for kind, k in ks if kind != K.KIND_XOR]
        if tiling == K.GLOBAL:
            assert count == 1 and halo == 0
        elif tiling == K.STRIDED:
            assert not shifts and halo == 0
            assert all(k < 5 or k >= L - T + 5 for _, k in ks)
        elif T < L:
            assert ks[:len(shifts)] == [(kind, k) for kind, k in ks
                                        if kind != K.KIND_XOR]
            assert halo == sum(1 << k for k in shifts) <= K.HALO_MAX
            assert all(k < T for kind, k in ks if kind == K.KIND_XOR)


@pytest.mark.parametrize("T", [4, 5, 6, 7, 9, 14])
def test_b10_phased_schedule_matches_plain_version(case, T):
    """The phased schedule equals bfly_full_torch bit for bit on each
    case's program at tiles of 2^T (L = 9 or 12 here: T = 7 is L = 2T − 5
    for L = 9; T = 5 and 6 leave stages to global phases; T >= L is one
    tile)."""
    _, _, _, A, x = case
    v = BF._spread_x(torch.from_numpy(x), A.n, A.N, A.sigma_x)
    want = K.bfly_full_torch(v, *A.planes())
    got = _b10_emulation(v, *A.planes(), T=T)
    assert torch.equal(got, want)
    codes, n_codes, _ = K._codes(*A.planes()[7:])
    _check_plan(list(codes)[:n_codes], K.plan_phases(
        list(codes)[:n_codes], A.L, min(T, A.L)), A.L, min(T, A.L))


@pytest.mark.parametrize("L, T, passes, fill, scan, halo_max", [
    (9, 7, 2, 4, 6, K.HALO_MAX),     # L = 2T − 5, two passes a network
    (11, 8, 1, 6, 9, K.HALO_MAX),    # L = 2T − 5, scircuit's fill and scan
    (10, 6, 2, 3, 9, 40),            # global exchanges, halo split
    (8, 10, 2, 5, 7, K.HALO_MAX),    # L <= T: one tile, shifts wrap
])
def test_b10_phased_schedule_on_random_programs(L, T, passes, fill, scan,
                                               halo_max, monkeypatch):
    """Random word planes and multi-pass networks: the phased schedule
    equals bfly_full_torch bit for bit, and the plan covers every code once,
    in order (a small halo budget splits the scan's run; past L = 2T − 5
    global phases take the exchanges no tiling serves)."""
    monkeypatch.setattr(K, "HALO_MAX", halo_max)
    v, planes, stages = _random_program(L, passes, fill, scan, seed=L + T)
    want = K.bfly_full_torch(v, *planes, *stages)
    assert torch.equal(_b10_emulation(v, *planes, *stages, T=T), want)
    codes, n_codes, _ = K._codes(*map(tuple, stages))
    codes = list(codes)[:n_codes]
    phases = K.plan_phases(codes, L, min(T, L))
    _check_plan(codes, phases, L, min(T, L))
    kinds = {p[2] for p in phases}
    assert (K.GLOBAL in kinds) == (L > 2 * T - 5)
    assert (len(phases) == 1) == (T >= L)


def test_b10_plan_of_the_scircuit_shape():
    """The scircuit program's shape (L = 20: three 39-stage Waksman
    networks, fill 0..5, scan 0..8) takes 9 phases at T = 13, 8 grid
    launches for 132 stages; mac_econ_fwd500's (L = 21) 9 at T = 14. B9's
    calls on the same shape: each network alone 3 phases (contiguous,
    strided, contiguous), the fill and the scan 1 contiguous phase each
    (halo 63 and 511): 11 launches per SpMV, where one a stage took 132 and
    138."""
    for L, T, n_codes in ((20, 13, 132), (21, 14, 138)):
        assert K.tile_log(L) == T
        net = tuple((0, j % 32, k) for j, k in enumerate(
            list(range(L)) + list(range(L - 2, -1, -1))))
        stages = (net, tuple(range(6)), net, tuple(range(9)), net)
        n = K._codes(*stages)[1]
        phases = K.phase_table(stages, L)
        assert n == n_codes and len(phases) == 9
        assert [p[2] for p in phases] == [K.CONTIG, K.STRIDED, K.CONTIG] * 3
        assert [p[3] for p in phases] == [0, 0, 0, 63, 0, 0, 511, 0, 0]
        b9 = [K.b9_phase_table(key, st, L) for key, st in zip(
            ("bfly_xor_net", "bfly_fill", "bfly_xor_net", "bfly_scan",
             "bfly_xor_net"), stages)]
        assert [len(p) for p in b9] == [3, 1, 3, 1, 3]
        assert [p[2] for p in b9[0]] == [K.CONTIG, K.STRIDED, K.CONTIG]
        assert [p[3] for p in b9[0]] == [0, 0, 0]
        assert b9[1] == ((0, 6, K.CONTIG, 63),)
        assert b9[3] == ((0, 9, K.CONTIG, 511),)
        assert sum(p[1] for ph in b9 for p in ph) == n_codes
    assert [K.tile_log(L) for L in (4, 9, 12, 16, 19, 22)] == [4, 7, 9, 11,
                                                                12, 14]


# ------------------------------------------- B9's calls in the same phases

@pytest.mark.parametrize("T", [4, 5, 7, 14])
def test_b9_phased_schedule_matches_plain_versions(case, T):
    """Each B9 call of one SpMV on its real input, run in the phases of its
    own codes at tiles of 2^T (global phases only at T = 4; T = 14 >= L is
    one tile), equals its plain version bit for bit, and the plan covers
    its codes once, in order."""
    _, _, _, A, x = case
    v = BF._spread_x(torch.from_numpy(x), A.n, A.N, A.sigma_x)
    for key, u, plane, stages in _b9_calls(v, *A.planes()):
        want = getattr(K, key + "_torch")(u, plane, stages)
        assert torch.equal(_b9_emulation(key, u, plane, stages, T), want), key
        codes = K.b9_codes(key, stages)
        assert not any(c & K.PREMUL for c in codes)
        if codes:
            _check_plan(codes, K.plan_phases(codes, A.L, min(T, A.L)), A.L,
                        min(T, A.L))


@pytest.mark.parametrize("L, T, passes, fill, scan, halo_max", [
    (9, 7, 2, 4, 6, K.HALO_MAX),     # L = 2T − 5, two passes a network
    (11, 8, 1, 6, 9, K.HALO_MAX),    # L = 2T − 5, scircuit's fill and scan
    (8, 6, 1, 4, 7, K.HALO_MAX),     # L = 2T − 5 + 1: global exchanges
    (10, 6, 2, 3, 9, 40),            # global exchanges, halo split
    (10, 5, 1, 5, 8, 100),           # the smallest tile, halo split
    (8, 10, 2, 5, 7, K.HALO_MAX),    # L <= T: one tile, shifts wrap
])
def test_b9_phased_schedule_on_random_programs(L, T, passes, fill, scan,
                                              halo_max, monkeypatch):
    """Random word planes and multi-pass networks: each network, the fill
    and the scan alone, in the phases of their own codes, equal their
    plain versions bit for bit (a small halo budget splits the scan's run
    into several contiguous phases; past L = 2T − 5 global phases take the
    exchanges no tiling serves)."""
    monkeypatch.setattr(K, "HALO_MAX", halo_max)
    v, planes, stages = _random_program(L, passes, fill, scan, seed=L + T)
    for key, u, plane, st in _b9_calls(v, *planes, *stages):
        want = getattr(K, key + "_torch")(u, plane, st)
        assert torch.equal(_b9_emulation(key, u, plane, st, T), want), key
        codes = K.b9_codes(key, st)
        phases = K.plan_phases(codes, L, min(T, L))
        _check_plan(codes, phases, L, min(T, L))
        if key == "bfly_xor_net":
            assert ({p[2] for p in phases} >= {K.GLOBAL}) == (L > 2 * T - 5)
        else:
            halo = sum(1 << k for k in st)
            assert (len(phases) > 1) == (halo > halo_max and T < L)
