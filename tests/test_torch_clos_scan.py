"""The phased scan (``clos_cuda.plan_scan_phases``) on the CPU: K3's capped
scan, B5, B8's fill and scan, and B15's scan.

The CUDA kernels (``csrc/closg.cu`` ``scan_contig_kernel`` and
``scan_strided_kernel``) run the r3 layer (× vals for B8's scan) and the
guarded segmented scan (or, in select mode, B8's forward fill) in phases of
tiles with a halo. Here a plain PyTorch emulation follows the planner's
tiles, halos and strided views exactly as the kernels index them (all tiles
of a phase at once, one row each; a read that leaves the window is NaN, the
kernels' garbage, which must reach no tile slot) and must equal the plain
versions bit for bit: ``closg_r3_scan_torch`` and
``closgx_r3_scan_yext_torch`` on CLOSG's W = 0 programs (the ``w0`` case,
and ``scan_hi``, whose stage 15 reads the overflow plane), on a CLOSGX
stack, and on K3's capped scan of a W > 0 program; ``clos_r3_fill_torch``
and ``clos_r3_scan_torch`` on CLOS programs (their stages past 14 on the
hi planes); and random planes in all three modes, at several tile sizes
and halo budgets. The planner's arithmetic is checked on its own, and on
the scircuit twin's programs (the chip smoke's shapes).
"""

import numpy as np
import pytest
import torch

from spmv_research_tpu_torch import bench
from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.ops import build_clos_gather, build_clos_gather_xl
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops.clos import build_clos, invreg_torch
from spmv_research_tpu_torch.ops.clos_route import LANES

from torch_cases import (capped_scan_matrix, clos_hi_matrix, fill_chunks,
                         random_matrix, w0_matrix)


def _phased_emulation(v, w3, hi, stages, chunk, T, halo_max, vals=None,
                      select=False):
    """The phased scan in plain PyTorch: each tiled phase gathers every
    tile's window (halo first), runs the r3 layer on it (phase 0; × vals at
    each window slot's plane slot, where given) and the phase's stages as
    shifts by D window slots, a read that would leave the window reading
    NaN, and writes back the tiles' own slots; a global phase is one stage
    over the plane. A stage adds the value read where the guard is set, or
    (``select``) takes it where the take bit is set."""
    def step(cur, take, read):
        if select:
            return torch.where(take, read, cur)
        return cur + torch.where(take, read, 0.0)

    n = v.numel()
    v, w3 = v.reshape(-1), w3.reshape(-1).long() & 0xFFFFFFFF
    hi = (hi.reshape(-1).long() & 0xFFFFFFFF if hi.numel() == n
          else torch.zeros_like(w3))
    guards = hi << 15 | w3 >> 17          # bit k: stage k's guard
    stages = tuple(stages)
    L = chunk.bit_length() - 1
    C = n // chunk
    phases = K.plan_scan_phases(stages, n, chunk, T, halo_max)
    T = min(T, L)
    src = v
    for first, count, tiling, halo in phases:
        ks = stages[first:first + count]
        if tiling == K.GLOBAL:
            k = ks[0]
            u = src.view(C, chunk)
            g = ((guards >> k) & 1).bool().view(C, chunk)
            src = step(u, g, torch.roll(u, 1 << k, dims=1)).reshape(-1)
            continue
        k0 = ks[0] if ks else 0
        if tiling == K.CONTIG:
            R = T
            whole = R == L
            H = 0 if whole or halo == 0 else 1024
            per = 1 << (L - R)
        else:
            jl = L - k0
            R = min(T - 5, jl)
            whole = R == jl
            H = 0 if whole else 32 * halo
            per = 1 << (k0 - 5 + jl - R)
        W = (1 << R) + H if tiling == K.CONTIG else (32 << R) + H
        t = torch.arange(C * per)[:, None]
        i = torch.arange(W)
        cbase, local = (t // per) << L, t % per
        if tiling == K.CONTIG:
            gi = cbase + (((local << R) + i - H) & (chunk - 1))
            cur = invreg_torch(src[gi].view(-1, LANES),
                               w3[gi].int().view(-1, LANES)).view(-1, W)
            if vals is not None:
                cur = cur * vals.reshape(-1)[gi]
            shifts = [1 << k for k in ks]
        else:
            jt, rg = local & ((1 << (jl - R)) - 1), local >> (jl - R)
            j = ((jt << R) + (i >> 5) - (H >> 5)) & ((1 << jl) - 1)
            gi = cbase + (j << k0) + (rg << 5) + (i & 31)
            cur = src[gi]
            shifts = [32 << (k - k0) for k in ks]
        g = guards[gi]
        for k, d in zip(ks, shifts):
            q = i - d
            if whole:
                q = q & (W - 1)
            read = torch.where(q >= 0, cur[:, q.clamp(min=0)], float("nan"))
            cur = step(cur, ((g >> k) & 1).bool(), read)
        dst = torch.full_like(src, float("nan"))
        dst[gi[:, H:]] = cur[:, H:]
        # every slot written once, and no garbage read reached a tile slot
        assert not torch.isnan(dst).any()
        src = dst
    return src.view(-1, LANES)


def _v(n, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    return torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).view(
        -1, LANES)


@pytest.fixture(scope="module", params=["w0", "scan_hi"])
def w0_case(request):
    mat = (w0_matrix(130, 520) if request.param == "w0"
           else w0_matrix(130, 600, heavy=33000))
    A = build_clos_gather(HostCSR.from_scipy(mat))
    assert A.W == 0 and (len(A.scan_stages) > 15) == (
        request.param == "scan_hi")
    return A


@pytest.mark.parametrize("T,halo_max", [(13, 1024), (11, 1024), (10, 256),
                                        (12, 64)])
def test_phased_schedule_equals_closg_r3_scan(w0_case, T, halo_max):
    A = w0_case
    v = _v(A.N, 3)
    want = K.closg_r3_scan_torch(v, A.perm_r3, A.scan_hi, A.scan_stages)
    got = _phased_emulation(v, A.perm_r3, A.scan_hi, A.scan_stages, A.N, T,
                            halo_max)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def xl_stack():
    A = build_clos_gather_xl(HostCSR.from_scipy(
        random_matrix(4000, 900, 0.008, 5)), chunk_N=8192)
    assert A.n_chunks >= 3 and A.stages >= 5
    return A


@pytest.mark.parametrize("T,halo_max", [(13, 1024), (11, 1024), (10, 128)])
def test_phased_schedule_equals_closgx_back_end(xl_stack, T, halo_max):
    """B15 over a stack of 8192-slot chunks: one whole-chunk tile at T =
    13, tiles with a halo that wraps inside each chunk below it."""
    A = xl_stack
    v = _v(A.n_chunks * A.N, 4)
    r3 = A.r3.view(-1, LANES)
    ysel_w, wstart = A.ysel_w.view(-1, LANES), A.wstart_abs.view(-1)
    want = K.closgx_r3_scan_yext_torch(v, r3, ysel_w, wstart, A.stages, A.N)
    u = _phased_emulation(v, r3, r3.new_zeros(1), range(A.stages), A.N, T,
                          halo_max)
    got = K._y_pick(u, ysel_w, wstart, torch.arange(ysel_w.shape[0]))
    assert torch.equal(got, want)


RANDOM_SHAPES = pytest.mark.parametrize("chunk,n_chunks,stages,T,halo_max", [
    (1 << 15, 1, tuple(range(15)), 10, 1024),     # strided, some whole
    (1 << 14, 3, tuple(range(14)), 11, 512),
    (1 << 14, 2, (0, 2, 5, 9, 11, 13), 10, 1024),  # sparse stages
    (1 << 13, 2, (), 10, 1024),                    # the r3 layer alone
    (1 << 16, 1, tuple(range(17)), 10, 16),        # tiny budget: global
    (1 << 10, 4, tuple(range(12)), 13, 1024),      # chunk < tile, k >= L
])


def _random_planes(chunk, n_chunks, stages):
    rng = np.random.Generator(np.random.PCG64(chunk + len(stages)))
    n = chunk * n_chunks
    w3 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n).astype(
        np.int32)).view(-1, LANES)
    hi = torch.from_numpy(rng.integers(0, 2 ** 16, n).astype(np.int32))
    return _v(n, 5), w3, hi


@RANDOM_SHAPES
def test_phased_schedule_on_random_planes(chunk, n_chunks, stages, T,
                                          halo_max):
    """Random words and guards (any bit may be set, wrapping or not) and
    random values: the schedule equals the plain scan whatever the guards,
    so the halo alone carries its exactness."""
    v, w3, hi = _random_planes(chunk, n_chunks, stages)
    want = (K.closg_r3_scan_torch(v, w3, hi, stages) if n_chunks == 1 else
            K._scan_torch(invreg_torch(v, w3).reshape(-1), w3.reshape(-1),
                          hi, stages, chunk).view(-1, LANES))
    got = _phased_emulation(v, w3, hi, stages, chunk, T, halo_max)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["select", "vals"])
@RANDOM_SHAPES
def test_phased_fill_and_vals_on_random_planes(mode, chunk, n_chunks, stages,
                                               T, halo_max):
    """The same shapes in select mode (B8's fill) and with vals (B8's
    scan): equal to ``clos_r3_fill_torch`` and ``clos_r3_scan_torch`` on one
    chunk, to their stages run per chunk on several."""
    v, w3, hi = _random_planes(chunk, n_chunks, stages)
    vals = _v(v.numel(), 6)
    if mode == "select":
        want = (K.clos_r3_fill_torch(v, w3, hi, stages) if n_chunks == 1
                else fill_chunks(invreg_torch(v, w3), w3, hi, stages, chunk))
        got = _phased_emulation(v, w3, hi, stages, chunk, T, halo_max,
                                select=True)
    else:
        want = (K.clos_r3_scan_torch(v, w3, vals, hi, stages) if n_chunks == 1
                else K._scan_torch((invreg_torch(v, w3) * vals).reshape(-1),
                                   w3.reshape(-1), hi, stages,
                                   chunk).view(-1, LANES))
        got = _phased_emulation(v, w3, hi, stages, chunk, T, halo_max,
                                vals=vals)
    assert torch.equal(got, want)


B5_TILINGS = [(13, 1024), (11, 1024), (10, 256), (12, 64)]


@pytest.fixture(scope="module", params=["random", "hi_planes"])
def clos_case(request):
    mat = (clos_hi_matrix() if request.param == "hi_planes"
           else random_matrix(3000, 2500, 0.002, 8))
    A = build_clos(HostCSR.from_scipy(mat))
    hi = request.param == "hi_planes"
    assert (A.fill_hi.numel() == A.N) == hi == (max(A.fill_stages) >= 15)
    assert (A.scan_hi.numel() == A.N) == hi == (max(A.scan_stages) >= 15)
    return A


@pytest.mark.parametrize("T,halo_max", B5_TILINGS)
def test_phased_schedule_equals_clos_fill_and_scan(clos_case, T, halo_max):
    """B8 on CLOS programs: the fill in select mode (take bits in widen_r3
    and fill_hi) and the r3 layer × vals with the scan, at B5's tile sizes
    and halo budgets."""
    A = clos_case
    v = _v(A.N, 6)
    want = K.clos_r3_fill_torch(v, A.widen_r3, A.fill_hi, A.fill_stages)
    got = _phased_emulation(v, A.widen_r3, A.fill_hi, A.fill_stages, A.N, T,
                            halo_max, select=True)
    assert torch.equal(got, want)
    want = K.clos_r3_scan_torch(v, A.perm_r3, A.vals, A.scan_hi,
                                A.scan_stages)
    got = _phased_emulation(v, A.perm_r3, A.scan_hi, A.scan_stages, A.N, T,
                            halo_max, vals=A.vals)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def capped():
    A = build_clos_gather(HostCSR.from_scipy(capped_scan_matrix()))
    assert A.W > 0 and 0 < len(A.scan_cap) < len(A.scan_stages)
    assert A.acc_src.numel() > 0
    return A


@pytest.mark.parametrize("T,halo_max", B5_TILINGS)
def test_phased_schedule_equals_closg_capped_scan(capped, T, halo_max):
    """K3's capped scan on a W > 0 program with accumulate records: the
    scanned plane its plain version extracts y from."""
    A = capped
    v = _v(A.N, 7)
    want = K.closg_r3_scan_torch(v, A.perm_r3, A.scan_hi, A.scan_cap)
    got = _phased_emulation(v, A.perm_r3, A.scan_hi, A.scan_cap, A.N, T,
                            halo_max)
    assert torch.equal(got, want)


def test_clos_r3_valid_leading_blocks(clos_case):
    """With m, the valid step's plain version gives the leading 1024-slot
    blocks that hold slots [0, m), equal to the whole plane's rows."""
    A = clos_case
    u = _v(A.N, 8)
    whole = K.clos_r3_valid_torch(u, A.compact_r3)
    assert whole.shape == (A.N // LANES, LANES)
    for m in (A.m, 0, 1, 1024, 1025, A.N):
        rows = -(-m // 1024) * 8
        got = K.clos_r3_valid_torch(u, A.compact_r3, m)
        assert got.shape == (rows, LANES) and torch.equal(got, whole[:rows])
    with pytest.raises(ValueError, match="past the plane"):
        K.clos_r3_valid_torch(u, A.compact_r3, A.N + 1)


# ------------------------------------------------------ the planner

def _check_plan(phases, stages, chunk, T, halo_max):
    """Every stage in exactly one phase, in order; phase 0 contiguous; each
    halo the sum of its phase's shifts, within the budget."""
    L = chunk.bit_length() - 1
    assert phases[0][0] == 0 and phases[0][2] == K.CONTIG
    assert [p[0] for p in phases] == list(
        np.cumsum([0] + [p[1] for p in phases[:-1]]))
    assert sum(p[1] for p in phases) == len(stages)
    for first, count, tiling, halo in phases:
        ks = stages[first:first + count]
        if tiling == K.CONTIG:
            if min(T, L) == L:
                assert halo == 0 and count == len(stages)
            else:
                assert halo == sum(1 << k for k in ks) <= halo_max
        elif tiling == K.STRIDED:
            k0 = ks[0]
            assert count >= 1 and k0 >= 5 and max(ks) < L
            if L - k0 > T - 5:                   # a halo of rows
                assert halo == sum(1 << (k - k0) for k in ks)
                assert 32 * halo <= halo_max
            else:
                assert halo == 0
        else:
            assert tiling == K.GLOBAL and count == 1 and halo == 0


@pytest.mark.parametrize("L,n_stages", [(20, 14), (20, 16), (17, 10),
                                        (13, 13), (18, 0), (14, 14)])
@pytest.mark.parametrize("T,halo_max", [(13, 1024), (10, 1024), (11, 64)])
def test_plan_covers_every_stage(L, n_stages, T, halo_max):
    stages = tuple(range(n_stages))
    phases = K.plan_scan_phases(stages, 2 << L, 1 << L, T, halo_max)
    _check_plan(phases, stages, 1 << L, T, halo_max)


def test_plan_of_the_smoke_shapes():
    """gupta3's chunk (2^20 slots, 14 stages) in 2 phases: stages 0–9 with
    a halo of 1023 slots, 10–13 strided with a halo of 15 rows; mip1's
    stack (12 × 2^20, 9 stages) in one; a plane of one tile in one, no
    halo; 16 stages (scan_hi) in 3."""
    assert K.plan_scan_phases(range(14), 1 << 20, 1 << 20) == (
        (0, 10, K.CONTIG, 1023), (10, 4, K.STRIDED, 15))
    assert K.plan_scan_phases(range(9), 12 << 20, 1 << 20) == (
        (0, 9, K.CONTIG, 511),)
    assert K.plan_scan_phases(range(13), 1 << 13, 1 << 13) == (
        (0, 13, K.CONTIG, 0),)
    assert len(K.plan_scan_phases(range(16), 1 << 20, 1 << 20)) == 3
    assert K.plan_scan_phases((), 1 << 20, 1 << 20) == ((0, 0, K.CONTIG, 0),)


def test_plan_of_the_scircuit_programs():
    """The chip smoke's main-path shapes, on the scircuit twin (bench.py's
    line, RCM) at N = 2^20: K3's 7 capped stages, CLOS's 6 fill and 9 scan
    stages, one contiguous phase each."""
    host = rcm_if_beneficial(generate_from_line(bench.SCIRCUIT_LINE)[0])[0]
    G, C = build_clos_gather(host), build_clos(host)
    N = 1 << 20
    assert G.N == C.N == N and G.W > 0
    assert K.plan_scan_phases(G.scan_cap, N, N) == ((0, 7, K.CONTIG, 127),)
    assert K.plan_scan_phases(C.fill_stages, N, N) == (
        (0, 6, K.CONTIG, 63),)
    assert K.plan_scan_phases(C.scan_stages, N, N) == (
        (0, 9, K.CONTIG, 511),)


@pytest.mark.parametrize("stages,n,chunk", [
    ((0, 2, 1), 1 << 14, 1 << 14),       # out of order
    ((0, 1, 1), 1 << 14, 1 << 14),       # repeated
    ((0, 31), 1 << 14, 1 << 14),         # past the last stage
    ((0, 1), 1 << 14, 512),              # chunk below one r3 block
    ((0, 1), 3 << 13, 1 << 14),          # chunk not dividing the plane
])
def test_plan_refuses_bad_stage_lists(stages, n, chunk):
    with pytest.raises(ValueError):
        K.plan_scan_phases(stages, n, chunk)
