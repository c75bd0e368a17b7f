"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and nvcc, and skip without them.
On the GPU machine, which has no JAX for ``tests/conftest.py``, run them
with ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
Tolerances: K1 and K2 (B1, and B2 as ``clos_r2`` and ``clos_invreg``) are
gathers and one product per slot and must match exactly; K3 runs the same
additions in the same order as its plain version and is held to 1e-6 of max |y| (fp32 add-order slack). The SELLW and SELLR
kernels add in their plain versions' order and must match exactly, as must
B4-B7 and B15 (gathers, one product per slot, and scan stages that add in
the plain versions' order), and B12, the SELLW SpMM kernel (the SpMV
kernel's pipeline per column), and B13, the double-single SELLW kernel,
and its combine (every product and sum rounded on its own, in the plain
version's order),
and B8, B9 and B10, the CLOS and BFLY kernels (selects, one product per
slot and adds in the plain versions' order). B16a and B16b, BTILE's SpMM and SDDMM, sum
their products in another order than ``torch.bmm`` (B16a skips stored
zeros): they are held to 1e-5 of |A|·|X| per element and of Σ|a||b| per
slot.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.ops import (build_btile, build_clos_gather,
                                         build_clos_gather_auto,
                                         build_clos_gather_xl, build_dense,
                                         sddmm, spmm, spmv)
from spmv_research_tpu_torch.ops import bfly_cuda as KF
from spmv_research_tpu_torch.ops import btile_cuda as KB
from spmv_research_tpu_torch.ops import clos_gather as cg
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops import sell_cuda as KS
from spmv_research_tpu_torch.ops import bfly, clos, sellr, sellw, sellw_ds
from spmv_research_tpu_torch.ops.compensated import _split_f64

from torch_cases import (TWIN_LINE, banded_matrix, bfly_pathological,
                         btile_banded, btile_special_matrix,
                         capped_scan_matrix, clos_hi_matrix,
                         closm_spilling_matrix,
                         dirty_sellr_matrix, ds_banded, ds_staged_matrix,
                         fill_chunks, random_cand_parts, random_lut_inputs,
                         random_matrix, random_win_inputs, skewed_matrix, skewed_xl_matrix,
                         staged_sellw_matrix, W0_CHUNK_N, w0_chunked_matrix,
                         w0_matrix)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _host(case):
    if case == "twin":
        return rcm_if_beneficial(generate_from_line(TWIN_LINE)[0])[0]
    return HostCSR.from_scipy(capped_scan_matrix())


@pytest.mark.parametrize("kind", ["closg", "closg_chunked"])
def test_cached_closg_program_gives_the_same_y(cuda, kind, tmp_path):
    """A CLOSG program loaded from the format cache gives, on the card, the
    y of the fresh build bit for bit (B1, clos_r2 and K3 are deterministic);
    the chunked one runs K3 once a chunk."""
    from spmv_research_tpu_torch.convert.cache import cached_build_timed
    host = _host("twin")
    kw = {"max_N": 1 << 13} if kind == "closg_chunked" else {}
    A, cold = cached_build_timed(build_clos_gather_auto, host, "closg",
                                 cache_dir=str(tmp_path), **kw)
    B, hit = cached_build_timed(build_clos_gather_auto, host, "closg",
                                cache_dir=str(tmp_path), **kw)
    assert not cold["from_cache"] and hit["from_cache"]
    assert type(B) is type(A) and A.format_name == "CLOSG"
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    K.reset_launch_counts()
    y = spmv(B.to(cuda), xd, impl="cuda")
    assert K.LAUNCHES["closg_front"] >= 1
    assert torch.equal(y, spmv(A.to(cuda), xd, impl="cuda"))


@pytest.mark.parametrize("case", ["twin", "capped_scan"])
def test_kernels_match_plain_versions(cuda, case):
    host = _host(case)
    A = build_clos_gather(host).to(cuda)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)

    v1 = K.closg_front(A.rowidx, A.perm_r1, A.vals_cs, xd)
    assert torch.equal(v1, K.closg_front_torch(A.rowidx, A.perm_r1,
                                               A.vals_cs, xd))
    v2 = K.clos_r2(v1, A.perm_r2, A.V)
    assert torch.equal(v2, K.clos_r2_torch(v1, A.perm_r2, A.V))
    stages = A.scan_cap or A.scan_stages
    args = (v2, A.perm_r3, A.scan_hi, A.ysel_w, A.wstart,
            A.acc_ptr, A.acc_src, stages)
    K.reset_launch_counts()
    y = K.closg_r3_scan_yext(*args)
    y_plain = K.closg_r3_scan_yext_torch(*args)
    torch.cuda.synchronize()
    assert (y - y_plain).abs().max() <= 1e-6 * y_plain.abs().max()
    # K3: the phased scan, one launch a phase, then the extraction; the
    # scanned plane it extracts from equals the plain version's exactly
    assert K.LAUNCHES["closg_r3_scan_yext"] == len(
        K.plan_scan_phases(stages, A.N, A.N)) + 1
    hi_ptr = A.scan_hi.data_ptr() if A.scan_hi.numel() == A.N else None
    scr = K._scan_phases("closg_r3_scan_yext", args[0], A.perm_r3, hi_ptr,
                         stages, A.N)
    assert torch.equal(scr, K.closg_r3_scan_torch(args[0], A.perm_r3,
                                                  A.scan_hi, stages))

    mat = host.to_scipy()
    K.reset_launch_counts()
    got = spmv(A, xd).double().cpu().numpy()          # CUDA tensor: "cuda"
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(got - mat @ x) / scale) <= 1e-5
    # one SpMV: B1, the r2 layer with its transposes, K3's phases and its
    # extraction, nothing else
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "closg_front": 1,
                          "clos_r2": 1, "closg_r3_scan_yext": len(
                              K.plan_scan_phases(stages, A.N, A.N)) + 1}


def test_invreg_any_lane_width(cuda):
    """K2 is generic in the lane width: 1..128 lanes per row."""
    rng = np.random.Generator(np.random.PCG64(3))
    for lanes in (1, 2, 16, 128):
        S = 8192 // lanes
        word = (rng.integers(0, lanes, (S, lanes))
                | rng.integers(0, 8, (S, lanes)) << 7
                | rng.integers(0, lanes, (S, lanes)) << 10).astype(np.int32)
        v = torch.as_tensor(rng.uniform(-1, 1, (S, lanes)),
                            dtype=torch.float32, device=cuda)
        w = torch.as_tensor(word, device=cuda)
        assert torch.equal(K.clos_invreg(v, w), K.clos_invreg_torch(v, w))


def _random_words(rng, S, L):
    return torch.as_tensor(
        (rng.integers(0, L, (S, L)) | rng.integers(0, 8, (S, L)) << 7
         | rng.integers(0, L, (S, L)) << 10
         | rng.integers(0, 1 << 15, (S, L)) << 17
         ).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("n_planes", [1, 2, 12])
@pytest.mark.parametrize("V", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_clos_r2_on_every_v(cuda, V, n_planes):
    """B2's r2 layer with its transposes equals its plain version bit for
    bit at every V, on 1, 2 and 12 stacked planes (CLOSGX's stack), in
    one launch."""
    rng = np.random.Generator(np.random.PCG64(V * 16 + n_planes))
    v = torch.as_tensor(rng.uniform(-1, 1, (n_planes * 8 * V, 128)),
                        dtype=torch.float32, device=cuda)
    w = _random_words(rng, n_planes * 8 * 1024, V // 8).to(cuda)
    K.reset_launch_counts()
    got = K.clos_r2(v, w, V)
    want = K.clos_r2_torch(v, w, V)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "clos_r2": 1}


def _seven_tiles_grid(n_items, n_sms, per_sm):
    """A persistent grid of at most 7 blocks."""
    return min(n_items, 7)


@pytest.mark.parametrize("grid", ["card", "seven"])
@pytest.mark.parametrize("case", ["ragged", "past_4mb", "tail_window",
                                  "unaligned"])
def test_front_on_awkward_x(cuda, case, grid, monkeypatch):
    """B1 equals its plain version bit for bit where x's staging is
    awkward: n % 128 != 0, x past 4 MB, windows that end at x's tail (the
    last, partial x row), x not 16-byte aligned; on the card's persistent
    grid and on 7 blocks; one launch."""
    if grid == "seven":
        monkeypatch.setattr(K, "persistent_grid", _seven_tiles_grid)
    rng = np.random.Generator(np.random.PCG64(17))
    n_x = {"ragged": 5000 + 37, "past_4mb": (1 << 20) + 4099,
           "tail_window": 3 * 128 + 5, "unaligned": 2000 + 3}[case]
    S = 8 * 300
    x_rows = -(-n_x // 128)
    rowidx = rng.integers(0, x_rows, S)
    if case == "tail_window":
        rowidx[::3] = x_rows - 1
    buf = torch.as_tensor(rng.uniform(-1, 1, n_x + 1), dtype=torch.float32,
                          device=cuda)
    x = buf[1:] if case == "unaligned" else buf[:n_x]
    assert (x.data_ptr() % 16 != 0) == (case == "unaligned")
    args = (torch.as_tensor(rowidx, dtype=torch.int32, device=cuda),
            _random_words(rng, S, 128).to(cuda),
            torch.as_tensor(rng.uniform(-1, 1, (S, 128)),
                            dtype=torch.float32, device=cuda), x)
    K.reset_launch_counts()
    got = K.closg_front(*args)
    want = K.closg_front_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "closg_front": 1}
    assert K.front_grid(S // 8, x.device) == (
        7 if grid == "seven" else min(S // 8, K.front_grid(1 << 30,
                                                           x.device)))


@pytest.mark.parametrize("grid", ["card", "seven"])
def test_closg_programs_through_b1_and_b2(cuda, grid, monkeypatch):
    """B1 and the r2 layer on the twin's program and on a CLOSGX stack of
    several V = 8 chunks, on both grids, against their plain versions."""
    if grid == "seven":
        monkeypatch.setattr(K, "persistent_grid", _seven_tiles_grid)
    host = _host("twin")
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    A = build_clos_gather(host).to(cuda)
    X = build_clos_gather_xl(HostCSR.from_scipy(
        random_matrix(4000, 900, 0.008, 5)), chunk_N=8192).to(cuda)
    for front, r2 in (
            ((A.rowidx, A.perm_r1, A.vals_cs, xd), (A.perm_r2, A.V)),
            ((X.rowidx.view(-1), X.r1.view(-1, 128), X.vals.view(-1, 128),
              xd[:900]), (X.r2.view(-1, X.V // 8), X.V))):
        v1 = K.closg_front(*front)
        assert torch.equal(v1, K.closg_front_torch(*front))
        assert torch.equal(K.clos_r2(v1, *r2), K.clos_r2_torch(v1, *r2))
    assert X.n_chunks > 1


def test_wrappers_refuse_bad_input(cuda):
    v = torch.zeros((8, 128), device=cuda)
    with pytest.raises(TypeError):
        K.clos_invreg(v, torch.zeros((8, 128), device=cuda))   # float words
    with pytest.raises(ValueError, match="several devices"):
        K.clos_invreg(v, torch.zeros((8, 128), dtype=torch.int32))
    K.reset_launch_counts()
    K.clos_invreg(torch.zeros((8, 128), device=cuda),
                  torch.zeros((8, 128), dtype=torch.int32, device=cuda))
    assert K.LAUNCHES["clos_invreg"] == 1
    v = torch.zeros((64, 128), device=cuda)           # one plane at V = 8
    w = torch.zeros((8192, 1), dtype=torch.int32, device=cuda)
    K.clos_r2(v, w, 8)
    with pytest.raises(ValueError, match="power-of-two V"):
        K.clos_r2(v, w.view(-1, 2), 16)               # half a plane
    with pytest.raises(ValueError, match="power-of-two V"):
        K.clos_r2(v, w.view(-1, 2), 12)
    with pytest.raises(ValueError, match="shape"):
        K.clos_r2(v, w[:4096], 8)
    with pytest.raises(TypeError):
        K.clos_r2(v, w.float(), 8)
    # the layer kernels and B1 move their planes 16 bytes at a time (the
    # r2 layer's values by TMA): a plane that starts off 16 bytes is refused
    off = torch.zeros(64 * 128 + 1, device=cuda)[1:].view(64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.clos_r2(off, w, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.clos_invreg(off, w.view(64, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.closg_front(torch.zeros(64, dtype=torch.int32, device=cuda),
                      w.view(64, 128), off, torch.ones(300, device=cuda))
    assert K.LAUNCHES["clos_r2"] == 1 and K.LAUNCHES["closg_front"] == 0
    mat = sp.identity(100, format="csr")
    A = build_clos_gather(HostCSR.from_scipy(mat)).to(cuda)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A.to("cpu"), torch.ones(100), impl="cuda")


def _x(n, cuda):
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0, n)
    return x, torch.as_tensor(x, dtype=torch.float32, device=cuda)


def _close_to_scipy(mat, x, y):
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    got = y.double().cpu().numpy()
    assert np.max(np.abs(got - mat @ x) / scale) <= 1e-5


@pytest.mark.parametrize("kind", ["g1", "g2", "g4", "stream"])
def test_sellw_kernel_matches_plain_version(cuda, kind, monkeypatch):
    if kind == "stream":    # the streamed-wins program kind, at a small n
        monkeypatch.setattr(sellw, "_X_VMEM_LIMIT", 512)
        mat, G = banded_matrix(400, 1030, 60, 8, 3), 2
    else:
        mat, G = banded_matrix(1200, 1200, 160, 14, 2), int(kind[1])
    A = sellw.build_sellw(HostCSR.from_scipy(mat), group=G).to(cuda)
    assert A.stream_wins == (kind == "stream") and A.G == G
    x, xd = _x(mat.shape[1], cuda)
    args = (A.word, A.vals, A.wrow, xd, sellw.class_plan(A), G)
    KS.reset_launch_counts()
    got = KS.sellw_planes(*args, stream_wins=A.stream_wins)
    want = KS.sellw_planes_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    key = "sellw_stream" if A.stream_wins else "sellw"
    n_launched = sum(1 for _, cnt, _ in sellw.class_plan(A) if cnt)
    assert KS.LAUNCHES[key] == n_launched >= 1
    assert sum(KS.LAUNCHES.values()) == n_launched
    _close_to_scipy(mat, x, spmv(A, xd))               # CUDA tensor: "cuda"


def _seven_blocks(n_chunks, n_sms, per_sm):
    """A persistent grid of at most 7 blocks (no stage class of the test
    programs is a multiple of 7 chunks)."""
    return min(n_chunks, 7)


@functools.lru_cache(maxsize=None)
def _staged_sellw(G, stream):
    """``ds_staged_matrix``'s SELLW program at group G (a stage class at
    every scan depth 0..7; at G = 1 the depth-0 class holds 1280 chunks,
    more than the card's persistent grid), x resident or ``stream_wins``."""
    limit = sellw._X_VMEM_LIMIT
    sellw._X_VMEM_LIMIT = 512 if stream else limit
    try:
        return sellw.build_sellw(HostCSR.from_scipy(_ds_staged()), group=G,
                                 part_cap=128)
    finally:
        sellw._X_VMEM_LIMIT = limit


@functools.lru_cache(maxsize=None)
def _ds_staged():
    return ds_staged_matrix()


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_sellw_kernel_at_every_scan_depth(cuda, G, stream, monkeypatch):
    """B11 on a program with a stage class at every scan depth 0..7, both
    program kinds: the planes equal the plain version's bit for bit on the
    card's persistent grid and on a grid of 7 blocks, one launch per class,
    counted under the program kind."""
    A = _staged_sellw(G, stream).to(cuda)
    plan = sellw.class_plan(A)
    assert [st for _, _, st in plan] == list(range(8))
    assert A.stream_wins == stream and A.G == G
    x, xd = _x(A.n, cuda)
    args = (A.word, A.vals, A.wrow, xd, plan, G)
    want = KS.sellw_planes_torch(*args)
    key = "sellw_stream" if stream else "sellw"
    for grid in ("card", "seven"):
        if grid == "seven":
            monkeypatch.setattr(KS, "persistent_grid", _seven_blocks)
        KS.reset_launch_counts()
        got = KS.sellw_planes(*args, stream_wins=stream)
        torch.cuda.synchronize()
        assert torch.equal(got, want), grid
        assert {k: v for k, v in KS.LAUNCHES.items() if v} == {key: 8}
    _close_to_scipy(_ds_staged(), x, spmv(A, xd))


@pytest.mark.parametrize("kind", ["multi_step", "dirty"])
def test_sellr_kernels_match_plain_version(cuda, kind, monkeypatch):
    """B14 on a program of two steps with different scan depths (smeta's
    smax 5 and 6) and on one with dirty chunks and wrap rolls: place and
    flush equal their plain versions bit for bit on the card's persistent
    grid and on a grid of 7 blocks; one launch each."""
    if kind == "dirty":
        mat, factor = dirty_sellr_matrix(), 12.0
    else:
        mat, factor = banded_matrix(2000, 2000, 400, 80, 0), 4.0
    A = sellr.build_sellr(HostCSR.from_scipy(mat),
                          max_slot_factor=factor).to(cuda)
    smax = A.smeta.view(-1, sellr.SMEM_BLK)[:, sellr.NB * 9 + 1].tolist()
    assert kind == "dirty" or len(set(smax)) > 1
    x, xd = _x(mat.shape[1], cuda)
    args = (A.word, A.vals, A.smeta, A.gptr, A.gchunk, xd, A.nchunks,
            A.stages, A.rolls)
    place = (A.word, A.vals, A.smeta, xd, A.nchunks, A.stages, A.rolls)
    R_plain = KS.sellr_place_torch(*place)
    want = KS.sellr_flush_torch(R_plain, A.gptr, A.gchunk)
    for grid in ("card", "seven"):
        if grid == "seven":
            monkeypatch.setattr(KS, "persistent_grid", _seven_blocks)
        KS.reset_launch_counts()
        R = KS.sellr_place(*place)
        got = KS.sellr_flush(R_plain, A.gptr, A.gchunk)
        torch.cuda.synchronize()
        assert torch.equal(R, R_plain) and torch.equal(got, want), grid
        assert KS.LAUNCHES == {"sellw": 0, "sellw_stream": 0,
                               "sellw_spmm": 0, "sellr_place": 1,
                               "sellr_flush": 1, "sellwds": 0,
                               "sellwds_combine": 0}
    assert torch.equal(KS.sellr_y(*args), KS.sellr_y_torch(*args))
    _close_to_scipy(mat, x, spmv(A, xd))


def test_sellr_flush_on_ragged_groups(cuda):
    """B14's flush on groups of 1 chunk, none, 8 and 9 (one batch of
    loads in flight, and one more), 100 (past shipsec1's most, 64), with
    flush marks anywhere (a group's last chunk unflushed too) and values
    over many magnitudes: y equals the plain version bit for bit, one
    launch."""
    rng = np.random.default_rng(5)
    counts = [1, 0, 8, 9, 100, 3, 17]
    n = sum(counts)
    R = (rng.uniform(-1, 1, (n * 8, 128))
         * rng.lognormal(0, 4, (n * 8, 128))).astype(np.float32)
    gchunk = (rng.permutation(n) << 1) | (rng.random(n) < 0.3)
    gptr = np.concatenate([[0], np.cumsum(counts)])
    R, gptr, gchunk = (torch.as_tensor(a, device=cuda) for a in (
        R, gptr.astype(np.int32), gchunk.astype(np.int32)))
    KS.reset_launch_counts()
    got = KS.sellr_flush(R, gptr, gchunk)
    torch.cuda.synchronize()
    assert torch.equal(got, KS.sellr_flush_torch(R, gptr, gchunk))
    assert {k: v for k, v in KS.LAUNCHES.items() if v} == {"sellr_flush": 1}
    assert not got[8:16].any()                      # the empty group


def test_sell_wrappers_refuse_bad_input(cuda):
    A = sellw.build_sellw(HostCSR.from_scipy(
        banded_matrix(300, 300, 40, 6, 1))).to(cuda)
    xd = torch.zeros(300, device=cuda)
    plan = sellw.class_plan(A)
    with pytest.raises(ValueError, match="several devices"):
        KS.sellw_planes(A.word, A.vals, A.wrow, xd.cpu(), plan, A.G)
    with pytest.raises(TypeError):
        KS.sellw_planes(A.word.float(), A.vals, A.wrow, xd, plan, A.G)
    with pytest.raises(ValueError, match="contiguous"):
        KS.sellw_planes(A.word, A.vals, A.wrow, xd, ((64, 1, 3),), A.G)
    R = sellr.build_sellr(HostCSR.from_scipy(
        banded_matrix(300, 300, 40, 6, 1))).to(cuda)
    with pytest.raises(ValueError, match="several devices"):
        KS.sellr_y(R.word, R.vals, R.smeta, R.gptr.cpu(), R.gchunk, xd,
                   R.nchunks, R.stages, R.rolls)
    n = R.gchunk.numel()
    skew = torch.zeros(n * 1024 + 1, device=cuda)[1:].view(n * 8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        KS.sellr_flush(skew, R.gptr, R.gchunk)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(R.to("cpu"), torch.ones(300), impl="cuda")


def _r3_input(A, xd):
    v = K.closg_front(A.rowidx, A.perm_r1, A.vals_cs, xd)
    return K.clos_r2(v, A.perm_r2, A.V)


@pytest.mark.parametrize("case", ["w0", "scan_hi"])
def test_w0_back_end_kernels_match_plain_versions(cuda, case):
    """B5 (r3 layer + full scan; stage 15 reads scan_hi in the second case)
    and B6 (candidate-plane extraction)."""
    mat = (w0_matrix(130, 520) if case == "w0"
           else w0_matrix(130, 600, heavy=33000))
    A = build_clos_gather(HostCSR.from_scipy(mat)).to(cuda)
    assert A.W == 0 and (len(A.scan_stages) > 15) == (case == "scan_hi")
    x, xd = _x(mat.shape[1], cuda)
    v = _r3_input(A, xd)
    K.reset_launch_counts()
    scr = K.closg_r3_scan(v, A.perm_r3, A.scan_hi, A.scan_stages)
    y = K.closg_cand_yext(scr, A.ycand, A.ysel)
    torch.cuda.synchronize()
    assert torch.equal(scr, K.closg_r3_scan_torch(v, A.perm_r3, A.scan_hi,
                                                  A.scan_stages))
    assert torch.equal(y, K.closg_cand_yext_torch(scr, A.ycand, A.ysel))
    assert K.LAUNCHES["closg_r3_scan"] == len(
        K.plan_scan_phases(A.scan_stages, A.N, A.N))
    assert K.LAUNCHES["closg_cand_yext"] == 1
    _close_to_scipy(mat, x, spmv(A, xd))


@pytest.mark.parametrize("case", ["lut", "fused", "fused_compacted"])
def test_opt_in_front_ends_match_plain_versions(cuda, case):
    """B4 (value LUT) and B7 (fused windows, with and without compaction)."""
    if case == "lut":
        mat, opts = random_matrix(400, 400, 0.02, 7, levels=64), \
            dict(value_lut=True)
    else:
        mat = random_matrix(600, 4000 if case == "fused_compacted" else 700,
                            0.02, 11).tocoo()
        if case == "fused_compacted":      # every third x block non-empty
            keep = (mat.col // 128) % 3 == 0
            mat = type(mat)((mat.data[keep], (mat.row[keep], mat.col[keep])),
                            shape=mat.shape)
        mat, opts = mat.tocsr(), dict(fuse_windows=True)
    A = build_clos_gather(HostCSR.from_scipy(mat), **opts).to(cuda)
    x, xd = _x(mat.shape[1], cuda)
    K.reset_launch_counts()
    if case == "lut":
        assert A.use_vlut
        args = (A.rowidx, A.perm_r1, A.vals_cs, xd)
        got, want = K.closg_front_lut(*args), K.closg_front_lut_torch(*args)
        key = "closg_front_lut"
    else:
        assert A.fused_win and A.dense_blocks == (case == "fused")
        args = (A.gbase, A.nbids, A.perm_r1, A.vals_cs, xd, A.dense_blocks)
        got, want = K.closg_front_win(*args), K.closg_front_win_torch(*args)
        key = "closg_front_win"
    torch.cuda.synchronize()
    assert torch.equal(got, want) and K.LAUNCHES[key] == 1
    _close_to_scipy(mat, x, spmv(A, xd))


@pytest.mark.parametrize("grid", ["card", "seven"])
@pytest.mark.parametrize("case", ["ragged", "tail_window", "unaligned"])
def test_front_lut_on_awkward_x(cuda, case, grid, monkeypatch):
    """B4 (B1's persistent tile body in LUT mode) equals its plain version
    bit for bit with n % 128 != 0, windows at x's tail (the last, partial
    x row), x not 16-byte aligned and word bit 31 set at random; on the
    card's persistent grid and on 7 blocks; one launch."""
    if grid == "seven":
        monkeypatch.setattr(K, "persistent_grid", _seven_tiles_grid)
    rng = np.random.Generator(np.random.PCG64(29))
    n_x = {"ragged": 20000 + 37, "tail_window": 3 * 128 + 5,
           "unaligned": 5000 + 3}[case]
    n_tiles = 900
    rowidx, perm_r1, dict_plane, x = random_lut_inputs(rng, n_tiles, n_x)
    buf = torch.as_tensor(np.concatenate([[0.5], x]).astype(np.float32),
                          device=cuda)
    xd = buf[1:] if case == "unaligned" else buf[1:].clone()
    assert (xd.data_ptr() % 16 != 0) == (case == "unaligned")
    args = (torch.as_tensor(rowidx, device=cuda),
            torch.as_tensor(perm_r1, device=cuda),
            torch.as_tensor(dict_plane, device=cuda), xd)
    K.reset_launch_counts()
    got = K.closg_front_lut(*args)
    want = K.closg_front_lut_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          "closg_front_lut": 1}
    assert K.front_grid(n_tiles, cuda, K.FRONT_LUT) == (
        7 if grid == "seven" else min(n_tiles, K.front_grid(
            1 << 30, cuda, K.FRONT_LUT)))


@pytest.mark.parametrize("n_chunks", [1, 3, 10, 70])
def test_b6_one_launch_over_chunks(cuda, n_chunks):
    """B6 over 1, 3, 10 and 70 programs (past the by-value cap of 32:
    3 launches) with ragged rows, rows under 128 and empty programs, each
    program's y written in place: equal to its plain version bit for bit,
    one launch per 32 programs."""
    rng = np.random.Generator(np.random.PCG64(n_chunks))
    ms = rng.integers(1, 3000, n_chunks)
    ms[::3] = rng.integers(1, 128, ms[::3].size)
    if n_chunks > 3:
        ms[5] = 0
    ms = [int(m) for m in ms]
    parts = [tuple(t.to(cuda) for t in p)
             for p in random_cand_parts(rng, ms)]
    row_split = np.concatenate([[0], np.cumsum(ms)]).tolist()
    K.reset_launch_counts()
    got = K.closg_cand_yext_chunked(parts, row_split)
    want = K.closg_cand_yext_chunked_torch(parts, row_split)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          "closg_cand_yext": -(-n_chunks // 32)}


def test_w0_chunked_spmv_one_b6_launch(cuda):
    """An all-W = 0 ClosGChunked SpMV on the card: B1, ``clos_r2`` and B5
    per chunk, then one B6 launch over every chunk; y equals the torch
    impl's (per-chunk extraction and concatenation) bit for bit."""
    mat = w0_chunked_matrix()
    A = build_clos_gather_auto(HostCSR.from_scipy(mat),
                               max_N=W0_CHUNK_N).to(cuda)
    assert isinstance(A, cg.ClosGChunked) and len(A.chunks) == 3
    x, xd = _x(mat.shape[1], cuda)
    K.reset_launch_counts()
    y = spmv(A, xd)
    torch.cuda.synchronize()
    phases = sum(len(K.plan_scan_phases(c.scan_stages, c.N, c.N))
                 for c in A.chunks)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "closg_front": 3,
                          "clos_r2": 3, "closg_r3_scan": phases,
                          "closg_cand_yext": 1}
    assert torch.equal(y, spmv(A, xd, impl="torch"))
    _close_to_scipy(mat, x, y)


def test_b6_refuses_bad_input(cuda):
    rng = np.random.Generator(np.random.PCG64(4))
    parts = [tuple(t.to(cuda) for t in p)
             for p in random_cand_parts(rng, [300, 200])]
    with pytest.raises(ValueError, match="row boundaries"):
        K.closg_cand_yext_chunked(parts, [0, 300])
    with pytest.raises(ValueError, match="past its y plane"):
        K.closg_cand_yext_chunked(parts, [0, 300, 757])
    scr, ycand, ysel = parts[0]
    off = torch.zeros(ysel.numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view(ysel.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.closg_cand_yext(scr, ycand, off)
    with pytest.raises(ValueError, match="whole number"):
        K.closg_cand_yext(scr, ycand[:-1], ysel)


@pytest.mark.parametrize("grid", ["card", "seven"])
@pytest.mark.parametrize("case", ["dense", "compacted", "unaligned",
                                  "tail_window"])
def test_front_win_on_awkward_x(cuda, case, grid, monkeypatch):
    """B7 equals its plain version bit for bit on dense and compacted x
    planes with rows past the plane, n % 128 != 0, x not 16-byte aligned
    and windows at x's tail (the last, partial x row); on the card's
    persistent grid and on 7 blocks; one launch."""
    if grid == "seven":
        monkeypatch.setattr(K, "persistent_grid", _seven_tiles_grid)
    rng = np.random.Generator(np.random.PCG64(23))
    n_x = {"dense": 20000 + 37, "compacted": 20000 + 37,
           "unaligned": 5000 + 3, "tail_window": 3 * 128 + 5}[case]
    n_tiles = 900
    gbase, nbids, perm_r1, vals, x = random_win_inputs(
        rng, n_tiles, n_x, case != "compacted")
    if case == "tail_window":
        gbase[::3] = nbids.size - 1
    buf = torch.as_tensor(np.concatenate([[0.5], x]).astype(np.float32),
                          device=cuda)
    xd = buf[1:] if case == "unaligned" else buf[1:].clone()
    assert (xd.data_ptr() % 16 != 0) == (case == "unaligned")
    dense = case != "compacted"
    args = (torch.as_tensor(gbase, device=cuda),
            torch.as_tensor(nbids, device=cuda),
            torch.as_tensor(perm_r1, device=cuda),
            torch.as_tensor(vals, device=cuda).view(-1, 128), xd, dense)
    K.reset_launch_counts()
    got = K.closg_front_win(*args)
    want = K.closg_front_win_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          "closg_front_win": 1}
    assert K.front_grid(n_tiles, cuda, K.FRONT_WIN) == (
        7 if grid == "seven" else min(n_tiles, K.front_grid(
            1 << 30, cuda, K.FRONT_WIN)))


def test_closgx_kernels_match_plain_versions(cuda):
    """K1 and K2 on the stacked planes and B15 over all chunks at once."""
    from spmv_research_tpu_torch.ops.clos_route import LANES
    mat = random_matrix(4000, 900, 0.008, 5)
    A = build_clos_gather_xl(HostCSR.from_scipy(mat),
                             chunk_N=8192).to(cuda)
    x, xd = _x(mat.shape[1], cuda)
    V = A.V
    front = (A.rowidx.view(-1), A.r1.view(-1, LANES), A.vals.view(-1, LANES),
             xd)
    v1 = K.closg_front(*front)
    assert torch.equal(v1, K.closg_front_torch(*front))
    mid = (v1, A.r2.view(-1, V // 8), V)
    v2 = K.clos_r2(*mid)
    assert torch.equal(v2, K.clos_r2_torch(*mid))
    back = (v2, A.r3.view(-1, LANES), A.ysel_w.view(-1, LANES),
            A.wstart_abs.view(-1), A.stages, A.N)
    K.reset_launch_counts()
    y = K.closgx_r3_scan_yext(*back)
    torch.cuda.synchronize()
    assert torch.equal(y, K.closgx_r3_scan_yext_torch(*back))
    assert K.LAUNCHES["closgx_r3_scan_yext"] == len(K.plan_scan_phases(
        range(A.stages), A.n_chunks * A.N, A.N)) + 1
    _close_to_scipy(mat, x, spmv(A, xd))
    # B15 with no scan stage: the r3 layer, then the extraction
    back0 = back[:4] + (0, A.N)
    K.reset_launch_counts()
    y0 = K.closgx_r3_scan_yext(*back0)
    torch.cuda.synchronize()
    assert torch.equal(y0, K.closgx_r3_scan_yext_torch(*back0))
    assert K.LAUNCHES["closgx_r3_scan_yext"] == 2


def _random_scan_planes(n, seed, cuda):
    """Random values, r3 words (any guard bit set, wrapping or not) and
    scan_hi words of n slots on the card."""
    rng = np.random.Generator(np.random.PCG64(seed))
    w3 = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    hi = rng.integers(0, 2 ** 16, n).astype(np.int32)
    v = rng.uniform(-1, 1, n).astype(np.float32)
    return (torch.as_tensor(v, device=cuda).view(-1, 128),
            torch.as_tensor(w3, device=cuda).view(-1, 128),
            torch.as_tensor(hi, device=cuda))


@pytest.mark.parametrize("L,n_stages,halo_max", [
    (13, 13, 1024),      # the plane one tile: one phase, no halo
    (12, 12, 1024),      # a plane smaller than a tile
    (17, 17, 1024),      # contiguous, then strided over all rows
    (20, 20, 1024),      # strided with a 31-row halo, then scan_hi stages
    (17, 17, 64),        # a small budget: strided phases of 1-row halos
    (16, 17, 16),        # a budget below one row: global phases
    (15, 0, 1024),       # the r3 layer alone
])
def test_b5_phases_on_random_planes(cuda, monkeypatch, L, n_stages,
                                    halo_max):
    """B5 in the phases of ``plan_scan_phases`` at the halo budget given
    (monkeypatched) equals its plain version bit for bit, one launch a
    phase; stages >= 15 read scan_hi."""
    monkeypatch.setattr(K, "SCAN_HALO_MAX", halo_max)
    v, w3, hi = _random_scan_planes(1 << L, L + n_stages, cuda)
    stages = tuple(range(n_stages))
    K.reset_launch_counts()
    got = K.closg_r3_scan(v, w3, hi, stages)
    torch.cuda.synchronize()
    assert torch.equal(got, K.closg_r3_scan_torch(v, w3, hi, stages))
    assert K.LAUNCHES["closg_r3_scan"] == len(K.plan_scan_phases(
        stages, 1 << L, 1 << L, halo_max=halo_max))


@pytest.mark.parametrize("chunk,n_chunks,stages,halo_max", [
    (1 << 10, 6, 12, 1024),   # chunks smaller than a tile, shifts >= chunk
    (1 << 12, 5, 12, 1024),
    (1 << 15, 3, 14, 1024),   # tiles whose halo wraps inside each chunk
    (1 << 17, 2, 14, 128),    # strided with a 3-row halo in each chunk
    (1 << 14, 2, 0, 1024),    # no stage
])
def test_b15_phases_on_random_stacks(cuda, monkeypatch, chunk, n_chunks,
                                     stages, halo_max):
    """B15 over random stacks, its extraction reading every slot in place
    (y = the scanned plane), equals its plain version bit for bit."""
    monkeypatch.setattr(K, "SCAN_HALO_MAX", halo_max)
    n = chunk * n_chunks
    v, r3, _ = _random_scan_planes(n, chunk + stages, cuda)
    rows = n // 128
    ysel_w = torch.arange(128, dtype=torch.int32,
                          device=cuda).repeat(rows, 1)
    wstart = torch.arange(rows, dtype=torch.int32, device=cuda)
    args = (v, r3, ysel_w, wstart, stages, chunk)
    K.reset_launch_counts()
    y = K.closgx_r3_scan_yext(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, K.closgx_r3_scan_yext_torch(*args))
    assert K.LAUNCHES["closgx_r3_scan_yext"] == len(K.plan_scan_phases(
        range(stages), n, chunk, halo_max=halo_max)) + 1


def test_phased_scan_refuses_bad_stages(cuda):
    """A stage list out of order, and stages >= 15 without the scan_hi
    plane, raise before any launch."""
    v, w3, hi = _random_scan_planes(1 << 16, 1, cuda)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="increasing"):
        K.closg_r3_scan(v, w3, hi, (0, 2, 1))
    with pytest.raises(ValueError, match="scan_hi"):
        K.closg_r3_scan(v, w3, hi[:8].contiguous(), tuple(range(16)))
    with pytest.raises(ValueError, match="spare bits"):
        K.closgx_r3_scan_yext(v, w3, torch.zeros((0, 128), dtype=torch.int32,
                                                 device=cuda),
                              torch.zeros(0, dtype=torch.int32, device=cuda),
                              16, 1 << 16)
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("mode", ["select", "vals"])
@pytest.mark.parametrize("chunk,n_chunks,n_stages,halo_max", [
    (1 << 13, 1, 13, 1024),   # one tile: one phase, no halo
    (1 << 20, 1, 20, 1024),   # contiguous, strided, then hi stages
    (1 << 17, 1, 17, 64),     # strided phases of 1-row halos
    (1 << 16, 1, 17, 16),     # global phases
    (1 << 10, 6, 12, 1024),   # chunks smaller than a tile, k >= chunk
    (1 << 15, 3, 16, 1024),   # tiles whose halo wraps inside each chunk
])
def test_phased_fill_and_vals_on_random_planes(cuda, monkeypatch, mode,
                                               chunk, n_chunks, n_stages,
                                               halo_max):
    """The phased scan in select mode (B8's fill) and with vals (B8's scan)
    over random planes, at several chunk sizes and halo budgets
    (monkeypatched), equals the plain stages bit for bit, one launch a
    phase; on one chunk through the wrappers ``clos_r3_fill`` and
    ``clos_r3_scan``."""
    monkeypatch.setattr(K, "SCAN_HALO_MAX", halo_max)
    n = chunk * n_chunks
    v, w3, hi = _random_scan_planes(n, chunk + n_stages, cuda)
    vals = _random_scan_planes(n, n_stages, cuda)[0]
    stages = tuple(range(n_stages))
    key = "clos_r3_fill" if mode == "select" else "clos_r3_scan"
    K.reset_launch_counts()
    if n_chunks == 1 and mode == "select":
        got = K.clos_r3_fill(v, w3, hi, stages)
        want = K.clos_r3_fill_torch(v, w3, hi, stages)
    elif n_chunks == 1:
        got = K.clos_r3_scan(v, w3, vals, hi, stages)
        want = K.clos_r3_scan_torch(v, w3, vals, hi, stages)
    else:
        got = K._scan_phases(key, v, w3, hi.data_ptr(), stages, chunk,
                             vals=None if mode == "select" else vals,
                             select=mode == "select")
        u = K.clos_invreg_torch(v, w3)
        want = (fill_chunks(u, w3, hi, stages, chunk) if mode == "select"
                else K._scan_torch((u * vals).reshape(-1), w3.reshape(-1),
                                   hi, stages, chunk).view(-1, 128))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert K.LAUNCHES[key] == len(K.plan_scan_phases(
        stages, n, chunk, halo_max=halo_max))


def test_phased_fill_and_scan_refuse_bad_calls(cuda):
    """Select with vals, and a stage >= 15 with no hi plane (a null pointer
    to the C entry, or a dummy plane to the wrappers), raise before any
    launch."""
    v, w3, hi = _random_scan_planes(1 << 16, 2, cuda)
    stages = tuple(range(16))
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="closg_scan_phases"):
        K._scan_phases("clos_r3_scan", v, w3, None, range(4), 1 << 16,
                       vals=v, select=True)
    with pytest.raises(RuntimeError, match="closg_scan_phases"):
        K._scan_phases("clos_r3_fill", v, w3, None, stages, 1 << 16,
                       select=True)
    dummy = hi[:8].contiguous()
    with pytest.raises(ValueError, match="fill_hi"):
        K.clos_r3_fill(v, w3, dummy, stages)
    with pytest.raises(ValueError, match="scan_hi"):
        K.clos_r3_scan(v, w3, v, dummy, stages)
    torch.cuda.synchronize()
    assert not any(K.LAUNCHES.values())


def test_rowsplit_and_dense_on_the_card(cuda, monkeypatch):
    """RSPLIT over one CLOSG program and over CLOSGX (the split threshold
    lowered), and DENSE's torch.matmul, each within 1e-5 of |A|·|x|."""
    from spmv_research_tpu_torch.ops import ClosG, ClosGX
    monkeypatch.setattr(cg, "SPLIT_ROW_NNZ", 512)
    for mat, kw, inner in ((skewed_matrix(), {}, ClosG),
                           (skewed_xl_matrix(),
                            dict(max_N=8192, max_chunks=1), ClosGX)):
        A = build_clos_gather_auto(HostCSR.from_scipy(mat), **kw)
        assert A.format_name == "RSPLIT" and isinstance(A.inner, inner)
        x, xd = _x(mat.shape[1], cuda)
        _close_to_scipy(mat, x, spmv(A.to(cuda), xd))
        _close_to_scipy(mat, x, spmv(build_dense(HostCSR.from_scipy(mat))
                                     .to(cuda), xd))


@pytest.mark.parametrize("k", [1, 5, 7, 10, 128])
@pytest.mark.parametrize("kind", ["g1", "g2", "g4", "g8", "stream",
                                  "classes"])
def test_sellw_spmm_kernel_matches_plain_version(cuda, kind, k,
                                                 monkeypatch):
    """B12 over K = 1, 5, 7, 10 and 128 columns (last 4-column passes of 1,
    1, 3, 2 and 4 columns), G = 1, 2, 4, 8, a stream_wins program and a program of
    two stage classes (6 and 7 stages): the planes equal the plain
    version's bit for bit."""
    if kind == "stream":
        monkeypatch.setattr(sellw, "_X_VMEM_LIMIT", 512)
        mat, G, cap = banded_matrix(400, 1030, 60, 8, 3), 2, 8
    elif kind == "classes":
        mat, G, cap = staged_sellw_matrix(), 2, 128
    else:
        mat, G, cap = banded_matrix(1200, 1200, 160, 14, 2), int(kind[1]), 8
    A = sellw.build_sellw(HostCSR.from_scipy(mat), group=G,
                          part_cap=cap).to(cuda)
    plan = sellw.class_plan(A)
    assert A.stream_wins == (kind == "stream") and A.G == G
    assert (len(plan) > 1) == (kind == "classes")
    X = np.random.Generator(np.random.PCG64(8)).uniform(
        -1.0, 1.0, (mat.shape[1], k))
    Xd = torch.as_tensor(X, dtype=torch.float32, device=cuda)
    args = (A.word, A.vals, A.wrow, Xd.t().contiguous(), plan, G)
    KS.reset_launch_counts()
    got = KS.sellw_spmm_planes(*args)
    want = KS.sellw_spmm_planes_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n_launched = sum(1 for _, cnt, _ in plan if cnt)
    assert KS.LAUNCHES["sellw_spmm"] == n_launched >= 1
    Y = spmm(A, Xd).double().cpu().numpy()            # CUDA tensor: "cuda"
    scale = np.abs(mat) @ np.abs(X) + 1e-30
    assert np.max(np.abs(Y - mat @ X) / scale) <= 1e-5


def _btile_case(cuda, k, special=False):
    mat = btile_special_matrix() if special else btile_banded(
        2500, 2500, 12, 200, 1)
    A = build_btile(HostCSR.from_scipy(mat)).to(cuda)
    rng = np.random.Generator(np.random.PCG64(k))
    m, n = mat.shape
    return mat, A, *(torch.as_tensor(rng.uniform(-1, 1, s),
                                     dtype=torch.float32, device=cuda)
                     for s in ((n, k), (m, k), (n, k)))


@pytest.mark.parametrize("cut", ["whole", "halves", "steps"])
@pytest.mark.parametrize("k", [1, 16, 31, 32, 33, 37, 128, 200, 256])
def test_btile_kernels_match_plain_versions(cuda, k, cut, monkeypatch):
    """B16a (SpMM; X padded to a multiple of 32 columns) and B16b (SDDMM;
    K = 33 and up take more than one register per lane; K % 4 != 0 takes
    4-byte copies and a zero-padded float4 tail; K = 256 is its limit; the
    same bits on a second call) on three bands: a full tile, a live tile
    of stored zeros and an empty band (the builder's filler step); the
    bands whole (one chunk each), band 0 cut in two beside two whole bands
    (the combine skips those), or cut at every step."""
    slices = -(-k // KB.SPMM_SLICE)
    if cut == "whole":
        monkeypatch.setattr(KB, "SPMM_WAVES", 0)
    elif cut == "halves":
        monkeypatch.setattr(KB, "sm_count", lambda _: 1)
        monkeypatch.setattr(KB, "SPMM_WAVES", 6 * slices)
    mat, A, X, Am, Bm = _btile_case(cuda, k, special=True)
    plan = KB.spmm_plan(A.ngroups, A.max_band_steps, k,
                        KB.sm_count(X.device))
    steps = (A.band_ptr[1:] - A.band_ptr[:-1]).tolist()
    assert steps[1] == 1 and A.step_nt[int(A.band_ptr[1])] == 0
    assert plan.slices == slices and plan.kp == 32 * slices
    assert plan.nchunk == {"whole": 1, "halves": 2,
                           "steps": A.max_band_steps}[cut]
    KB.reset_launch_counts()
    Y = spmm(A, X)                                     # CUDA tensor: "cuda"
    Y_plain = spmm(A, X, impl="torch")
    yard = spmm(A.to("cpu"), X.abs().cpu()).abs().to(cuda)   # |A|·|X|
    C = sddmm(A, Am, Bm)
    C2 = sddmm(A, Am, Bm)
    C_plain = sddmm(A, Am, Bm, impl="torch")
    dots = sddmm(A, Am.abs(), Bm.abs(), impl="torch")  # Σ|a||b| per slot
    torch.cuda.synchronize()
    assert KB.LAUNCHES == {"btile_spmm": 1,
                           "btile_combine": int(plan.nchunk > 1),
                           "btile_sddmm": 2}
    assert Y.shape == (mat.shape[0], k)
    assert ((Y - Y_plain).abs() <= 1e-5 * yard).all()
    assert ((C - C_plain).abs() <= 1e-5 * dots).all()
    assert torch.equal(C, C2)
    assert not C[A.patt == 0].any()
    assert not Y[1024:2048].any()
    Xh = X.double().cpu().numpy()
    scale = np.abs(mat) @ np.abs(Xh) + 1e-30
    got = Y.double().cpu().numpy()
    assert np.max(np.abs(got - mat @ Xh) / scale) <= 1e-5


def test_btile_wrappers_refuse_bad_input(cuda):
    _, A, X, Am, Bm = _btile_case(cuda, 4)
    with pytest.raises(ValueError, match="CUDA"):
        spmm(A, X.cpu(), impl="cuda")
    big = torch.zeros((Am.shape[0], 300), device=cuda)
    with pytest.raises(ValueError, match="K ≤ 256"):
        sddmm(A, big, torch.zeros((Bm.shape[0], 300), device=cuda))
    with pytest.raises(ValueError, match="several devices"):
        KB.btile_spmm(A.tiles, A.tgt.cpu(), A.step_g, A.step_cb, A.step_nt,
                      A.band_ptr, X, A.ngroups, A.max_band_steps)
    args = (A.tiles, A.tgt, A.step_g, A.step_cb, A.step_nt, A.band_ptr)
    with pytest.raises(ValueError, match="ncb·128"):
        KB.btile_spmm(*args, X[:100], A.ngroups, A.max_band_steps)
    with pytest.raises(ValueError, match="band_ptr"):
        KB.btile_spmm(*args[:5], A.band_ptr[:-1], X, A.ngroups,
                      A.max_band_steps)
    # an X that is not 16-byte aligned is copied, not refused
    xp = torch.nn.functional.pad(X, (0, 0, 0, A.ncb * 128 - X.shape[0]))
    wide = torch.zeros((xp.shape[0], 5), device=cuda)
    wide[:, 1:] = xp
    odd = wide[:, 1:]
    assert odd.data_ptr() % 16 and not odd.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        KB.btile_spmm(*args, odd, A.ngroups, A.max_band_steps)
    flat = torch.zeros(xp.numel() + 1, device=cuda)[1:].view_as(xp)
    flat.copy_(xp)
    assert flat.data_ptr() % 16
    assert torch.equal(KB.btile_spmm(*args, flat, A.ngroups,
                                     A.max_band_steps),
                       KB.btile_spmm(*args, xp, A.ngroups,
                                     A.max_band_steps))


@pytest.mark.parametrize("G, seed", [(1, 3), (2, 0), (4, 6)])
def test_sellwds_kernel_matches_plain_version(cuda, G, seed):
    """B13 at G = 1, 2, 4 on n = 2500 (not a multiple of 128): the s and e
    planes equal the plain version's bit for bit; the fp64 result passes
    the fp64 gate, the fp32 entry lies within 1e-5 of |A|·|x|."""
    mat = ds_banded(2500, 50, seed=seed)
    host = HostCSR.from_scipy(mat)
    A = sellw_ds.build_sellwds(host, group=G).to(cuda)
    B = A.base
    x = np.random.default_rng(1).uniform(-1, 1, host.n)
    xh, xl = (torch.as_tensor(v, device=cuda) for v in _split_f64(x))
    args = (B.word, B.vals, A.vlo, B.wrow, xh, xl, sellw.class_plan(B), G)
    KS.reset_launch_counts()
    got = KS.sellwds_planes(*args)
    want = KS.sellwds_planes_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n_launched = sum(1 for _, cnt, _ in sellw.class_plan(B) if cnt)
    assert KS.LAUNCHES["sellwds"] == n_launched >= 1
    assert sum(KS.LAUNCHES.values()) == n_launched
    y = A.spmv_f64(x)                                  # CUDA program: "cuda"
    assert np.array_equal(y, sellw_ds.spmv_sellwds_f64(A.to("cpu"), x))
    gold = host.spmv_gold(x).astype(np.float64)
    assert (np.abs(y - gold) / np.maximum(np.abs(gold), 1e-300)).max() < 1e-10
    _close_to_scipy(mat, x.astype(np.float32).astype(np.float64),
                    spmv(A, xh))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_sellwds_kernels_at_every_scan_depth(cuda, G):
    """B13 on a program with a stage class at every scan depth 0..7: the
    planes equal the plain version's bit for bit, one launch per class;
    the combine's s and e equal ``_combine_y_ds``'s and its y their sum,
    bit for bit; one SpMV launches B13 once per class and the combine
    once, and its y equals the plain entry's."""
    A = sellw_ds.build_sellwds(HostCSR.from_scipy(ds_staged_matrix()),
                               group=G, part_cap=128).to(cuda)
    B = A.base
    plan = sellw.class_plan(B)
    assert [st for _, _, st in plan] == list(range(8))
    x = np.random.default_rng(G).uniform(-1, 1, B.n)
    xh, xl = (torch.as_tensor(v, device=cuda) for v in _split_f64(x))
    args = (B.word, B.vals, A.vlo, B.wrow, xh, xl, plan, G)
    KS.reset_launch_counts()
    got = KS.sellwds_planes(*args)
    want = KS.sellwds_planes_torch(*args)
    s, e = KS.sellwds_combine(got, B.yidx, B.m)
    y = KS.sellwds_combine(got, B.yidx, B.m, sum_pair=True)
    want_s, want_e = sellw_ds._combine_y_ds(B, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(s, want_s) and torch.equal(e, want_e)
    assert torch.equal(y, want_s + want_e)
    assert KS.LAUNCHES["sellwds"] == 8 and KS.LAUNCHES["sellwds_combine"] == 2
    KS.reset_launch_counts()
    y = spmv(A, xh)                                    # CUDA tensor: "cuda"
    torch.cuda.synchronize()
    assert {k: v for k, v in KS.LAUNCHES.items() if v} == {
        "sellwds": len(plan), "sellwds_combine": 1}
    assert torch.equal(y, sellw_ds.spmv_sellwds_torch(A, xh))


def test_sellwds_wrapper_refuses_bad_input(cuda):
    A = sellw_ds.build_sellwds(HostCSR.from_scipy(
        ds_banded(300, 6, seed=1))).to(cuda)
    B = A.base
    xd = torch.zeros(300, device=cuda)
    plan = sellw.class_plan(B)
    with pytest.raises(ValueError, match="several devices"):
        KS.sellwds_planes(B.word, B.vals, A.vlo, B.wrow, xd, xd.cpu(), plan,
                          B.G)
    with pytest.raises(ValueError, match="shape"):
        KS.sellwds_planes(B.word, B.vals, A.vlo, B.wrow, xd, xd[:10], plan,
                          B.G)
    with pytest.raises(TypeError):
        KS.sellwds_planes(B.word, B.vals, A.vlo.double(), B.wrow, xd, xd,
                          plan, B.G)
    planes = KS.sellwds_planes(B.word, B.vals, A.vlo, B.wrow, xd, xd, plan,
                               B.G)
    with pytest.raises(ValueError, match="several devices"):
        KS.sellwds_combine(planes, B.yidx.cpu(), B.m)
    with pytest.raises(TypeError):
        KS.sellwds_combine(planes, B.yidx.long(), B.m)
    with pytest.raises(ValueError, match="G·npad"):
        KS.sellwds_combine(planes[0], B.yidx, B.m)
    with pytest.raises(ValueError, match="nb·128"):
        KS.sellwds_combine(planes, B.yidx[:, :1].contiguous(), B.m)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A.to("cpu"), torch.ones(300), impl="cuda")


@pytest.mark.parametrize("case", ["random", "hi_planes"])
def test_clos_r3_kernels_match_plain_versions(cuda, case):
    """B8: the fill, the r3 layer × vals with the scan (each one launch a
    phase of ``plan_scan_phases``), and the out-valid mask, whole and over
    the blocks that hold y, equal their plain versions bit for bit (stages
    past 14 on the hi planes); CLOS/cuda's y lies within 1e-5 of |A|·|x|."""
    mat = (clos_hi_matrix() if case == "hi_planes"
           else random_matrix(3000, 2500, 0.002, 8))
    A = clos.build_clos(HostCSR.from_scipy(mat)).to(cuda)
    assert (A.fill_hi.numel() == A.N) == (case == "hi_planes")
    x, xd = _x(mat.shape[1], cuda)
    u = torch.nn.functional.pad(xd, (0, A.N - A.n)).view(-1, 128)
    K.reset_launch_counts()
    for name, args in (
            ("clos_r3_fill", (u, A.widen_r3, A.fill_hi, A.fill_stages)),
            ("clos_r3_scan", (u, A.perm_r3, A.vals, A.scan_hi,
                              A.scan_stages)),
            ("clos_r3_valid", (u, A.compact_r3)),
            ("clos_r3_valid", (u, A.compact_r3, A.m))):
        got = getattr(K, name)(*args)
        want = getattr(K, name + "_torch")(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    n_fill = len(K.plan_scan_phases(A.fill_stages, A.N, A.N))
    n_scan = len(K.plan_scan_phases(A.scan_stages, A.N, A.N))
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0),
                          "clos_r3_fill": n_fill, "clos_r3_scan": n_scan,
                          "clos_r3_valid": 2}
    assert n_fill + n_scan < len(A.fill_stages) + len(A.scan_stages)
    K.reset_launch_counts()
    y = spmv(A, xd)                                    # CUDA tensor: "cuda"
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "clos_invreg": 3,
                          "clos_r2": 3,
                          "clos_r3_fill": n_fill, "clos_r3_scan": n_scan,
                          "clos_r3_valid": 1}
    assert torch.equal(y, spmv(A, xd, impl="torch"))
    _close_to_scipy(mat, x, y)
    if case == "hi_planes":       # stages past 14 refuse a dummy hi plane
        with pytest.raises(ValueError, match="fill_hi"):
            K.clos_r3_fill(u, A.widen_r3, A.fill_hi[:8].contiguous(),
                           A.fill_stages)


@pytest.mark.parametrize("case", ["random", "spilling"])
def test_closm_kernels_on_multicast_planes(cuda, case):
    """B2 and B8 on a CLOSM program's multicast planes (one source feeds
    several outputs): ``clos_invreg`` and ``clos_r2`` on both networks,
    ``clos_r3_scan`` and ``clos_r3_valid`` equal their plain versions bit
    for bit on the pipeline's own inputs; one CLOSM/cuda SpMV launches the
    layers 2 + 2 times, the scan once a phase and the valid step once; its
    y (spilled nonzeros added by ``index_add_``, atomics on the card) lies
    within 1e-6 of |A|·|x| of CLOSM/torch's and 1e-5 of the float64
    product; CLOSM/cuda refuses CPU tensors."""
    from spmv_research_tpu_torch.ops import build_clos_mcast
    from spmv_research_tpu_torch.ops import clos_mcast as cm
    mat = (closm_spilling_matrix() if case == "spilling"
           else random_matrix(300, 300, 0.01, 1))
    A = build_clos_mcast(HostCSR.from_scipy(mat)).to(cuda)
    assert (A.n_spill == 134) == (case == "spilling")
    x, xd = _x(mat.shape[1], cuda)
    steps = []

    def step(name, *args):
        got = getattr(K, name)(*args)
        want = getattr(K, name + "_torch")(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        steps.append(name)
        return want

    u = cm._spread(xd, A.N, A.x_stride)
    for r1, r2 in ((A.g_r1, A.g_r2), (A.compact_r1, A.compact_r2)):
        u = step("clos_r2", step("clos_invreg", u, r1), r2, A.V)
        if r1 is A.g_r1:
            u = step("clos_r3_scan", u, A.g_r3, A.vals, A.scan_hi,
                     A.scan_stages)
    step("clos_r3_valid", u, A.compact_r3, A.m)
    assert len(steps) == 6
    n_scan = len(K.plan_scan_phases(A.scan_stages, A.N, A.N))
    K.reset_launch_counts()
    y = spmv(A, xd)                                    # CUDA tensor: "cuda"
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**dict.fromkeys(K.LAUNCHES, 0), "clos_invreg": 2,
                          "clos_r2": 2, "clos_r3_scan": n_scan,
                          "clos_r3_valid": 1}
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    plain = spmv(A, xd, impl="torch").double().cpu().numpy()
    assert np.max(np.abs(y.double().cpu().numpy() - plain) / scale) <= 1e-6
    _close_to_scipy(mat, x, y)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A.to("cpu"), torch.ones(mat.shape[1]), impl="cuda")


@pytest.mark.parametrize("case", ["random", "pathological"])
def test_bfly_kernels_match_plain_versions(cuda, case):
    """B9 (an exchange network, the fill and the scan, each in the phases
    of its own plan, one launch a phase) and B10 (the whole program in
    phases, one launch a phase) equal their plain versions bit for bit;
    the BFLY/cuda y lies within 1e-5 of |A|·|x|."""
    mat = (bfly_pathological() if case == "pathological"
           else random_matrix(3000, 2500, 0.002, 8))
    A = bfly.build_bfly(HostCSR.from_scipy(mat)).to(cuda)
    x, xd = _x(mat.shape[1], cuda)
    v = bfly._spread_x(xd, A.n, A.N, A.sigma_x)
    KF.reset_launch_counts()
    phases = dict.fromkeys(KF.LAUNCHES, 0)
    for name, args in (("bfly_xor_net", (A.widen_B, A.widen_stages)),
                       ("bfly_fill", (A.fill_words, A.fill_stages)),
                       ("bfly_xor_net", (A.perm_B, A.perm_stages)),
                       ("bfly_scan", (A.scan_guards, A.scan_stages)),
                       ("bfly_xor_net", (A.compact_B, A.compact_stages))):
        got = getattr(KF, name)(v, *args)
        want = getattr(KF, name + "_torch")(v, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        if args[1]:
            phases[name] += len(KF.b9_phase_table(name, args[1], A.L))
        v = want
    assert KF.LAUNCHES == phases
    v = bfly._spread_x(xd, A.n, A.N, A.sigma_x)
    full = KF.bfly_full(v, *A.planes())
    assert torch.equal(full, KF.bfly_full_torch(v, *A.planes()))
    assert KF.LAUNCHES["bfly_full"] == len(KF.phase_table(A.planes()[7:],
                                                          A.L))
    y = spmv(A, xd)                                    # CUDA tensor: "cuda"
    assert torch.equal(y, bfly.spmv_bfly_cuda_fused(A, xd))
    assert torch.equal(y, spmv(A, xd, impl="torch"))
    _close_to_scipy(mat, x, y)
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A.to("cpu"), torch.ones(mat.shape[1]), impl="cuda")


def _random_bfly(cuda, L, passes, fill, scan):
    """Random word planes, values and stage lists of a program of 2^L
    slots, each network ``passes`` Waksman-ordered passes."""
    rng = np.random.default_rng(L)
    N = 1 << L
    order = list(range(L)) + list(range(L - 2, -1, -1))
    net = tuple((j // 32, j % 32, k) for j, k in enumerate(order * passes))
    words = (len(net) + 31) // 32

    def bits(*shape):
        return torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape,
                                            dtype=np.int64).astype(np.int32),
                               device=cuda)

    def floats(lo=-1.0):
        return torch.as_tensor(rng.uniform(lo, 1, N), dtype=torch.float32,
                               device=cuda)

    v, vals, valid = floats(), floats(), (floats(0.0) < 0.7).float()
    planes = (bits(words, N), bits(N), bits(words, N), vals, bits(N),
              bits(words, N), valid)
    return v, planes, (net, tuple(range(fill)), net, tuple(range(scan)), net)


RANDOM_PROGRAMS = [(6, 2, 4, 5), (15, 2, 6, 9), (19, 2, 5, 13),
                   (21, 1, 6, 9)]


@pytest.mark.parametrize("L, passes, fill, scan", RANDOM_PROGRAMS)
def test_bfly_full_on_random_programs(cuda, L, passes, fill, scan):
    """B10 on random word planes (multi-pass Waksman-ordered networks): one
    tile (L = 6), contiguous and strided phases at T = 10, 12 and 14 (L =
    15, 19, 21), and at L = 19 a scan whose shifts pass the halo budget
    (a global phase); bit for bit the plain version's."""
    v, planes, stages = _random_bfly(cuda, L, passes, fill, scan)
    phases = KF.plan_phases(list(KF._codes(*stages)[0]), L, KF.tile_log(L))
    assert (KF.GLOBAL in {p[2] for p in phases}) == (scan > 12)
    want = KF.bfly_full_torch(v, *planes, *stages)
    got = KF.bfly_full(v, *planes, *stages)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("L, passes, fill, scan", RANDOM_PROGRAMS)
def test_b9_on_random_programs(cuda, L, passes, fill, scan):
    """B9 on the same random programs: each network, the fill and the scan
    alone, one launch a phase of its own plan (at L = 19 the scan's run
    split by the halo budget, its stages past 2^10 global phases), bit for
    bit the plain version's."""
    v, planes, stages = _random_bfly(cuda, L, passes, fill, scan)
    widen_B, fill_words, perm_B, vals, scan_guards, compact_B, _ = planes
    for name, plane, st in (("bfly_xor_net", widen_B, stages[0]),
                            ("bfly_fill", fill_words, stages[1]),
                            ("bfly_xor_net", perm_B, stages[2]),
                            ("bfly_scan", scan_guards, stages[3]),
                            ("bfly_xor_net", compact_B, stages[4])):
        KF.reset_launch_counts()
        got = getattr(KF, name)(v, plane, st)
        want = getattr(KF, name + "_torch")(v, plane, st)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        n_phases = len(KF.b9_phase_table(name, st, L))
        assert KF.LAUNCHES == {**dict.fromkeys(KF.LAUNCHES, 0),
                               name: n_phases}
        if name == "bfly_scan":
            assert (n_phases > 1) == (scan > 10)
        v = want * vals if plane is perm_B else want


def test_bench_spmv_torch_row_gates_the_torch_pair(cuda, monkeypatch):
    """A torch row of bench_spmv on a CUDA SELLWDS program is gated by the
    torch pair, not by B13's."""
    from spmv_research_tpu_torch.harness import BenchConfig, bench_spmv
    host = HostCSR.from_scipy(ds_banded(1200, 30, seed=7))
    A = sellw_ds.build_sellwds(host).to(cuda)
    ran = []
    for impl, pair in tuple(sellw_ds._PAIRS.items()):
        monkeypatch.setitem(sellw_ds._PAIRS, impl,
                            lambda *a, i=impl, f=pair: ran.append(i) or f(*a))
    cfg = BenchConfig(min_num_loops=2, min_time_s=0.0, warmup_iters=1,
                      inner_iters=2)
    KS.reset_launch_counts()
    r = bench_spmv(host, A, config=cfg, impl="torch", matrix_name="t")
    assert ran == ["torch"] and KS.LAUNCHES["sellwds"] == 0
    assert r.metrics.passed and r.metrics.max_rel_err < 1e-10
    bench_spmv(host, A, config=cfg, impl="cuda", matrix_name="t")
    assert ran == ["torch", "cuda"] and KS.LAUNCHES["sellwds"] > 0


@pytest.mark.parametrize("kind", ["level", "chunk", "band"])
def test_sptrsv_on_the_card_matches_cpu(cuda, kind):
    """The triangular solves (plain PyTorch, no hand kernel) on schedules
    built on the card agree with the same solve on the CPU within 1e-5 of
    max |x| (index_add_'s atomics add in another order), and CSR/sparse,
    cuSPARSE through the registry, is within 1e-5 of |A|·|x|."""
    from spmv_research_tpu_torch.convert import build_csr, make_spd
    from spmv_research_tpu_torch.solvers import ilu
    host = make_spd(HostCSR.from_scipy(banded_matrix(1500, 1500, 60, 12, 5)))
    L = ilu.ic0(host)
    build = {"level": ilu.build_level_schedule,
             "chunk": lambda T, lower, device: ilu.build_chunk_schedule(
                 T, lower=lower, C=16, device=device),
             "band": lambda T, lower, device: ilu.build_band_block_schedule(
                 T, lower=lower, B=128, device=device)}[kind]
    b = np.random.default_rng(3).uniform(-1, 1, host.m)
    xs = []
    for dev in (cuda, torch.device("cpu")):
        s = build(L, lower=True, device=dev)
        xs.append(ilu.sptrsv(s, torch.as_tensor(b, dtype=torch.float32,
                                                 device=dev)).cpu())
    torch.cuda.synchronize()
    assert (xs[0] - xs[1]).abs().max() <= 1e-5 * xs[1].abs().max()
    mat = host.to_scipy()
    x, xd = _x(host.n, cuda)
    A = build_csr(host).to(cuda)
    _close_to_scipy(mat, x, spmv(A, xd, impl="sparse"))


def test_one_rank_nccl_dist_sellr_and_closgx(cuda, tmp_path, monkeypatch):
    """The distributed layer on one rank over NCCL (``init_multihost``
    with no arguments): each SELLR strategy and CLOSGX with and without
    overlap against the single-device SpMV of the same matrix (B14, or
    B1, clos_r2 and B15, each launched), and B14 on the rank's padded
    program exact to its plain versions."""
    import torch.distributed as dist
    from spmv_research_tpu_torch.convert import cache
    from spmv_research_tpu_torch import parallel as tp
    from spmv_research_tpu_torch.parallel.dist_sellr import (
        _pad_x, dist_spmv_sellr)
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path))
    if dist.is_initialized():
        pytest.skip("a process group exists already in this process")
    tp.init_multihost()
    try:
        mesh = tp.make_sparse_mesh(1)
        mat = banded_matrix(3000, 3000, 300, 8, 11)
        h = HostCSR.from_scipy(mat)
        x = np.random.default_rng(1).standard_normal(3000)
        xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)
        A1 = sellr.build_sellr(h, max_slot_factor=30.0).to(cuda)
        want = spmv(A1, xd).double().cpu().numpy()
        for strategy in ("allgather", "ring", "psum_scatter"):
            D = tp.build_dist_sellr(h, mesh, strategy=strategy,
                                    max_slot_factor=30.0)
            assert D.device.type == "cuda"
            KS.reset_launch_counts()
            y = tp.dist_spmv_sellr_host(D, x)
            assert KS.LAUNCHES["sellr_place"] == KS.LAUNCHES[
                "sellr_flush"] == 1
            assert np.array_equal(y.astype(np.float32),
                                  want.astype(np.float32)), strategy
        xp = _pad_x(D, x)
        p_args = (D.word, D.vals, D.smeta, xp, D.nchunks,
                  D.meta["stages"], D.meta["rolls"])
        R = KS.sellr_place(*p_args)
        assert torch.equal(R, KS.sellr_place_torch(*p_args))
        assert torch.equal(KS.sellr_flush(R, D.gptr, D.gchunk),
                           KS.sellr_flush_torch(R, D.gptr, D.gchunk))
        assert dist_spmv_sellr(D, xp).shape[0] == D.meta["y_rows"] * 128
        mx = random_matrix(3000, 3000, 0.004, 3)
        hx = HostCSR.from_scipy(mx)
        xx = np.random.default_rng(2).uniform(-1, 1, 3000)
        Ax = build_clos_gather_xl(hx, chunk_N=1 << 14).to(cuda)
        want = spmv(Ax, torch.as_tensor(xx, dtype=torch.float32,
                                        device=cuda)).double().cpu().numpy()
        for ov in (False, True):
            Dx = tp.build_dist_closgx(hx, mesh, axis="rows",
                                      chunk_N=1 << 14, overlap=ov)
            K.reset_launch_counts()
            y = tp.dist_spmv_closgx_host(Dx, xx)
            for k in ("closg_front", "clos_r2", "closgx_r3_scan_yext"):
                assert K.LAUNCHES[k] > 0, k
            scale = np.abs(mx) @ np.abs(xx) + 1e-30
            assert np.max(np.abs(y - want) / scale) <= 1e-6, ov
    finally:
        dist.destroy_process_group()
