"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need a CUDA device and nvcc, and skip without them.
On the GPU machine, which has no JAX for ``tests/conftest.py``, run them
with ``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``.
Tolerances: K1 and K2 are gathers and one product per slot and must match
exactly; K3 runs the same additions in the same order as its plain version
and is held to 1e-6 of max |y| (fp32 add-order slack). The SELLW and SELLR
kernels add in their plain versions' order and must match exactly, as must
B4-B7 and B15 (gathers, one product per slot, and scan stages that add in
the plain versions' order), and B12, the SELLW SpMM kernel (the SpMV
kernel's pipeline per column), and B13, the double-single SELLW kernel
(every product and sum rounded on its own, in the plain version's order). B16a and B16b, BTILE's SpMM and SDDMM, sum
their products in another order than ``torch.bmm``: they are held to 1e-5
of |A|·|X| per element and of Σ|a||b| per slot.
"""

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
from spmv_research_tpu_torch.ops import btile_cuda as KB
from spmv_research_tpu_torch.ops import clos_gather as cg
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
from spmv_research_tpu_torch.ops import sell_cuda as KS
from spmv_research_tpu_torch.ops import sellr, sellw, sellw_ds
from spmv_research_tpu_torch.ops.compensated import _split_f64

from torch_cases import (TWIN_LINE, banded_matrix, btile_banded,
                         capped_scan_matrix,
                         dirty_sellr_matrix, ds_banded, random_matrix,
                         skewed_matrix,
                         skewed_xl_matrix, w0_matrix)

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


@pytest.mark.parametrize("case", ["twin", "capped_scan"])
def test_kernels_match_plain_versions(cuda, case):
    host = _host(case)
    A = build_clos_gather(host).to(cuda)
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0, host.n)
    xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)

    v1 = K.closg_front(A.rowidx, A.perm_r1, A.vals_cs, xd)
    assert torch.equal(v1, K.closg_front_torch(A.rowidx, A.perm_r1,
                                               A.vals_cs, xd))
    v2_in = _t_fwd(v1, A.V)
    v2 = K.clos_invreg(v2_in, A.perm_r2)
    assert torch.equal(v2, K.clos_invreg_torch(v2_in, A.perm_r2))
    args = (_t_bwd(v2, A.V), A.perm_r3, A.scan_hi, A.ysel_w, A.wstart,
            A.acc_ptr, A.acc_src, A.scan_cap or A.scan_stages)
    y = K.closg_r3_scan_yext(*args)
    y_plain = K.closg_r3_scan_yext_torch(*args)
    torch.cuda.synchronize()
    assert (y - y_plain).abs().max() <= 1e-6 * y_plain.abs().max()

    mat = host.to_scipy()
    got = spmv(A, xd).double().cpu().numpy()          # CUDA tensor: "cuda"
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    assert np.max(np.abs(got - mat @ x) / scale) <= 1e-5


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


@pytest.mark.parametrize("kind", ["multi_step", "dirty"])
def test_sellr_kernels_match_plain_version(cuda, kind):
    if kind == "dirty":
        mat, factor = dirty_sellr_matrix(), 12.0
    else:
        mat, factor = banded_matrix(2000, 2000, 400, 80, 0), 4.0
    A = sellr.build_sellr(HostCSR.from_scipy(mat),
                          max_slot_factor=factor).to(cuda)
    x, xd = _x(mat.shape[1], cuda)
    args = (A.word, A.vals, A.smeta, A.gptr, A.gchunk, xd, A.nchunks,
            A.stages, A.rolls)
    place = (A.word, A.vals, A.smeta, xd, A.nchunks, A.stages, A.rolls)
    KS.reset_launch_counts()
    R = KS.sellr_place(*place)
    R_plain = KS.sellr_place_torch(*place)
    got = KS.sellr_flush(R_plain, A.gptr, A.gchunk)
    want = KS.sellr_flush_torch(R_plain, A.gptr, A.gchunk)
    torch.cuda.synchronize()
    assert torch.equal(R, R_plain) and torch.equal(got, want)
    assert KS.LAUNCHES == {"sellw": 0, "sellw_stream": 0, "sellw_spmm": 0,
                           "sellr_place": 1, "sellr_flush": 1, "sellwds": 0}
    assert torch.equal(KS.sellr_y(*args), KS.sellr_y_torch(*args))
    _close_to_scipy(mat, x, spmv(A, xd))


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
    with pytest.raises(ValueError, match="CUDA"):
        spmv(R.to("cpu"), torch.ones(300), impl="cuda")


def _r3_input(A, xd):
    v = K.closg_front(A.rowidx, A.perm_r1, A.vals_cs, xd)
    return _t_bwd(K.clos_invreg(_t_fwd(v, A.V), A.perm_r2), A.V)


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
    assert K.LAUNCHES["closg_r3_scan"] == 1 + len(A.scan_stages)
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
    mid = (_t_fwd(v1, V), A.r2.view(-1, V // 8))
    v2 = K.clos_invreg(*mid)
    assert torch.equal(v2, K.clos_invreg_torch(*mid))
    back = (_t_bwd(v2, V), A.r3.view(-1, LANES), A.ysel_w.view(-1, LANES),
            A.wstart_abs.view(-1), A.stages, A.N)
    K.reset_launch_counts()
    y = K.closgx_r3_scan_yext(*back)
    torch.cuda.synchronize()
    assert torch.equal(y, K.closgx_r3_scan_yext_torch(*back))
    assert K.LAUNCHES["closgx_r3_scan_yext"] == A.stages + 2
    _close_to_scipy(mat, x, spmv(A, xd))


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


@pytest.mark.parametrize("kind", ["g2", "g4", "stream"])
def test_sellw_spmm_kernel_matches_plain_version(cuda, kind, monkeypatch):
    """B12 over K = 10 columns: the planes equal the plain version's."""
    if kind == "stream":
        monkeypatch.setattr(sellw, "_X_VMEM_LIMIT", 512)
        mat, G = banded_matrix(400, 1030, 60, 8, 3), 2
    else:
        mat, G = banded_matrix(1200, 1200, 160, 14, 2), int(kind[1])
    A = sellw.build_sellw(HostCSR.from_scipy(mat), group=G).to(cuda)
    X = np.random.Generator(np.random.PCG64(8)).uniform(
        -1.0, 1.0, (mat.shape[1], 10))
    Xd = torch.as_tensor(X, dtype=torch.float32, device=cuda)
    args = (A.word, A.vals, A.wrow, Xd.t().contiguous(), sellw.class_plan(A),
            G)
    KS.reset_launch_counts()
    got = KS.sellw_spmm_planes(*args)
    want = KS.sellw_spmm_planes_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    n_launched = sum(1 for _, cnt, _ in sellw.class_plan(A) if cnt)
    assert KS.LAUNCHES["sellw_spmm"] == n_launched >= 1
    Y = spmm(A, Xd).double().cpu().numpy()            # CUDA tensor: "cuda"
    scale = np.abs(mat) @ np.abs(X) + 1e-30
    assert np.max(np.abs(Y - mat @ X) / scale) <= 1e-5


def _btile_case(cuda, k, empty_band=False):
    mat = btile_banded(2500, 2500, 12, 200, 1)
    if empty_band:             # rows [1024, 2048) empty: a filler step
        mat = mat.tolil()
        mat[1024:2048] = 0
        mat = mat.tocsr()
        mat.eliminate_zeros()
    A = build_btile(HostCSR.from_scipy(mat)).to(cuda)
    rng = np.random.Generator(np.random.PCG64(k))
    m, n = mat.shape
    return mat, A, *(torch.as_tensor(rng.uniform(-1, 1, s),
                                     dtype=torch.float32, device=cuda)
                     for s in ((n, k), (m, k), (n, k)))


@pytest.mark.parametrize("k, empty_band", [(16, False), (37, False),
                                           (8, True)])
def test_btile_kernels_match_plain_versions(cuda, k, empty_band,
                                            monkeypatch):
    """B16a (SpMM; K = 37 pads X to 64 columns; bands cut into chunks, and
    whole bands in the empty-band case) and B16b (SDDMM; K = 37 takes two
    registers per lane), on three bands."""
    if empty_band:
        monkeypatch.setattr(KB, "spmm_blocks", lambda _: 1)
    mat, A, X, Am, Bm = _btile_case(cuda, k, empty_band)
    kp = -(-k // KB.SPMM_KS) * KB.SPMM_KS
    nchunk, _ = KB._chunks(A.ngroups, kp // KB.SPMM_KS, A.nsteps,
                           A.max_band_steps, kp, KB.spmm_blocks(X.device))
    assert (nchunk > 1) != empty_band
    KB.reset_launch_counts()
    Y = spmm(A, X)                                     # CUDA tensor: "cuda"
    Y_plain = spmm(A, X, impl="torch")
    yard = spmm(A.to("cpu"), X.abs().cpu()).to(cuda)   # |A|·|X|, A ≥ 0
    C = sddmm(A, Am, Bm)
    C_plain = sddmm(A, Am, Bm, impl="torch")
    dots = sddmm(A, Am.abs(), Bm.abs(), impl="torch")  # Σ|a||b| per slot
    torch.cuda.synchronize()
    assert KB.LAUNCHES == {"btile_spmm": 1, "btile_combine": int(nchunk > 1),
                           "btile_sddmm": 1}
    assert ((Y - Y_plain).abs() <= 1e-5 * yard).all()
    assert ((C - C_plain).abs() <= 1e-5 * dots).all()
    assert not C[A.patt == 0].any()
    if empty_band:
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


@pytest.mark.parametrize("G, seed", [(2, 0), (4, 6)])
def test_sellwds_kernel_matches_plain_version(cuda, G, seed):
    """B13: the s and e planes equal the plain version's bit for bit; the
    fp64 result passes the fp64 gate, the fp32 entry lies within 1e-5 of
    |A|·|x|."""
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
    with pytest.raises(ValueError, match="CUDA"):
        spmv(A.to("cpu"), torch.ones(300), impl="cuda")
