"""The column-locality engines' CUDA kernels: wrappers and plain versions.

Counterpart of the Pallas kernels of ``spmv_research_tpu/ops/sellw.py`` and
``spmv_research_tpu/ops/sellr.py`` (sources and design notes in
``csrc/sell.cu``):

======================  ===================================================
wrapper                 replaces
======================  ===================================================
``sellw_planes``        ``sellw.py:_sellw_kernel`` and
                        ``:_sellw_stream_kernel`` (one launch per stage
                        class; one kernel for both program kinds, counted
                        apart: ``sellw`` and ``sellw_stream``)
``sellw_spmm_planes``   ``sellw.py:_sellw_spmm_kernel``: the same kernel
                        over the columns of X, word and vals read once for
                        all of them (one launch per stage class, counted as
                        ``sellw_spmm``)
``sellr_place``         ``sellr.py:_sellr_kernel``, with ``sellr_flush``:
                        the placed chunk planes R
``sellr_flush``         the run-flush of R into y, one block per y group in
                        the order the host listed
``sellwds_planes``      ``sellw_ds.py:_sellwds_kernel``: SELLW's pipeline
                        in double-single arithmetic, the s and e planes
                        (one launch per stage class, counted as
                        ``sellwds``)
======================  ===================================================

``sellr_y`` chains the two SELLR wrappers. Each wrapper takes the kernels'
plain PyTorch version (``*_torch``) only when its tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts the kernel launches, beside each launch. The plain
versions add in the kernels' order
(sublanes 0..7 in turn, the roll sources by r, the run-flush chunk by
chunk), so on the card kernel and plain version agree exactly. B13's plain
version rounds every product and sum on its own, as the kernel does with
the ``__f*_rn`` intrinsics, so the two agree exactly too. SELLW's
``_combine_y`` and SELLWDS's ``_combine_y_ds`` (XLA gathers and sums in the
JAX package) stay PyTorch.

The kernels are compiled by ``nvcc`` from ``csrc/sell.cu`` at first CUDA use
(``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .clos_route import LANES, SUB
from .compensated import _two_prod, _two_sum
from .cuda_lib import CudaLib, check, on_cuda, stream

SELLR_NB = 64            # SELLR chunks per smeta step
SELLR_SMEM_BLK = 1024    # smeta ints per step

LAUNCHES = {"sellw": 0, "sellw_stream": 0, "sellw_spmm": 0,
            "sellr_place": 0, "sellr_flush": 0, "sellwds": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sellw_spmv.argtypes = [p, p, p, p, i64, p, i64, i64, i64, i32, i32,
                               p]
    lib.sellw_spmm.argtypes = [p, p, p, p, i64, i32, p, i64, i64, i64, i64,
                               i32, i32, p]
    lib.sellr_place.argtypes = [p, p, p, p, i64, p, i64, i32, p]
    lib.sellr_flush.argtypes = [p, p, p, p, i32, p]
    lib.sellwds_spmv.argtypes = [p, p, p, p, p, p, i64, p, p, i64, i64, i64,
                                 i32, i32, p]
    for fn in (lib.sellw_spmv, lib.sellw_spmm, lib.sellr_place,
               lib.sellr_flush, lib.sellwds_spmv):
        fn.restype = i32


_CUDA = CudaLib("sell", _bind)
SOURCE = _CUDA.source
build = _CUDA.build
build_log = _CUDA.build_log


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _x2d(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    return F.pad(x, (0, n_rows * LANES - x.shape[0])).view(n_rows, LANES)


def _pick_scan(word: torch.Tensor, vals: torch.Tensor, wrow: torch.Tensor,
               x: torch.Tensor, stages: int) -> torch.Tensor:
    """x2d[wrow, lane] · val, then ``stages`` guarded lane-scan stages (the
    JAX kernels' ``v + where(guard, roll(v, 2^k), 0)``)."""
    x2d = _x2d(x, max(-(-x.shape[0] // LANES), 1))
    v = torch.gather(x2d[wrow.long()], 1, (word & 0x7F).long()) * vals
    for k in range(stages):
        guard = ((word >> (7 + k)) & 1) != 0
        v = v + torch.where(guard, torch.roll(v, 1 << k, dims=1), 0.0)
    return v


def _sum_sublanes(z: torch.Tensor) -> torch.Tensor:
    """(c, 8, 128) → (c, 128): 0 + z[:,0] + … + z[:,7], in that order."""
    acc = torch.zeros_like(z[:, 0])
    for s in range(SUB):
        acc = acc + z[:, s]
    return acc


# ------------------------------------------------------------ plain versions

def sellw_planes_torch(word, vals, wrow, x, classes: Sequence[Tuple[int, int,
                       int]], G: int) -> torch.Tensor:
    """SELLW's G partial planes and the zero row: (G·npad + 1, 128), plane g
    at rows [g·npad, (g+1)·npad); chunk c's row is the sublane sum of the
    part ends of bid g. ``classes`` = ((start_chunk, n_chunks, stages), …)."""
    npad = word.shape[0] // SUB
    out = vals.new_zeros((G * npad + 1, LANES))
    for start, cnt, stages in classes:
        sl = slice(start * SUB, (start + cnt) * SUB)
        w = word[sl]
        v = _pick_scan(w, vals[sl], wrow[sl], x, stages)
        E = torch.gather(v, 1, ((w >> 14) & 0x7F).long())
        live = ((w >> 21) & 1) != 0
        bid = (w >> 22) & (G - 1)
        for g in range(G):
            z = torch.where(live & (bid == g), E, 0.0).view(cnt, SUB, LANES)
            out[g * npad + start: g * npad + start + cnt] = _sum_sublanes(z)
    return out


def sellw_spmm_planes_torch(word, vals, wrow, xt, classes, G: int
                            ) -> torch.Tensor:
    """SELLW's planes for each column of X: (K, G·npad + 1, 128), from
    ``xt`` = Xᵀ (K, n), ``sellw_planes_torch`` column by column."""
    return torch.stack([sellw_planes_torch(word, vals, wrow, xt[k], classes,
                                           G) for k in range(xt.shape[0])])


def sellwds_planes_torch(word, vhi, vlo, wrow, xh, xl,
                         classes: Sequence[Tuple[int, int, int]],
                         G: int) -> torch.Tensor:
    """SELLWDS's s and e planes: (2, G·npad + 1, 128), each laid out as
    ``sellw_planes_torch``'s (the zero row last). Per slot the Dekker
    product of (vhi, x hi) plus the cross terms vhi·x lo + vlo·x hi, the
    guarded TwoSum scan of the (s, e) pair, the pick at eidx, and per y
    block of the group a sequential TwoSum fold over sublanes 0..7."""
    npad = word.shape[0] // SUB
    out = vhi.new_zeros((2, G * npad + 1, LANES))
    rows = max(-(-xh.shape[0] // LANES), 1)
    xh2, xl2 = _x2d(xh, rows), _x2d(xl, rows)
    for start, cnt, stages in classes:
        sl = slice(start * SUB, (start + cnt) * SUB)
        w, a, b = word[sl], vhi[sl], vlo[sl]
        wr, lane = wrow[sl].long(), (w & 0x7F).long()
        gxh = torch.gather(xh2[wr], 1, lane)
        gxl = torch.gather(xl2[wr], 1, lane)
        s_, e_ = _two_prod(a, gxh)
        e_ = e_ + a * gxl + b * gxh
        for k in range(stages):
            g = ((w >> (7 + k)) & 1) != 0
            rsg = torch.where(g, torch.roll(s_, 1 << k, dims=1), 0.0)
            re = torch.where(g, torch.roll(e_, 1 << k, dims=1), 0.0)
            t = s_ + rsg
            bb = t - s_
            err = (s_ - (t - bb)) + (rsg - bb)
            e_ = e_ + re + err
            s_ = t
        eidx = ((w >> 14) & 0x7F).long()
        Es = torch.gather(s_, 1, eidx).view(cnt, SUB, LANES)
        Ee = torch.gather(e_, 1, eidx).view(cnt, SUB, LANES)
        live = ((w >> 21) & 1) != 0
        bid = (w >> 22) & (G - 1)
        for g in range(G):
            mask = (live & (bid == g)).view(cnt, SUB, LANES)
            S = torch.zeros_like(Es[:, 0])
            E = torch.zeros_like(S)
            for si in range(SUB):
                S, e1 = _two_sum(S, torch.where(mask[:, si], Es[:, si], 0.0))
                E = E + e1 + torch.where(mask[:, si], Ee[:, si], 0.0)
            out[0, g * npad + start: g * npad + start + cnt] = S
            out[1, g * npad + start: g * npad + start + cnt] = E
    return out


def sellr_place_torch(word, vals, smeta, x, nchunks: int, stages: int,
                      rolls) -> torch.Tensor:
    """SELLR's placed chunk planes R (nchunks·8, 128): each part sum moved to
    its target sublane of the same chunk, the roll sources added by r."""
    ns = nchunks * SUB
    wrow = smeta.view(-1, SELLR_SMEM_BLK)[:, : SELLR_NB * SUB].reshape(-1)
    w = word[:ns]
    v = _pick_scan(w, vals[:ns], wrow[:ns], x, stages)
    E = torch.gather(v, 1, ((w >> 14) & 0x7F).long())
    live = ((w >> 21) & 1) != 0
    P = torch.where(live, E, 0.0)
    rcode = (w >> 22) & 0xF
    R = torch.where(live & (rcode == 0), P, 0.0)
    for r, wrap in rolls:
        Q = torch.where(live & (rcode == (r | (wrap << 3))), P, 0.0)
        R = R + torch.roll(Q.view(nchunks, SUB, LANES), r, dims=1).view(
            ns, LANES)
    return R


def sellr_flush_torch(R, gptr, gchunk) -> torch.Tensor:
    """SELLR's y plane (y_rows, 128) from R: the run-flush, group by group in
    the listed order."""
    R = R.view(-1, SUB * LANES)
    n_groups = gptr.shape[0] - 1
    y = R.new_zeros((n_groups, SUB * LANES))
    acc = torch.zeros_like(y)
    counts = (gptr[1:] - gptr[:-1]).long()
    for i in range(int(counts.max()) if n_groups else 0):
        gi = torch.nonzero(counts > i).squeeze(1)
        e = gchunk[(gptr[gi] + i).long()].long()
        acc[gi] = acc[gi] + R[e >> 1]
        f = gi[(e & 1) == 1]
        y[f] = y[f] + acc[f]
        acc[f] = 0.0
    return y.view(n_groups * SUB, LANES)


def sellr_y_torch(word, vals, smeta, gptr, gchunk, x, nchunks: int,
                  stages: int, rolls) -> torch.Tensor:
    """SELLR's y plane: ``sellr_place_torch``, then ``sellr_flush_torch``."""
    return sellr_flush_torch(sellr_place_torch(word, vals, smeta, x, nchunks,
                                               stages, rolls), gptr, gchunk)


# ------------------------------------------------------------------ wrappers

def _check_chunks(word, vals, rows_of_8: torch.Tensor, x) -> int:
    S = word.shape[0]
    check(word, "word", torch.int32, (S, LANES))
    check(vals, "vals", torch.float32, (S, LANES))
    check(rows_of_8, "wrow/smeta", torch.int32)
    check(x, "x", torch.float32)
    if x.dim() != 1:
        raise ValueError(f"x: expected one dimension, got {tuple(x.shape)}")
    if S % SUB:
        raise ValueError(f"{S} sublanes is not a whole number of chunks")
    return S // SUB


def _check_classes(classes, npad: int, G: int) -> int:
    """Stage classes contiguous from chunk 0; returns the chunks covered."""
    if G not in (1, 2, 4, 8):
        raise ValueError(f"group G={G} is not 1, 2, 4 or 8")
    covered = 0
    for start, cnt, stages in classes:
        if start != covered or stages > 7:
            raise ValueError(f"stage classes {classes} are not contiguous "
                             "from chunk 0 with at most 7 stages")
        covered += cnt
    if covered > npad:
        raise ValueError(f"stage classes cover {covered} > {npad} chunks")
    return covered


def _planes_out(vals, cols: int, G: int, npad: int, covered: int):
    """(cols, G·npad + 1, 128) output (cols: X's columns, or SELLWDS's s
    and e planes) with the rows no launch writes (the zero row, chunks past
    the classes) zeroed."""
    out = torch.empty((cols, G * npad + 1, LANES), dtype=vals.dtype,
                      device=vals.device)
    out[:, -1].zero_()
    if covered < npad:
        out[:, :-1].view(cols, G, npad, LANES)[:, :, covered:].zero_()
    return out


def sellw_planes(word, vals, wrow, x, classes: Sequence[Tuple[int, int, int]],
                 G: int, stream_wins: bool = False) -> torch.Tensor:
    """SELLW's G partial planes (the kernel; see ``sellw_planes_torch``).
    ``stream_wins`` names the program kind for the launch count only: the
    kernel is the same."""
    if not on_cuda(word, vals, wrow, x):
        return sellw_planes_torch(word, vals, wrow, x, classes, G)
    npad = _check_chunks(word, vals, wrow, x)
    check(wrow, "wrow", torch.int32, (npad * SUB,))
    covered = _check_classes(classes, npad, G)
    out = _planes_out(vals, 1, G, npad, covered)[0]
    key = "sellw_stream" if stream_wins else "sellw"
    st = stream(x)
    with torch.cuda.device(x.device):
        for start, cnt, stages in classes:
            if cnt:
                _CUDA.launch("sellw_spmv", word.data_ptr(), vals.data_ptr(),
                             wrow.data_ptr(), x.data_ptr(), x.shape[0],
                             out.data_ptr(), npad, start, cnt, stages, G, st)
                LAUNCHES[key] += 1
    return out


def sellw_spmm_planes(word, vals, wrow, xt, classes: Sequence[Tuple[int, int,
                      int]], G: int) -> torch.Tensor:
    """SELLW's planes for each column of X (the kernel; see
    ``sellw_spmm_planes_torch``), from ``xt`` = Xᵀ (K, n) contiguous."""
    if not on_cuda(word, vals, wrow, xt):
        return sellw_spmm_planes_torch(word, vals, wrow, xt, classes, G)
    check(xt, "xt", torch.float32)
    if xt.dim() != 2:
        raise ValueError(f"xt: expected (K, n), got {tuple(xt.shape)}")
    npad = _check_chunks(word, vals, wrow, xt.view(-1))
    check(wrow, "wrow", torch.int32, (npad * SUB,))
    covered = _check_classes(classes, npad, G)
    cols, n_x = xt.shape
    out = _planes_out(vals, cols, G, npad, covered)
    if cols:
        st = stream(xt)
        with torch.cuda.device(xt.device):
            for start, cnt, stages in classes:
                if cnt:
                    _CUDA.launch("sellw_spmm", word.data_ptr(),
                                 vals.data_ptr(), wrow.data_ptr(),
                                 xt.data_ptr(), n_x, cols, out.data_ptr(),
                                 out.shape[1] * LANES, npad, start, cnt,
                                 stages, G, st)
                    LAUNCHES["sellw_spmm"] += 1
    return out


def sellwds_planes(word, vhi, vlo, wrow, xh, xl,
                   classes: Sequence[Tuple[int, int, int]],
                   G: int) -> torch.Tensor:
    """SELLWDS's s and e planes (kernel B13; see ``sellwds_planes_torch``)
    from x's hi and lo planes ``xh``, ``xl``."""
    if not on_cuda(word, vhi, vlo, wrow, xh, xl):
        return sellwds_planes_torch(word, vhi, vlo, wrow, xh, xl, classes, G)
    npad = _check_chunks(word, vhi, wrow, xh)
    check(vlo, "vlo", torch.float32, tuple(vhi.shape))
    check(xl, "xl", torch.float32, tuple(xh.shape))
    check(wrow, "wrow", torch.int32, (npad * SUB,))
    covered = _check_classes(classes, npad, G)
    out = _planes_out(vhi, 2, G, npad, covered)
    st = stream(xh)
    with torch.cuda.device(xh.device):
        for start, cnt, stages in classes:
            if cnt:
                _CUDA.launch("sellwds_spmv", word.data_ptr(), vhi.data_ptr(),
                             vlo.data_ptr(), wrow.data_ptr(), xh.data_ptr(),
                             xl.data_ptr(), xh.shape[0], out[0].data_ptr(),
                             out[1].data_ptr(), npad, start, cnt, stages, G,
                             st)
                LAUNCHES["sellwds"] += 1
    return out


def sellr_place(word, vals, smeta, x, nchunks: int, stages: int,
                rolls) -> torch.Tensor:
    """SELLR's placed chunk planes R (kernel 1; see ``sellr_place_torch``)."""
    if not on_cuda(word, vals, smeta, x):
        return sellr_place_torch(word, vals, smeta, x, nchunks, stages, rolls)
    nch_pad = _check_chunks(word, vals, smeta, x)
    check(smeta, "smeta", torch.int32,
          (nch_pad // SELLR_NB * SELLR_SMEM_BLK,))
    if nch_pad % SELLR_NB or not 0 <= nchunks <= nch_pad or stages > 7:
        raise ValueError(f"SELLR program of {nch_pad} chunks ({nchunks} "
                         f"live, {stages} stages) is malformed")
    R = torch.empty((nchunks * SUB, LANES), dtype=vals.dtype,
                    device=vals.device)
    if nchunks:
        with torch.cuda.device(x.device):
            _CUDA.launch("sellr_place", word.data_ptr(), vals.data_ptr(),
                         smeta.data_ptr(), x.data_ptr(), x.shape[0],
                         R.data_ptr(), nchunks, stages, stream(x))
        LAUNCHES["sellr_place"] += 1
    return R


def sellr_flush(R, gptr, gchunk) -> torch.Tensor:
    """SELLR's y plane from R (kernel 2; see ``sellr_flush_torch``)."""
    if not on_cuda(R, gptr, gchunk):
        return sellr_flush_torch(R, gptr, gchunk)
    nchunks = gchunk.shape[0]
    n_groups = gptr.shape[0] - 1
    check(R, "R", torch.float32, (nchunks * SUB, LANES))
    check(gptr, "gptr", torch.int32)
    check(gchunk, "gchunk", torch.int32, (nchunks,))
    y = torch.empty((n_groups * SUB, LANES), dtype=R.dtype, device=R.device)
    if n_groups:
        with torch.cuda.device(R.device):
            _CUDA.launch("sellr_flush", R.data_ptr(), gptr.data_ptr(),
                         gchunk.data_ptr(), y.data_ptr(), n_groups,
                         stream(R))
        LAUNCHES["sellr_flush"] += 1
    return y


def sellr_y(word, vals, smeta, gptr, gchunk, x, nchunks: int, stages: int,
            rolls) -> torch.Tensor:
    """SELLR's y plane: ``sellr_place``, then ``sellr_flush``."""
    return sellr_flush(sellr_place(word, vals, smeta, x, nchunks, stages,
                                   rolls), gptr, gchunk)
