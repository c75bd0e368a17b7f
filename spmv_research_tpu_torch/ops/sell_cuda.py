"""The column-locality engines' CUDA kernels: wrappers and plain versions.

Counterpart of the Pallas kernels of ``spmv_research_tpu/ops/sellw.py`` and
``spmv_research_tpu/ops/sellr.py`` (sources and design notes in
``csrc/sell.cu``):

================  =========================================================
wrapper           replaces
================  =========================================================
``sellw_planes``  ``sellw.py:_sellw_kernel`` and ``:_sellw_stream_kernel``
                  (one launch per stage class; one kernel for both program
                  kinds, counted apart: ``sellw`` and ``sellw_stream``)
``sellr_place``   ``sellr.py:_sellr_kernel``, with ``sellr_flush``: the
                  placed chunk planes R
``sellr_flush``   the run-flush of R into y, one block per y group in the
                  order the host listed
================  =========================================================

``sellr_y`` chains the two SELLR wrappers. Each wrapper takes the kernels'
plain PyTorch version (``*_torch``) only when its tensors lie on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts the kernel launches, beside each launch. The plain
versions add in the kernels' order
(sublanes 0..7 in turn, the roll sources by r, the run-flush chunk by
chunk), so on the card kernel and plain version agree exactly. SELLW's
``_combine_y`` (an XLA gather + sum in the JAX package) stays PyTorch.

The kernels are compiled by ``nvcc`` from ``csrc/sell.cu`` at first CUDA use
(``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .clos_route import LANES, SUB
from .cuda_lib import CudaLib, check, on_cuda, stream

SELLR_NB = 64            # SELLR chunks per smeta step
SELLR_SMEM_BLK = 1024    # smeta ints per step

LAUNCHES = {"sellw": 0, "sellw_stream": 0, "sellr_place": 0,
            "sellr_flush": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sellw_spmv.argtypes = [p, p, p, p, i64, p, i64, i64, i64, i32, i32,
                               p]
    lib.sellr_place.argtypes = [p, p, p, p, i64, p, i64, i32, p]
    lib.sellr_flush.argtypes = [p, p, p, p, i32, p]
    for fn in (lib.sellw_spmv, lib.sellr_place, lib.sellr_flush):
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
    check(x, "x", torch.float32, (x.shape[0],))
    if S % SUB:
        raise ValueError(f"{S} sublanes is not a whole number of chunks")
    return S // SUB


def sellw_planes(word, vals, wrow, x, classes: Sequence[Tuple[int, int, int]],
                 G: int, stream_wins: bool = False) -> torch.Tensor:
    """SELLW's G partial planes (the kernel; see ``sellw_planes_torch``).
    ``stream_wins`` names the program kind for the launch count only: the
    kernel is the same."""
    if not on_cuda(word, vals, wrow, x):
        return sellw_planes_torch(word, vals, wrow, x, classes, G)
    npad = _check_chunks(word, vals, wrow, x)
    check(wrow, "wrow", torch.int32, (npad * SUB,))
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
    out = torch.empty((G * npad + 1, LANES), dtype=vals.dtype,
                      device=vals.device)
    out[-1].zero_()
    if covered < npad:
        out[:-1].view(G, npad, LANES)[:, covered:].zero_()
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
