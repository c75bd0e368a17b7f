"""SELLW: sublane-bound SpMV for matrices with column locality.

Counterpart of ``spmv_research_tpu/ops/sellw.py`` (SpMV): the ``SellW``
program, its builder with both packer tiers (carried over so that it emits
identical program arrays: the native ``sellw_pack2`` for G = 2 and fp32, the
Python packer otherwise), the float64 host executor ``execute_sellw_numpy``,
and two impls each of SpMV and SpMM:

* ``"cuda"`` — the hand-written kernels of ``sell_cuda.py`` (the pallas
  impls' counterparts; one kernel each for SpMV (B11) and SpMM (B12), each
  serving both the x-resident and the ``stream_wins`` program, since the
  card has no VMEM limit on x);
* ``"torch"`` — the same functions in plain PyTorch (SpMM: the SpMV's plain
  version column by column, like the JAX ``spmm_sellw_xla``).

Both impls end in the combine (``sell_cuda.sellw_combine``, kernel B12c,
and its plain version), which writes y, or Y (m, cols) row-major.

Layout (see the JAX module for the design): chunks of 8×128 slots, each
serving a group of ``G`` adjacent 128-row y blocks; each sublane is bound to
one x2d row ``wrow`` (x viewed as (x_rows, 128)). Word bits per slot:
[0,7) lane pick, [7,14) scan guards, [14,21) eidx, [21] emask, [22,25) bid.
The kernel writes G partial planes (plane g at rows [g·npad, (g+1)·npad)),
and the combine sums the ``K`` partial rows of each y block.

The constants ``CHUNK_PAD`` and ``_X_VMEM_LIMIT`` and the ``stream_wins``
flag are TPU-derived and kept so that the programs stay identical. With
``want_idx`` the builder also returns the source-index plane (the source
nnz of each slot, -1 where it is empty), on which the double-single build
(``sellw_ds.py``) places its lo value plane.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .clos_route import LANES, SUB
from .dispatch import register_spmm, register_spmv
from . import sell_cuda as K

CHUNK_PAD = 64          # chunks are padded to a multiple of this at build
_MAX_STAGES = 7         # parts ≤ 128 lanes
_X_VMEM_LIMIT = 1 << 20  # max n for the TPU's VMEM-resident x plane

DATA_FIELDS = ("word", "vals", "wrow", "yidx")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "nchunks", "x_rows", "K",
               "stages", "stream_wins", "G", "classes")


class SellWBuildError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class SellW:
    """SELLW program (field for field the JAX ``SellW``)."""

    word: torch.Tensor   # (8·nchunks_pad, 128) int32 packed per-slot word
    vals: torch.Tensor   # (8·nchunks_pad, 128) values (0 in padding)
    wrow: torch.Tensor   # (8·nchunks_pad,) int32 per-sublane x2d row
    yidx: torch.Tensor   # (K, nblocks) int32 partial row per y block
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    nchunks: int         # live chunks (≤ wrow.shape[0] // 8)
    x_rows: int          # x2d rows (≥ 1)
    K: int               # max chunks per y block
    stages: int          # segmented-scan stages = ceil(log2(max part len))
    stream_wins: bool = False  # n > _X_VMEM_LIMIT (the TPU streamed wins)
    G: int = 2           # y blocks grouped per chunk (bid bits = log2 G)
    # stage classes ((start_chunk, n_chunks, stages), ...): chunks sorted by
    # scan depth, each class run with only the stages it needs
    classes: Tuple[Tuple[int, int, int], ...] = ()

    format_name = "SELLW"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "SellW":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(self.word.numel() * 4
                   + self.vals.numel() * self.vals.element_size()
                   + self.wrow.numel() * 4 + self.yidx.numel() * 4)


def _guard_bits(k: int) -> np.ndarray:
    d = np.arange(k, dtype=np.uint32)
    g = np.zeros(k, np.uint32)
    for kk in range(_MAX_STAGES):
        g |= ((d >= (1 << kk)).astype(np.uint32) << kk)
    return g


def build_sellw(csr: HostCSR, dtype=np.float32,
                max_chunk_factor: float = 4.0, group: int = 2,
                part_cap: int = 8, want_idx: bool = False):
    """Compile host CSR into a SELLW program (carried over from the JAX
    builder: ``group`` = G y blocks per chunk, ``part_cap`` splits parts
    longer than the cap). Raises :class:`SellWBuildError` when columns are
    so scattered that the slot count would exceed ``max_chunk_factor`` ×
    nnz. x past ``_X_VMEM_LIMIT`` columns only sets ``stream_wins``. With
    ``want_idx`` returns ``(SellW, idx)``, idx the program's source-index
    plane (int32, the shape of ``vals``, -1 in empty slots)."""
    dt = np.dtype(dtype)
    G = int(group)
    cap = int(part_cap)
    if cap < 1 or cap > LANES or (cap & (cap - 1)):
        raise SellWBuildError(f"part_cap must be a power of two <= 128 ({cap})")
    if G not in (1, 2, 4, 8):
        raise SellWBuildError(f"group must be a power of two ≤ 8 ({G})")
    m, n, nnz = csr.m, csr.n, csr.nnz
    stream_wins = n > _X_VMEM_LIMIT
    if m == 0 or nnz == 0:
        raise SellWBuildError("empty matrix")
    x_rows = max((n + LANES - 1) // LANES, 1)
    nblocks = (m + LANES - 1) // LANES
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)

    # fast suitability precheck, sampled: chunks per block GROUP ≈
    # max(ceil(#distinct-x2d-rows / 8), ceil(nnz / 1024))
    est_slots = est_nnz = 0
    npairs_pre = (nblocks + G - 1) // G
    for b in range(0, npairs_pre, max(npairs_pre // 64, 1)):
        e0 = int(ia[b * G * LANES])
        e1 = int(ia[min((b + 1) * G * LANES, m)])
        if e0 == e1:
            continue
        nb = np.unique(ja[e0:e1] // LANES).size
        nch = max((nb + SUB - 1) // SUB,
                  (e1 - e0 + SUB * LANES - 1) // (SUB * LANES))
        est_slots += nch * SUB * LANES
        est_nnz += e1 - e0
    if est_nnz and est_slots > max_chunk_factor * 1.5 * est_nnz:
        raise SellWBuildError(
            f"estimated {est_slots / est_nnz:.1f} slots/nnz "
            "(no column locality — not a SELLW matrix)")

    chunk_cap = max(int(max_chunk_factor * (nnz / (SUB * LANES) + nblocks)
                        + 64), 64)

    # native packer tier (native/sparse_host.cpp sellw_pack2: the same
    # algorithm as the Python loop below, ~50x faster)
    from ..io import native as _native
    if _native.have_sellw_pack() and dt == np.float32 and G == 2:
        packed = _native.sellw_pack_native(ia, csr.ja,
                                           csr.a.astype(np.float32), m,
                                           part_cap=cap, want_idx=want_idx)
        word_n, vals_n, wrow_n, pair_n, bids_n, max_part = packed[:6]
        if pair_n.shape[0] > chunk_cap:
            raise SellWBuildError(
                f"chunk count {pair_n.shape[0]} exceeded {chunk_cap} "
                "(scattered columns)")
        return _emit_sellw(word_n.view(np.uint32), vals_n, wrow_n,
                           list(pair_n), [tuple(bool(b & (1 << g))
                                                for g in range(G))
                                          for b in bids_n],
                           max_part, m, n, nnz, csr.nnz_expanded, x_rows,
                           nblocks, dt, stream_wins, G,
                           idx_u=packed[6] if want_idx else None)

    wrow_l, word_l, vals_l, idx_l = [], [], [], []
    chunk_pair, chunk_bids = [], []
    gb_cache = {k: _guard_bits(k) for k in range(1, LANES + 1)}
    max_part = 1
    npairs = (nblocks + G - 1) // G

    for pb in range(npairs):
        r0, r1 = pb * G * LANES, min((pb + 1) * G * LANES, m)
        e0, e1 = int(ia[r0]), int(ia[r1])
        if e0 == e1:
            continue
        cols_b = ja[e0:e1]
        vals_b = csr.a[e0:e1].astype(dt)
        lens = ia[r0 + 1:r1 + 1] - ia[r0:r1]
        rowl_b = np.repeat(np.arange(r1 - r0), lens)   # 0..G·128-1 in group
        blk_b = cols_b // LANES
        # parts = maximal runs of equal (row, x2d row), ordered by (x2d row,
        # length desc) so each bin's sublanes fill first-fit
        pstart = np.flatnonzero(np.r_[True, (np.diff(rowl_b) != 0)
                                      | (np.diff(blk_b) != 0)])
        pend = np.append(pstart[1:], cols_b.size)
        plen = pend - pstart
        if cap < LANES and plen.size and int(plen.max()) > cap:
            n_pieces = (plen + cap - 1) // cap
            idx = np.repeat(np.arange(plen.size), n_pieces)
            within = (np.arange(idx.size)
                      - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces))
            pstart = pstart[idx] + within * cap
            pend = np.minimum(pstart + cap, pend[idx])
            plen = pend - pstart
        porder = np.lexsort((-plen, blk_b[pstart]))
        queue = list(porder)
        while queue:
            wd = np.zeros((SUB, LANES), np.uint32)
            ex = np.zeros((SUB, LANES), np.uint32)  # eidx/emask (ORed last:
            vv = np.zeros((SUB, LANES), dt)         # lanes overlap slots)
            iv = np.full((SUB, LANES), -1, np.int32)
            wr = np.zeros(SUB, np.int32)
            pos = [0] * SUB
            sub_of = {}         # x2d row -> open sublanes (in open order)
            next_s = 0
            bids = [False] * G
            defer = []
            for t in queue:
                p, q, k = int(pstart[t]), int(pend[t]), int(plen[t])
                r = int(blk_b[p])
                l = int(rowl_b[p])
                lane, bid = l & (LANES - 1), l >> 7
                s = -1
                for so in sub_of.get(r, ()):   # first fit, lane-conflict-free
                    if pos[so] + k <= LANES and not ex[so, lane]:
                        s = so
                        break
                if s < 0:
                    if next_s >= SUB:
                        defer.append(t)
                        continue
                    s, next_s = next_s, next_s + 1
                    sub_of.setdefault(r, []).append(s)
                    wr[s] = r
                wd[s, pos[s]:pos[s] + k] = (
                    (cols_b[p:q] % LANES).astype(np.uint32)
                    | (gb_cache[k] << 7))
                vv[s, pos[s]:pos[s] + k] = vals_b[p:q]
                iv[s, pos[s]:pos[s] + k] = np.arange(e0 + p, e0 + q,
                                                     dtype=np.int32)
                ex[s, lane] = np.uint32(((pos[s] + k - 1) << 14)
                                        | (1 << 21) | (bid << 22))
                pos[s] += k
                bids[bid] = True
                max_part = max(max_part, k)
            wd |= ex
            wrow_l.append(wr)
            word_l.append(wd)
            vals_l.append(vv)
            idx_l.append(iv)
            chunk_pair.append(pb)
            chunk_bids.append(tuple(bids))
            queue = defer
            if len(wrow_l) > chunk_cap:
                raise SellWBuildError(
                    f"chunk count exceeded {chunk_cap} (scattered columns)")

    word_u = (np.concatenate(word_l, axis=0) if wrow_l
              else np.zeros((0, LANES), np.uint32))
    vals_u = (np.concatenate(vals_l, axis=0) if wrow_l
              else np.zeros((0, LANES), dt))
    wrow_u = (np.concatenate(wrow_l) if wrow_l
              else np.zeros(0, np.int32))
    idx_u = (np.concatenate(idx_l, axis=0) if wrow_l
             else np.zeros((0, LANES), np.int32))
    return _emit_sellw(word_u, vals_u, wrow_u, chunk_pair, chunk_bids,
                       max_part, m, n, nnz, csr.nnz_expanded, x_rows,
                       nblocks, dt, stream_wins, G,
                       idx_u=idx_u if want_idx else None)


def _stage_classes(word_u, nchunks):
    """Per-chunk required scan depth from the packed guard bits, and a small
    set of contiguous classes (chunks sorted by depth): (perm, [(n_chunks,
    stages), ...])."""
    g = (word_u.view(np.uint32) >> 7) & 0x7F
    g_or = np.bitwise_or.reduce(g.reshape(nchunks, SUB * LANES), axis=1)
    stages_c = np.zeros(nchunks, np.int64)
    nz = g_or > 0
    stages_c[nz] = np.floor(np.log2(g_or[nz])).astype(np.int64) + 1
    perm = np.argsort(stages_c, kind="stable")
    counts = np.bincount(stages_c, minlength=_MAX_STAGES + 1)
    classes = [(int(c), s) for s, c in enumerate(counts) if c > 0]
    # merge small classes upward (higher stages win: extra stages are no-ops)
    merged = []
    for cnt, s in classes:
        if merged and (merged[-1][0] < 2 * CHUNK_PAD
                       or cnt < 2 * CHUNK_PAD):
            pc, _ = merged.pop()
            merged.append((pc + cnt, s))
        else:
            merged.append((cnt, s))
    return perm, merged


def _emit_sellw(word_u, vals_u, wrow_u, chunk_pair, chunk_bids, max_part,
                m, n, nnz, nnz_expanded, x_rows, nblocks, dt,
                stream_wins, G, idx_u=None):
    """Sort chunks into stage classes, pad per class, build yidx, assemble
    the program (shared tail of the native and Python packer tiers). With
    ``idx_u`` (the source-index plane, -1 in empty slots) returns
    ``(SellW, idx_padded)``, the plane laid out as ``vals``."""
    nchunks = len(chunk_pair)
    if nchunks:
        perm, klasses = _stage_classes(word_u, nchunks)
        word_u = word_u.reshape(nchunks, SUB, LANES)[perm].reshape(-1, LANES)
        vals_u = vals_u.reshape(nchunks, SUB, LANES)[perm].reshape(-1, LANES)
        wrow_u = wrow_u.reshape(nchunks, SUB)[perm].reshape(-1)
        if idx_u is not None:
            idx_u = idx_u.reshape(nchunks, SUB, LANES)[perm].reshape(
                -1, LANES)
        chunk_pair = [chunk_pair[p] for p in perm]
        chunk_bids = [chunk_bids[p] for p in perm]
    else:
        klasses = [(0, 0)]

    # lay classes out contiguously, each padded to a CHUNK_PAD multiple
    classes = []
    padded_pos = np.zeros(max(nchunks, 1), np.int64)
    npad = 0
    src = 0
    seg_src, seg_dst, seg_len = [], [], []
    for cnt, s in klasses:
        n_pad = ((cnt + CHUNK_PAD - 1) // CHUNK_PAD) * CHUNK_PAD
        if cnt:
            padded_pos[src: src + cnt] = npad + np.arange(cnt)
            seg_src.append(src)
            seg_dst.append(npad)
            seg_len.append(cnt)
        classes.append((npad, n_pad, s))
        npad += n_pad
        src += cnt
    npad = max(npad, CHUNK_PAD)

    word = np.zeros((npad * SUB, LANES), np.uint32)
    vals = np.zeros((npad * SUB, LANES), dt)
    wrow = np.zeros(npad * SUB, np.int32)
    idxp = (np.full((npad * SUB, LANES), -1, np.int32)
            if idx_u is not None else None)
    for s0, d0, ln in zip(seg_src, seg_dst, seg_len):
        word[d0 * SUB: (d0 + ln) * SUB] = word_u[s0 * SUB: (s0 + ln) * SUB]
        vals[d0 * SUB: (d0 + ln) * SUB] = vals_u[s0 * SUB: (s0 + ln) * SUB]
        wrow[d0 * SUB: (d0 + ln) * SUB] = wrow_u[s0 * SUB: (s0 + ln) * SUB]
        if idxp is not None:
            idxp[d0 * SUB: (d0 + ln) * SUB] = idx_u[s0 * SUB:
                                                    (s0 + ln) * SUB]

    # output rows: group-member g's partials live at [g·npad, (g+1)·npad),
    # the all-zero row at G·npad
    slot = np.zeros(max(nblocks, 1), np.int64)
    entries = []
    for c, (pb, bids) in enumerate(zip(chunk_pair, chunk_bids)):
        for bid in range(G):
            b = G * pb + bid
            if bids[bid] and b < nblocks:
                entries.append((b, int(padded_pos[c]) + bid * npad))
                slot[b] += 1
    K = max(int(slot.max()) if nblocks else 1, 1)
    if K > 64:
        raise SellWBuildError(f"y-block multiplicity {K} > 64")
    yidx = np.full((K, nblocks), G * npad, np.int32)   # G·npad = zero row
    slot[:] = 0
    for b, row in entries:
        yidx[slot[b], b] = row
        slot[b] += 1

    A = _sellw(dict(word=word.view(np.int32), vals=vals, wrow=wrow,
                    yidx=yidx),
               dict(shape=(m, n), nnz=nnz, nnz_expanded=nnz_expanded,
                    nchunks=nchunks, x_rows=x_rows, K=K,
                    stages=int(max_part - 1).bit_length(),
                    stream_wins=stream_wins, G=G, classes=tuple(classes)))
    return A if idxp is None else (A, idxp)


def _sellw(arrays: dict, meta: dict) -> SellW:
    """SellW from numpy program arrays and meta fields (on the CPU)."""
    return SellW(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                    for k in DATA_FIELDS}, **meta)


def sellw_from_jax(leaves: dict, meta: dict) -> SellW:
    """The port's ``SellW`` for a program built by the JAX package.

    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value, so both packages can run
    the identical program."""
    return _sellw({k: np.array(leaves[k]) for k in DATA_FIELDS},
                  {k: meta[k] for k in META_FIELDS})


# ---------------------------------------------------------------- execution

def class_plan(A: SellW):
    """((start_chunk, n_chunks, stages), ...) of the live stage classes, or
    one class over all chunks with the global stage count (as the JAX
    ``_class_plan``)."""
    nch = A.wrow.shape[0] // SUB
    cls = tuple(c for c in A.classes if c[1] > 0)
    return cls or ((0, nch, A.stages),)


@register_spmv("SELLW", "torch")
def spmv_sellw_torch(A: SellW, x: torch.Tensor) -> torch.Tensor:
    """SELLW in plain PyTorch, on any device (the kernel's plain version)."""
    planes = K.sellw_planes_torch(A.word, A.vals, A.wrow,
                                  x.to(A.vals.dtype), class_plan(A), A.G)
    return K.sellw_combine_torch(planes, A.yidx, A.m)


def _check_cuda(A: SellW, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"SELLW/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")


@register_spmv("SELLW", "cuda")
def spmv_sellw_cuda(A: SellW, x: torch.Tensor) -> torch.Tensor:
    """SELLW through the hand-written CUDA kernel (CUDA tensors only)."""
    _check_cuda(A, x)
    planes = K.sellw_planes(A.word, A.vals, A.wrow, x.to(A.vals.dtype),
                            class_plan(A), A.G, stream_wins=A.stream_wins)
    return K.sellw_combine(planes, A.yidx, A.m)


def _xt(A: SellW, X: torch.Tensor) -> torch.Tensor:
    return X.to(A.vals.dtype).t().contiguous()


@register_spmm("SELLW", "torch")
def spmm_sellw_torch(A: SellW, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in plain PyTorch: the SpMV's planes column by column, then
    one combine over all columns."""
    planes = K.sellw_spmm_planes_torch(A.word, A.vals, A.wrow, _xt(A, X),
                                       class_plan(A), A.G)
    return K.sellw_combine_torch(planes, A.yidx, A.m)


@register_spmm("SELLW", "cuda")
def spmm_sellw_cuda(A: SellW, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through the hand-written SpMM kernel (CUDA tensors only),
    for x-resident and ``stream_wins`` programs alike."""
    _check_cuda(A, X)
    planes = K.sellw_spmm_planes(A.word, A.vals, A.wrow, _xt(A, X),
                                 class_plan(A), A.G)
    return K.sellw_combine(planes, A.yidx, A.m)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def pick_scan_numpy(w: np.ndarray, vals, wrow: np.ndarray, x: np.ndarray,
                    x_rows: int, stages: int) -> np.ndarray:
    """float64 steps shared by both locality engines' host executors: the
    product x2d[wrow, lane]·val, ``stages`` guarded lane-scan stages, and
    the pick at eidx (``w`` is the uint32 word plane)."""
    x2d = np.zeros(x_rows * LANES)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(x_rows, LANES)
    v = (np.take_along_axis(x2d[wrow], (w & 0x7F).astype(np.int64), axis=1)
         * np.asarray(vals, np.float64))
    for k in range(stages):
        guard = ((w >> (7 + k)) & 1) != 0
        v = v + np.where(guard, np.roll(v, 1 << k, axis=1), 0.0)
    return np.take_along_axis(v, ((w >> 14) & 0x7F).astype(np.int64), axis=1)


def execute_sellw_numpy(A: SellW, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program (program semantics)."""
    nch = int(A.wrow.shape[0]) // SUB
    w = _np(A.word).view(np.uint32)
    E = pick_scan_numpy(w, _np(A.vals), _np(A.wrow), x, A.x_rows, A.stages)
    live = ((w >> 21) & 1) != 0
    bid = (w >> 22) & (A.G - 1)
    planes = [np.where(live & (bid == g), E, 0.0)
              .reshape(nch, SUB, LANES).sum(axis=1) for g in range(A.G)]
    outp = np.concatenate(planes + [np.zeros((1, LANES))], axis=0)
    y2 = outp[_np(A.yidx)].sum(axis=0)
    return y2.reshape(-1)[: A.m]
