"""SELLR: group-pure sublane-bound SpMV for matrices with column locality.

Counterpart of ``spmv_research_tpu/ops/sellr.py``: the ``SellR`` program,
its builder (pure Python in the JAX package too, carried over so that it
emits identical program arrays), the float64 host executor
``execute_sellr_numpy``, and two SpMV impls:

* ``"cuda"`` — the hand-written kernels of ``sell_cuda.py`` (the pallas
  impl's counterpart);
* ``"torch"`` — the same function in plain PyTorch.

Layout (see the JAX module for the design): rows in groups of 1024 (8 y2d
rows of 128 lanes); a chunk is 8 sublane lists of one group, each bound to
one x2d row. Word bits per slot: [0,7) lane pick, [7,14) scan guards,
[14,21) eidx, [21] emask, [22,25) roll r, [25] wrap. ``smeta`` holds, per
step of ``NB`` = 64 chunks, 1024 ints: [0,512) the sublane x2d rows,
[512,576) per chunk ``ybase<<1 | flush``, [576] the step's roll mask, [577]
its scan depth ``smax``.

The JAX kernel runs the chunks in order on one core and carries a run
accumulator from chunk to chunk, flushing it into the resident y at each
``flush`` chunk. GPU blocks run in parallel, so when a program is built or
carried over, ``_flush_order`` lists per y group its chunks in that order
with their flush bits (``gptr``/``gchunk``), and one block per group applies
them in turn: the sums are the JAX kernel's, deterministic, without atomics.

``NB``, ``SMEM_BLK`` and ``_XY_VMEM_ROWS`` are TPU-derived and kept so that
``build_best`` makes the same choices. ``sellr_pallas_raw``'s counterpart
(the raw-array entry of the distributed layer) waits for that layer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .clos_route import LANES, SUB
from .dispatch import register_spmv
from . import sell_cuda as K
from .sellw import _guard_bits, pick_scan_numpy

GROUP = SUB * LANES          # 1024 rows per group
NB = K.SELLR_NB              # chunks per step (64)
SMEM_BLK = K.SELLR_SMEM_BLK  # smeta ints per step (1024)
_XY_VMEM_ROWS = 1 << 14      # x2d/y2d rows each ≤ 16384 (the TPU's VMEM)

DATA_FIELDS = ("word", "vals", "smeta")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "nchunks", "x_rows",
               "y_rows", "stages", "rolls")


class SellRBuildError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class SellR:
    """SELLR program (field for field the JAX ``SellR``).

    ``gptr``/``gchunk`` are not part of the JAX program: they are derived
    from ``smeta`` on the host (:func:`_flush_order`)."""

    word: torch.Tensor    # (8·nch_pad, 128) int32 packed per-slot word
    vals: torch.Tensor    # (8·nch_pad, 128) fp32 values (0 in padding)
    smeta: torch.Tensor   # (nsteps·1024,) int32 per-step metadata
    gptr: torch.Tensor    # (y_rows/8 + 1,) int32 derived, see _flush_order
    gchunk: torch.Tensor  # (nchunks,) int32 derived: chunk<<1 | flush
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    nchunks: int          # live chunks
    x_rows: int           # x2d rows (≥ 1)
    y_rows: int           # y2d rows incl. pad to multiple of 8
    stages: int           # segmented-scan stages
    rolls: Tuple[Tuple[int, int], ...]  # static (r, wrap) roll set, r>0

    format_name = "SELLR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "SellR":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(self.word.numel() * 4
                   + self.vals.numel() * self.vals.element_size()
                   + self.smeta.numel() * 4)


def build_sellr(csr: HostCSR, dtype=np.float32,
                max_slot_factor: float = 3.0) -> SellR:
    """Compile host CSR into a SELLR program.

    Raises :class:`SellRBuildError` when the matrix has no column locality
    (estimated slots/nnz > ``max_slot_factor``) or exceeds the residency
    limits for x/y."""
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    if m == 0 or nnz == 0:
        raise SellRBuildError("empty matrix")
    x_rows = max((n + LANES - 1) // LANES, 1)
    ngroups = (m + GROUP - 1) // GROUP
    y_rows = ngroups * SUB
    if x_rows > _XY_VMEM_ROWS or y_rows > _XY_VMEM_ROWS:
        raise SellRBuildError(
            f"x_rows={x_rows} / y_rows={y_rows} exceed VMEM residency "
            f"limit {_XY_VMEM_ROWS}")
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)

    # fast suitability precheck (sampled): slots/group ≈ Σ_bins
    # (binlen + 64): scattered matrices degenerate to ~128 slots/nnz.
    est_slots = est_nnz = 0
    for g in range(0, ngroups, max(ngroups // 64, 1)):
        e0 = int(ia[g * GROUP])
        e1 = int(ia[min((g + 1) * GROUP, m)])
        if e0 == e1:
            continue
        xr, cnt = np.unique(ja[e0:e1] // LANES, return_counts=True)
        est_slots += int(np.ceil(cnt / LANES).sum()) * LANES
        est_nnz += e1 - e0
    if est_nnz and est_slots > max_slot_factor * est_nnz:
        raise SellRBuildError(
            f"estimated {est_slots / est_nnz:.1f} slots/nnz "
            "(no column locality — not a SELLR matrix)")

    gb_cache = {k: _guard_bits(k) for k in range(1, LANES + 1)}
    word_l, vals_l, wrow_l = [], [], []       # per sublane (128,) arrays
    chunk_of = []                             # per chunk: group id
    chunk_smax_l = []                         # per chunk: scan stages needed
    max_part = 1

    a32 = csr.a.astype(dt)
    for g in range(ngroups):
        r0, r1 = g * GROUP, min((g + 1) * GROUP, m)
        e0, e1 = int(ia[r0]), int(ia[r1])
        if e0 == e1:
            continue
        cols = ja[e0:e1]
        vals_b = a32[e0:e1]
        lens = (ia[r0 + 1:r1 + 1] - ia[r0:r1]).astype(np.int64)
        rowl = np.repeat(np.arange(r1 - r0, dtype=np.int64), lens)
        xrow = cols >> 7
        lane = (cols & 127).astype(np.uint32)
        # parts: maximal runs of (rowl, xrow), split at 128
        brk = np.flatnonzero(np.r_[True, (np.diff(rowl) != 0)
                                   | (np.diff(xrow) != 0)])
        pstart = brk
        pend = np.append(brk[1:], cols.size)
        plen = pend - pstart
        if plen.max(initial=0) > LANES:
            ps, pe = [], []
            for s, e in zip(pstart, pend):
                while e - s > LANES:
                    ps.append(s)
                    pe.append(s + LANES)
                    s += LANES
                ps.append(s)
                pe.append(e)
            pstart = np.array(ps, np.int64)
            pend = np.array(pe, np.int64)
            plen = pend - pstart
        # bin by xrow; within bin by target sublane (tsrow), longest first
        order = np.lexsort((-plen, rowl[pstart] >> 7, xrow[pstart]))
        sub_words, sub_vals, sub_wrow = [], [], []   # this group's sublanes
        sub_tcnt, sub_maxp = [], []                  # tsrow histogram, max k
        open_pos, open_taken, open_idx = [], [], []  # current bin's subs
        cur_xrow = -1
        for t in order:
            p, e = int(pstart[t]), int(pend[t])
            k = e - p
            xr = int(xrow[p])
            rl = int(rowl[p])
            tlane = rl & 127
            tsrow = rl >> 7
            if xr != cur_xrow:
                cur_xrow = xr
                open_pos, open_taken, open_idx = [], [], []
            s = -1
            # first fit over the newest 2 open sublanes only (keeps lists
            # tsrow-pure, so per-step roll masks stay small)
            for q in range(max(0, len(open_pos) - 2), len(open_pos)):
                if open_pos[q] + k <= LANES and not (
                        open_taken[q] >> tlane) & 1:
                    s = q
                    break
            if s < 0:
                open_pos.append(0)
                open_taken.append(0)
                open_idx.append(len(sub_words))
                sub_words.append(np.zeros(LANES, np.uint32))
                sub_vals.append(np.zeros(LANES, dt))
                sub_wrow.append(xr)
                sub_tcnt.append([0] * SUB)
                sub_maxp.append(1)
                s = len(open_pos) - 1
            si = open_idx[s]
            pos = open_pos[s]
            # |= : slot bits [0,14) are written once per slot; other parts'
            # eidx/emask/roll bits [14,26) may already live at these lanes
            sub_words[si][pos:pos + k] |= lane[p:e] | (gb_cache[k] << 7)
            sub_vals[si][pos:pos + k] = vals_b[p:e]
            sub_words[si][tlane] |= np.uint32(((pos + k - 1) << 14)
                                              | (1 << 21))
            open_pos[s] = pos + k
            open_taken[s] |= 1 << tlane
            max_part = max(max_part, k)
            sub_tcnt[si][tsrow] += 1
            sub_maxp[si] = max(sub_maxp[si], k)
            # staging: tsrow now, roll bits fixed at pack time
            sub_words[si][tlane] |= np.uint32(tsrow << 22)
        # pack this group's sublane lists into group-pure chunks, each list
        # at the sublane of its modal tsrow when free
        nsub = len(sub_words)
        buckets = [[] for _ in range(SUB)]
        for si in range(nsub):
            buckets[int(np.argmax(sub_tcnt[si]))].append(si)
        rr_order = []
        bi = [0] * SUB
        while len(rr_order) < nsub:
            for b in range(SUB):
                if bi[b] < len(buckets[b]):
                    rr_order.append(buckets[b][bi[b]])
                    bi[b] += 1
        for c0 in range(0, nsub, SUB):
            members = [rr_order[q] for q in range(c0, min(c0 + SUB, nsub))]
            modal = {si: int(np.argmax(sub_tcnt[si])) for si in members}
            slot_of = {}
            taken_s = [False] * SUB
            for si in sorted(members, key=lambda q: -max(sub_tcnt[q])):
                want = modal[si]
                for d in range(SUB):
                    s = (want + d) % SUB
                    if not taken_s[s]:
                        taken_s[s] = True
                        slot_of[si] = s
                        break
            chunk_smax = 0
            for s in range(SUB):
                si = next((q for q in members if slot_of[q] == s), None)
                if si is not None:
                    wd = sub_words[si]
                    # rewrite bits [22,26): r = (tsrow - s) mod 8, wrap
                    em = (wd >> 21) & 1
                    tsrow_v = (wd >> 22) & 0x7
                    r = (tsrow_v - s) % 8
                    wrap = ((s + r) >= SUB).astype(np.uint32)
                    wd = (wd & np.uint32((1 << 22) - 1)) | (r << 22) \
                        | (wrap << 25)
                    wd &= np.uint32(0x03FFFFFF)
                    # dead eidx entries keep bits zero
                    wd = np.where(em == 1, wd,
                                  wd & np.uint32(~(0xFFF << 14) & 0xFFFFFFFF))
                    word_l.append(wd)
                    vals_l.append(sub_vals[si])
                    wrow_l.append(sub_wrow[si])
                    chunk_smax = max(chunk_smax,
                                     int(sub_maxp[si] - 1).bit_length())
                else:
                    word_l.append(np.zeros(LANES, np.uint32))
                    vals_l.append(np.zeros(LANES, dt))
                    wrow_l.append(0)
            chunk_of.append(g)
            chunk_smax_l.append(chunk_smax)

    nchunks = len(chunk_of)
    if nchunks == 0:
        raise SellRBuildError("no chunks built")

    # quarantine "dirty" chunks (any part with |dist| > 1) at the tail: they
    # flush one by one; clean steps then need only the {+1, -1} rolls
    words_c = [np.stack(word_l[c * SUB:(c + 1) * SUB]) for c in range(nchunks)]
    vals_c = [np.stack(vals_l[c * SUB:(c + 1) * SUB]) for c in range(nchunks)]
    wrow_c = [wrow_l[c * SUB:(c + 1) * SUB] for c in range(nchunks)]
    clean_codes = {0, 1 | (0 << 3), 7 | (1 << 3)}

    def is_dirty(c):
        wd = words_c[c]
        em = ((wd >> 21) & 1) == 1
        codes = set(np.unique(((wd >> 22) & 0xF)[em]).tolist())
        return bool(codes - clean_codes)

    dirty = [c for c in range(nchunks) if is_dirty(c)]
    clean = [c for c in range(nchunks) if c not in set(dirty)]
    order_c = clean + dirty
    flush_c = np.zeros(nchunks, np.int32)
    for j, c in enumerate(order_c):
        if j < len(clean):
            nxt = order_c[j + 1] if j + 1 < len(clean) else -1
            flush_c[j] = 1 if (nxt < 0 or chunk_of[nxt] != chunk_of[c]) else 0
        else:
            flush_c[j] = 1
    word_l = [words_c[c][s] for c in order_c for s in range(SUB)]
    vals_l = [vals_c[c][s] for c in order_c for s in range(SUB)]
    wrow_l = [wrow_c[c][s] for c in order_c for s in range(SUB)]
    chunk_of = [chunk_of[c] for c in order_c]
    chunk_smax_l = [chunk_smax_l[c] for c in order_c]
    if nchunks * SUB * LANES > max_slot_factor * max(nnz, 1) * 4 + 65536:
        raise SellRBuildError(
            f"{nchunks * SUB * LANES / nnz:.1f} slots/nnz after build")
    nsteps = (nchunks + NB - 1) // NB
    nch_pad = nsteps * NB
    word = np.zeros((nch_pad * SUB, LANES), np.uint32)
    vals = np.zeros((nch_pad * SUB, LANES), dt)
    word[: nchunks * SUB] = np.stack(word_l)
    vals[: nchunks * SUB] = np.stack(vals_l)
    wrow = np.zeros(nch_pad * SUB, np.int32)
    wrow[: nchunks * SUB] = np.array(wrow_l, np.int32)

    # roll set (static, from live eidx entries) + per-STEP activation mask
    em = (word >> 21) & 1
    rcode_all = np.where(em == 1, ((word >> 22) & 0xF), 0)
    pairs = sorted({(int(c & 7), int(c >> 3))
                    for c in np.unique(rcode_all).tolist()} - {(0, 0)})
    rolls = tuple(pairs)
    code_to_bit = {r | (w << 3): j for j, (r, w) in enumerate(rolls)}

    # smeta: per step 1024 ints: [0,512) sublane wrows; [512,576) chunk meta
    smeta = np.zeros(nsteps * SMEM_BLK, np.int32)
    chunk_of_a = np.array(chunk_of + [-1] * (nch_pad - nchunks))
    live = chunk_of_a >= 0
    flush = np.zeros(nch_pad, np.int32)
    flush[:nchunks] = flush_c
    ybase = np.maximum(chunk_of_a, 0) * SUB
    cmeta = np.where(live, (ybase << 1) | flush, 0).astype(np.int32)
    chunk_smax_a = np.array(chunk_smax_l + [0] * (nch_pad - nchunks),
                            np.int32)
    for i in range(nsteps):
        smeta[i * SMEM_BLK: i * SMEM_BLK + NB * SUB] = \
            wrow[i * NB * SUB: (i + 1) * NB * SUB]
        smeta[i * SMEM_BLK + NB * SUB: i * SMEM_BLK + NB * SUB + NB] = \
            cmeta[i * NB: (i + 1) * NB]
        rc = rcode_all[i * NB * SUB * LANES // LANES:
                       (i + 1) * NB * SUB]  # rows of this step
        mask = 0
        for c in np.unique(rc).tolist():
            if c in code_to_bit:
                mask |= 1 << code_to_bit[c]
        smeta[i * SMEM_BLK + NB * SUB + NB] = mask
        smeta[i * SMEM_BLK + NB * SUB + NB + 1] = int(
            chunk_smax_a[i * NB:(i + 1) * NB].max(initial=0))

    return _sellr(dict(word=word.view(np.int32), vals=vals, smeta=smeta),
                  dict(shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
                       nchunks=nchunks, x_rows=x_rows, y_rows=y_rows,
                       stages=int(max_part - 1).bit_length(), rolls=rolls))


def _chunk_meta(smeta: np.ndarray) -> np.ndarray:
    """Per chunk ``ybase<<1 | flush`` (smeta's [512,576) of each step)."""
    return smeta.reshape(-1, SMEM_BLK)[:, NB * SUB: NB * SUB + NB].reshape(-1)


def _flush_order(smeta: np.ndarray, nchunks: int, y_rows: int) -> tuple:
    """Per y group, its chunks in the JAX kernel's order: ``(gptr, gchunk)``.

    The JAX kernel walks the chunks in order with one run accumulator: each
    chunk adds its plane into it, and a chunk with the flush bit adds the
    run into y at its ``ybase`` and clears it. The builder keeps a run within
    one group, so per group the chunks are listed in order, each as
    ``chunk<<1 | flush``, and one GPU block per group replays them."""
    cmeta = _chunk_meta(np.asarray(smeta))[:nchunks].astype(np.int64)
    group, flush = (cmeta >> 1) // SUB, cmeta & 1
    ngroups = y_rows // SUB
    run_broken = (flush[:-1] == 0) & (group[1:] != group[:-1])
    if np.any(run_broken) or (nchunks and flush[-1] == 0):
        raise SellRBuildError("a SELLR run spans y groups or is never "
                              "flushed")
    order = np.argsort(group, kind="stable")      # keeps chunk order per group
    gchunk = ((order << 1) | flush[order]).astype(np.int32)
    counts = np.bincount(group, minlength=ngroups)
    gptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return gptr, gchunk


def _sellr(arrays: dict, meta: dict) -> SellR:
    """SellR from numpy program arrays and meta fields (on the CPU)."""
    gptr, gchunk = _flush_order(arrays["smeta"], meta["nchunks"],
                                meta["y_rows"])
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in DATA_FIELDS}
    return SellR(**t, gptr=torch.from_numpy(gptr),
                 gchunk=torch.from_numpy(gchunk), **meta)


def sellr_from_jax(leaves: dict, meta: dict) -> SellR:
    """The port's ``SellR`` for a program built by the JAX package (data
    fields as ``np.asarray`` of the JAX leaves, meta fields as values)."""
    return _sellr({k: np.array(leaves[k]) for k in DATA_FIELDS},
                  {k: meta[k] for k in META_FIELDS})


# ---------------------------------------------------------------- execution

def _args(A: SellR, x: torch.Tensor) -> tuple:
    return (A.word, A.vals, A.smeta, A.gptr, A.gchunk, x.to(A.vals.dtype),
            A.nchunks, A.stages, A.rolls)


@register_spmv("SELLR", "torch")
def spmv_sellr_torch(A: SellR, x: torch.Tensor) -> torch.Tensor:
    """SELLR in plain PyTorch, on any device (the kernels' plain versions)."""
    return K.sellr_y_torch(*_args(A, x)).reshape(-1)[: A.m]


@register_spmv("SELLR", "cuda")
def spmv_sellr_cuda(A: SellR, x: torch.Tensor) -> torch.Tensor:
    """SELLR through the hand-written CUDA kernels (CUDA tensors only)."""
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"SELLR/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")
    return K.sellr_y(*_args(A, x)).reshape(-1)[: A.m]


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def execute_sellr_numpy(A: SellR, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program semantics."""
    nch = int(A.word.shape[0]) // SUB
    nsteps = nch // NB
    smeta = _np(A.smeta).reshape(nsteps, SMEM_BLK)
    wrow = smeta[:, : NB * SUB].reshape(-1)
    cmeta = smeta[:, NB * SUB: NB * SUB + NB].reshape(-1)
    w = _np(A.word).view(np.uint32)
    E = pick_scan_numpy(w, _np(A.vals), wrow, x, A.x_rows, A.stages)
    live = ((w >> 21) & 1) != 0
    P = np.where(live, E, 0.0)
    rcode = (w >> 22) & 0xF
    R = np.where(live & (rcode == 0), P, 0.0)
    for (r, wrap) in A.rolls:
        mask = live & (rcode == (r | (wrap << 3)))
        Q = np.where(mask, P, 0.0).reshape(nch, SUB, LANES)
        R = R + np.roll(Q, r, axis=1).reshape(nch * SUB, LANES)
    y2 = np.zeros((A.y_rows, LANES))
    for c in range(nch):
        yb = int(cmeta[c]) >> 1
        y2[yb: yb + SUB] += R[c * SUB: (c + 1) * SUB]
    return y2.reshape(-1)[: A.m]
