"""ILU(0) / IC(0) factorization and level-scheduled sparse triangular
solves.

Counterpart of ``spmv_research_tpu/solvers/ilu.py``. The host code is the
JAX package's: the three schedule builders carried over unchanged but for
the value type (a torch dtype) and the device their arrays go to (the card
unless the caller asks for the CPU), and the numeric factorizations
(``ilu0``, ``ic0``) as its row sweeps with each row's pattern work done at
once, about 3× faster on a 2000-row twin of shipsec1 and with the same
float64 operations in the same order; factors and schedules equal the JAX
package's. The JAX package solves in XLA, outside any Pallas kernel, so
the port's solves are plain PyTorch, no hand-written kernel:

* a ``lax.scan`` over levels or chunks becomes a Python loop over the
  schedule's device tensors, one step a level, chunk or block, with no
  host read inside it (a step's scalars are one-element tensors, its
  branches ``torch.where``);
* ``jax.ops.segment_sum`` becomes ``index_add_``, whose order on the card
  (atomics) is not fixed, so the solves match the JAX package's within a
  tolerance, not bit for bit;
* the band solve's block products are ``torch.mv`` in float32 (cuBLAS
  gemv on the card, no TF32 path; the port never turns TF32 on), where
  the JAX package leaves them to XLA at its default precision;
* a zero diagonal in the band-block build raises ``BandScheduleError``, so
  that ``build_schedule`` falls back to the level schedules (the JAX
  package raises a plain ``ValueError`` there, which its fallback does not
  catch).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.host import HostCSR, INDEX_DTYPE

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type of a schedule's values (float32 or float64)."""
    if dtype not in _NP_DTYPES:
        raise ValueError(f"schedules hold float32 or float64 values, not "
                         f"{dtype}")
    return np.dtype(_NP_DTYPES[dtype])


def _ranges(starts: np.ndarray, lens: np.ndarray):
    """The positions of the ranges [starts[t], starts[t] + lens[t]), in
    order, and the range t each belongs to."""
    seg = np.repeat(np.arange(lens.size), lens)
    first = np.cumsum(lens) - lens
    return starts[seg] + np.arange(int(lens.sum())) - first[seg], seg


def ilu0(csr: HostCSR) -> Tuple[HostCSR, HostCSR]:
    """ILU(0): incomplete LU with zero fill-in on the pattern of A.

    Returns (L, U): L unit-lower-triangular (diagonal ones stored), U upper
    triangular. Host numeric (IKJ variant restricted to the sparsity
    pattern): the JAX package's row sweep, each row's pattern work (which
    entries of row i the upper part of each row k < i updates) found for
    the whole row at once, then the same float64 operations in the same
    order, so the factors are the JAX package's bit for bit.
    """
    if csr.m != csr.n:
        raise ValueError("ILU0 requires square matrix")
    m = csr.m
    ia, ja = csr.ia.astype(np.int64), csr.ja.astype(np.int64)
    a = csr.a.astype(np.float64).copy()

    diag_ptr = [-1] * m
    for i in range(m):
        s, e = int(ia[i]), int(ia[i + 1])
        row_cols = ja[s:e]
        # the factor step runs over the leading entries k < i
        ge = np.flatnonzero(row_cols >= i)
        nl = int(ge[0]) if ge.size else e - s
        if nl:
            ks = row_cols[:nl]
            # for each k, the entries of row k right of k that row i holds
            src, seg = _ranges(ia[ks], ia[ks + 1] - ia[ks])
            kc = ja[src]
            up = kc > ks[seg]
            src, seg, kc = src[up], seg[up], kc[up]
            pos = np.clip(np.searchsorted(row_cols, kc), 0,
                          row_cols.size - 1)
            hit = row_cols[pos] == kc
            src, tgt = src[hit], s + pos[hit]
            bounds = np.searchsorted(seg[hit], np.arange(nl + 1)).tolist()
            for t, k in enumerate(ks.tolist()):
                # a[i,k] /= u[k,k]
                dk = diag_ptr[k]
                if dk < 0 or a[dk] == 0.0:
                    raise ZeroDivisionError(f"zero pivot at row {k}")
                a[s + t] /= a[dk]
                # a[i,j] -= l[i,k] * u[k,j] for j > k on row i's pattern
                o0, o1 = bounds[t], bounds[t + 1]
                if o1 > o0:
                    a[tgt[o0:o1]] -= a[s + t] * a[src[o0:o1]]
        dp = int(np.searchsorted(row_cols, i))
        if dp < row_cols.size and row_cols[dp] == i:
            diag_ptr[i] = s + dp
        else:
            raise ValueError(f"missing diagonal in row {i} (run fix_diagonal_zeros)")
        # pivot perturbation (SuperLU-style): a vanishing U diagonal makes
        # later L entries explode -> fp32 inf/NaN in the level schedule
        # (the raefsky3 twin's trisolve gave NaN). Floor the
        # pivot at 1e-4 x the row scale; ILU0 is approximate anyway and a
        # perturbed preconditioner beats a NaN one.
        dv = a[diag_ptr[i]]
        row_scale = float(np.max(np.abs(a[s:e]))) or 1.0
        tiny = 1e-4 * row_scale
        if abs(dv) < tiny:
            a[diag_ptr[i]] = tiny if dv >= 0.0 else -tiny

    # split into L (strict lower + unit diag) and U (diag + upper)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.row_lengths())
    lower = rows > ja
    upper = rows <= ja
    L = _from_triplets(rows[lower], ja[lower], a[lower], m, add_unit_diag=True)
    U = _from_triplets(rows[upper], ja[upper], a[upper], m, add_unit_diag=False)
    return L, U


def ic0(csr: HostCSR) -> HostCSR:
    """IC(0): incomplete Cholesky on the lower-triangular pattern of SPD A.
    Returns L with A ≈ L·Lᵀ.

    The JAX package's row sweep on A's lower pattern (rows sorted, as
    ``HostCSR`` keeps them): for each row i and each j <= i in order,
    s = a[i,j] minus l[i,k]·l[j,k] over the k < j that rows i and j share,
    subtracted one at a time in increasing k, then l[i,j] = s / l[j,j]
    (or sqrt(s) on the diagonal). The shared k of every j of a row are
    found at once; the float64 operations and their order are the JAX
    package's, so L equals its L bit for bit.
    """
    if csr.m != csr.n:
        raise ValueError("IC0 requires square matrix")
    m = csr.m
    ia, ja = csr.ia.astype(np.int64), csr.ja.astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), csr.row_lengths())
    if np.any((np.diff(ja) <= 0) & (rows[1:] == rows[:-1])):
        raise ValueError("IC0 needs each row's columns sorted and unique")
    low = ja <= rows
    lr, lc = rows[low], ja[low]
    lia = np.zeros(m + 1, dtype=np.int64)
    np.add.at(lia, lr + 1, 1)
    np.cumsum(lia, out=lia)
    lv = csr.a.astype(np.float64)[low].tolist()
    cols = lc.tolist()
    for i in range(m):
        a0, a1 = int(lia[i]), int(lia[i + 1])
        ci = lc[a0:a1]
        # step t (j = ci[t]): the k < j of row j that row i holds
        q, seg = _ranges(lia[ci], lia[ci + 1] - lia[ci])
        kc = lc[q]
        keep = kc < ci[seg]
        q, seg, kc = q[keep], seg[keep], kc[keep]
        p = np.clip(np.searchsorted(ci, kc), 0, max(ci.size - 1, 0))
        hit = ci[p] == kc
        pi, pj = (a0 + p[hit]).tolist(), q[hit].tolist()
        bounds = np.searchsorted(seg[hit], np.arange(ci.size + 1)).tolist()
        for t in range(a1 - a0):
            j = cols[a0 + t]
            s = lv[a0 + t]
            for r in range(bounds[t], bounds[t + 1]):
                s -= lv[pi[r]] * lv[pj[r]]
            if j < i:
                dj = int(lia[j + 1]) - 1
                if dj < lia[j] or cols[dj] != j:
                    raise KeyError(j)          # row j has no diagonal
                lv[a0 + t] = s / lv[dj]
            else:
                if s <= 0:
                    raise ValueError(f"IC0 breakdown at row {i} (not SPD enough)")
                lv[a0 + t] = float(np.sqrt(s))
    return _from_triplets(lr, lc, np.array(lv), m, add_unit_diag=False)


def _from_triplets(rows, cols, vals, m, add_unit_diag: bool) -> HostCSR:
    if add_unit_diag:
        rows = np.concatenate([rows, np.arange(m, dtype=np.int64)])
        cols = np.concatenate([cols, np.arange(m, dtype=np.int64)])
        vals = np.concatenate([vals, np.ones(m)])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    ia = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ia, rows + 1, 1)
    np.cumsum(ia, out=ia)
    return HostCSR(a=vals, ia=ia.astype(INDEX_DTYPE),
                   ja=cols.astype(INDEX_DTYPE), m=m, n=m)


# ---------------------------------------------------------------- trisolve

class SchedulePaddingError(ValueError):
    """Dense level schedule would exceed the padding budget."""


@dataclasses.dataclass
class LevelSchedule:
    """Level-scheduled triangular structure, padded uniform per level."""

    rows: torch.Tensor      # (n_levels, R) row ids (pad: m)
    cols: torch.Tensor      # (n_levels, R, W) off-diag column ids (pad: 0)
    vals: torch.Tensor      # (n_levels, R, W) off-diag values (pad: 0)
    inv_diag: torch.Tensor  # (n_levels, R) 1/diag per row (pad: 0)
    n_levels: int
    m: int
    lower: bool


def build_level_schedule(T: HostCSR, lower: bool = True,
                         dtype=torch.float32,
                         device="cuda") -> LevelSchedule:
    """Compute dependency levels: level(i) = 1 + max(level(j)) over off-diag
    neighbours j of row i (j < i for lower, j > i for upper)."""
    m = T.m
    ia, ja = T.ia.astype(np.int64), T.ja.astype(np.int64)
    vals = T.a.astype(np.float64)
    level = np.zeros(m, dtype=np.int64)
    row_iter = range(m) if lower else range(m - 1, -1, -1)
    for i in row_iter:
        s, e = ia[i], ia[i + 1]
        nb = ja[s:e]
        nb = nb[nb < i] if lower else nb[nb > i]
        if nb.size:
            level[i] = level[nb].max() + 1
    n_levels = int(level.max()) + 1 if m else 1

    # group rows by level
    order = np.argsort(level, kind="stable")
    counts = np.bincount(level, minlength=n_levels)
    R = int(counts.max()) if m else 1
    lengths = T.row_lengths()
    offd = lengths - 1  # off-diagonal count per row (diag always present)
    W = max(int(offd.max()) if m else 0, 1)

    # the dense (n_levels, R, W) padding explodes on scattered matrices
    # with deep dependency chains (the scircuit twin's schedule reached
    # tens of GB) — refuse with a clean error so build_schedule falls back
    # to the chunked formulation. Bound computed from the real dtypes.
    val_isz = _np_dtype(dtype).itemsize
    idx_isz = np.dtype(INDEX_DTYPE).itemsize
    pad_bytes = n_levels * R * (W * (idx_isz + val_isz)
                                + 2 * idx_isz + val_isz)
    if pad_bytes > (1 << 28):
        raise SchedulePaddingError(
            f"level schedule too padded ({pad_bytes / 1e9:.1f} GB: "
            f"{n_levels} levels x {R} rows x {W} width) — use the chunked "
            "schedule (build_schedule falls back automatically)")

    rows_arr = np.full((n_levels, R), m, dtype=INDEX_DTYPE)
    cols_arr = np.zeros((n_levels, R, W), dtype=INDEX_DTYPE)
    vals_arr = np.zeros((n_levels, R, W), dtype=np.float64)
    invd_arr = np.zeros((n_levels, R), dtype=np.float64)
    fill = np.zeros(n_levels, dtype=np.int64)
    for i in order:
        lv = level[i]
        r = fill[lv]
        fill[lv] += 1
        rows_arr[lv, r] = i
        s, e = ia[i], ia[i + 1]
        w = 0
        diag = None
        for idx in range(s, e):
            j = ja[idx]
            if j == i:
                diag = vals[idx]
            else:
                cols_arr[lv, r, w] = j
                vals_arr[lv, r, w] = vals[idx]
                w += 1
        if diag is None or diag == 0.0:
            raise ValueError(f"missing/zero diagonal at row {i}")
        invd_arr[lv, r] = 1.0 / diag

    return LevelSchedule(
        rows=torch.as_tensor(rows_arr, device=device),
        cols=torch.as_tensor(cols_arr, device=device),
        vals=torch.as_tensor(vals_arr.astype(_np_dtype(dtype)), device=device),
        inv_diag=torch.as_tensor(
            invd_arr.astype(_np_dtype(dtype)), device=device),
        n_levels=n_levels,
        m=m,
        lower=lower,
    )


@dataclasses.dataclass
class ChunkSchedule:
    """Slot-chunked level schedule: memory bounded by nnz + n_levels·C.

    The dense ``LevelSchedule`` pads to (n_levels, max_rows, max_width) and
    explodes on scattered matrices with deep dependency chains. Here the
    solve is a loop over fixed-size chunks of ``C`` slots, slots ordered
    (level, row); a level's slots are padded to whole chunks, rows wider
    than ``C`` straddle chunks via a scalar carry. Per-slot cost is 20 B.
    """

    cols: torch.Tensor   # (n_chunks, C) int32 col ids (pad: m = zero sink)
    vals: torch.Tensor   # (n_chunks, C) off-diag values (pad 0)
    sid: torch.Tensor    # (n_chunks, C) int32 local segment id, sorted
    rows: torch.Tensor   # (n_chunks, C) int32 target row per segment (pad m)
    invd: torch.Tensor   # (n_chunks, C) 1/diag per segment (pad 0)
    cont: torch.Tensor   # (n_chunks,) bool — segment 0 continues prev chunk
    tail: torch.Tensor   # (n_chunks,) bool — last segment continues onward
    last_sid: torch.Tensor  # (n_chunks,) int32 — last live segment id
    n_chunks: int
    m: int
    C: int
    lower: bool

    # dense-schedule interface parity (reporting)
    @property
    def n_levels(self):
        return self.n_chunks


def build_chunk_schedule(T: HostCSR, lower: bool = True, dtype=torch.float32,
                         C: int = 512, device="cuda") -> ChunkSchedule:
    """Build the chunked level schedule (see :class:`ChunkSchedule`)."""
    m = T.m
    ia, ja = T.ia.astype(np.int64), T.ja.astype(np.int64)
    vals = T.a.astype(np.float64)
    level = np.zeros(m, dtype=np.int64)
    row_iter = range(m) if lower else range(m - 1, -1, -1)
    for i in row_iter:
        s, e = ia[i], ia[i + 1]
        nb = ja[s:e]
        nb = nb[nb < i] if lower else nb[nb > i]
        if nb.size:
            level[i] = level[nb].max() + 1
    n_levels = int(level.max()) + 1 if m else 1
    order = np.argsort(level, kind="stable")

    # per-row off-diag slots (>= 1: zero-offd rows get one dummy slot)
    dt = _np_dtype(dtype)
    cols_l, vals_l, sid_l, rows_l, invd_l = [], [], [], [], []
    cont_l, tail_l, last_l = [], [], []

    cur_cols = []     # growing slot lists of the current chunk
    cur_vals = []
    cur_sid = []
    seg_rows = []     # (C,) per-segment row target / invd of current chunk
    seg_invd = []
    cur_cont = False
    nseg = 0

    def flush(tail):
        nonlocal cur_cols, cur_vals, cur_sid, seg_rows, seg_invd
        nonlocal cur_cont, nseg
        k = len(cur_cols)
        if k == 0 and not tail:
            return
        cols_l.append(np.pad(np.array(cur_cols, np.int64), (0, C - k),
                             constant_values=m))
        vals_l.append(np.pad(np.array(cur_vals, np.float64), (0, C - k)))
        sid_l.append(np.pad(np.array(cur_sid, np.int64), (0, C - k),
                            constant_values=max(nseg - 1, 0)))
        r = np.full(C, m, np.int64)
        d = np.zeros(C, np.float64)
        r[:len(seg_rows)] = seg_rows
        d[:len(seg_invd)] = seg_invd
        rows_l.append(r)
        invd_l.append(d)
        cont_l.append(cur_cont)
        tail_l.append(tail)
        last_l.append(max(nseg - 1, 0))
        cur_cols, cur_vals, cur_sid = [], [], []
        seg_rows, seg_invd = [], []
        cur_cont = tail
        nseg = 1 if tail else 0
        if tail:
            seg_rows.append(m)       # placeholder; final chunk sets real row
            seg_invd.append(0.0)

    prev_level = 0
    for i in order:
        lv = level[i]
        if lv != prev_level:
            flush(False)             # levels never share a chunk
            prev_level = lv
        s, e = ia[i], ia[i + 1]
        jj = ja[s:e]
        off = jj != i
        oc, ov = jj[off], vals[s:e][off]
        dsel = np.flatnonzero(~off)
        if dsel.size == 0 or vals[s + dsel[0]] == 0.0:
            raise ValueError(f"missing/zero diagonal at row {i}")
        dv = 1.0 / vals[s + dsel[0]]
        if oc.size == 0:             # zero-offd row: one dummy slot
            oc, ov = np.array([m], np.int64), np.array([0.0])
        if 0 < len(cur_cols) and len(cur_cols) + oc.size > C \
                and oc.size <= C:
            flush(False)             # small row starts a fresh chunk
        pos = 0
        sidv = None                  # this row's segment in current chunk
        while pos < oc.size:
            take = min(oc.size - pos, C - len(cur_cols))
            if sidv is None:
                if cur_cont and len(cur_cols) == 0:
                    sidv = 0         # tail flush pre-allocated segment 0
                else:
                    sidv = nseg
                    seg_rows.append(m)
                    seg_invd.append(0.0)
                    nseg += 1
            cur_cols.extend(oc[pos:pos + take].tolist())
            cur_vals.extend(ov[pos:pos + take].tolist())
            cur_sid.extend([sidv] * take)
            pos += take
            if pos < oc.size:        # straddles: carry to next chunk
                flush(True)
                sidv = None
            else:                    # final chunk of the row: completes here
                seg_rows[sidv] = i
                seg_invd[sidv] = dv
    flush(False)

    n_chunks = max(len(cols_l), 1)
    if not cols_l:
        cols_l = [np.full(C, m, np.int64)]
        vals_l = [np.zeros(C)]
        sid_l = [np.zeros(C, np.int64)]
        rows_l = [np.full(C, m, np.int64)]
        invd_l = [np.zeros(C)]
        cont_l, tail_l, last_l = [False], [False], [0]
    return ChunkSchedule(
        cols=torch.as_tensor(
            np.stack(cols_l).astype(INDEX_DTYPE), device=device),
        vals=torch.as_tensor(np.stack(vals_l).astype(dt), device=device),
        sid=torch.as_tensor(
            np.stack(sid_l).astype(INDEX_DTYPE), device=device),
        rows=torch.as_tensor(
            np.stack(rows_l).astype(INDEX_DTYPE), device=device),
        invd=torch.as_tensor(np.stack(invd_l).astype(dt), device=device),
        cont=torch.as_tensor(np.array(cont_l), device=device),
        tail=torch.as_tensor(np.array(tail_l), device=device),
        last_sid=torch.as_tensor(np.array(last_l, INDEX_DTYPE), device=device),
        n_chunks=n_chunks, m=m, C=C, lower=lower)


class BandScheduleError(ValueError):
    """Matrix outside the band-block formulation's budget."""


@dataclasses.dataclass
class BandBlockSchedule:
    """Band-block back-substitution for banded factors.

    Rows are cut into B-row blocks; with bandwidth(T) <= Q*B, block k
    depends only on the Q preceding (following, for upper) blocks, so

        x_k = invD_k @ (b_k - C_k @ w_k)

    where D_k is the dense diagonal block (inverted at build, in fp64),
    C_k the dense (B, Q*B) coupling strip, and w_k the running window of
    the Q previous block solutions: two dense products a block and no
    gather. Densifying the band costs 4*m*(Q+1)*B bytes; the builder
    refuses matrices where that exceeds ``max_bytes`` (scattered factors
    keep the chunked schedule). Entries beyond the Q*B band (a few, by
    construction at most 2% of nnz) are gathered per block from the
    solved prefix (``olcols``/``olvals``/``olrow``; empty when the whole
    matrix fits the band).
    """

    invD: torch.Tensor   # (K, B, B) inverted diagonal blocks
    C: torch.Tensor      # (K, B, Q*B) coupling strips
    olcols: torch.Tensor  # (K, R_out) int32 carry-space x index (pad: sink)
    olvals: torch.Tensor  # (K, R_out) values (pad 0)
    olrow: torch.Tensor   # (K, R_out) int32 local row (pad: B)
    m: int
    B: int
    Q: int
    K: int
    lower: bool

    @property
    def n_levels(self):
        return self.K


def build_band_block_schedule(T: HostCSR, lower: bool = True,
                              dtype=torch.float32, B: int = 512,
                              max_bytes: int = int(5e9),
                              device="cuda") -> BandBlockSchedule:
    # max_bytes 5 GB: the L+U pair of the widest banded solver twin
    # (mc2depi_dd: 4.8 + 3.3 GB) must fit device memory together with x/b;
    # the densified strips stream once per solve.
    m = T.m
    if m == 0:
        raise BandScheduleError("empty matrix")
    rows = np.repeat(np.arange(m, dtype=np.int64), T.row_lengths())
    ja = T.ja.astype(np.int64)
    dist = (rows - ja) if lower else (ja - rows)
    bw = max(int(dist.max()) if dist.size else 0, 0)
    K = (m + B - 1) // B
    Q = max((bw + B - 1) // B, 1)
    if 4 * K * B * B * (Q + 1) > max_bytes:
        # scattered tail inflates max-bandwidth: shrink the band to the
        # budget and push the out-of-band entries to the gather channel
        Q = max(int(max_bytes // (4 * K * B * B)) - 1, 1)
    need = 4 * K * B * B * (Q + 1)
    if need > max_bytes:
        raise BandScheduleError(
            f"band-block densification {need / 1e9:.1f} GB over budget "
            f"(bandwidth {bw}, Q={Q})")
    out = dist > Q * B
    n_out = int(out.sum())
    if n_out > max(0.02 * T.nnz, 0):
        raise BandScheduleError(
            f"{n_out / max(T.nnz, 1):.1%} of entries beyond the affordable "
            f"{Q}-block band — genuinely scattered, not a banded factor")

    k = rows // B
    li = rows - k * B
    D = np.zeros((K, B, B), np.float64)
    C = np.zeros((K, B, Q * B), np.float64)
    # column offset within [D | C] space: for lower, coupling cols are the
    # Q blocks BEFORE block k (ascending); for upper, the Q blocks after
    jrel = ja - (k - Q) * B if lower else ja - k * B
    dmask = (((jrel >= Q * B) & (jrel < (Q + 1) * B)) if lower
             else (jrel < B)) & ~out
    drel = np.where(dmask, (jrel - Q * B) if lower else jrel, 0)
    np.add.at(D, (k[dmask], li[dmask], drel[dmask]), T.a[dmask])
    cmask = ~dmask & ~out
    crel = jrel[cmask] if lower else jrel[cmask] - B
    np.add.at(C, (k[cmask], li[cmask], crel), T.a[cmask])

    # outlier side-channel (carry-space layout: see _sptrsv_band)
    if n_out:
        ko = k[out]
        cnt = np.bincount(ko, minlength=K)
        R_out = int(cnt.max() + 7) // 8 * 8
        if R_out > 8192:
            raise BandScheduleError(
                f"outlier row burst {cnt.max()} per block — too scattered")
        sink = K * B + Q * B
        olcols = np.full((K, R_out), sink, np.int64)
        olvals = np.zeros((K, R_out), np.float64)
        olrow = np.full((K, R_out), B, np.int64)
        slot = np.zeros(K, np.int64)
        off = Q * B if lower else 0
        jo, lio, vo = ja[out], li[out], T.a[out]
        for idx in range(n_out):
            kk = ko[idx]
            s = slot[kk]
            slot[kk] = s + 1
            olcols[kk, s] = off + jo[idx]
            olvals[kk, s] = vo[idx]
            olrow[kk, s] = lio[idx]
    else:
        R_out = 0
        olcols = np.zeros((K, 0), np.int64)
        olvals = np.zeros((K, 0), np.float64)
        olrow = np.zeros((K, 0), np.int64)

    # padding rows of the last block solve to 0 via a unit diagonal
    pad = K * B - m
    if pad:
        D[-1, B - pad:, B - pad:][np.diag_indices(pad)] = 1.0
    dz = np.abs(np.diagonal(D, axis1=1, axis2=2)).min()
    if dz == 0.0:
        # JAX raises a plain ValueError here, which its build_schedule
        # does not catch; the port's falls back to the level schedules
        raise BandScheduleError("zero diagonal in band-block build")
    invD = np.linalg.inv(D)
    return BandBlockSchedule(
        invD=torch.as_tensor(invD.astype(_np_dtype(dtype)), device=device),
        C=torch.as_tensor(C.astype(_np_dtype(dtype)), device=device),
        olcols=torch.as_tensor(olcols.astype(INDEX_DTYPE), device=device),
        olvals=torch.as_tensor(olvals.astype(_np_dtype(dtype)), device=device),
        olrow=torch.as_tensor(olrow.astype(INDEX_DTYPE), device=device),
        m=m, B=B, Q=Q, K=K, lower=lower)


def build_schedule(T: HostCSR, lower: bool = True, dtype=torch.float32,
                   device="cuda"):
    """Band-block solve for banded factors; dense level schedule when its
    padding is modest; chunked schedule otherwise."""
    try:
        return build_band_block_schedule(T, lower=lower, dtype=dtype,
                                         device=device)
    except BandScheduleError:
        pass
    try:
        return build_level_schedule(T, lower=lower, dtype=dtype,
                                    device=device)
    except SchedulePaddingError:
        return build_chunk_schedule(T, lower=lower, dtype=dtype,
                                    device=device)


def _sptrsv_band(sched: BandBlockSchedule, b: torch.Tensor) -> torch.Tensor:
    """Carry-space layout: the carried x buffer is
    lower:  [Q*B zeros | block 0 ... block K-1 | sink]
    upper:  [block 0 ... block K-1 | Q*B zeros | sink]
    so block k's coupling window is always a contiguous Q*B slice and
    the outlier gather indexes solved blocks directly."""
    B, Q, K, m = sched.B, sched.Q, sched.K, sched.m
    dt = sched.invD.dtype
    b2 = F.pad(b.to(dt), (0, K * B - m)).view(K, B)
    has_out = sched.olvals.shape[1] > 0
    off = Q * B if sched.lower else 0
    xf = torch.zeros(K * B + Q * B + 1, dtype=dt, device=b.device)
    for kk in (range(K) if sched.lower else range(K - 1, -1, -1)):
        wstart = kk * B if sched.lower else (kk + 1) * B
        t = b2[kk] - torch.mv(sched.C[kk], xf[wstart:wstart + Q * B])
        if has_out:
            g = sched.olvals[kk] * xf.index_select(0, sched.olcols[kk])
            t = t - torch.zeros(B + 1, dtype=dt, device=b.device
                                ).index_add_(0, sched.olrow[kk], g)[:B]
        xf[off + kk * B:off + (kk + 1) * B] = torch.mv(sched.invD[kk], t)
    return xf[off:off + m]


def _sptrsv_chunked(sched: ChunkSchedule, b: torch.Tensor) -> torch.Tensor:
    m, C = sched.m, sched.C
    dt = sched.vals.dtype
    x = torch.zeros(m + 1, dtype=dt, device=b.device)   # slot m = zero sink
    bp = F.pad(b.to(dt), (0, 1))
    # b at each segment's row, for every chunk at once
    brow = bp.index_select(0, sched.rows.reshape(-1)).view(sched.rows.shape)
    carry = torch.zeros(1, dtype=dt, device=b.device)
    for k in range(sched.n_chunks):
        g = x.index_select(0, sched.cols[k]) * sched.vals[k]
        acc = torch.zeros(C, dtype=dt, device=b.device).index_add_(
            0, sched.sid[k], g)
        acc[:1] += torch.where(sched.cont[k:k + 1], carry, 0.0)
        xi = (brow[k] - acc) * sched.invd[k]
        x[sched.rows[k]] = xi          # pad rows: invd = 0, into the sink
        x[m:].zero_()                  # keep the sink zero (x[m] = 0.0
                                       # would copy from the host: a sync)
        carry = torch.where(sched.tail[k:k + 1],
                            acc.index_select(0, sched.last_sid[k:k + 1]),
                            0.0)
    return x[:m]


def _sptrsv_level(sched: LevelSchedule, b: torch.Tensor) -> torch.Tensor:
    m = sched.m
    dt = sched.vals.dtype
    x = torch.zeros(m + 1, dtype=dt, device=b.device)  # slot m = pad sink
    bp = F.pad(b.to(dt), (0, 1))
    # b at each level's rows, and which rows are live, for all levels
    brow = bp.index_select(0, sched.rows.reshape(-1)).view(sched.rows.shape)
    live = sched.rows < m
    for lv in range(sched.n_levels):
        rows, cols = sched.rows[lv], sched.cols[lv]
        gathered = x.index_select(0, cols.reshape(-1)).view(cols.shape)
        acc = torch.sum(sched.vals[lv] * gathered, dim=1)
        xi = (brow[lv] - acc) * sched.inv_diag[lv]
        x[rows] = torch.where(live[lv], xi, x.index_select(0, rows))
    return x[:m]


def sptrsv(sched, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b through the schedule, on the schedule's device: one
    step a level (``LevelSchedule``), chunk (``ChunkSchedule``) or block
    (``BandBlockSchedule``)."""
    if isinstance(sched, BandBlockSchedule):
        return _sptrsv_band(sched, b)
    if isinstance(sched, ChunkSchedule):
        return _sptrsv_chunked(sched, b)
    return _sptrsv_level(sched, b)


def ilu0_solve(L_sched, U_sched, b: torch.Tensor) -> torch.Tensor:
    """x = U⁻¹ L⁻¹ b — the ILU0 preconditioner application."""
    return sptrsv(U_sched, sptrsv(L_sched, b))
