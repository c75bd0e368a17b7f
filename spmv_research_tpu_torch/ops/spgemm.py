"""SpGEMM: sparse × sparse matrix product C = A·B (ESC plans on the host,
a lane-scan numeric phase on the device).

Counterpart of ``spmv_research_tpu/ops/spgemm.py`` (BASELINE.json config
#4). The split is the JAX package's:

* **symbolic phase** (host, vectorized numpy): ESC — expand every
  contribution pair (one per product A(i,j)·B(j,k)), sort by output
  coordinate, compress to C's CSR structure (``spgemm_symbolic``); A's rows
  cut into blocks of at most ``PAIR_BUDGET`` pairs
  (``_row_blocks_by_pairs``), each lowered to a device program
  (``device_plan``): the A and B operands gathered into pair order on the
  host, the guard bits of a suffix scan, each segment's head. These arrays
  equal the JAX package's.
* **numeric phase** (device): ``_scan_numeric_plane``, plain PyTorch (the
  JAX package's is ``jax.jit`` XLA, no Pallas kernel): the pair products in
  a ``(R, 128)`` plane, a ≤ 7-stage guarded lane suffix scan
  (``torch.roll``), a guarded suffix scan of the row carries over the lead
  column, the carry added at the crossing head by a lane-iota match, and ×
  the head mask: C's values at the segment heads, zeros elsewhere. The
  steps and their add order are JAX's.

``device_plan`` and ``spgemm_device_plans`` build on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.host import HostCSR, INDEX_DTYPE

# max expanded pairs materialized at once; kept a little under 2^24 so a
# block that overshoots by one row still buckets to a 2^24 pad (the JAX
# package's constant, kept so that the blocks are the same)
PAIR_BUDGET = (1 << 24) - (1 << 21)
LANES2D = 128       # lanes of the numeric plane's rows


@dataclasses.dataclass
class SpGEMMPlan:
    """Static expansion plan: C = A·B structure + contribution indices
    (host arrays)."""

    c_ia: np.ndarray       # (m+1,) C row pointer
    c_ja: np.ndarray       # (nnzC,) C column indices
    a_idx: np.ndarray      # (n_pairs,) index into A's values
    b_idx: np.ndarray      # (n_pairs,) index into B's values
    seg: np.ndarray        # (n_pairs,) output slot (sorted)
    nnz_c: int
    shape: Tuple[int, int]

    def numeric(self, a_data: torch.Tensor,
                b_data: torch.Tensor) -> torch.Tensor:
        """C's values from A's and B's value arrays, on their device."""
        dev = a_data.device
        prod = (a_data.index_select(0, torch.as_tensor(self.a_idx, device=dev))
                * b_data.index_select(0, torch.as_tensor(self.b_idx,
                                                         device=dev)))
        return prod.new_zeros(self.nnz_c).index_add_(
            0, torch.as_tensor(self.seg, device=dev), prod)


def spgemm_symbolic(A: HostCSR, B: HostCSR) -> SpGEMMPlan:
    if A.n != B.m:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    # expand: pair t = (a-nnz index, b-nnz index within row ja_A[t])
    counts = B.row_lengths()[A.ja]                  # contributions per A nnz
    n_pairs = int(counts.sum())
    a_idx = np.repeat(np.arange(A.nnz, dtype=np.int64), counts)
    # b index ranges: start of B row ja_A[t] for each expanded element
    b_start = B.ia[:-1].astype(np.int64)[A.ja]
    offs = np.arange(n_pairs, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(b_start, counts) + offs

    rows_a = np.repeat(np.arange(A.m, dtype=np.int64), A.row_lengths())
    out_row = rows_a[a_idx]
    out_col = B.ja.astype(np.int64)[b_idx]

    key = out_row * B.n + out_col
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(n_pairs, dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    seg = np.cumsum(first) - 1
    nnz_c = int(seg[-1]) + 1 if n_pairs else 0

    uniq = key_s[first]
    c_row = (uniq // B.n).astype(np.int64)
    c_ja = (uniq % B.n).astype(INDEX_DTYPE)
    c_ia = np.zeros(A.m + 1, dtype=np.int64)
    np.add.at(c_ia, c_row + 1, 1)
    np.cumsum(c_ia, out=c_ia)

    return SpGEMMPlan(c_ia=c_ia.astype(INDEX_DTYPE), c_ja=c_ja,
                      a_idx=a_idx[order], b_idx=b_idx[order], seg=seg,
                      nnz_c=nnz_c, shape=(A.m, B.n))


def _row_blocks_by_pairs(A: HostCSR, B: HostCSR, budget: int):
    """A's rows cut into blocks whose expanded-pair counts fit the budget:
    the block of a row is its pair offset // budget, so every block holds
    at most budget + one row's own pairs (a row larger than the budget
    gets a block of its own)."""
    per_nnz = B.row_lengths()[A.ja].astype(np.int64)
    cps = np.zeros(A.nnz + 1, np.int64)
    np.cumsum(per_nnz, out=cps[1:])
    ia = A.ia.astype(np.int64)
    blk = cps[ia[:-1]] // max(budget, 1)     # pairs before each row
    change = np.nonzero(np.diff(blk))[0] + 1
    bounds = np.concatenate(([0], change, [A.m]))
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    e0, e1 = int(csr.ia[r0]), int(csr.ia[r1])
    return HostCSR(a=csr.a[e0:e1], ja=csr.ja[e0:e1],
                   ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]), m=r1 - r0, n=csr.n)


def _bucket(n: int, floor: int = 1024) -> int:
    return max(1 << int(max(n, 1) - 1).bit_length(), floor)


@dataclasses.dataclass(frozen=True)
class SpGEMMBlockDevice:
    """One row block's numeric program on the device.

    The pairs live in a ``(R, 128)`` plane. A ≤ 7-stage guarded lane suffix
    scan sums each segment's piece within its plane row; a segment that
    crosses row ends is closed by a second guarded suffix scan over the
    rows' lane-0 lead pieces (only a row's last segment can cross, so each
    crossing head adds exactly its continuation rows' pieces); the head
    mask keeps C's values at the segment heads."""

    av: torch.Tensor      # (pad_pairs,) A operand per pair
    bv: torch.Tensor      # (pad_pairs,) B operand per pair
    guard: torch.Tensor   # (R, 128) int32: bit k = within-row suffix guard
    rowg: torch.Tensor    # (R,) int32: bit k = lead-piece run guard, bit 30
                          # = the row's lead pair continues a segment
    cross_lane: torch.Tensor  # (R,) int32 lane of the row's crossing head
    headmask: torch.Tensor    # (R, 128) values: 1 at segment heads
    head: torch.Tensor    # (pad_out,) int32 position of each segment's head
    c_ia: np.ndarray
    c_ja: np.ndarray
    nnz_c: int
    npairs: int           # true (unpadded) pair count
    stages: int           # lane-scan stages (<= 7)
    cstages: int          # row-carry scan stages
    r0: int
    r1: int

    def numeric_plane(self) -> torch.Tensor:
        """The numeric phase: the (R, 128) plane with C's values at the
        segment heads, zeros elsewhere; no gather or scatter."""
        return _scan_numeric_plane(self.av, self.bv, self.guard, self.rowg,
                                   self.cross_lane, self.headmask,
                                   stages=self.stages, cstages=self.cstages)

    def numeric(self) -> torch.Tensor:
        """C's values compacted, (pad_out,): one gather of the plane at the
        heads (the conversion path, not the timed phase)."""
        return self.numeric_plane().reshape(-1).index_select(0, self.head)


def _scan_numeric_plane(av, bv, guard, rowg, cross_lane, headmask, *,
                        stages: int, cstages: int) -> torch.Tensor:
    R = guard.shape[0]
    prod = (av * bv).reshape(R, LANES2D)
    for k in range(stages):
        shifted = torch.roll(prod, -(1 << k), dims=1)
        prod = prod + torch.where((guard & (1 << k)) != 0, shifted, 0.0)
    # cross-row carries: cs[r] = the sum of the consecutive continuation
    # rows' lead pieces from r on (a suffix scan over the lead column)
    cs = prod[:, 0] * ((rowg >> 30) & 1).to(prod.dtype)
    for k in range(cstages):
        s = 1 << k
        shifted = torch.cat([cs[s:], cs.new_zeros(s)])
        cs = cs + torch.where((rowg & s) != 0, shifted, 0.0)
    # at most one head per row crosses its row end (the last one); its
    # continuation sum lands by a lane-iota match, no gather
    cs1 = torch.cat([cs[1:], cs.new_zeros(1)])
    lanes = torch.arange(LANES2D, dtype=torch.int32, device=prod.device)
    corrected = prod + torch.where(lanes == cross_lane[:, None],
                                   cs1[:, None], 0.0)
    return corrected * headmask


def device_plan(plan: SpGEMMPlan, A: HostCSR, B: HostCSR, e0: int,
                dtype=torch.float32, device="cuda") -> SpGEMMBlockDevice:
    """Lower a symbolic block plan to its numeric program on ``device``
    (the lane-scan and row-carry layout of ``SpGEMMBlockDevice``)."""
    dt = torch.empty(0, dtype=dtype).numpy().dtype
    npairs = int(plan.a_idx.shape[0])
    pad_pairs = max(_bucket(npairs), LANES2D)
    R = pad_pairs // LANES2D
    pad_out = _bucket(plan.nnz_c)
    seg = np.asarray(plan.seg)
    av = np.zeros(pad_pairs, dt)
    av[:npairs] = A.a[np.asarray(plan.a_idx) + e0]
    bv = np.zeros(pad_pairs, dt)
    bv[:npairs] = B.a[np.asarray(plan.b_idx)]

    head_pos = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    ends = np.append(head_pos[1:], npairs)
    seg_len = ends - head_pos
    pos = np.arange(npairs, dtype=np.int64)
    d_end = np.repeat(ends, seg_len) - 1 - pos
    lane = pos % LANES2D
    # within-row suffix guards: add p + 2^k iff same segment and same row
    guard = np.zeros((R, LANES2D), np.int32)
    gflat = guard.reshape(-1)
    stages = 0
    for k in range(7):
        s = 1 << k
        bits = (d_end >= s) & (lane + s < LANES2D)
        if not bits.any():
            break
        stages = k + 1
        gflat[:npairs] |= bits.astype(np.int32) << k
    # row-carry scan: m[r] = row r's lane-0 pair continues a segment;
    # cont[r] = that segment also extends past row r (one segment's carry
    # chain stops at the row where it ends: a run of consecutive m can span
    # several crossing segments)
    is_head = np.zeros(pad_pairs, bool)
    is_head[head_pos] = True
    lane0 = np.arange(R) * LANES2D
    m = (lane0 < npairs) & ~is_head[np.minimum(lane0, pad_pairs - 1)]
    d0 = np.zeros(R, np.int64)
    sel = lane0 < npairs
    d0[sel] = d_end[lane0[sel]]
    cont = m & (d0 >= LANES2D)
    rowg = np.zeros(R, np.int32)
    rowg |= m.astype(np.int32) << 30
    d_run = np.zeros(R, np.int64)
    run = 0
    for r in range(R - 1, -1, -1):     # R = pairs / 128: a cheap host loop
        run = run + 1 if cont[r] else 0
        d_run[r] = run
    cstages = max(int(d_run.max()).bit_length(), 0) if R else 0
    for k in range(cstages):
        rowg |= ((d_run >= (1 << k)).astype(np.int32) << k)

    head = np.zeros(pad_out, np.int32)
    head[: plan.nnz_c] = head_pos.astype(np.int32)
    # only a row's last segment can cross its row end: its lane, so that
    # the carry lands by a lane-iota match
    crosses = (head_pos + seg_len - 1) // LANES2D > head_pos // LANES2D
    cross_lane = np.full(R, -1, np.int32)
    cross_lane[head_pos[crosses] // LANES2D] = head_pos[crosses] % LANES2D
    headmask = np.zeros(pad_pairs, dt)
    headmask[head_pos] = 1.0

    def t(a):
        return torch.from_numpy(a).to(device)
    return SpGEMMBlockDevice(
        av=t(av), bv=t(bv), guard=t(guard), rowg=t(rowg),
        cross_lane=t(cross_lane), headmask=t(headmask.reshape(R, LANES2D)),
        head=t(head), c_ia=plan.c_ia, c_ja=plan.c_ja, nnz_c=plan.nnz_c,
        npairs=npairs, stages=stages, cstages=cstages, r0=0, r1=0)


def spgemm_device_plans(A: HostCSR, B: HostCSR, dtype=torch.float32,
                        pair_budget: int = PAIR_BUDGET, device="cuda"):
    """The numeric programs of A's row blocks, in order, on ``device``: the
    full quadratic pair expansion is never materialized at once."""
    out = []
    for (r0, r1) in _row_blocks_by_pairs(A, B, pair_budget):
        Ablk = _rows_slice(A, r0, r1)
        if Ablk.nnz == 0:
            z32 = torch.zeros(0, dtype=torch.int32, device=device)
            out.append(SpGEMMBlockDevice(
                av=torch.zeros(0, dtype=dtype, device=device),
                bv=torch.zeros(0, dtype=dtype, device=device),
                guard=torch.zeros((0, LANES2D), dtype=torch.int32,
                                  device=device),
                rowg=z32, cross_lane=z32,
                headmask=torch.zeros((0, LANES2D), dtype=dtype,
                                     device=device),
                head=z32, c_ia=np.zeros(r1 - r0 + 1, INDEX_DTYPE),
                c_ja=np.zeros(0, INDEX_DTYPE), nnz_c=0, npairs=0, stages=0,
                cstages=0, r0=r0, r1=r1))
            continue
        plan = spgemm_symbolic(Ablk, B)
        out.append(dataclasses.replace(
            device_plan(plan, A, B, int(A.ia[r0]), dtype, device),
            r0=r0, r1=r1))
    return out


def spgemm(A: HostCSR, B: HostCSR, dtype=torch.float32,
           pair_budget: int = PAIR_BUDGET, device="cuda") -> HostCSR:
    """C = A·B end to end: host plans, each block's numeric phase on
    ``device``, C's values brought back (float64) into a host CSR."""
    plans = spgemm_device_plans(A, B, dtype, pair_budget, device)
    c_ia = np.zeros(A.m + 1, np.int64)
    c_ja_l, c_val_l = [], []
    for bp in plans:
        c_ia[bp.r0 + 1: bp.r1 + 1] = c_ia[bp.r0]
        if bp.nnz_c == 0:
            continue
        vals = bp.numeric()[: bp.nnz_c].cpu().numpy()
        c_val_l.append(vals.astype(np.float64))
        c_ja_l.append(bp.c_ja)
        c_ia[bp.r0 + 1: bp.r1 + 1] = (bp.c_ia[1:].astype(np.int64)
                                      + c_ia[bp.r0])
    return HostCSR(
        a=np.concatenate(c_val_l) if c_val_l else np.zeros(0),
        ia=c_ia.astype(np.int64 if c_ia[-1] > 2**31 - 1 else INDEX_DTYPE),
        ja=(np.concatenate(c_ja_l) if c_ja_l
            else np.zeros(0, INDEX_DTYPE)),
        m=A.m, n=B.n)
