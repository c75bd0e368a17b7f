"""CLOSG: row-gather + lane-pick front end on the Clos SpMV pipeline.

Counterpart of ``spmv_research_tpu/ops/clos_gather.py``: the ``ClosG``
program and the row-chunked ``ClosGChunked`` (one ``ClosG`` per row block
past the 2^20-slot cap), their builders (carried over so that they emit
identical program arrays, every option included), the float64 host executor
``execute_closg_numpy``, and two SpMV impls:

* ``"cuda"`` — the hand-written kernels of ``clos_cuda.py`` (the pallas
  impl's counterpart);
* ``"torch"`` — the same function in plain PyTorch. Like the kernels, and
  unlike the JAX package's ``xla`` impl, it runs the capped scan plus the
  accumulate ("extra pick") records, so kernel and plain version compute
  the same function.

The pipeline: a front end (window gather × value, then the r1 layer; the
value may come from a 128-entry dictionary, ``use_vlut``, and the window
from a per-8-row base plus a rotation, ``fused_win``) → ``_t_fwd`` →
``clos_invreg`` (r2 layer) → ``_t_bwd`` → a back end. Programs with windowed
extraction (W > 0) run ``closg_r3_scan_yext`` (r3 layer, capped segmented
scan, y extraction); W = 0 programs, whose 128-row groups span more than 64
window octaves, run ``closg_r3_scan`` (r3 layer, full scan) and then
``closg_cand_yext`` (per y slot, a pick from one of C candidate rows).

``build_clos_gather_auto`` also routes a matrix to the long-row split
(``rowsplit.py``) and to the XL tier (``clos_xl.py``), as the JAX builder
does. The SpMM scan follows with the other workloads.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .dispatch import register_spmm_column_loop, register_spmv
from .clos_route import BLK, LANES, SUB, ClosRoutingError, route_clos
from .clos import (LANE2_SHIFT, ROT_SHIFT, SPARE_BITS, SPARE_SHIFT, _pack,
                   _t_fwd, _t_bwd)
from . import clos_cuda as K

DATA_FIELDS = ("rowidx", "vals_cs", "perm_r1", "perm_r2", "perm_r3",
               "ycand", "ysel", "ysel_w", "wstart", "border",
               "scan_hi", "gbase", "nbids")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "N", "V", "x_rows",
               "scan_stages", "C", "W", "yext_classes", "use_vlut",
               "fused_win", "dense_blocks", "scan_cap")


@dataclasses.dataclass(frozen=True)
class ClosG:
    """Window-gather + Clos SpMV program (field for field the JAX ``ClosG``).

    ``acc_ptr``/``acc_src`` are not part of the JAX program: they are
    derived from ``border`` and ``yext_classes`` on the host
    (:func:`_accum_order`) and give, per y batch, the accumulate records
    that add into it, in the order the JAX package applies them."""

    rowidx: torch.Tensor       # (8V,) int32 x2d row feeding sublane s
    vals_cs: torch.Tensor      # (8V, 128) values in padded column-sorted
    #                            order; (8, 128) dictionary rows if use_vlut
    perm_r1: torch.Tensor      # spare bits [17,24): per-slot x lane λ;
    #                            [24,31): value index (use_vlut), or
    #                            [24,27): window rotation (fused_win)
    perm_r2: torch.Tensor      # (8·1024, V/8)
    perm_r3: torch.Tensor      # spare bits: scan guards (low stages)
    ycand: torch.Tensor        # (C·m_rows,) int32 scan-output row ids
    ysel: torch.Tensor         # (m_rows, 128) int32: lane | cand<<7
    ysel_w: torch.Tensor       # (records·8, 128) int32: lane | cid<<7 | empty<<16
    wstart: torch.Tensor       # (records·8,) int32 per-group window start row
    border: torch.Tensor       # (records,) int32 src | dst<<16, class order
    scan_hi: torch.Tensor      # (8V,128) guards of stages ≥ 15, or (8,128) dummy
    gbase: torch.Tensor        # (8V/8,) int32 window base row (fused_win)
    nbids: torch.Tensor        # (n_nonempty,) int32 nonempty x2d blocks
    acc_ptr: torch.Tensor      # (n_batches+1,) int32 derived, see _accum_order
    acc_src: torch.Tensor      # (n_accum,) int32 derived
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    x_rows: int
    scan_stages: Tuple[int, ...]
    C: int
    W: int                     # max window octaves per group (0 = legacy)
    yext_classes: Tuple[Tuple[int, int, int, int], ...]  # (octaves, base, count, accum)
    use_vlut: bool = False
    fused_win: bool = False
    dense_blocks: bool = True
    scan_cap: Tuple[int, ...] = ()

    format_name = "CLOSG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals_cs.device

    def to(self, device) -> "ClosG":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        leaves = (self.rowidx, self.vals_cs, self.perm_r1, self.perm_r2,
                  self.perm_r3, self.ysel_w, self.wstart, self.border,
                  self.scan_hi)
        return int(sum(l.numel() * l.element_size() for l in leaves))


@dataclasses.dataclass(frozen=True)
class ClosGChunked:
    """Row-chunked CLOSG: one Clos program per ≤2^20-slot row block (field
    for field the JAX ``ClosGChunked``). The chunks share x; y is the
    concatenation of the per-chunk y."""

    chunks: Tuple[ClosG, ...]
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    row_split: Tuple[int, ...]   # chunk row boundaries, len = len(chunks)+1

    format_name = "CLOSG"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.chunks[0].device

    def to(self, device) -> "ClosGChunked":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(sum(c.mem_footprint_bytes() for c in self.chunks))


def _accum_order(border: np.ndarray, yext_classes) -> tuple:
    """Per-batch order of the accumulate records: ``(acc_ptr, acc_src)``.

    The JAX kernel walks the classes in order on one core: every base record
    writes its batch (each batch once, read and written at the same batch,
    ``bs == bd``), then each accumulate record adds into batch ``bd``. GPU
    blocks run in parallel, so the records that add into one batch are
    listed here in that order, and one block applies them in turn — the sums
    are the JAX package's, and deterministic. A W = 0 program has no
    classes: zero batches, and ``border`` is never read."""
    border = np.asarray(border).astype(np.int64)
    bs, bd = border & 0xFFFF, border >> 16
    base_ids, acc_ids = [], []
    for _, base, count, accum in yext_classes:
        if not accum and acc_ids:
            raise ClosRoutingError("a base y-extraction class follows an "
                                   "accumulate class")
        (acc_ids if accum else base_ids).extend(range(base, base + count))
    base_ids = np.asarray(base_ids, np.int64)
    n_batches = base_ids.size
    if not (np.array_equal(bs[base_ids], bd[base_ids])
            and np.array_equal(np.sort(bd[base_ids]), np.arange(n_batches))):
        raise ClosRoutingError("base y-extraction records must cover every "
                               "batch once, in place")
    acc = np.asarray(acc_ids, np.int64)
    order = np.argsort(bd[acc], kind="stable")   # keeps class order per batch
    acc_src = bs[acc][order].astype(np.int32)
    counts = np.bincount(bd[acc], minlength=n_batches)
    acc_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return acc_ptr, acc_src


def _closg(arrays: dict, meta: dict) -> ClosG:
    """ClosG from numpy program arrays and meta fields (on the CPU)."""
    if meta["use_vlut"] and meta["fused_win"]:
        raise ClosRoutingError("a program cannot carry both the value LUT "
                               "and fused windows (both use r1 bits 24+)")
    acc_ptr, acc_src = _accum_order(arrays["border"], meta["yext_classes"])
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in DATA_FIELDS}
    return ClosG(**t, acc_ptr=torch.from_numpy(acc_ptr),
                 acc_src=torch.from_numpy(acc_src), **meta)


def from_jax_program(leaves: dict, meta: dict) -> ClosG:
    """The port's ``ClosG`` for a program built by the JAX package.

    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value, so both packages can run
    the identical program (any front end, any back end)."""
    meta = {k: meta[k] for k in META_FIELDS}
    return _closg({k: np.array(leaves[k]) for k in DATA_FIELDS}, meta)


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    lo, hi = int(csr.ia[r0]), int(csr.ia[r1])
    return HostCSR(ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]).astype(csr.ia.dtype),
                   ja=csr.ja[lo:hi], a=csr.a[lo:hi],
                   m=r1 - r0, n=csr.n)


def _closg_need(csr: HostCSR, r0: int, r1: int) -> int:
    """Exact slot need of rows [r0, r1) (mirrors build_clos_gather)."""
    lo, hi = int(csr.ia[r0]), int(csr.ia[r1])
    nnz_c = hi - lo
    n_blocks = (csr.n + LANES - 1) // LANES
    cnt = np.bincount(csr.ja[lo:hi] // LANES, minlength=n_blocks)
    s_needed = int(((cnt + LANES - 1) // LANES).sum())
    return max(nnz_c + 1, r1 - r0, s_needed * LANES, 8 * BLK)


SPLIT_ROW_NNZ = 16384    # rows past this break the windowed y extraction


def build_clos_gather_auto(csr: HostCSR, max_N: int = 1 << 20,
                           value_lut: bool = False, max_chunks: int = 12,
                           split_rows: bool = True):
    """``build_clos_gather`` with the JAX builder's routing: the long-row
    split, one program, row chunks, or the XL tier.

    * 1 to 4096 rows longer than ``SPLIT_ROW_NNZ``: the rows are split into
      sub-rows of at most 256 nnz (``rowsplit.split_long_rows``), the split
      matrix is built by this function again (without the split) and
      wrapped in a ``RowSplit``;
    * a matrix that fits ``max_N`` slots: one ``ClosG``;
    * more than ``max_chunks`` chunks expected: ``clos_xl.build_clos_gather_xl``
      (stacked uniform chunks);
    * otherwise row-contiguous chunks of at most ``max_N`` slots each, built
      two at a time (``ClosGChunked``).

    The constants (12 chunks, 16,384 nnz, 4,096 rows) are the JAX
    package's, so that the same matrix gets the same program. The chunk loop
    stops at one row and raises ``ClosRoutingError`` where the JAX loop
    spins (a single row past ``max_N`` slots, or ``max_N`` < 8192)."""
    if split_rows:
        from .rowsplit import DEFAULT_T, split_long_rows, wrap_row_split
        heavy_n = int((csr.row_lengths() > SPLIT_ROW_NNZ).sum())
        if 0 < heavy_n <= 4096:
            csr2, heavy, seg_ptr = split_long_rows(
                csr, DEFAULT_T, threshold=SPLIT_ROW_NNZ)
            inner = build_clos_gather_auto(csr2, max_N=max_N,
                                           value_lut=value_lut,
                                           max_chunks=max_chunks,
                                           split_rows=False)
            return wrap_row_split(inner, (csr.m, csr.n), csr.nnz,
                                  csr.nnz_expanded, heavy, seg_ptr)
    if _closg_need(csr, 0, csr.m) <= max_N:
        return build_clos_gather(csr, max_N=max_N, value_lut=value_lut)
    est_chunks = _closg_need(csr, 0, csr.m) / (0.9 * max_N) + 1
    if est_chunks > max_chunks:
        from .clos_xl import build_clos_gather_xl
        return build_clos_gather_xl(csr, chunk_N=max_N)
    splits = [0]
    r0 = 0
    nnz_per_row = max(csr.nnz / max(csr.m, 1), 1e-9)
    while r0 < csr.m:
        r1 = min(csr.m, r0 + max(int(0.8 * max_N / nnz_per_row), 1))
        while _closg_need(csr, r0, r1) > max_N and r1 > r0 + 1:
            r1 = r0 + max((r1 - r0) * 3 // 4, 1)
        while r1 < csr.m:
            r_try = min(csr.m, r1 + max((r1 - r0) // 8, 1))
            if _closg_need(csr, r0, r_try) > max_N:
                break
            r1 = r_try
        if _closg_need(csr, r0, r1) > max_N:
            raise ClosRoutingError(
                f"rows [{r0},{r1}) exceed a single clos-gather program")
        splits.append(r1)
        r0 = r1
    with ThreadPoolExecutor(2) as ex:
        chunks = tuple(ex.map(
            lambda i: build_clos_gather(
                _rows_slice(csr, splits[i], splits[i + 1]), max_N=max_N,
                value_lut=value_lut),
            range(len(splits) - 1)))
    return ClosGChunked(chunks=chunks, shape=(csr.m, csr.n), nnz=csr.nnz,
                        nnz_expanded=csr.nnz_expanded,
                        row_split=tuple(splits))


def build_clos_gather(csr: HostCSR, max_N: int = 1 << 20,
                      value_lut: bool = False, fuse_windows: bool = False,
                      force_N: int = 0, cap_scan: bool = True,
                      class_pow2: bool = False) -> ClosG:
    """Compile host CSR into one CLOSG program (float32 values).

    Carried over from the JAX builder with its options and defaults; the
    program arrays are identical. ``value_lut``: a matrix with at most 128
    distinct values (the zero padding included) keeps a 7-bit dictionary
    index per slot in r1 bits [24,31) and an (8, 128) dictionary plane
    instead of the value plane. ``fuse_windows``: each 8-row group reads its
    x rows from one base row plus a per-slot rotation (r1 bits [24,27)) over
    the non-empty x blocks; exclusive with ``value_lut``. ``force_N``: pad the
    program to exactly that many slots (uniform XL chunks). ``cap_scan=False``
    keeps the full scan (no accumulate records). ``class_pow2``: round the
    extraction window classes up to powers of two (one class set for all XL
    chunks). The JAX ``host_arrays`` flag has no counterpart: the port
    always builds CPU tensors, moved with ``.to``."""
    dt = np.dtype(np.float32)
    m, n, nnz = csr.m, csr.n, csr.nnz

    lengths = csr.row_lengths()
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = csr.ja.astype(np.int64)

    # --- padded column-sorted layout: sublane-aligned column blocks --------
    css = np.lexsort((rows, cols))          # nnz ids in (col, row) order
    blk_of = cols[css] // LANES             # x2d row of each sorted nnz
    n_blocks = (n + LANES - 1) // LANES
    cnt = np.bincount(blk_of, minlength=n_blocks)
    subl_per_blk = (cnt + LANES - 1) // LANES        # sublanes per block
    subl_per_blk = np.maximum(subl_per_blk, 0)
    sub_start = np.concatenate([[0], np.cumsum(subl_per_blk)])
    S_needed = int(sub_start[-1])

    # nnz+1: slot `nnz` must exist as an always-zero padding slot (empty rows
    # read it during y extraction)
    need = max(nnz + 1, m, S_needed * LANES, 8 * BLK)
    N = 1 << int(need - 1).bit_length()
    if force_N:
        if need > force_N:
            raise ClosRoutingError(
                f"chunk needs {need} slots > forced N={force_N}")
        N = force_N
    if N > max_N:
        raise ClosRoutingError(f"matrix too large for clos-gather (N={N})")
    V = N // BLK
    S = SUB * V

    # slot of sorted-nnz j: block b starts at sublane sub_start[b]
    within = np.arange(nnz) - np.concatenate([[0], np.cumsum(cnt)])[blk_of]
    cs_slot = (sub_start[blk_of] * LANES + within).astype(np.int64)

    rowidx = np.zeros(S, np.int32)
    for_blocks = np.repeat(np.arange(n_blocks), subl_per_blk)
    rowidx[: S_needed] = for_blocks
    lam = np.zeros(N, np.uint32)
    lam[cs_slot] = (cols[css] % LANES).astype(np.uint32)

    # --- fused-window front end ---------------------------------------------
    # rowidx is sorted, so after compacting away the empty x2d blocks every
    # 8-sublane group reads at most 8 consecutive compacted x rows: one base
    # row per group (gbase) plus a per-sublane rotation (r1 bits [24,27))
    # name the row; the value-LUT index wants the same bits, so the two are
    # exclusive.
    nb = np.flatnonzero(subl_per_blk > 0)
    fused_win = (fuse_windows and not value_lut
                 and (nb.size + SUB) * LANES * 4 <= (4 << 20))
    if fused_win:
        rank = np.zeros(n_blocks, np.int64)
        rank[nb] = np.arange(nb.size)
        rowidx_c = np.zeros(S, np.int64)
        rowidx_c[:S_needed] = rank[for_blocks]
        gbase = rowidx_c.reshape(-1, SUB)[:, 0]
        wrot = (rowidx_c - np.repeat(gbase, SUB)
                - (np.arange(S) % SUB)) % SUB
        assert int((rowidx_c - np.repeat(gbase, SUB)).max(initial=0)) < SUB
        lam = lam | (wrot.astype(np.uint32)[np.arange(N) // LANES] << 7)
        dense_blocks = nb.size == n_blocks
        nbids = nb.astype(np.int32)
        gbase = gbase.astype(np.int32)
    else:
        dense_blocks = True
        nbids = np.zeros(1, np.int32)
        gbase = np.zeros(1, np.int32)
    vals_cs = np.zeros(N, dtype=dt)
    vals_cs[cs_slot] = csr.a[css].astype(dt)

    # --- value LUT -------------------------------------------------------------
    # At most 128 distinct values (the zero padding included): the value of
    # a slot is a 7-bit dictionary index in r1 bits [24,31), and the value
    # plane becomes one (8, 128) plane whose row 0 is the dictionary.
    lut = False
    if value_lut:
        uniq = np.unique(vals_cs)            # includes the 0.0 padding value
        if uniq.shape[0] <= LANES:
            lut = True
            vidx = np.searchsorted(uniq, vals_cs).astype(np.uint32)
            lam |= vidx << 7                  # spare payload: lam | vidx<<7
            dict_pad = np.zeros(LANES, dt)
            dict_pad[: uniq.shape[0]] = uniq
            vals_cs = np.broadcast_to(dict_pad, (SUB, LANES)).copy()

    # --- perm: padded column-sorted slot -> CSR slot -----------------------
    perm = route_clos(cs_slot, css.astype(np.int64), N)

    # --- scan guards over CSR slot space -----------------------------------
    starts = csr.ia[:-1].astype(np.int64)
    row_start = np.zeros(N, dtype=np.int64)
    row_start[:nnz] = np.repeat(starts, lengths)
    reach_v = np.arange(N, dtype=np.int64) - row_start
    reach_v[nnz:] = 0
    max_reach = int(reach_v[:nnz].max()) if nnz else 0
    scan_guards = np.zeros(N, dtype=np.uint32)
    scan_stages = tuple(range(max_reach.bit_length()))
    for k in scan_stages:
        scan_guards |= ((reach_v >= (1 << k)).astype(np.uint32) << k)

    # --- y extraction: row-gather of end-slot rows + per-slot select -------
    # empty rows read slot nnz (a padding slot that stays exactly 0)
    end_slot = np.full(m, nnz, np.int64)
    ne = lengths > 0
    end_slot[ne] = csr.ia[1:].astype(np.int64)[ne] - 1
    m_rows = (m + LANES - 1) // LANES
    end_pad = np.full(m_rows * LANES, nnz, np.int64)
    end_pad[:m] = end_slot
    src_row = (end_pad // LANES).reshape(m_rows, LANES)
    ycand_l, cidx = [], np.zeros((m_rows, LANES), np.uint32)
    C = 1
    for j in range(m_rows):
        u, inv = np.unique(src_row[j], return_inverse=True)
        ycand_l.append(u)
        cidx[j] = inv.astype(np.uint32)
        C = max(C, len(u))
    if C > 128:
        raise ClosRoutingError(f"y-extraction candidate count {C} > 128 "
                               "(extreme row-length skew)")
    ycand = np.zeros((C, m_rows), np.int32)
    for j, u in enumerate(ycand_l):
        ycand[: len(u), j] = u
        ycand[len(u):, j] = u[-1] if len(u) else 0
    ysel = ((end_pad % LANES).astype(np.uint32).reshape(m_rows, LANES)
            | (cidx << 7))  # bits [7,14): candidate id (C <= 128)

    # --- windowed extraction: per-group (8w,128) scan-row windows ----------
    # end slots are monotone in row, so each y row (= group of 128 matrix
    # rows) draws its end-slot rows from a contiguous range of w_g octaves of
    # 8. Groups are processed in batches of 8, sorted into classes by max
    # w_g. Empty rows get bit 16 and read no slot.
    m_rows_pad = ((m_rows + SUB - 1) // SUB) * SUB
    n_batches = m_rows_pad // SUB
    src2 = np.zeros((m_rows_pad, LANES), np.int64)
    src2[:m_rows] = (end_pad // LANES).reshape(m_rows, LANES)
    emp2 = np.ones((m_rows_pad, LANES), bool)
    emp2.reshape(-1)[:m] = ~ne
    smin = np.where(emp2, np.int64(S - 1), src2).min(axis=1)
    smax = np.where(emp2, np.int64(0), src2).max(axis=1)
    has = np.logical_not(emp2.all(axis=1))
    smin = np.where(has, smin, 0)
    smax = np.where(has, np.maximum(smax, smin), 0)
    w_g = (smax - smin) // SUB + 1                     # octaves per group
    if class_pow2:      # XL: classes must be uniform across chunks
        w_g = np.power(2, np.ceil(np.log2(np.maximum(w_g, 1)))
                       ).astype(w_g.dtype)
    W = int(w_g.max()) if m_rows_pad else 1
    if W <= 64:            # cid is 9 bits [7,16)
        wstart = np.minimum(smin, S - SUB * w_g).astype(np.int32)
        cidp = np.clip(src2 - wstart[:, None], 0, SUB * W - 1)
        ysel_w = ((end_pad % LANES).astype(np.uint32)
                  .reshape(m_rows, LANES))
        ysel_w = np.concatenate(
            [ysel_w, np.zeros((m_rows_pad - m_rows, LANES), np.uint32)])
        ysel_w |= (cidp.astype(np.uint32) << 7)
        ysel_w |= (emp2.astype(np.uint32) << 16)
        wb = w_g.reshape(n_batches, SUB).max(axis=1)   # batch class
        border = np.argsort(wb, kind="stable").astype(np.int64)
        counts = np.bincount(wb[border], minlength=65)  # index 1..64
        yext_classes = []
        base = 0
        for c in range(1, 65):
            if counts[c]:
                yext_classes.append((int(c), int(base), int(counts[c]), 0))
                base += int(counts[c])
        border = border | (border << 16)               # (src | dst<<16)
    else:  # extreme skew: the candidate-plane back end (ycand, ysel)
        W = 0
        wstart = np.zeros(SUB, np.int32)
        ysel_w = np.zeros((SUB, LANES), np.uint32)
        border = np.zeros(1, np.int64)
        yext_classes = []

    # --- scan-stage capping --------------------------------------------------
    # Running only stages 0..K-1 turns the segmented scan into in-row window
    # sums of width 2^K: slot p holds the sum of its last min(p+1, 2^K) row
    # elements. Rows longer than 2^K are completed in extraction by summing
    # extra picks at end−c·2^K, shipped as accumulate records (accum=1)
    # appended to ysel_w/wstart/border.
    scan_cap = scan_stages
    if cap_scan and W and len(scan_stages) > 4:
        bits_full = len(scan_stages)
        # the JAX package's cost model: one scan stage ~ 9 extra-batch
        # extractions; ties break toward more capping (smaller K)
        long = lengths[lengths > (1 << 4)].astype(np.int64)
        K = min(range(4, bits_full + 1),
                key=lambda k: 9 * k + int(((long - 1) >> k).sum()))
        if K < bits_full:
            cap = 1 << K
            max_c = int((int(lengths.max()) - 1) // cap)
            len_pad = np.zeros(m_rows_pad * LANES, np.int64)
            len_pad[:m] = lengths
            end2 = np.full(m_rows_pad * LANES, np.int64(nnz))
            end2[:m] = end_slot
            ex_ysel, ex_wstart, ex_border, ex_w = [], [], [], []
            n_syn = n_batches
            for c in range(1, max_c + 1):
                live = len_pad > c * cap
                for b in np.flatnonzero(
                        live.reshape(-1, SUB * LANES).any(axis=1)):
                    sl = slice(b * SUB * LANES, (b + 1) * SUB * LANES)
                    lvg = live[sl].reshape(SUB, LANES)
                    es = (end2[sl] - c * cap).reshape(SUB, LANES)
                    srcg = np.where(lvg, es // LANES, 0)
                    hasg = lvg.any(axis=1)
                    smin_e = np.where(lvg, srcg, np.int64(S - 1)).min(axis=1)
                    smax_e = np.where(lvg, srcg, np.int64(0)).max(axis=1)
                    smin_e = np.where(hasg, smin_e, 0)
                    smax_e = np.where(hasg, np.maximum(smax_e, smin_e), 0)
                    w_e = (smax_e - smin_e) // SUB + 1
                    if int(w_e.max()) > 64:    # can't happen: subset of main
                        raise ClosRoutingError("extra-pick window > 64")
                    ws_e = np.minimum(smin_e, S - SUB * w_e).astype(np.int32)
                    cid_e = np.clip(srcg - ws_e[:, None], 0,
                                    SUB * 64 - 1).astype(np.uint32)
                    sel_e = np.where(
                        lvg, (es % LANES).astype(np.uint32) | (cid_e << 7),
                        np.uint32(1 << 16))
                    ex_ysel.append(sel_e)
                    ex_wstart.append(ws_e)
                    ex_border.append(n_syn | (b << 16))
                    ex_w.append(int(w_e.max()))
                    n_syn += 1
            if ex_border and len(ex_border) <= max(n_batches // 2, 64):
                scan_cap = tuple(range(K))
                ysel_w = np.concatenate([ysel_w] + ex_ysel)
                wstart = np.concatenate(
                    [wstart] + [e.astype(np.int32) for e in ex_wstart])
                order = np.argsort(np.asarray(ex_w), kind="stable")
                eb = np.asarray(ex_border, np.int64)[order]
                ecnt = np.bincount(np.asarray(ex_w)[order], minlength=65)
                base = border.shape[0]
                for cc in range(1, 65):
                    if ecnt[cc]:
                        yext_classes.append((int(cc), int(base),
                                             int(ecnt[cc]), 1))
                        base += int(ecnt[cc])
                border = np.concatenate([border, eb])
    border = border.astype(np.int32)

    spare_mask = (1 << SPARE_BITS) - 1
    dummy = np.zeros((SUB, LANES), np.int32)
    scan_hi = (scan_guards >> SPARE_BITS).astype(np.uint32)

    arrays = dict(
        rowidx=rowidx,
        vals_cs=vals_cs if lut else vals_cs.reshape(S, LANES),
        perm_r1=_pack(perm.r1, lam),
        perm_r2=_pack(perm.r2),
        perm_r3=_pack(perm.r3, scan_guards & spare_mask),
        ycand=ycand.reshape(-1),
        ysel=ysel.view(np.int32),
        ysel_w=ysel_w.view(np.int32),
        wstart=wstart,
        border=border,
        scan_hi=(scan_hi.view(np.int32).reshape(S, LANES)
                 if scan_hi.any() else dummy),
        gbase=gbase, nbids=nbids)
    meta = dict(
        shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
        N=N, V=V, x_rows=int((n + LANES - 1) // LANES),
        scan_stages=scan_stages, C=C, W=W,
        yext_classes=tuple(yext_classes), use_vlut=lut,
        fused_win=fused_win, dense_blocks=dense_blocks, scan_cap=scan_cap)
    return _closg(arrays, meta)


def _pipeline(A: ClosG, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """One program's SpMV through the wrappers of ``clos_cuda`` (``plain``:
    their plain PyTorch versions, on any device)."""
    def k(name):
        return getattr(K, name + "_torch" if plain else name)

    x = x.to(torch.float32)
    if A.fused_win:
        v = k("closg_front_win")(A.gbase, A.nbids, A.perm_r1, A.vals_cs, x,
                                 A.dense_blocks)
    elif A.use_vlut:
        v = k("closg_front_lut")(A.rowidx, A.perm_r1, A.vals_cs, x)
    else:
        v = k("closg_front")(A.rowidx, A.perm_r1, A.vals_cs, x)
    v = _t_bwd(k("clos_invreg")(_t_fwd(v, A.V), A.perm_r2), A.V)
    if A.W:
        y = k("closg_r3_scan_yext")(v, A.perm_r3, A.scan_hi, A.ysel_w,
                                    A.wstart, A.acc_ptr, A.acc_src,
                                    A.scan_cap or A.scan_stages)
    else:
        scr = k("closg_r3_scan")(v, A.perm_r3, A.scan_hi, A.scan_stages)
        y = k("closg_cand_yext")(scr, A.ycand, A.ysel)
    return y.reshape(-1)[: A.m]


@register_spmv("CLOSG", "torch")
def spmv_closg_torch(A, x: torch.Tensor) -> torch.Tensor:
    """CLOSG in plain PyTorch, on any device (the kernels' plain versions)."""
    if isinstance(A, ClosGChunked):
        return torch.cat([spmv_closg_torch(c, x) for c in A.chunks])
    return _pipeline(A, x, plain=True)


@register_spmv("CLOSG", "cuda")
def spmv_closg_cuda(A, x: torch.Tensor) -> torch.Tensor:
    """CLOSG through the hand-written CUDA kernels (CUDA tensors only)."""
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"CLOSG/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")
    if isinstance(A, ClosGChunked):
        return torch.cat([spmv_closg_cuda(c, x) for c in A.chunks])
    return _pipeline(A, x, plain=False)


# SpMM: one SpMV per column of X, for both impls (the JAX lax.scan)
register_spmm_column_loop("CLOSG")


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def unpack_layer(leaf):
    """A packed layer word plane as the three index planes of
    ``clos_route.apply_clos_numpy``."""
    from .clos_route import InVregPlanes
    w = _np(leaf).view(np.uint32)
    return InVregPlanes(lane1=(w & 0x7F).astype(np.int64),
                        subrot=((w >> ROT_SHIFT) & 0x7).astype(np.int64),
                        lane2=((w >> LANE2_SHIFT) & 0x7F).astype(np.int64))


def execute_closg_numpy(A, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program (full scan, candidate
    planes), as in the JAX package."""
    if isinstance(A, ClosGChunked):
        return np.concatenate([execute_closg_numpy(c, x) for c in A.chunks])
    from .clos_route import ClosPerm, apply_clos_numpy

    V = A.V
    n_rows = A.x_rows
    x2d = np.zeros((n_rows * LANES,), np.float64)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(n_rows, LANES)
    wins = x2d[_np(A.rowidx)]
    r1w = _np(A.perm_r1).view(np.uint32)
    lam = (r1w >> SPARE_SHIFT) & 0x7F
    w = np.take_along_axis(wins, lam.astype(np.int64), axis=1)
    if A.use_vlut:
        drow = _np(A.vals_cs)[0].astype(np.float64)
        vals = drow[((r1w >> (SPARE_SHIFT + 7)) & 0x7F).astype(np.int64)]
    else:
        vals = _np(A.vals_cs).astype(np.float64)
    w = (w * vals).reshape(-1)
    w = apply_clos_numpy(w, ClosPerm(V=V, r1=unpack_layer(A.perm_r1),
                                     r2=unpack_layer(A.perm_r2),
                                     r3=unpack_layer(A.perm_r3)))
    sg = (_np(A.perm_r3).view(np.uint32).reshape(-1)
          >> SPARE_SHIFT).astype(np.uint64)
    hi = _np(A.scan_hi).view(np.uint32).reshape(-1)
    if hi.shape[0] == sg.shape[0]:
        sg |= hi.astype(np.uint64) << SPARE_BITS
    for k in A.scan_stages:
        d = 1 << k
        guard = ((sg >> k) & 1) == 1
        sh = np.zeros_like(w)
        sh[d:] = w[:-d]
        w = w + np.where(guard, sh, 0.0)
    C = A.C
    w2 = w.reshape(-1, LANES)
    m_rows = _np(A.ycand).shape[0] // C
    cands = w2[_np(A.ycand)].reshape(C, m_rows, LANES)
    sel = _np(A.ysel).view(np.uint32)
    lam_y = (sel & 0x7F).astype(np.int64)
    cid = (sel >> 7) & 0x7F
    y = np.zeros((m_rows, LANES))
    for c in range(C):
        pick = np.take_along_axis(cands[c], lam_y, axis=1)
        y = np.where(cid == c, pick, y)
    return y.reshape(-1)[: A.m]
