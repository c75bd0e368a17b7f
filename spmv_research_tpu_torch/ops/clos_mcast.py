"""CLOSM: the multicast Clos gather network, x → CSR slots in one route.

Counterpart of ``spmv_research_tpu/ops/clos_mcast.py``. The exact-CLOS
engine (``clos.py``) spends three networks per SpMV: widen (x to the
column-run starts), fill (duplicate within runs) and perm (column-sorted to
CSR order). CLOSM collapses them into one 5-stage *multicast* network that
routes x[c] to every CSR slot of column c:

    spread(x) → R1 → T → R2 → T → R3 × vals → scan → compact network

Duplication is free inside the in-vreg layers: the sublane-rotate stage
lets every (dst sublane, lane) cell read any source sublane, and the final
lane-pick lets every output lane read any middle lane, so one middle-lane
cell feeds any number of outputs. The only routing constraint, globally
(1024 colors, the intermediate vreg) and inside each vreg (128 colors, the
middle lane), is an element coloring: an element's middle position must be
unique within its source group and within every destination group it
feeds. A greedy colorer with per-destination splitting handles it; the rare
uncolorable leftovers spill to a COO side path added to y (their slots
carry exact zero values).

The router (``route_invreg_gather``, ``route_mcast``) is the JAX package's
numpy code, kept line for line so that the planes are identical: the greedy
coloring depends on exact order (``np.lexsort`` keys, ``np.unique``, dict
insertion order, the rotations ``(ei * 97) % W`` and ``(ei * 641) % BLK``),
and its masks are Python ints up to 1024 bits wide.

Two SpMV impls, each the pipeline of ``spmv_closm_pallas`` over the
wrappers of ``clos_cuda`` (the B2 layers ``clos_invreg`` and ``clos_r2``,
the B8 steps ``clos_r3_scan`` and ``clos_r3_valid``):

* ``"cuda"`` — the hand-written kernels (CUDA tensors only);
* ``"torch"`` — their plain PyTorch versions, on any device, in the role
  of the JAX package's ``xla`` impl.

The spread of x and the spill side path are PyTorch in both (XLA, not
Pallas, in the JAX package); on a card the spill's ``index_add_`` adds
with atomics, so its order is not fixed from run to run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .clos import (LANE2_SHIFT, ROT_SHIFT, SPARE_BITS, SPARE_SHIFT, _np,
                   _pack)
from .clos_route import (BLK, LANES, SUB, ClosPerm, ClosRoutingError,
                         InVregPlanes, apply_clos_numpy, apply_invreg_numpy,
                         route_clos)
from .dispatch import register_spmv
from .reference import _segment_sum


# --------------------------------------------------------------------------
# In-vreg multicast gather router
# --------------------------------------------------------------------------

def _pick_bit(mask: int, width: int, off: int) -> int:
    """Lowest set bit of mask rotated by off — spreads picks over [0,width)
    (always taking the lowest bit concentrates colors in the low positions,
    starving the source sublanes of downstream in-vreg routes)."""
    rot = ((mask >> off) | (mask << (width - off))) & ((1 << width) - 1)
    return ((rot & -rot).bit_length() - 1 + off) % width


def route_invreg_gather(vreg: np.ndarray, out_pos: np.ndarray,
                        src_pos: np.ndarray, n_vregs: int, n_lanes: int):
    """Route, within every vreg independently, the gather
    ``out[out_pos] = in[src_pos]`` (outputs distinct per vreg; sources may
    repeat — duplication). Returns (InVregPlanes, spilled_mask) where
    spilled entries could not be routed (their plane cells are left 0).

    Greedy element coloring: element = distinct source position; its middle
    lane must be unique within its source sublane and within every dst
    sublane it feeds; fallback splits per dst sublane (extra source-sublane
    cells), then spills.
    """
    W = n_lanes
    S = SUB
    lane1 = np.zeros((n_vregs * S, W), np.int8)
    subrot = np.zeros((n_vregs * S, W), np.int8)
    lane2 = np.zeros((n_vregs * S, W), np.int8)
    spilled = np.zeros(out_pos.shape[0], bool)

    sigma = src_pos // W
    lam = src_pos % W
    ds = out_pos // W
    dl = out_pos % W

    # group by (vreg, element=src_pos)
    order = np.lexsort((ds, src_pos, vreg))
    v_s, sp_s, sg_s, lm_s = vreg[order], src_pos[order], sigma[order], lam[order]
    ds_s, dl_s = ds[order], dl[order]

    # element boundaries
    eb = np.ones(order.shape[0], bool)
    eb[1:] = (v_s[1:] != v_s[:-1]) | (sp_s[1:] != sp_s[:-1])
    estart = np.nonzero(eb)[0]
    eend = np.append(estart[1:], order.shape[0])

    full = (1 << W) - 1
    # per-vreg free masks, allocated lazily
    free_sig: dict = {}
    free_dst: dict = {}

    for ei in range(estart.shape[0]):
        a, b = estart[ei], eend[ei]
        v = int(v_s[a])
        sg = int(sg_s[a])
        lm = int(lm_s[a])
        if v not in free_sig:
            free_sig[v] = [full] * S
            free_dst[v] = [full] * S
        fs, fd = free_sig[v], free_dst[v]
        dss = ds_s[a:b]
        sublanes = np.unique(dss)
        allowed = fs[sg]
        for s in sublanes:
            allowed &= fd[s]
        off = (ei * 97) % W
        if allowed:
            m = _pick_bit(allowed, W, off)
            fs[sg] &= ~(1 << m)
            lane1[v * S + sg, m] = lm
            for s in sublanes:
                s = int(s)
                fd[s] &= ~(1 << m)
                subrot[v * S + s, m] = (sg - s) % S
            sel = slice(a, b)
            lane2[v * S + ds_s[sel], dl_s[sel]] = m
        else:
            # split per dst sublane
            for s in sublanes:
                s = int(s)
                mm = fs[sg] & fd[s]
                rows = a + np.nonzero(dss == s)[0]
                if mm:
                    m = _pick_bit(mm, W, off)
                    fs[sg] &= ~(1 << m)
                    fd[s] &= ~(1 << m)
                    lane1[v * S + sg, m] = lm
                    subrot[v * S + s, m] = (sg - s) % S
                    lane2[v * S + ds_s[rows], dl_s[rows]] = m
                else:
                    spilled[order[rows]] = True

    return InVregPlanes(lane1=lane1, subrot=subrot, lane2=lane2), spilled


# --------------------------------------------------------------------------
# Global multicast route
# --------------------------------------------------------------------------

@dataclasses.dataclass
class McastRoute:
    V: int
    r1: InVregPlanes   # (8V, 128)
    r2: InVregPlanes   # (8·1024, V/8)
    r3: InVregPlanes   # (8V, 128)
    spilled: np.ndarray  # bool per routed output (True ⇒ not delivered)


def route_mcast(src_slot: np.ndarray, out_slot: np.ndarray,
                N: int) -> McastRoute:
    """Compile the multicast gather out[out_slot[i]] = in[src_slot[i]]
    (out slots distinct; src slots may repeat) into a 5-stage program."""
    V = N // BLK
    if V * BLK != N or (V & (V - 1)) or V < SUB:
        raise ClosRoutingError(f"N must be (power-of-two ≥ 8)·1024, got {N}")
    src_slot = np.asarray(src_slot, np.int64)
    out_slot = np.asarray(out_slot, np.int64)
    K = out_slot.shape[0]
    w = out_slot // BLK          # dst vreg

    # ---- global element coloring: element = distinct src slot ------------
    order = np.lexsort((w, src_slot))
    spilled = np.zeros(K, bool)
    src_o, w_o = src_slot[order], w[order]
    eb = np.ones(K, bool)
    eb[1:] = src_o[1:] != src_o[:-1]
    estart = np.nonzero(eb)[0]
    eend = np.append(estart[1:], K)

    full = (1 << BLK) - 1
    free_src: dict = {}
    free_dst: dict = {}
    color = np.zeros(K, np.int64)         # per routed output (in `order`)

    for ei in range(estart.shape[0]):
        lo, hi = estart[ei], eend[ei]
        av = int(src_o[lo] // BLK)
        ws = w_o[lo:hi]
        wu = np.unique(ws)
        if av not in free_src:
            free_src[av] = full
        allowed = free_src[av]
        for wv in wu:
            wv = int(wv)
            if wv not in free_dst:
                free_dst[wv] = full
            allowed &= free_dst[wv]
        off = (ei * 641) % BLK
        if allowed:
            c = _pick_bit(allowed, BLK, off)
            free_src[av] &= ~(1 << c)
            for wv in wu:
                free_dst[int(wv)] &= ~(1 << c)
            color[lo:hi] = c
        else:
            for wv in wu:
                wv = int(wv)
                mm = free_src[av] & free_dst[wv]
                rows = lo + np.nonzero(ws == wv)[0]
                if mm:
                    c = _pick_bit(mm, BLK, off)
                    free_src[av] &= ~(1 << c)
                    free_dst[wv] &= ~(1 << c)
                    color[rows] = c
                else:
                    spilled[order[rows]] = True

    live = ~spilled[order]
    src_l, out_l = src_o[live], out_slot[order][live]
    col_l, w_l = color[live], w_o[live]
    a_l = src_l // BLK

    # ---- R1: in src vreg, spread position -> color position --------------
    # one (vreg, src, color) cell per distinct pair
    pair_key = a_l * (BLK * N) + col_l * N + src_l
    _, first = np.unique(pair_key, return_index=True)
    r1, sp1 = route_invreg_gather(a_l[first], col_l[first],
                                  src_l[first] % BLK, V, LANES)
    if sp1.any():
        bad = set(pair_key[first[sp1]].tolist())
        mask = np.isin(pair_key, list(bad))
        spill_ids = np.nonzero(live)[0][mask]
        spilled[order[spill_ids]] = True
        keep = ~mask
        src_l, out_l, col_l, w_l, a_l = (src_l[keep], out_l[keep],
                                         col_l[keep], w_l[keep], a_l[keep])
        pair_key = pair_key[keep]

    # ---- R2: in vreg c, position a -> positions {w} -----------------------
    pair2_key = col_l * (BLK * BLK) + w_l * BLK + a_l
    _, first2 = np.unique(pair2_key, return_index=True)
    r2, sp2 = route_invreg_gather(col_l[first2], w_l[first2], a_l[first2],
                                  BLK, V // SUB)
    if sp2.any():
        bad = set(pair2_key[first2[sp2]].tolist())
        mask = np.isin(pair2_key, list(bad))
        idx_in_order = np.nonzero(~spilled[order])[0]
        spilled[order[idx_in_order[mask]]] = True
        keep = ~mask
        src_l, out_l, col_l, w_l, a_l = (src_l[keep], out_l[keep],
                                         col_l[keep], w_l[keep], a_l[keep])

    # ---- R3: in dst vreg w, position c -> final slots ---------------------
    r3, sp3 = route_invreg_gather(w_l, out_l % BLK, col_l, V, LANES)
    if sp3.any():
        idx_in_order = np.nonzero(~spilled[order])[0]
        spilled[order[idx_in_order[sp3]]] = True

    return McastRoute(V=V, r1=r1, r2=r2, r3=r3, spilled=spilled.copy())


def apply_mcast_numpy(v: np.ndarray, r: McastRoute) -> np.ndarray:
    """Reference execution (delivers garbage to unrouted slots — callers
    must mask by vals / validity)."""
    V = r.V
    w = apply_invreg_numpy(v.reshape(SUB * V, LANES), r.r1)
    w = w.reshape(V, BLK).T.copy()
    w = apply_invreg_numpy(w.reshape(SUB * BLK, V // SUB), r.r2)
    w = w.reshape(BLK, V).T.copy()
    w = apply_invreg_numpy(w.reshape(SUB * V, LANES), r.r3)
    return w.reshape(-1)


# --------------------------------------------------------------------------
# Device format
# --------------------------------------------------------------------------

DATA_FIELDS = ("g_r1", "g_r2", "g_r3", "compact_r1", "compact_r2",
               "compact_r3", "vals", "scan_hi", "spill_cols", "spill_rows",
               "spill_vals")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "N", "V", "x_stride",
               "scan_stages", "n_spill")


@dataclasses.dataclass(frozen=True)
class ClosM:
    """Multicast-Clos SpMV program (field for field the JAX ``ClosM``): one
    gather net (x → CSR slots) + scan + one exact compaction net.
    Packed-word planes as in ``clos.Clos``: ``g_r3``'s spare bits carry the
    scan guards, ``compact_r3``'s the valid bit. Spilled nonzeros
    (unroutable, few or none) ride a COO side path: ``spill_*`` padded to a
    multiple of 128, the padding in the overflow row m."""

    g_r1: torch.Tensor
    g_r2: torch.Tensor
    g_r3: torch.Tensor
    compact_r1: torch.Tensor
    compact_r2: torch.Tensor
    compact_r3: torch.Tensor
    vals: torch.Tensor          # (8V, 128) values in CSR slot order
    scan_hi: torch.Tensor
    spill_cols: torch.Tensor    # (n_spill_pad,) int32
    spill_rows: torch.Tensor    # (n_spill_pad,) int32
    spill_vals: torch.Tensor    # (n_spill_pad,)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    x_stride: int
    scan_stages: Tuple[int, ...]
    n_spill: int

    format_name = "CLOSM"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "ClosM":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return self.N * (self.vals.element_size() + 6 * 4) + self.n_spill * 12


def _closm(arrays: dict, meta: dict) -> ClosM:
    """ClosM from numpy program arrays and meta fields (on the CPU)."""
    return ClosM(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                    for k in DATA_FIELDS}, **meta)


def closm_from_jax(leaves: dict, meta: dict) -> ClosM:
    """The port's ``ClosM`` for a program built by the JAX package:
    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value."""
    return _closm({k: np.array(leaves[k]) for k in DATA_FIELDS},
                  {k: meta[k] for k in META_FIELDS})


def build_clos_mcast(csr: HostCSR, dtype=np.float32, max_N: int = 1 << 20,
                     max_spill_frac: float = 0.02) -> ClosM:
    """Compile host CSR into a CLOSM program (the arrays of the JAX
    package's ``build_clos_mcast``). Raises ``ClosRoutingError`` past
    ``max_N`` slots or where more than ``max_spill_frac`` of the nonzeros
    spill."""
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    need = max(nnz, n, m, 8 * BLK)
    N = 1 << int(need - 1).bit_length()
    if N > max_N:
        raise ClosRoutingError(f"matrix too large for single-block clos (N={N})")
    V = N // BLK

    lengths = csr.row_lengths()
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    cols = csr.ja.astype(np.int64)

    # spread x over the WHOLE slot space (stride = floor(N/n)): the global
    # colorer's source and destination groups must both stay under 1024
    # entries per vreg, which needs columns spread over all V vregs
    x_stride = max(N // max(n, 1), 1)

    g = route_mcast(cols * x_stride, np.arange(nnz, dtype=np.int64), N)
    spill_frac = g.spilled.mean() if nnz else 0.0
    if spill_frac > max_spill_frac:
        raise ClosRoutingError(
            f"mcast spill fraction {spill_frac:.3f} > {max_spill_frac}")

    vals = np.zeros(N, dtype=dt)
    vals[:nnz] = csr.a.astype(dt)
    vals[:nnz][g.spilled] = 0.0        # a view: the spilled slots carry 0

    # scan guards over CSR slot space (identical to clos.build_clos)
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

    nonempty = np.nonzero(lengths > 0)[0].astype(np.int64)
    last_slot = (csr.ia[1:].astype(np.int64) - 1)[nonempty]
    compact = route_clos(last_slot, nonempty, N)
    out_valid = np.zeros(N, dtype=np.uint32)
    out_valid[nonempty] = 1

    spare_mask = (1 << SPARE_BITS) - 1
    dummy = np.zeros((SUB, LANES), np.int32)
    scan_hi = (scan_guards >> SPARE_BITS).astype(np.uint32)

    sp_idx = np.nonzero(g.spilled)[0]
    n_spill = int(sp_idx.shape[0])
    sp_pad = max(((n_spill + 127) // 128) * 128, 128)
    sc = np.zeros(sp_pad, np.int32)
    sr = np.full(sp_pad, m, np.int32)   # overflow row, sliced off
    sv = np.zeros(sp_pad, dt)
    sc[:n_spill] = cols[sp_idx]
    sr[:n_spill] = rows[sp_idx]
    sv[:n_spill] = csr.a[sp_idx].astype(dt)

    arrays = dict(
        g_r1=_pack(g.r1), g_r2=_pack(g.r2),
        g_r3=_pack(g.r3, scan_guards & spare_mask),
        compact_r1=_pack(compact.r1), compact_r2=_pack(compact.r2),
        compact_r3=_pack(compact.r3, out_valid),
        vals=vals.reshape(SUB * V, LANES),
        scan_hi=(scan_hi.view(np.int32).reshape(SUB * V, LANES)
                 if scan_hi.any() else dummy),
        spill_cols=sc, spill_rows=sr, spill_vals=sv)
    return _closm(arrays, dict(
        shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded, N=N, V=V,
        x_stride=x_stride, scan_stages=scan_stages, n_spill=n_spill))


# ------------------------------------------------------------------ the SpMV

def _spread(x: torch.Tensor, N: int, stride: int) -> torch.Tensor:
    """x[c] placed at slot c·stride (any integer stride), zero elsewhere:
    the (8V, 128) plane the gather network reads (a fill and one strided
    copy)."""
    v = x.new_zeros(N)
    v[: x.shape[0] * stride: stride] = x
    return v.view(-1, LANES)


def _spill_y(A: ClosM, x: torch.Tensor) -> torch.Tensor:
    """The spilled nonzeros' share of y: gather, multiply, a segment sum
    over m + 1 rows (the padding in row m, sliced off)."""
    prods = A.spill_vals * x.index_select(0, A.spill_cols)
    return _segment_sum(prods, A.spill_rows, A.m + 1)[: A.m]


def _pipeline(A: ClosM, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """One SpMV through the wrappers of ``clos_cuda`` (``plain``: their
    plain PyTorch versions, on any device)."""
    from . import clos_cuda as K

    def k(name):
        return getattr(K, name + "_torch" if plain else name)

    def net(v, r1, r2):          # the r1 and r2 layers of one network
        return k("clos_r2")(k("clos_invreg")(v, r1), r2, A.V)

    x = x.to(A.vals.dtype)
    v = net(_spread(x, A.N, A.x_stride), A.g_r1, A.g_r2)
    v = k("clos_r3_scan")(v, A.g_r3, A.vals, A.scan_hi, A.scan_stages)
    v = k("clos_r3_valid")(net(v, A.compact_r1, A.compact_r2), A.compact_r3,
                           A.m)             # only the blocks that hold y
    y = v.reshape(-1)[: A.m]
    if A.n_spill:
        y = y + _spill_y(A, x)
    return y


@register_spmv("CLOSM", "torch")
def spmv_closm_torch(A: ClosM, x: torch.Tensor) -> torch.Tensor:
    """CLOSM in plain PyTorch, on any device (the kernels' plain versions;
    the JAX ``xla`` impl's role)."""
    return _pipeline(A, x, plain=True)


@register_spmv("CLOSM", "cuda")
def spmv_closm_cuda(A: ClosM, x: torch.Tensor) -> torch.Tensor:
    """CLOSM through the hand-written CUDA kernels (CUDA tensors only)."""
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"CLOSM/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")
    return _pipeline(A, x, plain=False)


def execute_closm_numpy(A: ClosM, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program."""

    def unpack(leaf):
        w = _np(leaf).view(np.uint32)
        return InVregPlanes(lane1=(w & 0x7F).astype(np.int64),
                            subrot=((w >> ROT_SHIFT) & 0x7).astype(np.int64),
                            lane2=((w >> LANE2_SHIFT) & 0x7F).astype(np.int64))

    N, V = A.N, A.V
    stride = A.x_stride
    v = np.zeros(N, np.float64)
    v[: x.shape[0] * stride: stride] = x
    r = McastRoute(V=V, r1=unpack(A.g_r1), r2=unpack(A.g_r2),
                   r3=unpack(A.g_r3), spilled=np.zeros(0, bool))
    w = apply_mcast_numpy(v, r)
    w = w * _np(A.vals).reshape(-1).astype(np.float64)
    sg = (_np(A.g_r3).view(np.uint32).reshape(-1) >> SPARE_SHIFT
          ).astype(np.uint64)
    hi = _np(A.scan_hi).view(np.uint32).reshape(-1)
    if hi.shape[0] == sg.shape[0]:
        sg |= hi.astype(np.uint64) << SPARE_BITS
    for k in A.scan_stages:
        d = 1 << k
        guard = ((sg >> k) & 1) == 1
        sh = np.zeros_like(w)
        sh[d:] = w[:-d]
        w = w + np.where(guard, sh, 0.0)
    w = apply_clos_numpy(w, ClosPerm(V=V, r1=unpack(A.compact_r1),
                                     r2=unpack(A.compact_r2),
                                     r3=unpack(A.compact_r3)))
    valid = (_np(A.compact_r3).view(np.uint32).reshape(-1)
             >> SPARE_SHIFT) & 1
    y = (w * valid)[: A.m]
    if A.n_spill:
        sc = _np(A.spill_cols)
        sr = _np(A.spill_rows)
        sv = _np(A.spill_vals).astype(np.float64)
        np.add.at(y, sr[sr < A.m], (sv * x[sc])[sr < A.m])
    return y
