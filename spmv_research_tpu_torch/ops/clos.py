"""CLOS: the radix-1024 routed SpMV engine, and the Clos packed-word layout.

Counterpart of ``spmv_research_tpu/ops/clos.py``: the bit-layout constants,
``_pack``, ``_stage_bit``, the plain in-vreg layer (``_invreg_xla``) and the
``_t_fwd``/``_t_bwd`` transposes, which CLOSG shares; and the exact-CLOS
engine, the fallback ``build_best`` tries where CLOSG refuses a matrix: the
``Clos`` program, ``build_clos`` (which refuses N > 2^20 slots),
``execute_clos_numpy``, ``clos_from_jax``, and two SpMV impls:

* ``"cuda"`` — ``spmv_clos_pallas``'s pipeline on the hand-written kernels:
  per network the r1 layer on ``clos_invreg`` and the r2 layer with the
  ``_t_fwd``/``_t_bwd`` transposes around it on ``clos_r2`` (both B2: the
  transposes are folded into the kernel's addressing), then the network's
  r3 step on B8 (``clos_r3_fill``, ``clos_r3_scan``, ``clos_r3_valid`` in
  ``clos_cuda.py``);
* ``"torch"`` — the same pipeline on the kernels' plain versions, in the
  role of the JAX package's ``xla`` impl (the same function: rolls,
  selects, one product per slot, adds in the same order).

One SpMV: x at slots [0, n) → widen network (x to the first slot of each
column run in column-sorted slot space) → forward fill within the runs →
perm network (to CSR slot order) → × vals → segmented scan by row → compact
network (each row's last slot to slot r) → out-valid mask → y = slots
[0, m). Each network is a 5-stage Clos program (``clos_route.py``).

Each layer word packs one slot's three in-vreg shuffle indices: bits [0,7)
lane1, [7,10) sublane rotation, [10,17) lane2; the 15 spare bits [17,32)
carry whatever follows the layer (CLOSG: λ in r1, scan guards in r3; CLOS:
fill take bits in widen_r3, scan guards in perm_r3, the out-valid bit in
compact_r3). Words use all 32 bits, and torch's int32 ``>>`` is
arithmetic, so every read masks after shifting.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.formats import _move
from ..core.host import HostCSR
from .clos_route import (BLK, LANES, SUB, ClosPerm, ClosRoutingError,
                         InVregPlanes, apply_clos_numpy, route_clos)
from .dispatch import register_spmv

LANE1_SHIFT, ROT_SHIFT, LANE2_SHIFT, SPARE_SHIFT = 0, 7, 10, 17
SPARE_BITS = 32 - SPARE_SHIFT  # 15


def _pack(p, spare: np.ndarray | None = None) -> np.ndarray:
    """Pack one layer's planes (+optional spare-bit payload) into int32."""
    w = (p.lane1.astype(np.uint32)
         | (p.subrot.astype(np.uint32) << ROT_SHIFT)
         | (p.lane2.astype(np.uint32) << LANE2_SHIFT))
    if spare is not None:
        w |= spare.reshape(w.shape).astype(np.uint32) << SPARE_SHIFT
    return w.view(np.int32)


def _stage_bit(k: int, lo_word: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Guard bit of scan stage k: bit 17+k of the r3 word for k < 15, else
    bit k-15 of the overflow plane ``hi``."""
    if k < SPARE_BITS:
        return ((lo_word >> (SPARE_SHIFT + k)) & 1) != 0
    return ((hi >> (k - SPARE_BITS)) & 1) != 0


def invreg_torch(v: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """One in-vreg layer on an (S, L) array: lane-pick by lane1, rotate each
    8-row group by ``rot``, lane-pick by lane2 (``_invreg_xla``)."""
    S, L = v.shape
    l1 = (word & 0x7F).long()
    rot = ((word >> ROT_SHIFT) & 0x7).long()
    l2 = ((word >> LANE2_SHIFT) & 0x7F).long()
    t1 = torch.gather(v, 1, l1)
    rows = torch.arange(S, device=v.device).unsqueeze(1)
    src = rows // SUB * SUB + (rows % SUB + rot) % SUB
    t2 = torch.gather(t1, 0, src)
    return torch.gather(t2, 1, l2)


def _t_fwd(v: torch.Tensor, V: int) -> torch.Tensor:
    """(8V, 128) slot layout -> transposed (8·1024, V/8) layout; a stack of
    C such planes (CLOSGX) is transposed plane by plane in one copy."""
    return (v.reshape(-1, V, BLK).transpose(1, 2).contiguous()
            .view(-1, V // SUB))


def _t_bwd(v: torch.Tensor, V: int) -> torch.Tensor:
    return (v.reshape(-1, BLK, V).transpose(1, 2).contiguous()
            .view(-1, LANES))


# ------------------------------------------------------------ the CLOS engine

DATA_FIELDS = ("widen_r1", "widen_r2", "widen_r3", "perm_r1", "perm_r2",
               "perm_r3", "compact_r1", "compact_r2", "compact_r3",
               "fill_hi", "vals", "scan_hi")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "N", "V", "fill_stages",
               "scan_stages")


@dataclasses.dataclass(frozen=True)
class Clos:
    """Compiled Clos routing program (field for field the JAX ``Clos``).

    Each ``*_r*`` leaf packs one layer's three in-vreg shuffle planes into
    one int32 word per slot; ``*_r{1,3}`` are (8V, 128), ``*_r2`` is
    (8·1024, V/8) (the middle layer works on the transposed plane). Fill and
    scan stages past 14 keep their bits in ``fill_hi``/``scan_hi`` ((8V,128)
    int32, bit k-15 for stage k; all-zero (8,128) dummies when unused)."""

    widen_r1: torch.Tensor
    widen_r2: torch.Tensor
    widen_r3: torch.Tensor
    perm_r1: torch.Tensor
    perm_r2: torch.Tensor
    perm_r3: torch.Tensor
    compact_r1: torch.Tensor
    compact_r2: torch.Tensor
    compact_r3: torch.Tensor
    fill_hi: torch.Tensor
    vals: torch.Tensor         # (8V, 128) values in CSR slot order
    scan_hi: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    fill_stages: Tuple[int, ...]
    scan_stages: Tuple[int, ...]

    format_name = "CLOS"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "Clos":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        words = 9 * 4  # one packed int32 word plane per layer, 9 layers
        extra = (self.fill_hi.numel() + self.scan_hi.numel()) * 4
        return self.N * (self.vals.element_size() + words) + extra


def _clos(arrays: dict, meta: dict) -> Clos:
    """Clos from numpy program arrays and meta fields (on the CPU)."""
    return Clos(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                   for k in DATA_FIELDS}, **meta)


def clos_from_jax(leaves: dict, meta: dict) -> Clos:
    """The port's ``Clos`` for a program built by the JAX package:
    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value."""
    return _clos({k: np.array(leaves[k]) for k in DATA_FIELDS},
                 {k: meta[k] for k in META_FIELDS})


def build_clos(csr: HostCSR, dtype=np.float32, max_N: int = 1 << 20) -> Clos:
    """Compile host CSR into a Clos routing program (the arrays of the JAX
    package's ``build_clos``). Raises ``ClosRoutingError`` past ``max_N``
    slots."""
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

    # column-sorted slot space (as routing.py's build_bfly_program)
    css = np.lexsort((rows, cols))
    cols_css = cols[css]
    first = np.ones(nnz, dtype=bool)
    first[1:] = cols_css[1:] != cols_css[:-1]
    run_start_idx = np.nonzero(first)[0]
    distinct_cols = cols_css[run_start_idx]

    widen = route_clos(distinct_cols, run_start_idx, N)

    run_start_of = np.zeros(N, dtype=np.int64)
    run_start_of[:nnz] = run_start_idx[np.cumsum(first) - 1]
    reach_f = np.arange(N, dtype=np.int64) - run_start_of
    reach_f[nnz:] = 0
    fill_words = np.zeros(N, np.uint32)
    fill_stages = []
    max_rf = int(reach_f[:nnz].max()) if nnz else 0
    for k in range(max_rf.bit_length()):
        hsb = (reach_f > 0) & ((reach_f >> k) == 1)
        if hsb.any():
            fill_words |= hsb.astype(np.uint32) << k
            fill_stages.append(k)

    perm = route_clos(np.arange(nnz, dtype=np.int64), css.astype(np.int64), N)

    vals = np.zeros(N, dtype=dt)
    vals[:nnz] = csr.a.astype(dt)
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
    fill_hi = (fill_words >> SPARE_BITS).astype(np.uint32)
    scan_hi = (scan_guards >> SPARE_BITS).astype(np.uint32)
    arrays = dict(
        widen_r1=_pack(widen.r1), widen_r2=_pack(widen.r2),
        widen_r3=_pack(widen.r3, fill_words & spare_mask),
        perm_r1=_pack(perm.r1), perm_r2=_pack(perm.r2),
        perm_r3=_pack(perm.r3, scan_guards & spare_mask),
        compact_r1=_pack(compact.r1), compact_r2=_pack(compact.r2),
        compact_r3=_pack(compact.r3, out_valid),
        fill_hi=(fill_hi.view(np.int32).reshape(SUB * V, LANES)
                 if fill_hi.any() else dummy),
        vals=vals.reshape(SUB * V, LANES),
        scan_hi=(scan_hi.view(np.int32).reshape(SUB * V, LANES)
                 if scan_hi.any() else dummy))
    return _clos(arrays, dict(
        shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded, N=N, V=V,
        fill_stages=tuple(fill_stages), scan_stages=scan_stages))


def _pipeline(A: Clos, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """One SpMV through the wrappers of ``clos_cuda`` (``plain``: their
    plain PyTorch versions, on any device)."""
    from . import clos_cuda as K

    def k(name):
        return getattr(K, name + "_torch" if plain else name)

    def net(v, r1, r2):          # the r1 and r2 layers of one network
        return k("clos_r2")(k("clos_invreg")(v, r1), r2, A.V)

    v = F.pad(x.to(A.vals.dtype), (0, A.N - x.shape[0])).view(-1, LANES)
    v = k("clos_r3_fill")(net(v, A.widen_r1, A.widen_r2), A.widen_r3,
                          A.fill_hi, A.fill_stages)
    v = k("clos_r3_scan")(net(v, A.perm_r1, A.perm_r2), A.perm_r3, A.vals,
                          A.scan_hi, A.scan_stages)
    v = k("clos_r3_valid")(net(v, A.compact_r1, A.compact_r2), A.compact_r3,
                           A.m)             # only the blocks that hold y
    return v.reshape(-1)[: A.m]


@register_spmv("CLOS", "torch")
def spmv_clos_torch(A: Clos, x: torch.Tensor) -> torch.Tensor:
    """CLOS in plain PyTorch, on any device (the kernels' plain versions;
    the JAX ``xla`` impl's role)."""
    return _pipeline(A, x, plain=True)


@register_spmv("CLOS", "cuda")
def spmv_clos_cuda(A: Clos, x: torch.Tensor) -> torch.Tensor:
    """CLOS through the hand-written CUDA kernels (CUDA tensors only)."""
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"CLOS/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")
    return _pipeline(A, x, plain=False)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def execute_clos_numpy(A: Clos, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program."""
    def unpack(leaf):
        w = _np(leaf).view(np.uint32)
        return InVregPlanes(lane1=(w & 0x7F).astype(np.int64),
                            subrot=((w >> ROT_SHIFT) & 0x7).astype(np.int64),
                            lane2=((w >> LANE2_SHIFT) & 0x7F).astype(np.int64))

    def spare(leaf, hi_leaf):
        lo = _np(leaf).view(np.uint32).reshape(-1) >> SPARE_SHIFT
        hi = _np(hi_leaf).view(np.uint32).reshape(-1)
        out = lo.astype(np.uint64)
        if hi.shape[0] == lo.shape[0]:
            out |= hi.astype(np.uint64) << SPARE_BITS
        return out

    def net(w, r1, r2, r3):
        return apply_clos_numpy(w, ClosPerm(V=A.V, r1=unpack(r1),
                                            r2=unpack(r2), r3=unpack(r3)))

    def shifted(w, d):
        sh = np.zeros_like(w)
        sh[d:] = w[:-d]
        return sh

    v = np.zeros(A.N, np.float64)
    v[: x.shape[0]] = x
    w = net(v, A.widen_r1, A.widen_r2, A.widen_r3)
    fw = spare(A.widen_r3, A.fill_hi)
    for k in A.fill_stages:
        w = np.where(((fw >> k) & 1) == 1, shifted(w, 1 << k), w)
    w = net(w, A.perm_r1, A.perm_r2, A.perm_r3)
    w = w * _np(A.vals).reshape(-1).astype(np.float64)
    sg = spare(A.perm_r3, A.scan_hi)
    for k in A.scan_stages:
        w = w + np.where(((sg >> k) & 1) == 1, shifted(w, 1 << k), 0.0)
    w = net(w, A.compact_r1, A.compact_r2, A.compact_r3)
    valid = (_np(A.compact_r3).view(np.uint32).reshape(-1)
             >> SPARE_SHIFT) & 1
    return (w * valid)[: A.m]
