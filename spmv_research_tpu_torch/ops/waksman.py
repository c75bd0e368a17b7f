"""Exact Beneš/Waksman routing: single-pass permutation networks.

Counterpart of ``spmv_research_tpu/ops/waksman.py``, copied so that the port
builds the identical BFLY programs. A Beneš network on N = 2^L positions
(exchange distances 1, 2, …, N/2, …, 2, 1: XOR butterflies) routes any
permutation with no conflict. ``route_waksman`` routes an injective partial
map (padded to a full permutation; mask bits only for the real elements)
with the classic looping algorithm, 2-colouring the constraint cycles level
by level. It takes the C++ router of the native host library
(``native/sparse_host.cpp`` ``waksman_route``) where the library loaded, and
the vectorised numpy router otherwise; both give the same
:class:`~.routing.PassMasks` contract (default-keep stages, no keep plane).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .routing import PassMasks, RoutingError


def _pad_to_full_permutation(src: np.ndarray, tgt: np.ndarray, N: int):
    """Extend a partial injective route to a full permutation; returns
    (src_full, tgt_full, real_mask)."""
    used_s = np.zeros(N, dtype=bool)
    used_t = np.zeros(N, dtype=bool)
    used_s[src] = True
    used_t[tgt] = True
    free_s = np.nonzero(~used_s)[0]
    free_t = np.nonzero(~used_t)[0]
    src_full = np.concatenate([src, free_s])
    tgt_full = np.concatenate([tgt, free_t])
    real = np.zeros(N, dtype=bool)
    real[: src.size] = True
    return src_full.astype(np.int64), tgt_full.astype(np.int64), real


def _pair_partner(keys: np.ndarray) -> np.ndarray:
    """Elements come in pairs sharing a key; return partner index per element."""
    order = np.argsort(keys, kind="stable")
    partner = np.empty(keys.size, dtype=np.int64)
    partner[order[0::2]] = order[1::2]
    partner[order[1::2]] = order[0::2]
    return partner


def _orbit_reps(step: np.ndarray, rounds: int) -> np.ndarray:
    """Minimum element id in each orbit of the permutation `step`."""
    rep = np.arange(step.size, dtype=np.int64)
    f = step.copy()
    for _ in range(rounds):
        rep = np.minimum(rep, rep[f])
        f = f[f]
    return rep


def route_waksman(src: np.ndarray, tgt: np.ndarray, L: int, N: int,
                  use_native: bool = True) -> PassMasks:
    """Exact single-pass Beneš routing of an injective partial map src→tgt.

    Uses the C++ cycle-walking router (native/sparse_host.cpp waksman_route)
    when available; numpy otherwise (identical output contract)."""
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    if src.size and (np.unique(src).size != src.size
                     or np.unique(tgt).size != tgt.size):
        raise RoutingError("waksman requires injective src and tgt")
    s, t, real = _pad_to_full_permutation(src, tgt, N)

    if use_native:
        from ..io import native as _native
        if _native.have_native():
            A, B, ks = _native.waksman_route_native(
                s, t, real.astype(np.uint8), N, L)
            stages = tuple((i // 32, i % 32, k) for i, k in enumerate(ks))
            return PassMasks(A=A, B=B, stages=stages)
    E = N

    colors = np.zeros(E, dtype=np.int64)  # packed low bits, grows per level
    color_bit = np.zeros((max(L - 1, 0), E), dtype=np.int64)

    rounds = L + 2
    for lvl in range(L - 1):
        # subproblem = colors (low lvl bits); pairs share all other bits
        key_in = ((s >> (lvl + 1)) << lvl) | colors
        key_out = ((t >> (lvl + 1)) << lvl) | colors
        pin = _pair_partner(key_in)
        pout = _pair_partner(key_out)
        step = pout[pin]
        rep = _orbit_reps(step, rounds)
        # base coloring: antisymmetric w.r.t. the in-partner (different orbits)
        c = (rep > rep[pin]).astype(np.int64)
        # each constraint cycle admits two colorings (flip all); pick the one
        # with fewer entry+exit swaps among REAL elements, so that local
        # permutations keep high stages empty (→ stage skipping)
        sbit = (s >> lvl) & 1
        tbit = (t >> lvl) & 1
        cost0 = ((sbit ^ c) + (c ^ tbit)) * real  # cost if orbit keeps c
        cost1 = ((sbit ^ c ^ 1) + (c ^ 1 ^ tbit)) * real
        # pair orbits: flipping an orbit forces flipping its partner orbit
        # (colors must stay antisymmetric across pin/pout) — group by the
        # unordered pair {rep, rep[pin]}
        rep2 = rep[pin]
        group = np.minimum(rep, rep2)
        g0 = np.zeros(E, np.int64)
        g1 = np.zeros(E, np.int64)
        np.add.at(g0, group, cost0)
        np.add.at(g1, group, cost1)
        flip = (g1 < g0)[group].astype(np.int64)
        c = c ^ flip
        color_bit[lvl] = c
        colors = colors | (c << lvl)

    # --- emit stages -------------------------------------------------------
    # Exact routing needs no keep-plane: stage semantics are default-keep
    # (out[p] = B[p] ? v[p^d] : v[p]). Dead copies left at vacated cells are
    # harmless: real flows never read unrouted cells, every slot/y cell is
    # overwritten by its own route's arrival (or by fill / vals / out_valid).
    planes_B: List[np.ndarray] = []
    stage_list: List[Tuple[int, int, int]] = []

    def emit(k: int, p_after: np.ndarray, swap: np.ndarray):
        sel = real
        if not (swap & sel).any():
            return  # identity stage for all real elements → skip
        bi = len(stage_list)
        w, b = divmod(bi, 32)
        if w == len(planes_B):
            planes_B.append(np.zeros(N, np.uint32))
        bit = np.uint32(1 << b)
        # each swapping element sets the bit at its own destination; for a
        # true pair swap both partners are marked movers, covering both cells
        planes_B[w][p_after[swap & sel]] |= bit
        stage_list.append((w, b, k))

    low = lambda lvl: colors & ((1 << lvl) - 1)

    # entry stages, levels 0..L-2
    for lvl in range(L - 1):
        c = color_bit[lvl]
        p_after = (((s >> (lvl + 1)) << (lvl + 1))
                   | (c << lvl) | low(lvl))
        swap = ((s >> lvl) & 1) != c
        emit(lvl, p_after, swap)

    # middle stage, level L-1
    lvl = L - 1
    p_after = (((t >> lvl) & 1) << lvl) | low(lvl)
    swap = ((s >> lvl) & 1) != ((t >> lvl) & 1)
    emit(lvl, p_after, swap)

    # exit stages, levels L-2..0
    for lvl in range(L - 2, -1, -1):
        c = color_bit[lvl]
        p_after = ((t >> lvl) << lvl) | low(lvl)
        swap = c != ((t >> lvl) & 1)
        emit(lvl, p_after, swap)

    B = np.stack(planes_B) if planes_B else np.zeros((0, N), np.uint32)
    A = np.zeros((0, N), np.uint32)  # default-keep semantics: no keep plane
    return PassMasks(A=A, B=B, stages=tuple(stage_list))
