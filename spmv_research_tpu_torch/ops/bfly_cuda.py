"""The BFLY engine's CUDA kernels: build, wrappers, plain versions.

Counterpart of ``spmv_research_tpu/ops/bfly_pallas.py``. One wrapper per
Pallas kernel (sources and design notes in ``csrc/bfly.cu``):

=================  ==========================================================
wrapper            replaces
=================  ==========================================================
``bfly_xor_net``   ``bfly_pallas.py:_xor_net_kernel`` (one exchange network:
                   out = take bit ? v[p XOR 2^k] : v)
``bfly_fill``      ``bfly_pallas.py:_fill_kernel`` (forward fill: out = take
                   bit k ? v[p − 2^k] : v)
``bfly_scan``      ``bfly_pallas.py:_scan_kernel`` (segmented scan: out = v +
                   (guard bit k ? v[p − 2^k] : 0))
``bfly_full``      ``bfly_pallas.py:_full_kernel`` (the whole program, × vals
                   and × valid included)
=================  ==========================================================

All four run the same phase kernel: the wrapper's stages become stage codes
(``_codes`` for B10's program, ``b9_codes`` for one network, fill or scan),
``plan_phases`` cuts them into phases of tiles, and each phase is one
launch. A Waksman network of L = 20 takes three launches, a fill or a scan
one, where one a stage took 39, 6 and 9.

The shifts wrap over the N slots as ``jnp.roll`` and ``torch.roll`` do (a
set bit never wraps). Each wrapper takes the kernel's plain PyTorch version
(``*_torch``) only when its tensors lie on the CPU; for CUDA tensors it
launches the kernel or raises, nothing falls back. ``LAUNCHES`` counts, per
wrapper, its kernel launches. A network, fill or scan with no stages
returns its input and launches nothing, as the JAX package skips the call.

The kernels are compiled by ``nvcc`` from ``csrc/bfly.cu`` at first CUDA use
(``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence, Tuple

import torch

from .cuda_lib import CudaLib, check as _check, on_cuda as _on_cuda
from .cuda_lib import stream as _stream

LAUNCHES = {"bfly_xor_net": 0, "bfly_fill": 0, "bfly_scan": 0,
            "bfly_full": 0}
Stages = Sequence[Tuple[int, int, int]]
MAX_CODES = 256                  # csrc/bfly.cu kMaxCodes
KIND_XOR, KIND_FILL, KIND_SCAN = 0, 1, 2
NET_WIDEN, NET_PERM, NET_COMPACT = 0, 1, 2
PREMUL = 1 << 20                 # the stage reads its values × vals
# B10's phases (csrc/bfly.cu): tilings, the largest tile (2^14 fp32 = 64 KB,
# 512 threads of 32 slots), the halo budget and the phase table's size
CONTIG, STRIDED, GLOBAL = 0, 1, 2
MAX_TILE_LOG = 14
HALO_MAX = 1024
MAX_PHASES = 128


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bfly_full.argtypes = ([p] * 11
                              + [i64, ctypes.POINTER(ctypes.c_uint32), i32,
                                 i32, ctypes.POINTER(ctypes.c_int32), i32,
                                 i32, p])
    lib.bfly_full.restype = i32


_CUDA = CudaLib("bfly", _bind)
SOURCE = _CUDA.source
build = _CUDA.build
build_log = _CUDA.build_log
_launch = _CUDA.launch


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions

def bfly_xor_net_torch(v: torch.Tensor, B: torch.Tensor,
                       stages: Stages) -> torch.Tensor:
    """Default-keep exchange network over the flat plane v (N,): per stage
    (w, b, k), out = bit b of B[w] ? v[p XOR 2^k] : v (``_xor_net_flat``:
    the partner from two rolls and a select)."""
    pos = torch.arange(v.numel(), dtype=torch.int32, device=v.device)
    for w, b, k in stages:
        d = 1 << k
        partner = torch.where((pos & d) != 0, torch.roll(v, d),
                              torch.roll(v, -d))
        v = torch.where(((B[w] >> b) & 1) != 0, partner, v)
    return v


def bfly_fill_torch(v: torch.Tensor, words: torch.Tensor,
                    stages: Sequence[int]) -> torch.Tensor:
    """Forward fill: per stage k, out = bit k of words ? v[p − 2^k] : v."""
    for k in stages:
        v = torch.where(((words >> k) & 1) != 0, torch.roll(v, 1 << k), v)
    return v


def bfly_scan_torch(v: torch.Tensor, guards: torch.Tensor,
                    stages: Sequence[int]) -> torch.Tensor:
    """Segmented scan: per stage k, out = v + (bit k of guards ?
    v[p − 2^k] : 0)."""
    for k in stages:
        v = v + torch.where(((guards >> k) & 1) != 0, torch.roll(v, 1 << k),
                            0.0)
    return v


def bfly_full_torch(v, widen_B, fill_words, perm_B, vals, scan_guards,
                    compact_B, out_valid, widen_stages: Stages,
                    fill_stages: Sequence[int], perm_stages: Stages,
                    scan_stages: Sequence[int],
                    compact_stages: Stages) -> torch.Tensor:
    """The whole program on the spread x (N,): widen, fill, perm, × vals,
    scan, compact, × out_valid (``_full_kernel``; B9's plain chain)."""
    v = bfly_xor_net_torch(v, widen_B, widen_stages)
    v = bfly_fill_torch(v, fill_words, fill_stages)
    v = bfly_xor_net_torch(v, perm_B, perm_stages) * vals
    v = bfly_scan_torch(v, scan_guards, scan_stages)
    return bfly_xor_net_torch(v, compact_B, compact_stages) * out_valid


# ------------------------------------------------------------------ wrappers

def _check_plane(v: torch.Tensor) -> int:
    n = v.numel()
    _check(v, "v", torch.float32, (n,))
    if n < 1 or n & (n - 1):
        raise ValueError(f"BFLY planes hold a power of two of slots, not {n}")
    return n


def _check_words(t: torch.Tensor, name: str, n: int) -> None:
    _check(t, name, torch.int32, (n,))


def _check_stages(B: torch.Tensor, stages: Stages, n: int) -> None:
    _check(B, "B", torch.int32, (B.shape[0], n))
    for w, b, k in stages:
        if not (0 <= w < B.shape[0] and 0 <= b < 32 and 0 <= k < 31
                and (1 << k) < n):
            raise ValueError(f"stage {(w, b, k)} does not fit {B.shape[0]} "
                             f"word planes of {n} slots")


def _check_shifts(stages: Sequence[int], n: int) -> None:
    if any(not 0 <= k < 31 or (1 << k) >= n for k in stages):
        raise ValueError(f"shift stages {tuple(stages)} do not fit {n} slots")


def _xor_codes(net: int, stages: Stages) -> list:
    return [k | b << 5 | w << 10 | KIND_XOR << 16 | net << 18
            for w, b, k in stages]


def _shift_codes(kind: int, stages: Sequence[int]) -> list:
    return [k | kind << 16 for k in stages]


@lru_cache(maxsize=64)
def _codes(widen_stages, fill_stages, perm_stages, scan_stages,
           compact_stages):
    """B10's program: the stage codes (``csrc/bfly.cu``: k, b, w, kind,
    network, and the × vals flag on the first stage after the perm
    network), their count, and whether the final pass reads × vals itself
    (no stage follows the perm network)."""
    head = (_xor_codes(NET_WIDEN, widen_stages)
            + _shift_codes(KIND_FILL, fill_stages)
            + _xor_codes(NET_PERM, perm_stages))
    tail = (_shift_codes(KIND_SCAN, scan_stages)
            + _xor_codes(NET_COMPACT, compact_stages))
    if tail:
        tail[0] |= PREMUL
    codes = tuple(head + tail)
    return codes, len(codes), int(not tail)


# each B9 wrapper's stage codes and the slot of ``bfly_full``'s word-plane
# arguments (widen_b, fill_words, perm_b, vals, scan_guards, compact_b)
# its one plane goes in: a network is coded as the widen network
_B9 = {"bfly_xor_net": (lambda st: _xor_codes(NET_WIDEN, st), 0),
       "bfly_fill": (lambda st: _shift_codes(KIND_FILL, st), 1),
       "bfly_scan": (lambda st: _shift_codes(KIND_SCAN, st), 4)}


def b9_codes(key: str, stages) -> tuple:
    """The stage codes of one B9 call (``key`` the wrapper): one network,
    or one run of fill or scan stages, without × vals."""
    return tuple(_B9[key][0](stages))


def tile_log(L: int) -> int:
    """B10's tile: 2^T slots with T the larger of ceil((L + 5) / 2) (the
    two tilings then serve every exchange stage, L <= 2T − 5) and L − 7
    (at least 128 tiles, one a streaming multiprocessor of the H100's 132),
    at most 14 (a tile of 64 KB in the registers of 512 threads; three
    shared buffers of a tile and its halo in one SM's 227 KB); T = L, the
    whole plane one tile, where that is smaller."""
    return min(MAX_TILE_LOG, max(-(-(L + 5) // 2), L - 7), L)


def plan_phases(codes: Sequence[int], L: int, T: int) -> tuple:
    """B10's phases: ((first code, code count, tiling, halo), ...), maximal
    runs of consecutive stage codes that one tiling of the 2^L slots into
    tiles of 2^T serves, the longer run of the two tilings at each step
    (``csrc/bfly.cu`` describes them):

    * ``CONTIG``: exchange stages with k < T, after a leading run of fill
      or scan stages whose shifts 2^k sum to at most ``HALO_MAX``, the
      halo each tile reads from the tile before it; T >= L: every stage,
      the whole plane one tile;
    * ``STRIDED``: exchange stages with k < 5 or k >= L − T + 5;
    * ``GLOBAL``: one stage that neither serves (every stage when T < 5:
      a tile is at least a warp's 32 slots).

    Every code lands in exactly one phase, in order; no code: one empty
    phase (x · valid)."""
    n = len(codes)
    if T < 5:
        return tuple((i, 1, GLOBAL, 0) for i in range(n)) or (
            (0, 0, GLOBAL, 0),)
    if T >= L:
        return ((0, n, CONTIG, 0),)

    def kind_k(c):
        return (c >> 16) & 3, c & 31

    def contig(s):
        halo, i = 0, s
        while i < n:
            kind, k = kind_k(codes[i])
            if kind == KIND_XOR:
                if k >= T:
                    break
            elif i > s and kind_k(codes[i - 1])[0] == KIND_XOR:
                break                      # a shift after an exchange
            elif halo + (1 << k) > HALO_MAX:
                break
            else:
                halo += 1 << k
            i += 1
        return i - s, halo

    def strided(s):
        i = s
        while i < n:
            kind, k = kind_k(codes[i])
            if kind != KIND_XOR or 5 <= k < L - T + 5:
                break
            i += 1
        return i - s

    phases, s = [], 0
    while s < n:
        (nc, halo), ns = contig(s), strided(s)
        if nc == ns == 0:
            phases.append((s, 1, GLOBAL, 0))
        elif nc >= ns:
            phases.append((s, nc, CONTIG, halo))
        else:
            phases.append((s, ns, STRIDED, 0))
        s += phases[-1][1]
    return tuple(phases) or ((0, 0, CONTIG, 0),)


def phase_table(stages: Sequence, L: int) -> tuple:
    """B10's phases for the stage lists ``stages`` (widen, fill, perm,
    scan, compact) on 2^L slots: ``plan_phases`` at ``tile_log(L)``."""
    return plan_phases(_codes(*map(tuple, stages))[0], L, tile_log(L))


def b9_phase_table(key: str, stages, L: int) -> tuple:
    """The phases of one B9 call (``key`` the wrapper) on 2^L slots:
    ``plan_phases`` of ``b9_codes`` at ``tile_log(L)``."""
    return plan_phases(b9_codes(key, stages), L, tile_log(L))


@lru_cache(maxsize=128)
def _plan(codes: tuple, L: int, T: int):
    """The launch plan of ``codes`` at tiles of 2^T slots: (the codes and
    their count, the phase table as 4 ints a phase, the phase count)."""
    if len(codes) > MAX_CODES:
        raise ValueError(f"{len(codes)} stages: a program takes at most "
                         f"{MAX_CODES}")
    phases = plan_phases(codes, L, T)
    if len(phases) > MAX_PHASES:
        raise ValueError(f"{len(phases)} phases: a program takes at most "
                         f"{MAX_PHASES}")
    flat = [x for ph in phases for x in ph]
    return ((ctypes.c_uint32 * max(len(codes), 1))(*codes), len(codes),
            (ctypes.c_int32 * len(flat))(*flat), len(phases))


def _b9(key: str, v: torch.Tensor, plane: torch.Tensor,
        stages) -> torch.Tensor:
    """One B9 call: ``b9_codes`` in the phases of ``plan_phases`` at
    ``tile_log(L)``, one launch a phase, counted; the phases ping-pong two
    buffers (only those they need), x read by the first and out written by
    the last. No stage: v itself."""
    codes = b9_codes(key, stages)
    if not codes:
        return v
    n = v.numel()
    L = n.bit_length() - 1
    T = tile_log(L)
    c_codes, n_codes, phases, n_phases = _plan(codes, L, T)
    out = torch.empty_like(v)
    bufs = [torch.empty_like(v) if n_phases > i else out for i in (1, 2)]
    words = [None] * 6
    words[_B9[key][1]] = plane.data_ptr()
    with torch.cuda.device(v.device):
        _launch("bfly_full", v.data_ptr(), *(t.data_ptr() for t in bufs),
                *words, None, out.data_ptr(), n, c_codes, n_codes, 0, phases,
                n_phases, T, _stream(v))
    LAUNCHES[key] += n_phases
    return out


def bfly_xor_net(v: torch.Tensor, B: torch.Tensor,
                 stages: Stages) -> torch.Tensor:
    """One exchange network over the flat plane v (N,) (kernel B9)."""
    if not _on_cuda(v, B):
        return bfly_xor_net_torch(v, B, stages)
    n = _check_plane(v)
    _check_stages(B, stages, n)
    return _b9("bfly_xor_net", v, B, stages)


def _shift(key: str, v: torch.Tensor, words: torch.Tensor,
           stages: Sequence[int]) -> torch.Tensor:
    n = _check_plane(v)
    _check_words(words, "words", n)
    _check_shifts(stages, n)
    return _b9(key, v, words, stages)


def bfly_fill(v: torch.Tensor, words: torch.Tensor,
              stages: Sequence[int]) -> torch.Tensor:
    """Forward fill over the flat plane v (N,) (kernel B9)."""
    if not _on_cuda(v, words):
        return bfly_fill_torch(v, words, stages)
    return _shift("bfly_fill", v, words, stages)


def bfly_scan(v: torch.Tensor, guards: torch.Tensor,
              stages: Sequence[int]) -> torch.Tensor:
    """Segmented scan over the flat plane v (N,) (kernel B9)."""
    if not _on_cuda(v, guards):
        return bfly_scan_torch(v, guards, stages)
    return _shift("bfly_scan", v, guards, stages)


def bfly_full(v, widen_B, fill_words, perm_B, vals, scan_guards, compact_B,
              out_valid, widen_stages: Stages, fill_stages: Sequence[int],
              perm_stages: Stages, scan_stages: Sequence[int],
              compact_stages: Stages) -> torch.Tensor:
    """The whole program on the spread x (N,) (kernel B10): v · valid after
    widen, fill, perm, × vals, scan and compact, in the phases of
    ``plan_phases``, one launch per phase (each counted)."""
    planes = (v, widen_B, fill_words, perm_B, vals, scan_guards, compact_B,
              out_valid)
    stages = (tuple(widen_stages), tuple(fill_stages), tuple(perm_stages),
              tuple(scan_stages), tuple(compact_stages))
    if not _on_cuda(*planes):
        return bfly_full_torch(*planes, *stages)
    n = _check_plane(v)
    for B, st in ((widen_B, stages[0]), (perm_B, stages[2]),
                  (compact_B, stages[4])):
        _check_stages(B, st, n)
    _check_words(fill_words, "fill_words", n)
    _check_words(scan_guards, "scan_guards", n)
    _check(vals, "vals", torch.float32, (n,))
    _check(out_valid, "out_valid", torch.float32, (n,))
    _check_shifts(stages[1] + stages[3], n)
    codes, _, premul_final = _codes(*stages)
    L = n.bit_length() - 1
    T = tile_log(L)
    codes, n_codes, phases, n_phases = _plan(codes, L, T)
    buf0, buf1, out = (torch.empty_like(v) for _ in range(3))
    with torch.cuda.device(v.device):
        _launch("bfly_full", *(t.data_ptr() for t in (v, buf0, buf1)),
                *(t.data_ptr() for t in planes[1:7]), out_valid.data_ptr(),
                out.data_ptr(), n, codes, n_codes, premul_final, phases,
                n_phases, T, _stream(v))
    LAUNCHES["bfly_full"] += n_phases
    return out
