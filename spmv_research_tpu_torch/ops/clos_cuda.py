"""The Clos engines' CUDA kernels: build, wrappers, plain versions.

Counterpart of ``spmv_research_tpu/ops/clos_pallas.py`` and of the kernels
of ``spmv_research_tpu/ops/clos_gather.py`` and
``spmv_research_tpu/ops/clos_xl.py``: CLOSG's, and the r3 steps of the
exact-CLOS engine (``clos.py``). One wrapper per Pallas kernel (sources and
design notes in ``csrc/closg.cu``):

=========================  ===================================================
wrapper                    replaces
=========================  ===================================================
``closg_front``            ``clos_gather.py:_gmul_r1_dma_kernel`` (x window
                           gather × value, then the r1 layer); also the
                           non-LUT mode of ``_gmul_r1_kernel``, since the
                           kernel reads x from device memory at any n —
                           persistent blocks (``front_grid``)
``closg_front_lut``        ``clos_gather.py:_gmul_r1_kernel`` in value-LUT
                           mode (the value from a 128-entry dictionary) —
                           B1's persistent tile body (``front_grid``)
``closg_front_win``        ``clos_gather.py:_gmul_r1_win_kernel`` (fused
                           windows: x row = base of the 8-row group + a
                           per-slot rotation) — B1's persistent tile body
                           (``front_grid``)
``clos_r2``                ``clos_pallas.py:_invreg_kernel`` as the r2
                           layer with the ``_t_fwd``/``_t_bwd`` transposes
                           around it, on C stacked natural planes: one
                           launch, no transposed copy
``clos_invreg``            ``clos_pallas.py:_invreg_kernel`` (one in-vreg
                           layer on a natural plane: CLOS's r1 layers)
``closg_r3_scan_yext``     ``clos_pallas.py:_r3_scan_yext_kernel`` (r3 layer,
                           capped segmented scan, windowed y extraction) —
                           launches: one per phase of ``plan_scan_phases``
                           (scircuit's 7 capped stages: 1), + the
                           extraction
``closg_r3_scan``          ``clos_pallas.py:_r3_scan_kernel_noval`` (r3 layer
                           + full scan, the W = 0 back end's first half) —
                           launches: one per phase of ``plan_scan_phases``
                           (a 2^20-slot chunk of 14 stages: 2)
``closg_cand_yext``        ``clos_gather.py:_extract_y_kernel`` (W = 0: per y
                           slot, a pick from one of C candidate rows); also
                           ``closg_cand_yext_chunked``: every W = 0 chunk
                           of a ``ClosGChunked`` in one launch (up to
                           ``YEXT_MAX_CHUNKS`` a launch), y in place
``closgx_r3_scan_yext``    ``clos_xl.py:_r3_scan_yext_dyn_kernel`` (the CLOSGX
                           back end over all stacked chunks at once) —
                           launches: one per phase of ``plan_scan_phases``
                           over all chunks (9 stages: 1), the extraction
``clos_r3_fill``           ``clos_pallas.py:_r3_fill_kernel`` (CLOS widen
                           network: r3 layer, then the forward fill) —
                           launches: one per phase of ``plan_scan_phases``
                           in select mode (scircuit's 6 stages: 1)
``clos_r3_scan``           ``clos_pallas.py:_r3_scan_kernel`` (CLOS perm
                           network: r3 layer × vals, then the full scan) —
                           launches: one per phase of ``plan_scan_phases``
                           (scircuit's 9 stages: 1)
``clos_r3_valid``          ``clos_pallas.py:_r3_valid_kernel`` (CLOS compact
                           network: r3 layer, then the out-valid mask) —
                           one launch, over the 1024-slot blocks that hold
                           the m rows of y where ``m`` is given
=========================  ===================================================

Each wrapper takes the kernel's plain PyTorch version (``*_torch``) only when
its tensors lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. ``LAUNCHES`` counts, per wrapper, its kernel launches.
The ``_t_fwd``/``_t_bwd`` transposes around the r2 layer, XLA ops in the JAX
package, are folded into ``clos_r2``'s addressing; ``clos.py`` keeps them for
the plain version ``clos_r2_torch``.

The kernels are compiled by ``nvcc`` from ``csrc/closg.cu`` at first CUDA use
(``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import torch
import torch.nn.functional as F

from .clos import (SPARE_BITS, SPARE_SHIFT, _stage_bit, _t_bwd, _t_fwd,
                   invreg_torch)
from .clos_route import BLK, LANES, SUB
from .cuda_lib import (CudaLib, check as _check, check_aligned,
                       on_cuda as _on_cuda, persistent_grid,
                       stream as _stream)

LAUNCHES = {"closg_front": 0, "closg_front_lut": 0, "closg_front_win": 0,
            "clos_r2": 0, "clos_invreg": 0, "closg_r3_scan_yext": 0,
            "closg_r3_scan": 0,
            "closg_cand_yext": 0, "closgx_r3_scan_yext": 0,
            "clos_r3_fill": 0, "clos_r3_scan": 0, "clos_r3_valid": 0}
VLUT_SHIFT = SPARE_SHIFT + 7    # r1 bits [24,31): value index / rotation
# the instances of the front ends' tile body (csrc/closg.cu front_kernel's
# mode): B1, B7, B4
FRONT_PLAIN, FRONT_WIN, FRONT_LUT = 0, 1, 2
# the phased scan's phases (csrc/closg.cu scan_contig_kernel and
# scan_strided_kernel): tilings, the kernels' tile (kScanTileLog: 2^13
# slots), the halo budget in window slots (one r3 block), and the kernels'
# limits on stages and phases
CONTIG, STRIDED, GLOBAL = 0, 1, 2
SCAN_TILE_LOG = 13
SCAN_HALO_MAX = 1024
MAX_SCAN_STAGE = 30
MAX_SCAN_PHASES = 32
# the layer kernels' tiles (csrc/closg.cu kR2Run, kR2Quads): runs of R2_RUN
# floats of each natural block, R2_QUADS 16-byte quads a thread
R2_RUN = 8
R2_QUADS = R2_RUN // 4 if R2_RUN > 8 else 2
# B6 (csrc/closg.cu cand_yext_kernel): programs a launch takes by value
# (kYextMaxChunks), a block's threads and the 16-byte ysel quads of each,
# and so the y elements a block extracts (kYextBlockElems)
YEXT_MAX_CHUNKS = 32
YEXT_THREADS = 64
YEXT_QUADS = 1
YEXT_BLOCK_ELEMS = 4 * YEXT_QUADS * YEXT_THREADS


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.closg_invreg.argtypes = [p, p, p, i64, i32, p]
    lib.clos_r2.argtypes = [p, p, p, i64, i32, p]
    lib.closg_blocks_per_sm.argtypes = [ctypes.POINTER(i32), i32]
    lib.closg_front.argtypes = [p, p, p, p, i64, p, i64, i32, p]
    lib.closg_front_lut.argtypes = [p, p, p, p, i64, p, i64, i32, p]
    lib.closg_front_win.argtypes = [p, p, i64, p, p, p, i64, p, i64, i32, p]
    lib.closg_yext.argtypes = [p, p, p, p, p, p, i32, p]
    ptrs, i64s = ctypes.POINTER(p), ctypes.POINTER(i64)
    lib.closg_cand_yext.argtypes = [i32, ptrs, ptrs, ptrs, i64s, i64s, i64s,
                                    p, p]
    lib.clos_r3_valid.argtypes = [p, p, p, i64, p]
    ints = ctypes.POINTER(ctypes.c_int32)
    lib.closg_scan_phases.argtypes = [p, p, p, p, i32, p, p, i64, i64, ints,
                                      i32, ints, i32, p]
    for fn in (lib.closg_invreg, lib.clos_r2, lib.closg_blocks_per_sm,
               lib.closg_front, lib.closg_front_lut, lib.closg_front_win,
               lib.closg_yext, lib.closg_cand_yext, lib.clos_r3_valid,
               lib.closg_scan_phases):
        fn.restype = i32


_CUDA = CudaLib("closg", _bind)
SOURCE = _CUDA.source
build = _CUDA.build
build_log = _CUDA.build_log
_launch = _CUDA.launch


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_slots(n_slots: int, lanes: int) -> None:
    if (n_slots <= 0 or n_slots % 1024 or lanes < 1 or lanes > LANES
            or lanes & (lanes - 1)):
        raise ValueError(f"layer shape needs a positive multiple of 1024 "
                         f"slots and a power-of-two lane width <= {LANES}; "
                         f"got {n_slots} slots of {lanes} lanes")


def _check_r2(n_slots: int, V: int) -> None:
    if (V < SUB or V > SUB * LANES or V & (V - 1) or n_slots <= 0
            or n_slots % (BLK * V)):
        raise ValueError(f"the r2 layer needs a power-of-two V in [{SUB}, "
                         f"{SUB * LANES}] and whole planes of 1024·V slots; "
                         f"got V = {V}, {n_slots} slots")


def r2_geometry(V: int | None) -> tuple:
    """The layer kernels' tile (``csrc/closg.cu`` ``r2_geom``): (nb,
    slots, rs, threads, shared bytes). ``clos_r2`` at V: nb offsets b of
    every natural block (runs of ``R2_RUN`` floats, or whole r2 blocks of
    1024 slots where V < 1024 / R2_RUN), nb·V slots, the values staged in
    natural order (and the output, moved by TMA), the words as nb rows of
    V padded by 4 where V >= 32 (stride rs), then the mbarrier;
    ``clos_invreg`` (V None): ``R2_RUN``·1024 contiguous slots, nb = rs =
    0. A thread moves ``R2_QUADS`` quads of words (and, natural, of
    values)."""
    if V is None:
        slots = R2_RUN * BLK
        return 0, slots, 0, slots // (4 * R2_QUADS), 8 * slots
    nb = max(R2_RUN, BLK // V)
    rs = V + (4 if V >= 32 else 0)
    return (nb, nb * V, rs, nb * V // (4 * R2_QUADS),
            4 * (2 * nb * V + nb * rs) + 8)


# the front ends' persistent grids: (SMs, blocks an SM) per (device, mode)
_OCCUPANCY: dict = {}


def front_occupancy(device: torch.device, mode: int = FRONT_PLAIN) -> tuple:
    """(SMs, blocks an SM) of ``front_kernel`` on ``device`` in ``mode``:
    B1's (``FRONT_PLAIN``), B7's (``FRONT_WIN``) or B4's (``FRONT_LUT``),
    asked once per device and instance."""
    key = (device.index, mode)
    if key not in _OCCUPANCY:
        n = ctypes.c_int()
        with torch.cuda.device(device):
            _launch("closg_blocks_per_sm", ctypes.byref(n), mode)
        _OCCUPANCY[key] = (
            torch.cuda.get_device_properties(device).multi_processor_count,
            n.value)
    return _OCCUPANCY[key]


def front_grid(n_tiles: int, device: torch.device,
               mode: int = FRONT_PLAIN) -> int:
    """The persistent grid a front end — B1 (``closg_front``), B7
    (``closg_front_win``) or B4 (``closg_front_lut``), by ``mode`` — is
    launched with over ``n_tiles`` 1024-slot tiles of ``device``: the
    card's SMs times the blocks of that ``front_kernel`` an SM holds, at
    most one block a tile."""
    return persistent_grid(n_tiles, *front_occupancy(device, mode))


def cand_yext_plan(ms: Sequence[int]) -> list:
    """B6's launches over programs that write ``ms`` elements of y each
    (``csrc/closg.cu`` ``closg_cand_yext``): per launch, its programs (at
    most ``YEXT_MAX_CHUNKS``, in order) and the prefix of their block
    counts (a program's first block; the last entry is the grid)."""
    plan = []
    for g in range(0, len(ms), YEXT_MAX_CHUNKS):
        ids = list(range(g, min(g + YEXT_MAX_CHUNKS, len(ms))))
        block0 = [0]
        for i in ids:
            block0.append(block0[-1] - (-ms[i] // YEXT_BLOCK_ELEMS))
        plan.append((ids, block0))
    return plan


# ------------------------------------------------------------ plain versions

clos_invreg_torch = invreg_torch


def clos_r2_torch(v: torch.Tensor, word: torch.Tensor,
                  V: int) -> torch.Tensor:
    """The r2 layer on C stacked natural (8V, 128) planes: ``_t_fwd``, the
    in-vreg layer on the transposed (C·8·1024, V/8) plane with the stored
    r2 words, ``_t_bwd`` (the JAX package's three steps)."""
    return _t_bwd(invreg_torch(_t_fwd(v, V), word), V)


def _x2d(x: torch.Tensor) -> torch.Tensor:
    x_rows = (x.shape[0] + LANES - 1) // LANES
    return F.pad(x, (0, x_rows * LANES - x.shape[0])).view(x_rows, LANES)


def _lam(perm_r1: torch.Tensor) -> torch.Tensor:
    return ((perm_r1 >> SPARE_SHIFT) & 0x7F).long()


def closg_front_torch(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                      vals_cs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """wins[s] = x2d[rowidx[s]]; v = wins[s, λ] · vals_cs; then the r1 layer
    (``_gmul_dma`` of the JAX package)."""
    g = torch.gather(_x2d(x)[rowidx.long()], 1, _lam(perm_r1))
    return invreg_torch(g * vals_cs, perm_r1)


def closg_front_lut_torch(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                          vals_cs: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """As ``closg_front_torch``, with each slot's value read from the
    dictionary ``vals_cs[0]`` at index r1 bits [24,31) (value-LUT mode of
    ``_gmul_r1_kernel``)."""
    g = torch.gather(_x2d(x)[rowidx.long()], 1, _lam(perm_r1))
    val = vals_cs[0][((perm_r1 >> VLUT_SHIFT) & 0x7F).long()]
    return invreg_torch(g * val, perm_r1)


def closg_front_win_torch(gbase: torch.Tensor, nbids: torch.Tensor,
                          perm_r1: torch.Tensor, vals_cs: torch.Tensor,
                          x: torch.Tensor, dense_blocks: bool) -> torch.Tensor:
    """Fused-window front end (``_gmul_win``): slot (s, l) reads the x row
    ``gbase[s/8] + ((s%8 + rot) & 7)`` of the compacted x plane (the
    non-empty blocks ``nbids``, or every block if ``dense_blocks``), rot =
    r1 bits [24,27); rows past the plane read 0 (the JAX package's 8-row
    overrun pad)."""
    x2c = _x2d(x) if dense_blocks else _x2d(x)[nbids.long()]
    x2c = F.pad(x2c, (0, 0, 0, SUB))
    s = torch.arange(perm_r1.shape[0], device=x.device).unsqueeze(1)
    rot = ((perm_r1 >> VLUT_SHIFT) & 0x7).long()
    xr = gbase.long()[s // SUB] + ((s % SUB + rot) & (SUB - 1))
    g = x2c[xr, _lam(perm_r1)]
    return invreg_torch(g * vals_cs, perm_r1)


def _scan_torch(u: torch.Tensor, w3: torch.Tensor, hi: torch.Tensor,
                stages: Sequence[int], chunk: int) -> torch.Tensor:
    """The guarded shift-add stages over flat slots, the shift rolling
    within each run of ``chunk`` slots (one program, or one CLOSGX chunk)."""
    u = u.view(-1, chunk)
    w3, hi = w3.view(-1, chunk), hi.reshape(-1)
    hi = hi.view(-1, chunk) if hi.numel() == w3.numel() else hi
    for k in stages:
        guard = _stage_bit(k, w3, hi)
        u = u + torch.where(guard, torch.roll(u, 1 << k, dims=1), 0.0)
    return u.reshape(-1)


def _y_pick(scr, ysel_w, wstart, rows):
    sel = ysel_w[rows]
    empty = ((sel >> 16) & 1) != 0
    src = wstart[rows].unsqueeze(1) + ((sel >> 7) & 0x1FF)
    val = scr[torch.where(empty, 0, src).long(), (sel & 0x7F).long()]
    return torch.where(empty, 0.0, val)


def closg_r3_scan_torch(v, perm_r3, scan_hi,
                        stages: Sequence[int]) -> torch.Tensor:
    """r3 layer, then the scan stages ``stages``: the scanned (8V, 128)
    plane (``_r3_scan_kernel_noval``)."""
    _check_hi(stages, scan_hi, v.numel())
    return _scan_torch(invreg_torch(v, perm_r3).reshape(-1),
                       perm_r3.reshape(-1), scan_hi, stages,
                       v.numel()).view(-1, LANES)


def closg_r3_scan_yext_torch(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr,
                             acc_src, stages: Sequence[int]) -> torch.Tensor:
    """r3 layer, the scan stages ``stages`` (capped: in-row window sums),
    then y extraction — base records, then the accumulate records in the
    order ``acc_ptr``/``acc_src`` give. Returns y as (8·n_batches, 128)."""
    scr = closg_r3_scan_torch(v, perm_r3, scan_hi, stages)
    n_batches = acc_ptr.shape[0] - 1
    dev = v.device
    y = _y_pick(scr, ysel_w, wstart, torch.arange(n_batches * SUB, device=dev))
    counts = (acc_ptr[1:] - acc_ptr[:-1]).long()
    g = torch.arange(SUB, device=dev)
    for r in range(int(counts.max()) if n_batches else 0):
        bd = torch.nonzero(counts > r).squeeze(1)
        src = acc_src[(acc_ptr[bd] + r).long()].long()
        rows_d = (bd.unsqueeze(1) * SUB + g).reshape(-1)
        rows_s = (src.unsqueeze(1) * SUB + g).reshape(-1)
        y[rows_d] = y[rows_d] + _y_pick(scr, ysel_w, wstart, rows_s)
    return y


def closg_cand_yext_torch(scr: torch.Tensor, ycand: torch.Tensor,
                          ysel: torch.Tensor) -> torch.Tensor:
    """W = 0 extraction (``_extract_y_kernel``): y[j, l] is lane ysel bits
    [0,7) of scan row ``ycand[cid·m_rows + j]``, cid = ysel bits [7,14).
    Returns y as (m_rows, 128)."""
    m_rows = ysel.shape[0]
    cid = ((ysel >> 7) & 0x7F).long()
    j = torch.arange(m_rows, device=ysel.device).unsqueeze(1)
    return scr[ycand.long()[cid * m_rows + j], (ysel & 0x7F).long()]


def closg_cand_yext_chunked_torch(parts: Sequence[tuple],
                                  row_split: Sequence[int]) -> torch.Tensor:
    """B6 over the W = 0 chunks of a ``ClosGChunked``: chunk c's
    extraction ``closg_cand_yext_torch(*parts[c])`` (parts[c] = (scr,
    ycand, ysel)), its first ``row_split[c + 1] − row_split[c]`` elements
    written to y at ``row_split[c]``. Returns y, (row_split[-1],)."""
    scr = parts[0][0]
    y = torch.empty(row_split[-1], dtype=scr.dtype, device=scr.device)
    for (s, ycand, ysel), r0, r1 in zip(parts, row_split, row_split[1:]):
        y[r0:r1] = closg_cand_yext_torch(s, ycand, ysel).reshape(-1)[:r1 - r0]
    return y


def closgx_r3_scan_yext_torch(v, r3, ysel_w, wstart_abs, stages: int,
                              chunk_slots: int) -> torch.Tensor:
    """CLOSGX back end over C stacked chunks of ``chunk_slots`` slots: r3
    layer, ``stages`` full scan stages (guards in r3's spare bits, the shift
    within each chunk), then every y batch of every chunk extracted in
    place from its window (``wstart_abs`` = the chunk's own window start +
    chunk·rows). Returns the stacked y, (C·mrp, 128)."""
    u = _scan_torch(invreg_torch(v, r3).reshape(-1), r3.reshape(-1),
                    r3.new_zeros(1), range(stages), chunk_slots)
    rows = torch.arange(ysel_w.shape[0], device=v.device)
    return _y_pick(u.view(-1, LANES), ysel_w, wstart_abs, rows)


def clos_r3_fill_torch(v, widen_r3, fill_hi,
                       stages: Sequence[int]) -> torch.Tensor:
    """CLOS widen network's last step (``_r3_fill_kernel``): the r3 layer,
    then the forward-fill stages ``stages``: a slot whose take bit k (bit
    17+k of the r3 word, or bit k-15 of ``fill_hi``) is set takes the value
    2^k slots before it, the shift rolling over the whole program as
    ``jnp.roll`` does. (8V, 128)."""
    _check_hi(stages, fill_hi, v.numel(), "fill")
    u, w3, hi = (invreg_torch(v, widen_r3).reshape(-1), widen_r3.reshape(-1),
                 fill_hi.reshape(-1))
    for k in stages:
        u = torch.where(_stage_bit(k, w3, hi), torch.roll(u, 1 << k), u)
    return u.view(-1, LANES)


def clos_r3_scan_torch(v, perm_r3, vals, scan_hi,
                       stages: Sequence[int]) -> torch.Tensor:
    """CLOS perm network's last step (``_r3_scan_kernel``): the r3 layer ×
    vals, then the full segmented scan. (8V, 128)."""
    _check_hi(stages, scan_hi, v.numel())
    return _scan_torch((invreg_torch(v, perm_r3) * vals).reshape(-1),
                       perm_r3.reshape(-1), scan_hi, stages,
                       v.numel()).view(-1, LANES)


def _valid_rows(n_rows: int, m: int | None) -> int:
    """The 128-lane rows of the 1024-slot blocks that hold slots [0, m):
    all ``n_rows`` when m is None."""
    if m is None:
        return n_rows
    if not 0 <= m <= n_rows * LANES:
        raise ValueError(f"m = {m} rows of y past the plane's "
                         f"{n_rows * LANES} slots")
    return -(-m // 1024) * SUB


def clos_r3_valid_torch(v, compact_r3, m: int | None = None) -> torch.Tensor:
    """CLOS compact network's last step (``_r3_valid_kernel``): the r3
    layer, then 0 wherever bit 17 of the r3 word (out-valid) is clear. With
    ``m``, only the leading 1024-slot blocks that hold slots [0, m): an r3
    pick stays inside its block, so they equal the whole plane's."""
    rows = _valid_rows(v.shape[0], m)
    v, compact_r3 = v[:rows], compact_r3[:rows]
    valid = ((compact_r3 >> SPARE_SHIFT) & 1) != 0
    return torch.where(valid, invreg_torch(v, compact_r3), 0.0)


def _check_hi(stages: Sequence[int], hi: torch.Tensor, n: int,
              what: str = "scan") -> None:
    if any(k >= SPARE_BITS for k in stages) and hi.numel() != n:
        raise ValueError(f"{what} stages >= 15 need the full {what}_hi plane")


# ------------------------------------------------------- the phased scan

def plan_scan_phases(stages: Sequence[int], n: int, chunk: int,
                     T: int = SCAN_TILE_LOG,
                     halo_max: int | None = None) -> tuple:
    """The phased scan's phases (K3, B5, B8's fill and scan, B15): ((first
    stage, stage count, tiling, halo),
    ...) for the r3 layer and the scan stages ``stages`` (strictly
    increasing) over n slots in runs of ``chunk``, on tiles of 2^T slots
    (``csrc/closg.cu`` describes the tilings; the kernels' T is
    ``SCAN_TILE_LOG``, another T only plans the CPU emulation of the
    schedule; the halo budget defaults to ``SCAN_HALO_MAX`` window slots):

    * ``CONTIG``, phase 0: the r3 layer and the leading stages whose shifts
      2^k sum to at most the budget (the halo); the chunk one tile
      (chunk <= 2^T): every stage, no halo;
    * ``STRIDED``: the stages from k0 on (2^k0 >= 32, 2^k < chunk) whose
      shifts 2^(k−k0) along j sum to at most budget / 32 rows (the halo,
      in rows); no halo where the tile holds all chunk / 2^k0 rows;
    * ``GLOBAL``: one stage neither serves.

    Every stage lands in exactly one phase, in order. Raises ValueError on
    a stage list out of order or past ``MAX_SCAN_STAGE`` and on a chunk
    that is not a power of two >= 1024 dividing n."""
    halo_max = SCAN_HALO_MAX if halo_max is None else halo_max
    stages = tuple(stages)
    if (any(b <= a for a, b in zip(stages, stages[1:]))
            or any(not 0 <= k <= MAX_SCAN_STAGE for k in stages)):
        raise ValueError(f"scan stages {stages}: the phased scan takes "
                         f"strictly increasing stages in [0, "
                         f"{MAX_SCAN_STAGE}]")
    if chunk < 1024 or chunk & (chunk - 1) or n % chunk:
        raise ValueError(f"{n} slots in chunks of {chunk}: the phased scan "
                         f"needs power-of-two chunks of >= 1024 slots")
    L = chunk.bit_length() - 1
    T = min(T, L)
    ns = len(stages)
    if T == L:
        return ((0, ns, CONTIG, 0),)
    halo, i = 0, 0
    while i < ns and halo + (1 << stages[i]) <= halo_max:
        halo += 1 << stages[i]
        i += 1
    phases = [(0, i, CONTIG, halo)]
    while i < ns:
        k0 = stages[i]
        whole = L - k0 <= T - 5
        s, rows = i, 0
        while (k0 >= 5 and s < ns and stages[s] < L
               and (whole or 32 * (rows + (1 << (stages[s] - k0)))
                    <= halo_max)):
            rows += 1 << (stages[s] - k0)
            s += 1
        if s == i:
            phases.append((i, 1, GLOBAL, 0))
            i += 1
        else:
            phases.append((i, s - i, STRIDED, 0 if whole else rows))
            i = s
    return tuple(phases)


@lru_cache(maxsize=64)
def _scan_plan(stages: tuple, n: int, chunk: int, halo_max: int):
    """The C arguments of a phased scan: (stages, their count, the phase
    table as 4 ints a phase, the phase count)."""
    phases = plan_scan_phases(stages, n, chunk, halo_max=halo_max)
    if len(phases) > MAX_SCAN_PHASES:
        raise ValueError(f"{len(phases)} phases: the phased scan takes at "
                         f"most {MAX_SCAN_PHASES}")
    flat = [x for ph in phases for x in ph]
    return ((ctypes.c_int32 * max(len(stages), 1))(*stages), len(stages),
            (ctypes.c_int32 * len(flat))(*flat), len(phases))


def _scan_phases(key, v, w3, hi_ptr, stages: Sequence[int], chunk: int,
                 vals: torch.Tensor | None = None,
                 select: bool = False) -> torch.Tensor:
    """The r3 layer (× ``vals`` if given) and the scan ``stages`` (or, with
    ``select``, the forward-fill stages) in the phases of
    ``plan_scan_phases``, one launch a phase (K3's, B5's and B15's scan;
    B8's fill and scan). The C entry refuses ``select`` with ``vals``."""
    n = v.numel()
    ks, n_stages, phases, n_phases = _scan_plan(tuple(stages), n, chunk,
                                                SCAN_HALO_MAX)
    out = torch.empty_like(v)
    tmp = torch.empty_like(v) if n_phases > 1 else None
    _launch("closg_scan_phases", v.data_ptr(), w3.data_ptr(), hi_ptr,
            None if vals is None else vals.data_ptr(), int(select),
            out.data_ptr(), None if tmp is None else tmp.data_ptr(), n,
            chunk, ks, n_stages, phases, n_phases, _stream(v))
    LAUNCHES[key] += n_phases
    return out


# ------------------------------------------------------------------ wrappers

def clos_invreg(v: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """One in-vreg layer on a natural (S, L) plane (kernel B2's tile body,
    natural addressing): CLOS's r1 layers."""
    if not _on_cuda(v, word):
        return clos_invreg_torch(v, word)
    _check(v, "v", torch.float32)
    _check(word, "word", torch.int32, v.shape)
    _check_slots(v.numel(), v.shape[1])
    check_aligned(v=v, word=word)
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        _launch("closg_invreg", v.data_ptr(), word.data_ptr(), out.data_ptr(),
                v.numel(), v.shape[1], _stream(v))
    LAUNCHES["clos_invreg"] += 1
    return out


def clos_r2(v: torch.Tensor, word: torch.Tensor, V: int) -> torch.Tensor:
    """The r2 layer with its transposes (kernel B2): ``_t_bwd(invreg(
    _t_fwd(v, V), word), V)`` on C stacked natural (8V, 128) planes, in
    one launch; ``word`` the stored r2 planes, (C·8·1024, V/8)."""
    if not _on_cuda(v, word):
        return clos_r2_torch(v, word, V)
    n = v.numel()
    _check(v, "v", torch.float32, (n // LANES, LANES))
    _check_r2(n, V)
    _check(word, "word", torch.int32, (n // (V // SUB), V // SUB))
    check_aligned(v=v, word=word)     # v by TMA, word 16 bytes at a time
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        _launch("clos_r2", v.data_ptr(), word.data_ptr(), out.data_ptr(), n,
                V, _stream(v))
    LAUNCHES["clos_r2"] += 1
    return out


def _check_front(rowidx, perm_r1, vals_cs, x, lut: bool) -> int:
    S = rowidx.shape[0]
    _check(rowidx, "rowidx", torch.int32, (S,))
    _check(perm_r1, "perm_r1", torch.int32, (S, LANES))
    _check(vals_cs, "vals_cs", torch.float32, (SUB, LANES) if lut
           else (S, LANES))
    _check(x, "x", torch.float32, (x.shape[0],))
    _check_slots(S * LANES, LANES)
    return S * LANES


def closg_front(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                vals_cs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Window gather × value, then the r1 layer (kernel B1), in
    persistent blocks (``front_grid``): (8V, 128)."""
    if not _on_cuda(rowidx, perm_r1, vals_cs, x):
        return closg_front_torch(rowidx, perm_r1, vals_cs, x)
    n = _check_front(rowidx, perm_r1, vals_cs, x, lut=False)
    check_aligned(perm_r1=perm_r1, vals_cs=vals_cs)
    out = torch.empty_like(vals_cs)
    with torch.cuda.device(x.device):
        _launch("closg_front", rowidx.data_ptr(), perm_r1.data_ptr(),
                vals_cs.data_ptr(), x.data_ptr(), x.shape[0], out.data_ptr(),
                n, front_grid(n // 1024, x.device), _stream(x))
    LAUNCHES["closg_front"] += 1
    return out


def closg_front_lut(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                    vals_cs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B1's function with the value read from the (8, 128) dictionary
    plane's row 0 at r1 bits [24,31) (kernel B4, B1's persistent tile
    body: ``front_grid`` in ``FRONT_LUT`` mode): (8V, 128)."""
    if not _on_cuda(rowidx, perm_r1, vals_cs, x):
        return closg_front_lut_torch(rowidx, perm_r1, vals_cs, x)
    n = _check_front(rowidx, perm_r1, vals_cs, x, lut=True)
    check_aligned(perm_r1=perm_r1)
    out = torch.empty_like(perm_r1, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _launch("closg_front_lut", rowidx.data_ptr(), perm_r1.data_ptr(),
                vals_cs.data_ptr(), x.data_ptr(), x.shape[0], out.data_ptr(),
                n, front_grid(n // 1024, x.device, FRONT_LUT), _stream(x))
    LAUNCHES["closg_front_lut"] += 1
    return out


def closg_front_win(gbase: torch.Tensor, nbids: torch.Tensor,
                    perm_r1: torch.Tensor, vals_cs: torch.Tensor,
                    x: torch.Tensor, dense_blocks: bool) -> torch.Tensor:
    """Fused-window front end (kernel B7, B1's persistent tile body
    with each group's x rows from ``gbase`` and ``nbids``): (8V, 128)."""
    if not _on_cuda(gbase, nbids, perm_r1, vals_cs, x):
        return closg_front_win_torch(gbase, nbids, perm_r1, vals_cs, x,
                                     dense_blocks)
    S = perm_r1.shape[0]
    _check(gbase, "gbase", torch.int32, (S // SUB,))
    _check(nbids, "nbids", torch.int32, (nbids.shape[0],))
    _check(perm_r1, "perm_r1", torch.int32, (S, LANES))
    _check(vals_cs, "vals_cs", torch.float32, (S, LANES))
    _check(x, "x", torch.float32, (x.shape[0],))
    _check_slots(S * LANES, LANES)
    check_aligned(perm_r1=perm_r1, vals_cs=vals_cs)
    out = torch.empty_like(vals_cs)
    with torch.cuda.device(x.device):
        _launch("closg_front_win", gbase.data_ptr(),
                None if dense_blocks else nbids.data_ptr(), nbids.shape[0],
                perm_r1.data_ptr(), vals_cs.data_ptr(), x.data_ptr(),
                x.shape[0], out.data_ptr(), S * LANES,
                front_grid(S // SUB, x.device, FRONT_WIN), _stream(x))
    LAUNCHES["closg_front_win"] += 1
    return out


def _check_back(v, word, chunk: int) -> None:
    n = v.numel()
    _check(v, "v", torch.float32, (n // LANES, LANES))
    _check(word, "perm_r3", torch.int32, v.shape)
    _check_slots(n, LANES)
    if chunk < 1 or chunk & (chunk - 1) or n % chunk:
        raise ValueError(f"{n} slots are not whole power-of-two chunks of "
                         f"{chunk}")


def closg_r3_scan(v, perm_r3, scan_hi, stages: Sequence[int]) -> torch.Tensor:
    """r3 layer + full segmented scan (kernel B5): the scanned (8V, 128)
    plane, in the phases of ``plan_scan_phases``. Stages ≥ 15 read their
    guards from ``scan_hi``."""
    if not _on_cuda(v, perm_r3, scan_hi):
        return closg_r3_scan_torch(v, perm_r3, scan_hi, stages)
    n = v.numel()
    _check_back(v, perm_r3, n)
    _check(scan_hi, "scan_hi", torch.int32)
    _check_hi(stages, scan_hi, n)
    with torch.cuda.device(v.device):
        return _scan_phases(
            "closg_r3_scan", v, perm_r3,
            scan_hi.data_ptr() if scan_hi.numel() == n else None, stages, n)


def _check_cand(scr, ycand, ysel) -> int:
    m_rows = ysel.shape[0]
    _check(scr, "scr", torch.float32, (scr.shape[0], LANES))
    _check(ysel, "ysel", torch.int32, (m_rows, LANES))
    _check(ycand, "ycand", torch.int32)
    if ycand.numel() % max(m_rows, 1):
        raise ValueError("ycand holds no whole number of candidate rows")
    check_aligned(ysel=ysel)          # 16-byte ysel quads
    return m_rows


def _cand_yext(parts, ms, row0s, y: torch.Tensor) -> None:
    """B6 over ``parts`` ((scr, ycand, ysel) each, checked), program i
    writing its first ms[i] elements to y at row0s[i]: one launch per
    group of ``cand_yext_plan``."""
    P, I = ctypes.c_void_p, ctypes.c_int64
    with torch.cuda.device(y.device):
        for ids, _ in cand_yext_plan(ms):
            n = len(ids)
            _launch("closg_cand_yext", n,
                    *((P * n)(*(parts[i][k].data_ptr() for i in ids))
                      for k in range(3)),
                    (I * n)(*(parts[i][2].shape[0] for i in ids)),
                    (I * n)(*(ms[i] for i in ids)),
                    (I * n)(*(row0s[i] for i in ids)), y.data_ptr(),
                    _stream(y))
            LAUNCHES["closg_cand_yext"] += 1


def closg_cand_yext(scr: torch.Tensor, ycand: torch.Tensor,
                    ysel: torch.Tensor) -> torch.Tensor:
    """W = 0 candidate-plane y extraction (kernel B6) of one program:
    (m_rows, 128)."""
    if not _on_cuda(scr, ycand, ysel):
        return closg_cand_yext_torch(scr, ycand, ysel)
    m_rows = _check_cand(scr, ycand, ysel)
    y = torch.empty((m_rows, LANES), dtype=scr.dtype, device=scr.device)
    if m_rows:
        _cand_yext([(scr, ycand, ysel)], [m_rows * LANES], [0], y)
    return y


def closg_cand_yext_chunked(parts: Sequence[tuple],
                            row_split: Sequence[int]) -> torch.Tensor:
    """Kernel B6 over the W = 0 chunks of a ``ClosGChunked``, each
    chunk's y written in place: parts[c] = (scr, ycand, ysel) of chunk c,
    whose rows are [row_split[c], row_split[c + 1]). One launch for up to
    ``YEXT_MAX_CHUNKS`` chunks; no concatenation. Returns y,
    (row_split[-1],)."""
    if len(row_split) != len(parts) + 1 or not parts:
        raise ValueError(f"{len(parts)} chunks need {len(parts) + 1} row "
                         f"boundaries, got {len(row_split)}")
    if not _on_cuda(*(t for part in parts for t in part)):
        return closg_cand_yext_chunked_torch(parts, row_split)
    ms = [r1 - r0 for r0, r1 in zip(row_split, row_split[1:])]
    for part, m in zip(parts, ms):
        if not 0 <= m <= _check_cand(*part) * LANES:
            raise ValueError(f"a chunk of {m} rows past its y plane of "
                             f"{part[2].shape[0]} × {LANES}")
    y = torch.empty(row_split[-1], dtype=parts[0][0].dtype,
                    device=parts[0][0].device)
    _cand_yext(parts, ms, list(row_split[:-1]), y)
    return y


def closg_r3_scan_yext(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr, acc_src,
                       stages: Sequence[int]) -> torch.Tensor:
    """r3 layer + capped segmented scan + y extraction (kernel K3): the
    scan in the phases of ``plan_scan_phases``, one launch a phase, then
    one extraction launch. Stages ≥ 15 read their guards from
    ``scan_hi``."""
    if not _on_cuda(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr, acc_src):
        return closg_r3_scan_yext_torch(v, perm_r3, scan_hi, ysel_w, wstart,
                                        acc_ptr, acc_src, stages)
    n = v.numel()
    n_batches = acc_ptr.shape[0] - 1
    _check_back(v, perm_r3, n)
    _check(scan_hi, "scan_hi", torch.int32)
    _check(ysel_w, "ysel_w", torch.int32, (ysel_w.shape[0], LANES))
    _check(wstart, "wstart", torch.int32, (ysel_w.shape[0],))
    _check(acc_ptr, "acc_ptr", torch.int32)
    _check(acc_src, "acc_src", torch.int32)
    if ysel_w.shape[0] < n_batches * SUB:
        raise ValueError("ysel_w holds fewer records than y batches")
    _check_hi(stages, scan_hi, n)
    y = torch.empty((n_batches * SUB, LANES), dtype=v.dtype, device=v.device)
    with torch.cuda.device(v.device):
        a = _scan_phases(
            "closg_r3_scan_yext", v, perm_r3,
            scan_hi.data_ptr() if scan_hi.numel() == n else None, stages, n)
        if n_batches:
            _launch("closg_yext", a.data_ptr(), ysel_w.data_ptr(),
                    wstart.data_ptr(), acc_ptr.data_ptr(), acc_src.data_ptr(),
                    y.data_ptr(), n_batches, _stream(v))
            LAUNCHES["closg_r3_scan_yext"] += 1
    return y


def closgx_r3_scan_yext(v, r3, ysel_w, wstart_abs, stages: int,
                        chunk_slots: int) -> torch.Tensor:
    """CLOSGX back end over all stacked chunks at once (kernel B15): the r3
    layer and ``stages`` scan steps whose shift stays inside its chunk, in
    the phases of ``plan_scan_phases``, then one extraction launch over
    every chunk's y batches. (C·mrp, 128)."""
    if not _on_cuda(v, r3, ysel_w, wstart_abs):
        return closgx_r3_scan_yext_torch(v, r3, ysel_w, wstart_abs, stages,
                                         chunk_slots)
    _check_back(v, r3, chunk_slots)
    if stages > SPARE_BITS:
        raise ValueError(f"{stages} scan stages: CLOSGX keeps every guard "
                         f"in r3's {SPARE_BITS} spare bits")
    rows = ysel_w.shape[0]
    _check(ysel_w, "ysel_w", torch.int32, (rows, LANES))
    _check(wstart_abs, "wstart_abs", torch.int32, (rows,))
    if rows % SUB:
        raise ValueError("ysel_w holds no whole number of y batches")
    y = torch.empty((rows, LANES), dtype=v.dtype, device=v.device)
    with torch.cuda.device(v.device):
        a = _scan_phases("closgx_r3_scan_yext", v, r3, None, range(stages),
                         chunk_slots)
        if rows:
            _launch("closg_yext", a.data_ptr(), ysel_w.data_ptr(),
                    wstart_abs.data_ptr(), None, None, y.data_ptr(),
                    rows // SUB, _stream(v))
            LAUNCHES["closgx_r3_scan_yext"] += 1
    return y


def clos_r3_fill(v, widen_r3, fill_hi, stages: Sequence[int]) -> torch.Tensor:
    """CLOS widen network's r3 layer + forward fill (kernel B8): (8V, 128),
    in the phases of ``plan_scan_phases`` (the phased scan in select mode,
    one launch a phase). Stages ≥ 15 read their take bits from
    ``fill_hi``."""
    if not _on_cuda(v, widen_r3, fill_hi):
        return clos_r3_fill_torch(v, widen_r3, fill_hi, stages)
    n = v.numel()
    _check_back(v, widen_r3, n)
    _check(fill_hi, "fill_hi", torch.int32)
    _check_hi(stages, fill_hi, n, "fill")
    with torch.cuda.device(v.device):
        return _scan_phases(
            "clos_r3_fill", v, widen_r3,
            fill_hi.data_ptr() if fill_hi.numel() == n else None, stages, n,
            select=True)


def clos_r3_scan(v, perm_r3, vals, scan_hi,
                 stages: Sequence[int]) -> torch.Tensor:
    """CLOS perm network's r3 layer × vals + full segmented scan (kernel
    B8): (8V, 128), in the phases of ``plan_scan_phases``, one launch a
    phase. Stages ≥ 15 read their guards from ``scan_hi``."""
    if not _on_cuda(v, perm_r3, vals, scan_hi):
        return clos_r3_scan_torch(v, perm_r3, vals, scan_hi, stages)
    n = v.numel()
    _check_back(v, perm_r3, n)
    _check(vals, "vals", torch.float32, v.shape)
    _check(scan_hi, "scan_hi", torch.int32)
    _check_hi(stages, scan_hi, n)
    with torch.cuda.device(v.device):
        return _scan_phases(
            "clos_r3_scan", v, perm_r3,
            scan_hi.data_ptr() if scan_hi.numel() == n else None, stages, n,
            vals=vals)


def clos_r3_valid(v, compact_r3, m: int | None = None) -> torch.Tensor:
    """CLOS compact network's r3 layer + out-valid mask (kernel B8):
    (8V, 128), or with ``m`` only the leading 1024-slot blocks that hold
    slots [0, m) (the rows of y), ⌈m/1024⌉·8 rows; one launch."""
    if not _on_cuda(v, compact_r3):
        return clos_r3_valid_torch(v, compact_r3, m)
    _check_back(v, compact_r3, v.numel())
    rows = _valid_rows(v.shape[0], m)
    out = torch.empty((rows, LANES), dtype=v.dtype, device=v.device)
    if rows:
        with torch.cuda.device(v.device):
            _launch("clos_r3_valid", v.data_ptr(), compact_r3.data_ptr(),
                    out.data_ptr(), rows * LANES, _stream(v))
        LAUNCHES["clos_r3_valid"] += 1
    return out
