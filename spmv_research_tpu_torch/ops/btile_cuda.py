"""The BTILE engine's CUDA kernels: wrappers and plain versions.

Counterpart of the Pallas kernels of ``spmv_research_tpu/ops/btile.py``
(sources and design notes in ``csrc/btile.cu``):

===============  ==========================================================
wrapper          replaces
===============  ==========================================================
``btile_spmm``   ``btile.py:_btile_spmm_kernel``: Y (ngroups·1024, K) from
                 the tile slabs and X padded to (ncb·128, K); a product
                 launch (``btile_spmm``), and a second (``btile_combine``)
                 when bands are cut into chunks
``btile_sddmm``  ``btile.py:_btile_sddmm_kernel``: the C slab
                 (nsteps·tg·8, 128) = (A[band rows] · B[cb]ᵀ) ∘ pattern
===============  ==========================================================

Each wrapper takes the kernel's plain PyTorch version (``*_torch``, the
JAX package's ``spmm_btile_xla`` / ``sddmm_btile_xla``) only when its
tensors lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. ``LAUNCHES`` counts the kernel launches, beside each
launch. The plain versions multiply with ``torch.bmm`` and place with
``index_add_``, so kernel and plain version agree to fp32 add-order slack,
not bit for bit.

The kernels are compiled by ``nvcc`` from ``csrc/btile.cu`` at first CUDA
use (``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_lib import CudaLib, check, on_cuda, stream

TILE_R = 8
TILE_C = 128
BAND = 1024            # rows per band
SPMM_KS = 64           # X columns per SpMM block (csrc/btile.cu kKS)
SPMM_BLOCKS_PER_SM = 8  # SpMM blocks to aim for, per SM of the card
SPMM_PART_BYTES = 1 << 30   # the most the SpMM's chunk partials may take
MAX_STEP_ROWS = 256    # slab rows per step the kernels take (tg ≤ 32)
SDDMM_MAX_K = 256      # 8 registers of 32 lanes per A row

LAUNCHES = {"btile_spmm": 0, "btile_combine": 0, "btile_sddmm": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.btile_spmm.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                               p]
    lib.btile_combine.argtypes = [p, p, p, i32, i32, i32, i32, p]
    lib.btile_sddmm.argtypes = [p, p, p, p, p, p, p, p, i64, i32, i32, p]
    for fn in (lib.btile_spmm, lib.btile_combine, lib.btile_sddmm):
        fn.restype = i32


_CUDA = CudaLib("btile", _bind)
SOURCE = _CUDA.source
build = _CUDA.build
build_log = _CUDA.build_log


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _band_rows(tgt, step_g) -> torch.Tensor:
    """(nsteps·tg·8,) global Y row of every slab row."""
    return (step_g.long()[:, None] * BAND + tgt.long()).reshape(-1)


# ------------------------------------------------------------ plain versions

def btile_spmm_torch(tiles, tgt, step_g, step_cb, step_nt, band_ptr, xp,
                     ngroups: int, max_band_steps: int) -> torch.Tensor:
    """Y (ngroups·1024, K): P = tiles·X[cb] per step (``torch.bmm``), each
    slab row added into its band row (``index_add_``; padding tiles are
    zero and add nothing). ``step_nt``, ``band_ptr`` and ``max_band_steps``
    are the kernel's and unused here."""
    nsteps, R = tgt.shape
    k = xp.shape[1]
    xg = xp.view(-1, TILE_C, k)[step_cb.long()]           # (nsteps, 128, K)
    p = torch.bmm(tiles.view(nsteps, R, TILE_C), xg)       # (nsteps, R, K)
    y = xp.new_zeros((ngroups * BAND, k))
    return y.index_add_(0, _band_rows(tgt, step_g), p.view(-1, k))


def btile_sddmm_torch(patt, tgt, step_g, step_cb, step_nt, ap, bp
                      ) -> torch.Tensor:
    """The C slab: A's slab rows · B[cb]ᵀ per step (``torch.bmm``), times
    the pattern. ``step_nt`` is the kernel's and unused here."""
    nsteps, R = tgt.shape
    k = ap.shape[1]
    a_rows = ap[_band_rows(tgt, step_g)].view(nsteps, R, k)
    bb = bp.view(-1, TILE_C, k)[step_cb.long()]            # (nsteps, 128, K)
    prod = torch.bmm(a_rows, bb.transpose(1, 2))           # (nsteps, R, 128)
    return prod.view(-1, TILE_C) * (patt != 0)


# ------------------------------------------------------------------ wrappers

def _check_steps(slab, tgt, step_g, step_cb, step_nt, slab_dtype):
    nsteps, R = tgt.shape
    check(slab, "tiles/patt", slab_dtype, (nsteps * R, TILE_C))
    check(tgt, "tgt", torch.int32)
    for t, name in ((step_g, "step_g"), (step_cb, "step_cb"),
                    (step_nt, "step_nt")):
        check(t, name, torch.int32, (nsteps,))
    if R > MAX_STEP_ROWS or R % TILE_R:
        raise ValueError(f"{R} slab rows per step: the kernels take a "
                         f"multiple of 8 up to {MAX_STEP_ROWS} (tg ≤ 32)")
    return nsteps, R


@functools.lru_cache(maxsize=None)
def spmm_blocks(device: torch.device) -> int:
    """SpMM blocks to aim for on ``device``: ``SPMM_BLOCKS_PER_SM`` per SM."""
    return (SPMM_BLOCKS_PER_SM
            * torch.cuda.get_device_properties(device).multi_processor_count)


def _chunks(ngroups: int, slices: int, nsteps: int, max_band_steps: int,
            kp: int, blocks: int):
    """(chunks per band, steps per chunk): about ``blocks`` blocks of equal
    work (nsteps · slices step-blocks shared out), so that a large band is
    cut and small ones are not; the partials stay within
    ``SPMM_PART_BYTES``."""
    steps = max(max_band_steps, 1)
    ch = max(nsteps * slices // blocks, 1)
    cap = max(SPMM_PART_BYTES // (4 * BAND * kp * max(ngroups, 1)), 1)
    ch = max(ch, -(-steps // cap))
    return -(-steps // ch), ch


def btile_spmm(tiles, tgt, step_g, step_cb, step_nt, band_ptr, xp,
               ngroups: int, max_band_steps: int) -> torch.Tensor:
    """Y (ngroups·1024, K) (the kernel; see ``btile_spmm_torch``): the
    product launch and, when bands are cut into chunks, the combine of the
    chunks' partials, each counted where it is launched."""
    if not on_cuda(tiles, tgt, step_g, step_cb, step_nt, band_ptr, xp):
        return btile_spmm_torch(tiles, tgt, step_g, step_cb, step_nt,
                                band_ptr, xp, ngroups, max_band_steps)
    _, R = _check_steps(tiles, tgt, step_g, step_cb, step_nt, torch.float32)
    check(band_ptr, "band_ptr", torch.int32, (ngroups + 1,))
    check(xp, "xp", torch.float32)
    if xp.dim() != 2 or xp.shape[0] % TILE_C:
        raise ValueError(f"xp: expected (ncb·128, K), got {tuple(xp.shape)}")
    k = xp.shape[1]
    kp = -(-k // SPMM_KS) * SPMM_KS
    xk = F.pad(xp, (0, kp - k)) if kp != k else xp
    y = torch.empty((ngroups * BAND, kp), dtype=torch.float32,
                    device=xp.device)
    nchunk, ch = _chunks(ngroups, kp // SPMM_KS, tgt.shape[0],
                         max_band_steps, kp, spmm_blocks(xp.device))
    part = (torch.empty((ngroups * nchunk * BAND, kp), dtype=torch.float32,
                        device=xp.device) if nchunk > 1 else y)
    if ngroups and kp:
        with torch.cuda.device(xp.device):
            _CUDA.launch("btile_spmm", tiles.data_ptr(), tgt.data_ptr(),
                         step_cb.data_ptr(), step_nt.data_ptr(),
                         band_ptr.data_ptr(), xk.data_ptr(), part.data_ptr(),
                         ngroups, nchunk, ch, R, kp, stream(xp))
            LAUNCHES["btile_spmm"] += 1
            if nchunk > 1:
                _CUDA.launch("btile_combine", part.data_ptr(),
                             band_ptr.data_ptr(), y.data_ptr(), ngroups,
                             nchunk, ch, kp, stream(xp))
                LAUNCHES["btile_combine"] += 1
    return y[:, :k] if kp != k else y


def btile_sddmm(patt, tgt, step_g, step_cb, step_nt, ap, bp) -> torch.Tensor:
    """The C slab (the kernel; see ``btile_sddmm_torch``)."""
    if not on_cuda(patt, tgt, step_g, step_cb, step_nt, ap, bp):
        return btile_sddmm_torch(patt, tgt, step_g, step_cb, step_nt, ap, bp)
    nsteps, R = _check_steps(patt, tgt, step_g, step_cb, step_nt,
                             torch.int8)
    k = ap.shape[1]
    check(ap, "ap", torch.float32)
    check(bp, "bp", torch.float32, (bp.shape[0], k))
    if not 1 <= k <= SDDMM_MAX_K or ap.shape[0] % BAND or bp.shape[0] % TILE_C:
        raise ValueError(f"ap {tuple(ap.shape)}, bp {tuple(bp.shape)}: the "
                         f"kernel takes (ngroups·1024, K) and (ncb·128, K) "
                         f"with 1 ≤ K ≤ {SDDMM_MAX_K}")
    out = torch.empty((nsteps * R, TILE_C), dtype=torch.float32,
                      device=ap.device)
    if nsteps:
        with torch.cuda.device(ap.device):
            _CUDA.launch("btile_sddmm", patt.data_ptr(), tgt.data_ptr(),
                         step_g.data_ptr(), step_cb.data_ptr(),
                         step_nt.data_ptr(), ap.data_ptr(), bp.data_ptr(),
                         out.data_ptr(), nsteps, R, k, stream(ap))
        LAUNCHES["btile_sddmm"] += 1
    return out
