"""The BTILE engine's CUDA kernels: wrappers and plain versions.

Counterpart of the Pallas kernels of ``spmv_research_tpu/ops/btile.py``
(sources and design notes in ``csrc/btile.cu``):

===============  ==========================================================
wrapper          replaces
===============  ==========================================================
``btile_spmm``   ``btile.py:_btile_spmm_kernel``: Y (ngroups·1024, K) from
                 the tile slabs and X padded to (ncb·128, K); a product
                 launch (``btile_spmm``: stored zeros skipped, the band
                 accumulator in shared memory; ``spmm_plan`` cuts it),
                 and a second (``btile_combine``) when bands are cut into
                 chunks
``btile_sddmm``  ``btile.py:_btile_sddmm_kernel``: the C slab
                 (nsteps·tg·8, 128) = (A[band rows] · B[cb]ᵀ) ∘ pattern;
                 one block of ``SDDMM_THREADS`` a step with B[cb] in
                 shared memory, a warp per slab row with its A row in
                 registers, 8 lanes a nonzero (``sddmm_smem`` gives its
                 shared memory a block)
===============  ==========================================================

Each wrapper takes the kernel's plain PyTorch version (``*_torch``, the
JAX package's ``spmm_btile_xla`` / ``sddmm_btile_xla``) only when its
tensors lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. ``LAUNCHES`` counts the kernel launches, beside each
launch. The plain versions multiply with ``torch.bmm`` and place with
``index_add_``, so kernel and plain version agree to fp32 add-order slack,
not bit for bit; the SpMM kernel skips stored zeros, so it also differs
where X holds inf or NaN (0·inf is NaN in the plain version only).

The kernels are compiled by ``nvcc`` from ``csrc/btile.cu`` at first CUDA
use (``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .cuda_lib import CudaLib, check, on_cuda, stream

TILE_R = 8
TILE_C = 128
BAND = 1024            # rows per band
SPMM_SLICE = 32        # X columns per SpMM block (csrc/btile.cu kSlice)
# the SpMM block's dynamic shared memory (csrc/btile.cu kSpmmSmem): the
# band accumulator, two X slices and 32 warps' lists of 128 (value,
# column) pairs, so one block an SM
SPMM_SMEM_BYTES = (4 * (BAND * SPMM_SLICE + 2 * TILE_C * SPMM_SLICE)
                   + 8 * 32 * TILE_C)
SPMM_WAVES = 4         # SpMM blocks to aim for, per SM of the card
SPMM_PART_BYTES = 1 << 30   # the most the SpMM's chunk partials may take
MAX_STEP_ROWS = 256    # slab rows per step the kernels take (tg ≤ 32)
SDDMM_MAX_K = 256      # B[cb] (128 × K fp32) in one SM's shared memory
SDDMM_THREADS = 512    # threads of an SDDMM block (csrc/btile.cu kSdThreads)

LAUNCHES = {"btile_spmm": 0, "btile_combine": 0, "btile_sddmm": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.btile_spmm.argtypes = [p, p, p, p, p, p, p, p, i32, i32, i32, i32,
                               i32, p]
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
def sm_count(device: torch.device) -> int:
    """The SMs of ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class SpmmPlan:
    """How the SpMM kernel cuts one product: X padded to ``kp`` columns,
    ``slices`` blocks of 32 columns per (band, chunk), bands cut into
    ``nchunk`` chunks of ``ch`` steps, ``blocks`` blocks in all, each with
    ``smem_bytes`` of shared memory; ``part_bytes`` of chunk partials
    (0 when no band is cut)."""
    kp: int
    slices: int
    nchunk: int
    ch: int
    blocks: int
    smem_bytes: int
    part_bytes: int


def spmm_plan(ngroups: int, max_band_steps: int, k: int,
              sms: int) -> SpmmPlan:
    """The SpMM kernel's cut for ``ngroups`` bands of at most
    ``max_band_steps`` steps and K = ``k`` on a card of ``sms`` SMs: bands
    are cut into chunks only as far as ``SPMM_WAVES`` blocks per SM need,
    one block an SM resident; the partials stay within
    ``SPMM_PART_BYTES``."""
    kp = -(-k // SPMM_SLICE) * SPMM_SLICE
    slices = kp // SPMM_SLICE
    steps = max(max_band_steps, 1)
    units = max(ngroups * slices, 1)
    nchunk = min(steps, -(-SPMM_WAVES * sms // units))
    band_bytes = 4 * BAND * max(kp, 1)
    nchunk = max(min(nchunk, SPMM_PART_BYTES // (band_bytes
                                                 * max(ngroups, 1))), 1)
    ch = -(-steps // nchunk)
    nchunk = -(-steps // ch)
    return SpmmPlan(kp=kp, slices=slices, nchunk=nchunk, ch=ch,
                    blocks=ngroups * nchunk * slices,
                    smem_bytes=SPMM_SMEM_BYTES,
                    part_bytes=(band_bytes * ngroups * nchunk
                                if nchunk > 1 else 0))


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
    if tiles.data_ptr() % 16:
        raise ValueError("tiles: the SpMM kernel reads them 16 bytes at a "
                         "time, so they must be 16-byte aligned")
    k = xp.shape[1]
    plan = spmm_plan(ngroups, max_band_steps, k, sm_count(xp.device))
    xk = xp
    if plan.kp != k or xp.data_ptr() % 16:   # cp.async reads 16 B at a time
        xk = xp.new_zeros((xp.shape[0], plan.kp))
        xk[:, :k] = xp
    y = torch.empty((ngroups * BAND, plan.kp), dtype=torch.float32,
                    device=xp.device)
    part = (torch.empty((ngroups * plan.nchunk * BAND, plan.kp),
                        dtype=torch.float32, device=xp.device)
            if plan.nchunk > 1 else y)
    if ngroups and k:
        with torch.cuda.device(xp.device):
            _CUDA.launch("btile_spmm", tiles.data_ptr(), tgt.data_ptr(),
                         step_cb.data_ptr(), step_nt.data_ptr(),
                         band_ptr.data_ptr(), xk.data_ptr(), y.data_ptr(),
                         part.data_ptr(), ngroups, plan.nchunk, plan.ch, R,
                         plan.kp, stream(xp))
            LAUNCHES["btile_spmm"] += 1
            if plan.nchunk > 1:
                _CUDA.launch("btile_combine", part.data_ptr(),
                             band_ptr.data_ptr(), y.data_ptr(), ngroups,
                             plan.nchunk, plan.ch, plan.kp, stream(xp))
                LAUNCHES["btile_combine"] += 1
    return y[:, :k] if plan.kp != k else y


def sddmm_smem(k: int) -> int:
    """The SDDMM block's dynamic shared memory at K = ``k`` (csrc/btile.cu
    ``sddmm_smem``): B[cb] at a padded row stride, and each warp's C row
    and list of up to 128 columns."""
    warps = SDDMM_THREADS // 32
    stride = (k + 7) // 8 * 8 + 4
    return 4 * (TILE_C * stride + warps * TILE_C) + warps * TILE_C


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
    if patt.data_ptr() % 4:
        raise ValueError("patt: the SDDMM kernel reads it 4 bytes at a "
                         "time, so it must be 4-byte aligned")
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
