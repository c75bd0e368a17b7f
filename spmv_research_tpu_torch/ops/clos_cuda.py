"""The CLOSG main path's CUDA kernels: build, wrappers, plain versions.

Counterpart of the main-path parts of ``spmv_research_tpu/ops/clos_pallas.py``
and ``spmv_research_tpu/ops/clos_gather.py``. Three kernels, one per Pallas
kernel the main path runs (sources and design notes in ``csrc/closg.cu``):

=======================  =====================================================
wrapper                  replaces
=======================  =====================================================
``closg_front``          ``clos_gather.py:_gmul_r1_dma_kernel`` (x window
                         gather × value, then the r1 layer)
``clos_invreg``          ``clos_pallas.py:_invreg_kernel`` (one in-vreg layer;
                         the r2 layer)
``closg_r3_scan_yext``   ``clos_pallas.py:_r3_scan_yext_kernel`` (r3 layer,
                         capped segmented scan, y extraction) — three
                         launches on the GPU: the r3 layer, one per scan
                         stage, the extraction
=======================  =====================================================

Each wrapper takes the kernel's plain PyTorch version (``*_torch``) only when
its tensors lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. ``LAUNCHES`` counts, per wrapper, its kernel launches
(K3's three kinds together). The ``_t_fwd``/``_t_bwd`` transposes between the layers stay
PyTorch copies (``clos.py``), as they were XLA ops in the JAX package.

The kernels are compiled by ``nvcc`` from ``csrc/closg.cu`` at first CUDA use
(``cuda_lib.CudaLib``); importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from .clos import SPARE_BITS, SPARE_SHIFT, _stage_bit, invreg_torch
from .clos_route import LANES, SUB
from .cuda_lib import CudaLib, check as _check, on_cuda as _on_cuda
from .cuda_lib import stream as _stream

LAUNCHES = {"closg_front": 0, "clos_invreg": 0, "closg_r3_scan_yext": 0}


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.closg_invreg.argtypes = [p, p, p, i64, i32, p]
    lib.closg_front.argtypes = [p, p, p, p, i64, p, i64, p]
    lib.closg_scan_step.argtypes = [p, p, p, p, i32, i64, p]
    lib.closg_yext.argtypes = [p, p, p, p, p, p, i32, p]
    for fn in (lib.closg_invreg, lib.closg_front, lib.closg_scan_step,
               lib.closg_yext):
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
    if n_slots % 1024 or lanes < 1 or lanes > LANES or lanes & (lanes - 1):
        raise ValueError(f"layer shape needs a multiple of 1024 slots and a "
                         f"power-of-two lane width <= {LANES}; got {n_slots} "
                         f"slots of {lanes} lanes")


# ------------------------------------------------------------ plain versions

clos_invreg_torch = invreg_torch


def closg_front_torch(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                      vals_cs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """wins[s] = x2d[rowidx[s]]; v = wins[s, λ] · vals_cs; then the r1 layer
    (``_gmul_dma`` of the JAX package)."""
    x_rows = (x.shape[0] + LANES - 1) // LANES
    x2d = F.pad(x, (0, x_rows * LANES - x.shape[0])).view(x_rows, LANES)
    lam = ((perm_r1 >> SPARE_SHIFT) & 0x7F).long()
    g = torch.gather(x2d[rowidx.long()], 1, lam)
    return invreg_torch(g * vals_cs, perm_r1)


def _scan_torch(u: torch.Tensor, w3: torch.Tensor, hi: torch.Tensor,
                stages: Sequence[int]) -> torch.Tensor:
    for k in stages:
        guard = _stage_bit(k, w3, hi)
        u = u + torch.where(guard, torch.roll(u, 1 << k), 0.0)
    return u


def _y_pick(scr, ysel_w, wstart, rows):
    sel = ysel_w[rows]
    empty = ((sel >> 16) & 1) != 0
    src = wstart[rows].unsqueeze(1) + ((sel >> 7) & 0x1FF)
    val = scr[torch.where(empty, 0, src).long(), (sel & 0x7F).long()]
    return torch.where(empty, 0.0, val)


def closg_r3_scan_yext_torch(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr,
                             acc_src, stages: Sequence[int]) -> torch.Tensor:
    """r3 layer, the scan stages ``stages`` (capped: in-row window sums),
    then y extraction — base records, then the accumulate records in the
    order ``acc_ptr``/``acc_src`` give. Returns y as (8·n_batches, 128)."""
    _check_hi(stages, scan_hi, v.numel())
    u = _scan_torch(invreg_torch(v, perm_r3).reshape(-1), perm_r3.reshape(-1),
                    scan_hi.reshape(-1), stages)
    scr = u.view(-1, LANES)
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


def _check_hi(stages: Sequence[int], scan_hi: torch.Tensor, n: int) -> None:
    if any(k >= SPARE_BITS for k in stages) and scan_hi.numel() != n:
        raise ValueError("scan stages >= 15 need the full scan_hi plane")


# ------------------------------------------------------------------ wrappers

def clos_invreg(v: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """One in-vreg layer on an (S, L) plane (kernel K2)."""
    if not _on_cuda(v, word):
        return clos_invreg_torch(v, word)
    _check(v, "v", torch.float32)
    _check(word, "word", torch.int32, v.shape)
    _check_slots(v.numel(), v.shape[1])
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        _launch("closg_invreg", v.data_ptr(), word.data_ptr(), out.data_ptr(),
                v.numel(), v.shape[1], _stream(v))
    LAUNCHES["clos_invreg"] += 1
    return out


def closg_front(rowidx: torch.Tensor, perm_r1: torch.Tensor,
                vals_cs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Window gather × value, then the r1 layer (kernel K1): (8V, 128)."""
    if not _on_cuda(rowidx, perm_r1, vals_cs, x):
        return closg_front_torch(rowidx, perm_r1, vals_cs, x)
    S = rowidx.shape[0]
    _check(rowidx, "rowidx", torch.int32, (S,))
    _check(perm_r1, "perm_r1", torch.int32, (S, LANES))
    _check(vals_cs, "vals_cs", torch.float32, (S, LANES))
    _check(x, "x", torch.float32, (x.shape[0],))
    _check_slots(S * LANES, LANES)
    out = torch.empty_like(vals_cs)
    with torch.cuda.device(x.device):
        _launch("closg_front", rowidx.data_ptr(), perm_r1.data_ptr(),
                vals_cs.data_ptr(), x.data_ptr(), x.shape[0], out.data_ptr(),
                S * LANES, _stream(x))
    LAUNCHES["closg_front"] += 1
    return out


def closg_r3_scan_yext(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr, acc_src,
                       stages: Sequence[int]) -> torch.Tensor:
    """r3 layer + capped segmented scan + y extraction (kernel K3)."""
    if not _on_cuda(v, perm_r3, scan_hi, ysel_w, wstart, acc_ptr, acc_src):
        return closg_r3_scan_yext_torch(v, perm_r3, scan_hi, ysel_w, wstart,
                                        acc_ptr, acc_src, stages)
    n = v.numel()
    n_batches = acc_ptr.shape[0] - 1
    _check(v, "v", torch.float32, (n // LANES, LANES))
    _check(perm_r3, "perm_r3", torch.int32, v.shape)
    _check(scan_hi, "scan_hi", torch.int32)
    _check(ysel_w, "ysel_w", torch.int32, (ysel_w.shape[0], LANES))
    _check(wstart, "wstart", torch.int32, (ysel_w.shape[0],))
    _check(acc_ptr, "acc_ptr", torch.int32)
    _check(acc_src, "acc_src", torch.int32)
    _check_slots(n, LANES)
    if n & (n - 1):
        raise ValueError(f"slot count {n} is not a power of two")
    if ysel_w.shape[0] < n_batches * SUB:
        raise ValueError("ysel_w holds fewer records than y batches")
    _check_hi(stages, scan_hi, n)
    hi_ptr = scan_hi.data_ptr() if scan_hi.numel() == n else None
    a = torch.empty_like(v)
    b = torch.empty_like(v)
    y = torch.empty((n_batches * SUB, LANES), dtype=v.dtype, device=v.device)
    stream = _stream(v)
    with torch.cuda.device(v.device):
        _launch("closg_invreg", v.data_ptr(), perm_r3.data_ptr(), a.data_ptr(),
                n, LANES, stream)
        LAUNCHES["closg_r3_scan_yext"] += 1
        for k in stages:
            _launch("closg_scan_step", a.data_ptr(), b.data_ptr(),
                    perm_r3.data_ptr(), hi_ptr, k, n, stream)
            LAUNCHES["closg_r3_scan_yext"] += 1
            a, b = b, a
        if n_batches:
            _launch("closg_yext", a.data_ptr(), ysel_w.data_ptr(),
                    wstart.data_ptr(), acc_ptr.data_ptr(), acc_src.data_ptr(),
                    y.data_ptr(), n_batches, stream)
            LAUNCHES["closg_r3_scan_yext"] += 1
    return y
