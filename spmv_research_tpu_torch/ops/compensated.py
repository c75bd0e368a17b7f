"""Double-single ("compensated fp32 pair") SpMV: the fp64-parity path.

Counterpart of ``spmv_research_tpu/ops/compensated.py``. The reference's
headline dtype is double, gated at 1e-10 relative error against a
``_Float128`` Kahan gold (``bench_spmv.cpp:61-64,114-119``). Every fp64
operand is held as an exact pair of fp32s (``hi + lo``, Dekker/Knuth
double-single arithmetic, ~2^-48 unit roundoff) and the whole SpMV runs in
paired fp32:

* TwoProd by Dekker splitting;
* TwoSum accumulation along padded row segments;
* the final ``hi + lo`` recombination in fp64 on the host.

The error after an n-term row sum is O(n · 2^-48) relative, inside the
1e-10 gate for any realistic row degree.

CSRDS is a parity engine, not a throughput engine: the JAX package computes
it in XLA and has no Pallas kernel for it, so the port computes it in plain
PyTorch on every device (``"torch"``, one of the dispatch's
``LIBRARY_FORMATS``). Every step is a separate elementwise PyTorch
operation, rounded on its own, so no multiply is fused into an add.

Layout: rows split into segments of ≤ ``SEG`` nnz; the segments padded into
an ``(nseg + 1, SEG)`` plane (hi and lo value planes, a column plane and a
live mask; the last segment all zero); each row's segment list padded into
``(m, kseg)`` with the all-zero segment. Both reductions are sequential
TwoSum folds, vectorised across rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .dispatch import register_spmv

SEG = 64               # nnz per padded row segment
DS_MAX_ABS = 8.0e34    # Dekker-split overflow bound (see _split32)

DATA_FIELDS = ("vhi", "vlo", "cols", "segrow", "xpad_mask")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "kseg")


class DSRangeError(ValueError):
    """A matrix value past ``DS_MAX_ABS``: its Dekker split would overflow
    fp32, so no double-single format takes the matrix."""


def _split_f64(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fp64 → (hi, lo) fp32 pair, lo = fp32(v − hi) taken in fp64."""
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _two_sum(a, b):
    """Knuth TwoSum: a + b = s + e exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split32(a):
    """Dekker split of fp32 into 12 + 12-bit halves (exact).

    ``4097·a`` overflows fp32 for |a| ≥ ~8.3e34, which would turn TwoProd's
    error terms into NaN: the builders refuse values past ``DS_MAX_ABS``."""
    c = a * 4097.0      # 2^12 + 1
    ahi = c - (c - a)
    return ahi, a - ahi


def _two_prod(a, b):
    """Dekker TwoProd: a·b = p + e exactly in fp32 pairs (no FMA)."""
    p = a * b
    ahi, alo = _split32(a)
    bhi, blo = _split32(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def check_ds_range(a: np.ndarray) -> None:
    """Raise :class:`DSRangeError` when max |a| reaches ``DS_MAX_ABS``."""
    amax = float(np.max(np.abs(a))) if a.size else 0.0
    if amax >= DS_MAX_ABS:
        raise DSRangeError(
            f"double-single operand range exceeded: max|a| = {amax:.3g} >= "
            f"{DS_MAX_ABS:.1g} overflows the fp32 Dekker split (scale the "
            "matrix)")


@dataclasses.dataclass(frozen=True)
class CsrDS:
    """Double-single padded-segment CSR (field for field the JAX
    ``CsrDS``)."""

    vhi: torch.Tensor        # (nseg + 1, SEG) fp32 value hi
    vlo: torch.Tensor        # (nseg + 1, SEG) fp32 value lo
    cols: torch.Tensor       # (nseg + 1, SEG) int32 column (0 where pad)
    segrow: torch.Tensor     # (m, kseg) int32 segment per row (pad: nseg)
    xpad_mask: torch.Tensor  # (nseg + 1, SEG) fp32 1.0 live / 0.0 pad
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    kseg: int

    format_name = "CSRDS"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vhi.device

    def to(self, device) -> "CsrDS":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(4 * (self.vhi.numel() + self.vlo.numel()
                        + self.cols.numel() + self.segrow.numel()
                        + self.xpad_mask.numel()))


def build_csrds(csr: HostCSR) -> CsrDS:
    """Compile host CSR (fp64 values) into the double-single format (the
    JAX builder's arrays). Raises :class:`DSRangeError` on values past
    ``DS_MAX_ABS``."""
    check_ds_range(csr.a)
    m, n = csr.m, csr.n
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)
    lens = np.diff(ia)
    nseg_per_row = (lens + SEG - 1) // SEG
    kseg = max(int(nseg_per_row.max(initial=0)), 1)
    nseg = max(int(nseg_per_row.sum()), 1)

    # segment s holds nnz [seg_start[s], seg_start[s] + SEG) of its row,
    # cut at the row's end; the segments of a row are consecutive
    seg_row = np.repeat(np.arange(m), nseg_per_row)
    seg_k = (np.arange(seg_row.size)
             - np.repeat(np.cumsum(nseg_per_row) - nseg_per_row,
                         nseg_per_row))
    seg_start = ia[seg_row] + seg_k * SEG
    width = np.minimum(seg_start + SEG, ia[seg_row + 1]) - seg_start
    live = np.arange(SEG)[None, :] < width[:, None]
    src = np.where(live, seg_start[:, None] + np.arange(SEG)[None, :], 0)

    hi_all, lo_all = _split_f64(csr.a)
    vhi = np.zeros((nseg + 1, SEG), np.float32)
    vlo = np.zeros((nseg + 1, SEG), np.float32)
    cols = np.zeros((nseg + 1, SEG), np.int32)
    mask = np.zeros((nseg + 1, SEG), np.float32)
    s = seg_row.size
    vhi[:s] = np.where(live, hi_all[src], 0.0)
    vlo[:s] = np.where(live, lo_all[src], 0.0)
    cols[:s] = np.where(live, ja[src], 0)
    mask[:s] = live
    # -1 pads point at the all-zero segment appended after the last one
    segrow = np.full((m, kseg), nseg, np.int32)
    segrow[seg_row, seg_k] = np.arange(s)
    return _csrds(dict(vhi=vhi, vlo=vlo, cols=cols, segrow=segrow,
                       xpad_mask=mask),
                  dict(shape=(m, n), nnz=csr.nnz,
                       nnz_expanded=csr.nnz_expanded, kseg=kseg))


def _csrds(arrays: dict, meta: dict) -> CsrDS:
    """CsrDS from numpy arrays and meta fields (on the CPU)."""
    return CsrDS(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                    for k in DATA_FIELDS}, **meta)


def csrds_from_jax(leaves: dict, meta: dict) -> CsrDS:
    """The port's ``CsrDS`` for a program built by the JAX package
    (``leaves``: each data field's array, ``meta``: each meta field)."""
    return _csrds({k: np.array(leaves[k]) for k in DATA_FIELDS},
                  {k: meta[k] for k in META_FIELDS})


def _ds_spmv_planes(A: CsrDS, xhi: torch.Tensor, xlo: torch.Tensor):
    """Per-segment compensated partial sums → per-row pair (hi, lo)."""
    cols = A.cols.long()
    mask = A.xpad_mask
    gx_hi = xhi[cols]
    gx_lo = xlo[cols]
    # elementwise DS product: (vhi + vlo)·(xhi + xlo) = p + e
    p, e = _two_prod(A.vhi, gx_hi * mask)
    e = e + A.vhi * gx_lo * mask + A.vlo * gx_hi * mask
    # sequential TwoSum fold along the segment axis
    p, e = p.t().contiguous(), e.t().contiguous()
    s = torch.zeros_like(p[0])
    err = torch.zeros_like(p[0])
    for j in range(SEG):
        s, e1 = _two_sum(s, p[j])
        err = err + e1 + e[j]
    # per-row combine across segments (≤ kseg, sequential TwoSum); pad
    # entries point at the all-zero segment
    seg = A.segrow.long().t()
    rs = torch.zeros(A.m, dtype=p.dtype, device=p.device)
    re = torch.zeros_like(rs)
    for k in range(A.kseg):
        rs, e1 = _two_sum(rs, s[seg[k]])
        re = re + e1 + err[seg[k]]
    return rs, re


def spmv_csrds_pair(A: CsrDS, xhi: torch.Tensor, xlo: torch.Tensor):
    """Pair-in, pair-out SpMV (for iterative solvers staying in DS)."""
    rs, re = _ds_spmv_planes(A, xhi, xlo)
    return _two_sum(rs, re)


@register_spmv("CSRDS", "torch")
def spmv_csrds_torch(A: CsrDS, x: torch.Tensor) -> torch.Tensor:
    """fp32-x entry (x with a zero lo plane), so the generic harness can
    drive the format with its fp32 vectors; the values keep their fp64
    precision. For the fp64 result call :func:`spmv_csrds_f64`."""
    xhi = x.to(torch.float32)
    s, e = spmv_csrds_pair(A, xhi, torch.zeros_like(xhi))
    return s + e


def spmv_csrds_f64(A: CsrDS, x: np.ndarray,
                   impl: Optional[str] = None) -> np.ndarray:
    """Host fp64 x → DS pair on ``A.device`` → host fp64 y (~2^-48
    relative): passes the reference's fp64 gate (1e-10 relative against
    the longdouble Kahan gold). CSRDS has one pair, the plain PyTorch one:
    ``impl`` may be ``"torch"`` or None, and anything else raises."""
    if impl not in (None, "torch"):
        raise ValueError(f"CSRDS has only the 'torch' pair, not {impl!r}")
    xhi, xlo = _split_f64(x)
    s, e = spmv_csrds_pair(A, torch.from_numpy(xhi).to(A.device),
                           torch.from_numpy(xlo).to(A.device))
    return (s.cpu().numpy().astype(np.float64)
            + e.cpu().numpy().astype(np.float64))[: A.m]


CsrDS.spmv_f64 = spmv_csrds_f64   # the harness's fp64-gate hook (bench_spmv)
