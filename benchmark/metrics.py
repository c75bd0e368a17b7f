"""The benchmark's arithmetic: peaks, least times, percentiles and interval
unions. Nothing here touches a device or the program.

The peaks are NVIDIA's data-sheet figures, copied from the port's
``utils/roofline.py`` so that the yardstick stays fixed: HBM bytes/s and
the fp32 rate outside the tensor cores, keyed on a substring of
``torch.cuda.get_device_name()``; the first match wins.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

PEAKS = (
    ("H100 NVL", 3.9e12, 60.0e12),
    ("H100 PCIe", 2.0e12, 51.0e12),
    ("H100 80GB HBM3", 3.35e12, 67.0e12),   # the SXM5 part
    ("H100 SXM", 3.35e12, 67.0e12),
    ("H200", 4.8e12, 67.0e12),
)


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    """(HBM bytes/s, fp32 FLOP/s) of the card named ``kind``, or None."""
    for key, bw, flops in PEAKS:
        if key in kind:
            return bw, flops
    return None


def csr_bytes(nnz: int, m: int, n: int, value_bytes: int = 4) -> int:
    """One SpMV's bytes in CSR storage, each input read once and y written
    once: values and column indices, the row pointer, x and y."""
    return nnz * (value_bytes + 4) + (m + 1) * 4 + (m + n) * value_bytes


def spmv_least_s(nnz: int, m: int, n: int, bw: float) -> float:
    return csr_bytes(nnz, m, n) / bw


def spmm_least_s(nnz: int, m: int, n: int, k: int, bw: float,
                 flops: float) -> float:
    """The larger of A's CSR bytes with X (n·k) and Y (m·k) over the
    bandwidth, and 2·nnz·k operations over the fp32 rate."""
    nbytes = nnz * 8 + (m + 1) * 4 + (n + m) * k * 4
    return max(nbytes / bw, 2.0 * nnz * k / flops)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, linear between the
    two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: Optional[float] = None,
                 hi: Optional[float] = None) -> float:
    """Length of the union of (start, end) intervals, each clipped to
    [lo, hi] where given."""
    clipped = []
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            clipped.append((s, e))
    clipped.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def card_peaks(device) -> Optional[Tuple[float, float]]:
    """``peaks`` of the CUDA card ``device``; None on another device."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peaks(torch.cuda.get_device_name(device))
