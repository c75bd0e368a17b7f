"""DIV-style packetized sparse-matrix compression (host bitstream codec).

Counterpart of ``spmv_research_tpu/io/div_codec.py``, host numpy, giving
the JAX package's arrays. The reference's research format DIV
(``DIV/div.cpp`` + ``div_kernels_rf.h:65-78,663-695``) cuts the bytes a
nonzero moves by splitting the matrix into packets of
``CSRCV_NUM_PACKET_VALS`` nonzeros and, per packet, (1) sorting the
nonzeros by value so the value stream becomes unique values + run lengths
("rf"), and (2) bit-packing the (row, col) coordinates at the packet's
natural bit widths. Here it is the storage and interchange codec: exact
CSR round trip, per-packet value RLE + bit-packed coordinates, and the
footprint accounting the reference reports as ``mem_footprint`` /
``mem_ratio`` (``bench_spmv.cpp:479-480``).

Packet layout (all host numpy):
  uvals[u_ptr[p]:u_ptr[p+1]]   sorted distinct values (RLE mode) or the raw
                               value stream (raw mode — chosen per packet
                               when repetition is too low for RLE to pay,
                               the reference's ADAPT variant, div.cpp:34-37)
  rf[ r_ptr[p]:r_ptr[p+1]]     run length per distinct value (RLE mode only)
  coord bitstream              per-nnz (row-row0) at rbits, col at cbits,
                               in value-sorted order (order within a packet
                               is free — SpMV is an unordered reduction)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _pack_bits(arr: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned ints (< 2**bits, bits ≤ 32) into a uint32 stream."""
    if bits == 0 or arr.size == 0:
        return np.zeros(0, np.uint32)
    a = arr.astype(np.uint64)
    bitpos = np.arange(a.size, dtype=np.uint64) * np.uint64(bits)
    word = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    n_words = int((a.size * bits + 31) // 32)
    out = np.zeros(n_words + 1, np.uint64)
    shifted = a << off
    np.bitwise_or.at(out, word, shifted & np.uint64(0xFFFFFFFF))
    np.bitwise_or.at(out, word + 1, shifted >> np.uint64(32))
    return out[:n_words].astype(np.uint32)


def _unpack_bits(words: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits`."""
    if bits == 0 or count == 0:
        return np.zeros(count, np.int64)
    w = np.concatenate([words.astype(np.uint64), np.zeros(1, np.uint64)])
    bitpos = np.arange(count, dtype=np.uint64) * np.uint64(bits)
    word = (bitpos >> np.uint64(5)).astype(np.int64)
    off = bitpos & np.uint64(31)
    pair = w[word] | (w[word + 1] << np.uint64(32))
    mask = np.uint64((1 << bits) - 1)
    return ((pair >> off) & mask).astype(np.int64)


def _bits_for(maxval: int) -> int:
    return int(maxval).bit_length() if maxval > 0 else 0


@dataclasses.dataclass
class DivPackets:
    """Compressed matrix: value-RLE + bit-packed coordinates per packet."""

    m: int
    n: int
    nnz: int
    packet_nnz: int
    uvals: np.ndarray      # concatenated per-packet value streams
    rf: np.ndarray         # uint32 run lengths (RLE packets only)
    u_ptr: np.ndarray      # (n_packets+1,) offsets into uvals
    r_ptr: np.ndarray      # (n_packets+1,) offsets into rf
    vmode: np.ndarray      # (n_packets,) uint8: 1 = RLE, 0 = raw values
    coords: np.ndarray     # uint32 bitstream
    c_ptr: np.ndarray      # (n_packets+1,) word offsets into coords
    row0: np.ndarray       # (n_packets,) first (smallest) row per packet
    rbits: np.ndarray      # (n_packets,) uint8 row-delta width
    cbits: np.ndarray      # (n_packets,) uint8 col width

    format_name = "DIVP"

    @property
    def n_packets(self) -> int:
        return self.row0.shape[0]

    def mem_footprint_bytes(self) -> int:
        return int(self.uvals.nbytes + self.rf.nbytes + self.u_ptr.nbytes
                   + self.r_ptr.nbytes + self.vmode.nbytes
                   + self.coords.nbytes + self.c_ptr.nbytes
                   + self.row0.nbytes + self.rbits.nbytes
                   + self.cbits.nbytes)

    def csr_footprint_bytes(self) -> int:
        vb = self.uvals.dtype.itemsize
        return self.nnz * (vb + 4) + (self.m + 1) * 4

    def compression_ratio(self) -> float:
        return self.mem_footprint_bytes() / max(self.csr_footprint_bytes(), 1)


def compress_csr(ia: np.ndarray, ja: np.ndarray, a: np.ndarray,
                 m: int, n: int, packet_nnz: int = 4096) -> DivPackets:
    """Compress CSR arrays (the reference's per-packet pipeline:
    ``div_kernels_rf.h:663-695`` sort + run-length; header ``:65-78``)."""
    nnz = int(ja.shape[0])
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ia))
    cols = ja.astype(np.int64)
    vals = np.asarray(a)

    n_packets = max((nnz + packet_nnz - 1) // packet_nnz, 1)
    uvals_l, rf_l, cwords_l = [], [], []
    u_ptr = np.zeros(n_packets + 1, np.int64)
    r_ptr = np.zeros(n_packets + 1, np.int64)
    c_ptr = np.zeros(n_packets + 1, np.int64)
    row0 = np.zeros(n_packets, np.int64)
    rbits = np.zeros(n_packets, np.uint8)
    cbits = np.zeros(n_packets, np.uint8)
    vmode = np.zeros(n_packets, np.uint8)
    vb = vals.dtype.itemsize

    for p in range(n_packets):
        lo, hi = p * packet_nnz, min((p + 1) * packet_nnz, nnz)
        pv, pr, pc = vals[lo:hi], rows[lo:hi], cols[lo:hi]
        uv, counts = np.unique(pv, return_counts=True)
        # ADAPT: RLE only when the dictionary+runs beat the raw stream
        if uv.shape[0] * (vb + 4) < pv.shape[0] * vb:
            vmode[p] = 1
            order = np.argsort(pv, kind="stable")  # value sort → RLE
            pv, pr, pc = pv[order], pr[order], pc[order]
            uvals_l.append(uv)
            rf_l.append(counts.astype(np.uint32))
            r_ptr[p + 1] = r_ptr[p] + uv.shape[0]
            u_ptr[p + 1] = u_ptr[p] + uv.shape[0]
        else:
            uvals_l.append(pv)
            r_ptr[p + 1] = r_ptr[p]
            u_ptr[p + 1] = u_ptr[p] + pv.shape[0]
        r0 = int(pr.min()) if pr.size else 0
        rb = _bits_for(int(pr.max()) - r0) if pr.size else 0
        cb = _bits_for(int(pc.max())) if pc.size else 0
        row0[p], rbits[p], cbits[p] = r0, rb, cb
        stream = np.concatenate([_pack_bits(pr - r0, rb),
                                 _pack_bits(pc, cb)])
        cwords_l.append(stream)
        c_ptr[p + 1] = c_ptr[p] + stream.shape[0]

    return DivPackets(
        m=m, n=n, nnz=nnz, packet_nnz=packet_nnz,
        uvals=np.concatenate(uvals_l) if uvals_l else np.zeros(0, vals.dtype),
        rf=np.concatenate(rf_l) if rf_l else np.zeros(0, np.uint32),
        u_ptr=u_ptr, r_ptr=r_ptr, vmode=vmode,
        coords=(np.concatenate(cwords_l) if cwords_l
                else np.zeros(0, np.uint32)),
        c_ptr=c_ptr, row0=row0, rbits=rbits, cbits=cbits)


def decompress(dp: DivPackets) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact inverse: returns CSR (ia, ja, a) in canonical (row, col) order."""
    rows = np.zeros(dp.nnz, np.int64)
    cols = np.zeros(dp.nnz, np.int64)
    vals = np.zeros(dp.nnz, dp.uvals.dtype)
    for p in range(dp.n_packets):
        lo = p * dp.packet_nnz
        hi = min(lo + dp.packet_nnz, dp.nnz)
        cnt = hi - lo
        uv = dp.uvals[dp.u_ptr[p]:dp.u_ptr[p + 1]]
        if dp.vmode[p]:
            rf = dp.rf[dp.r_ptr[p]:dp.r_ptr[p + 1]]
            vals[lo:hi] = np.repeat(uv, rf)
        else:
            vals[lo:hi] = uv
        stream = dp.coords[dp.c_ptr[p]:dp.c_ptr[p + 1]]
        rb, cb = int(dp.rbits[p]), int(dp.cbits[p])
        rw = (cnt * rb + 31) // 32
        rows[lo:hi] = _unpack_bits(stream[:rw], rb, cnt) + dp.row0[p]
        cols[lo:hi] = _unpack_bits(stream[rw:], cb, cnt)
        if dp.vmode[p]:
            # restore canonical CSR order (value sort is a within-packet
            # permutation; packets tile the row-major order)
            order = np.lexsort((cols[lo:hi], rows[lo:hi]))
            rows[lo:hi] = rows[lo:hi][order]
            cols[lo:hi] = cols[lo:hi][order]
            vals[lo:hi] = vals[lo:hi][order]

    ia = np.zeros(dp.m + 1, np.int64)
    np.add.at(ia, rows + 1, 1)
    ia = np.cumsum(ia)
    return ia.astype(np.int32), cols.astype(np.int32), vals
