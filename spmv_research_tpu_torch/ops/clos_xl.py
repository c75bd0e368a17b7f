"""CLOSGX: XL matrices as C stacked uniform CLOSG chunk programs.

Counterpart of ``spmv_research_tpu/ops/clos_xl.py``. Every chunk is built
with a forced uniform shape (N = ``chunk_N`` slots, padded), no scan capping
and power-of-two extraction classes, and the chunk planes are stacked on a
leading chunk axis: ``rowidx`` (C, S), ``vals``/``r1``/``r3`` (C, S, 128),
``r2`` (C, 8·1024, V/8), ``ysel_w`` (C, mrp, 128), ``wstart`` (C, mrp). Chunk
row boundaries are multiples of 128, so y is one row gather (``ymap``) over
the stacked (C·mrp, 128) output.

The JAX package runs a ``lax.scan`` over the chunks, one chunk pipeline per
step. Here each step of the pipeline runs once for all chunks: B1 over C·S
rows, ``clos_r2`` (the r2 layer with its transposes) over the stacked natural
planes, and ``clos_cuda.closgx_r3_scan_yext`` (the r3 layer, the scan stages
with the shift kept inside each chunk, in the phased scan, and one
extraction launch over every chunk's batches), then the ``ymap`` gather.

XL chunks carry no accumulate records and their base records are in place
(``border`` src = dst), so every batch of every chunk is extracted where it
lies; ``wstart_abs`` (derived on the host, not part of the JAX program) is
each group's window start plus its chunk's S rows. Padded batches carry the
empty bit and give 0; only ``ymap`` rows reach y.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from ..core.formats import _move
from ..core.host import HostCSR
from .dispatch import register_spmm_column_loop, register_spmv
from .clos import SPARE_SHIFT
from .clos_route import BLK, LANES, SUB, ClosRoutingError
from . import clos_cuda as K

_CLASS_WS = (1, 2, 4, 8, 16, 32, 64)   # canonical pow2 window classes
DATA_FIELDS = ("rowidx", "vals", "r1", "r2", "r3", "ysel_w", "wstart",
               "border", "clsmeta", "ymap")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "N", "V", "x_rows",
               "stages", "W", "mrp")


@dataclasses.dataclass(frozen=True)
class ClosGX:
    """Stacked uniform CLOSG chunk programs (field for field the JAX
    ``ClosGX``, leading axis = chunk), plus the derived ``wstart_abs``."""

    rowidx: torch.Tensor       # (C, S) int32
    vals: torch.Tensor         # (C, S, 128)
    r1: torch.Tensor           # (C, S, 128) int32 packed (λ in spare bits)
    r2: torch.Tensor           # (C, 8·1024, V/8) int32
    r3: torch.Tensor           # (C, S, 128) int32, spare bits: scan guards
    ysel_w: torch.Tensor       # (C, mrp, 128) int32
    wstart: torch.Tensor       # (C, mrp) int32
    border: torch.Tensor       # (C, nb) int32 (src | dst<<16)
    clsmeta: torch.Tensor      # (C, 7, 2) int32 (base, count) per pow2 class
    ymap: torch.Tensor         # (R,) int32 rows of the stacked (C·mrp) output
    wstart_abs: torch.Tensor   # (C, mrp) int32 derived: wstart + chunk·S
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    V: int
    x_rows: int
    stages: int                # canonical scan stage count (max over chunks)
    W: int                     # canonical max window class
    mrp: int                   # m_rows_pad (uniform)

    format_name = "CLOSGX"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def n_chunks(self):
        return int(self.rowidx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "ClosGX":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(sum(getattr(self, f).numel()
                       * getattr(self, f).element_size()
                       for f in DATA_FIELDS))


def _closgx(arrays: dict, meta: dict) -> ClosGX:
    """ClosGX from numpy stacked arrays and meta fields (on the CPU); checks
    that every chunk's base records cover its batches in place, which the
    one-launch extraction relies on."""
    border = np.asarray(arrays["border"]).astype(np.int64)
    clsmeta = np.asarray(arrays["clsmeta"])
    for ci in range(border.shape[0]):
        n_b = int(clsmeta[ci, :, 1].sum())
        b = border[ci, :n_b]
        if not (np.array_equal(b & 0xFFFF, b >> 16)
                and np.array_equal(np.sort(b & 0xFFFF), np.arange(n_b))):
            raise ClosRoutingError(f"CLOSGX chunk {ci}: base records must "
                                   "cover every batch once, in place")
    C, mrp = np.asarray(arrays["wstart"]).shape
    S = SUB * meta["V"]
    wstart_abs = (np.asarray(arrays["wstart"], np.int64)
                  + S * np.arange(C, dtype=np.int64)[:, None])
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in DATA_FIELDS}
    return ClosGX(**t, wstart_abs=torch.from_numpy(
        wstart_abs.astype(np.int32)), **meta)


def closgx_from_jax(leaves: dict, meta: dict) -> ClosGX:
    """The port's ``ClosGX`` for a program built by the JAX package
    (``leaves``: each data field as numpy, ``meta``: each meta field)."""
    return _closgx({k: np.array(leaves[k]) for k in DATA_FIELDS},
                   {k: meta[k] for k in META_FIELDS})


def build_clos_gather_xl(csr: HostCSR, chunk_N: int = 1 << 20,
                         max_chunks: int = 1024) -> ClosGX:
    """Build stacked uniform chunk programs for a matrix too large for the
    row-chunked path (carried over with every guard of the JAX builder;
    identical arrays). Chunk row boundaries are 128-aligned."""
    from .clos_gather import build_clos_gather, _closg_need, _rows_slice

    m, n = csr.m, csr.n
    est = _closg_need(csr, 0, m) / (0.88 * chunk_N) + 1
    if est > max_chunks:
        raise ClosRoutingError(f"~{est:.0f} chunks exceed the XL cap "
                               f"({max_chunks})")
    nnz_per_row = max(csr.nnz / max(m, 1), 1e-9)
    splits = [0]
    r0 = 0
    while r0 < m:
        r1 = min(m, r0 + max(int(0.8 * chunk_N / nnz_per_row), 128))
        r1 = r0 + max((r1 - r0) // LANES * LANES, LANES)
        r1 = min(r1, m)
        while _closg_need(csr, r0, r1) > chunk_N and r1 - r0 > LANES:
            r1 = r0 + max((r1 - r0) * 3 // 4 // LANES * LANES, LANES)
        while r1 < m:
            step = max((r1 - r0) // 8 // LANES * LANES, LANES)
            r_try = min(m, r1 + step)
            if _closg_need(csr, r0, r_try) > chunk_N:
                break
            r1 = r_try
        if _closg_need(csr, r0, r1) > chunk_N:
            raise ClosRoutingError(
                f"rows [{r0},{r1}) exceed one XL chunk (a single 128-row "
                "band needs more than 2^20 slots — split rows first)")
        splits.append(r1)
        r0 = r1
        if len(splits) - 1 > max_chunks:   # fast-fail mid-split
            raise ClosRoutingError(
                f"more than {max_chunks} chunks after "
                f"{r1}/{m} rows — XL cap exceeded")
        # early plane-byte projection so scattered blow-ups (~128-row
        # chunks) fail in seconds, not after a full split
        if len(splits) - 1 == 64 and r1 < m:
            proj = 64 * m / max(r1, 1) * 4 * chunk_N * 4
            if proj > 12 << 30:
                raise ClosRoutingError(
                    f"projected CLOSGX planes ~{proj / 1e9:.0f} GB from "
                    f"the first 64 chunks ({r1}/{m} rows) — scattered "
                    "slot blow-up, outside the engine")

    # plane-budget guard before any chunk builds: on ultra-sparse wide
    # matrices the column-block padding inflates the slots and ysel_w pads
    # every chunk to the largest row count
    C_est = len(splits) - 1
    if C_est > max_chunks:
        raise ClosRoutingError(
            f"{C_est} chunks after splitting exceed the XL cap "
            f"({max_chunks})")
    mrp_est = max(splits[i + 1] - splits[i]
                  for i in range(C_est)) // LANES + 1
    plane_b = C_est * (4 * chunk_N * 4 + mrp_est * LANES * 4)
    if plane_b > 8 << 30:
        raise ClosRoutingError(
            f"CLOSGX stacked planes ~{plane_b / 1e9:.1f} GB "
            f"({C_est} chunks x mrp {mrp_est}; "
            f"{C_est * chunk_N / max(csr.nnz, 1):.1f} slots/nnz) exceed "
            "the device-memory budget — ultra-sparse wide matrix outside "
            "the engine")

    # chunk programs are independent; the native coloring releases the GIL
    def _one(i):
        return build_clos_gather(_rows_slice(csr, splits[i], splits[i + 1]),
                                 max_N=chunk_N, force_N=chunk_N,
                                 cap_scan=False, class_pow2=True)

    with ThreadPoolExecutor(2) as ex:
        chunks = list(ex.map(_one, range(len(splits) - 1)))
    if any(c.W == 0 for c in chunks):
        raise ClosRoutingError("XL chunk fell back to legacy extraction "
                               "(window > 64 octaves)")
    if any(len(c.scan_stages) > 14 for c in chunks):
        raise ClosRoutingError("XL chunk needs > 14 scan stages "
                               "(row longer than 16k nnz unsplit?)")

    C = len(chunks)
    stages = max(len(c.scan_stages) for c in chunks)
    W = max(c.W for c in chunks)
    mrp = max(c.ysel_w.shape[0] for c in chunks)
    nb = max(c.border.shape[0] for c in chunks)
    V = chunks[0].V
    S = SUB * V
    rowidx = np.zeros((C, S), np.int32)
    vals = np.zeros((C, S, LANES), np.float32)
    r1 = np.zeros((C, S, LANES), np.int32)
    r2 = np.zeros((C, SUB * BLK, V // SUB), np.int32)  # middle-stage shape
    r3 = np.zeros((C, S, LANES), np.int32)
    ysel_w = np.zeros((C, mrp, LANES), np.int32)
    ysel_w |= (1 << 16)          # padded groups: the empty bit, so they read 0
    wstart = np.zeros((C, mrp), np.int32)
    border = np.zeros((C, nb), np.int32)
    clsmeta = np.zeros((C, len(_CLASS_WS), 2), np.int32)
    ymaps = []
    for ci, c in enumerate(chunks):
        rowidx[ci] = c.rowidx.numpy()
        vals[ci] = c.vals_cs.numpy()
        r1[ci] = c.perm_r1.numpy()
        r2[ci] = c.perm_r2.numpy()
        r3[ci] = c.perm_r3.numpy()
        k = c.ysel_w.shape[0]
        ysel_w[ci, :k] = c.ysel_w.numpy()
        wstart[ci, :k] = c.wstart.numpy()
        border[ci, : c.border.shape[0]] = c.border.numpy()
        for (w, base, count, accum) in c.yext_classes:
            if accum:
                raise ClosRoutingError("XL chunks must not carry accum "
                                       "classes (capping is disabled)")
            clsmeta[ci, _CLASS_WS.index(w)] = (base, count)
        rows_c = (splits[ci + 1] - splits[ci] + LANES - 1) // LANES
        ymaps.append(ci * mrp + np.arange(rows_c, dtype=np.int64))
    ymap = np.concatenate(ymaps).astype(np.int32)
    arrays = dict(rowidx=rowidx, vals=vals, r1=r1, r2=r2, r3=r3,
                  ysel_w=ysel_w, wstart=wstart, border=border,
                  clsmeta=clsmeta, ymap=ymap)
    return _closgx(arrays, dict(
        shape=(m, n), nnz=csr.nnz, nnz_expanded=csr.nnz_expanded,
        N=chunk_N, V=chunk_N // BLK, x_rows=(n + LANES - 1) // LANES,
        stages=stages, W=W, mrp=mrp))


def _pipeline(A: ClosGX, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """The stacked program's SpMV, every step once for all chunks."""
    def k(name):
        return getattr(K, name + "_torch" if plain else name)

    x = x.to(torch.float32)
    C, V = A.n_chunks, A.V
    v = k("closg_front")(A.rowidx.view(-1), A.r1.view(-1, LANES),
                         A.vals.view(-1, LANES), x)
    v = k("clos_r2")(v, A.r2.view(-1, V // SUB), V)
    y = k("closgx_r3_scan_yext")(v, A.r3.view(-1, LANES),
                                 A.ysel_w.view(-1, LANES),
                                 A.wstart_abs.view(-1), A.stages, A.N)
    return y[A.ymap.long()].view(-1)[: A.m]


@register_spmv("CLOSGX", "torch")
def spmv_closgx_torch(A: ClosGX, x: torch.Tensor) -> torch.Tensor:
    """CLOSGX in plain PyTorch, on any device (the kernels' plain versions)."""
    return _pipeline(A, x, plain=True)


@register_spmv("CLOSGX", "cuda")
def spmv_closgx_cuda(A: ClosGX, x: torch.Tensor) -> torch.Tensor:
    """CLOSGX through the hand-written CUDA kernels (CUDA tensors only)."""
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"CLOSGX/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")
    return _pipeline(A, x, plain=False)


# SpMM: one SpMV per column of X, for both impls (the JAX lax.scan)
register_spmm_column_loop("CLOSGX")


def execute_closgx_numpy(A: ClosGX, x: np.ndarray) -> np.ndarray:
    """float64 host reference of the stacked program, chunk by chunk (the
    JAX package's ``xla`` impl: full scan, windowed extraction)."""
    from .clos_gather import _np, unpack_layer
    from .clos_route import ClosPerm, apply_clos_numpy

    x2d = np.zeros(A.x_rows * LANES, np.float64)
    x2d[: x.shape[0]] = x
    x2d = x2d.reshape(A.x_rows, LANES)
    S = SUB * A.V
    ys = []
    for ci in range(A.n_chunks):
        r1w = _np(A.r1[ci]).view(np.uint32)
        w = np.take_along_axis(x2d[_np(A.rowidx[ci])],
                               ((r1w >> SPARE_SHIFT) & 0x7F).astype(np.int64),
                               axis=1)
        w = (w * _np(A.vals[ci]).astype(np.float64)).reshape(-1)
        w = apply_clos_numpy(w, ClosPerm(V=A.V, r1=unpack_layer(A.r1[ci]),
                                         r2=unpack_layer(A.r2[ci]),
                                         r3=unpack_layer(A.r3[ci])))
        sg = _np(A.r3[ci]).view(np.uint32).reshape(-1) >> SPARE_SHIFT
        for k in range(A.stages):
            d = 1 << k
            sh = np.zeros_like(w)
            sh[d:] = w[:-d]
            w = w + np.where(((sg >> k) & 1) == 1, sh, 0.0)
        sel = _np(A.ysel_w[ci]).view(np.uint32)
        src = np.clip(_np(A.wstart[ci]).astype(np.int64)[:, None]
                      + ((sel >> 7) & 0x1FF), 0, S - 1)
        y = w.reshape(S, LANES)[src, (sel & 0x7F).astype(np.int64)]
        ys.append(np.where(((sel >> 16) & 1) == 1, 0.0, y))
    rows = np.concatenate(ys)
    return rows[_np(A.ymap)].reshape(-1)[: A.m]
