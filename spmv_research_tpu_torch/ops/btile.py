"""BTILE: dense-(8,128)-tile engine for SpMM and SDDMM.

Counterpart of ``spmv_research_tpu/ops/btile.py``: the ``BTile`` program,
its builder (carried over so that it emits identical program arrays), the
float64 host executor ``execute_btile_numpy``, ``sddmm_slab_to_csr_values``,
and two impls per workload:

* ``"cuda"`` — the hand-written kernels of ``btile_cuda.py`` (the pallas
  impls' counterparts);
* ``"torch"`` — the same functions in plain PyTorch, following the JAX
  package's ``spmm_btile_xla`` and ``sddmm_btile_xla``.

Layout (see the JAX module for the design): only nonempty (8, 128) tiles
of A are stored, as dense float32 slabs, at (rowblock = row >> 3,
colblock = col >> 7); a row band is 1024 rows; a step is up to ``tg``
tiles sharing one (band, colblock), and steps are sorted band-major. Every
band has at least one step (an empty band gets a filler step of 0 tiles).

The port adds what the JAX program does not have: ``band_ptr``
(ngroups + 1,), each band's step range, and ``max_band_steps``, the most
steps of one band, derived from ``step_g`` when a program is built or
carried over, so that CUDA blocks can own a band's steps and walk them in
order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.formats import _move
from ..core.host import HostCSR
from .dispatch import register_sddmm, register_spmm
from . import btile_cuda as K
from .btile_cuda import BAND, TILE_C, TILE_R

RB_PER_BAND = BAND // TILE_R

DATA_FIELDS = ("tiles", "patt", "tgt", "step_g", "step_cb", "step_t0",
               "step_nt", "tile_rb", "tile_cb")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "ntiles", "nsteps", "tg",
               "ngroups", "ncb")


class BTileBuildError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class BTile:
    """BTILE program (field for field the JAX ``BTile``, plus ``band_ptr``
    and ``max_band_steps``)."""

    tiles: torch.Tensor    # (nsteps·tg·8, 128) fp32 dense tile slabs
    patt: torch.Tensor     # (nsteps·tg·8, 128) int8 structural pattern
    tgt: torch.Tensor      # (nsteps, tg·8) int32 local target row in band
    step_g: torch.Tensor   # (nsteps,) int32 band of each step
    step_cb: torch.Tensor  # (nsteps,) int32 column block of each step
    step_t0: torch.Tensor  # (nsteps,) int32 first tile id of the step
    step_nt: torch.Tensor  # (nsteps,) int32 live tile count of the step
    tile_rb: torch.Tensor  # (ntiles,) int32 global rowblock
    tile_cb: torch.Tensor  # (ntiles,) int32 global colblock
    band_ptr: torch.Tensor  # (ngroups + 1,) int32 steps of band g: [g, g+1)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    ntiles: int
    nsteps: int
    tg: int                # tiles per step
    ngroups: int           # row bands
    ncb: int               # column blocks
    max_band_steps: int    # the most steps of one band

    format_name = "BTILE"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def to(self, device) -> "BTile":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        return int(self.tiles.numel() * self.tiles.element_size()
                   + self.patt.numel() + self.tgt.numel() * 4
                   + self.step_g.numel() * 16 + self.tile_rb.numel() * 8)


def _btile(arrays: dict, meta: dict) -> BTile:
    """BTile from numpy program arrays and meta fields (on the CPU), with
    the band step ranges derived from ``step_g``."""
    step_g = np.asarray(arrays["step_g"])
    if np.any(np.diff(step_g) < 0):
        raise BTileBuildError("steps are not sorted band-major")
    band_ptr = np.searchsorted(step_g, np.arange(meta["ngroups"] + 1),
                               side="left").astype(np.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
         for k in DATA_FIELDS}
    return BTile(**t, band_ptr=torch.from_numpy(band_ptr), **meta,
                 max_band_steps=int(np.diff(band_ptr).max()))


def btile_from_jax(leaves: dict, meta: dict) -> BTile:
    """The port's ``BTile`` for a program built by the JAX package:
    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value."""
    return _btile({k: np.array(leaves[k]) for k in DATA_FIELDS},
                  {k: meta[k] for k in META_FIELDS})


def _tile_keys(csr: HostCSR, ncb: int):
    """Per nnz: its row, column, and the band-major tile key order (shared
    by the builder and ``sddmm_slab_to_csr_values``)."""
    ia = csr.ia.astype(np.int64)
    ja = csr.ja.astype(np.int64)
    rows = np.repeat(np.arange(csr.m, dtype=np.int64),
                     np.diff(ia).astype(np.int64))
    key = (((rows >> 10) * ncb + (ja >> 7)) * (1 + ((csr.m - 1) >> 3))
           + (rows >> 3))                       # band-major, cb, rb
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(csr.nnz, bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return rows, ja, order, first, np.cumsum(first) - 1


def build_btile(csr: HostCSR, dtype=np.float32, tg: int = 32,
                max_slots_per_nnz: float = 64.0) -> BTile:
    """Compile host CSR into a BTILE program (the JAX builder's arrays).

    Raises :class:`BTileBuildError` when tile fill is too low (slots/nnz
    above ``max_slots_per_nnz``): the tile stream would waste memory."""
    dt = np.dtype(dtype)
    m, n, nnz = csr.m, csr.n, csr.nnz
    if m == 0 or nnz == 0:
        raise BTileBuildError("empty matrix")
    ngroups = (m + BAND - 1) // BAND
    ncb = max((n + TILE_C - 1) // TILE_C, 1)
    rows, ja, order, first, tile_of_sorted = _tile_keys(csr, ncb)
    ntiles = int(tile_of_sorted[-1]) + 1
    if ntiles * (TILE_R * TILE_C) > max_slots_per_nnz * nnz:
        raise BTileBuildError(
            f"{ntiles * TILE_R * TILE_C / nnz:.0f} slots/nnz "
            "(tile fill too low — not a BTILE matrix)")

    t_first = np.flatnonzero(first)
    tile_rb = (rows >> 3)[order][t_first]
    tile_cb = (ja >> 7)[order][t_first]
    tile_g = (rows >> 10)[order][t_first]

    # dense tile slabs + structural pattern (explicit zeros stay live)
    r_in, c_in = rows[order] & 7, ja[order] & 127
    tiles = np.zeros((ntiles, TILE_R, TILE_C), dt)
    tiles[tile_of_sorted, r_in, c_in] = csr.a[order].astype(dt)
    patt = np.zeros((ntiles, TILE_R, TILE_C), np.int8)
    patt[tile_of_sorted, r_in, c_in] = 1

    # steps: split each (g, cb) run into ceil(run / tg) steps
    run_key = tile_g * ncb + tile_cb
    run_first = np.ones(ntiles, bool)
    run_first[1:] = run_key[1:] != run_key[:-1]
    run_starts = np.flatnonzero(run_first)
    run_ends = np.append(run_starts[1:], ntiles)

    step_g_l, step_cb_l, step_tiles_l = [], [], []
    for s, e in zip(run_starts, run_ends):
        for t0 in range(s, e, tg):
            step_g_l.append(int(tile_g[s]))
            step_cb_l.append(int(tile_cb[s]))
            step_tiles_l.append((t0, min(t0 + tg, e)))
    # every band needs >= 1 step (its output rows must be written)
    present = np.zeros(ngroups, bool)
    present[np.array(step_g_l, np.int64)] = True
    for gg in np.flatnonzero(~present):
        step_g_l.append(int(gg))
        step_cb_l.append(0)
        step_tiles_l.append((0, 0))
    o = np.argsort(np.array(step_g_l), kind="stable")   # keep band-major
    step_g_a = np.array(step_g_l, np.int32)[o]
    step_cb_a = np.array(step_cb_l, np.int32)[o]
    step_tiles_l = [step_tiles_l[i] for i in o]

    nsteps = len(step_tiles_l)
    tiles_p = np.zeros((nsteps, tg, TILE_R, TILE_C), dt)
    patt_p = np.zeros((nsteps, tg, TILE_R, TILE_C), np.int8)
    tgt = np.zeros((nsteps, tg * TILE_R), np.int32)
    step_t0 = np.zeros(nsteps, np.int32)
    step_nt = np.zeros(nsteps, np.int32)
    for i, (t0, t1) in enumerate(step_tiles_l):
        k = t1 - t0
        step_t0[i], step_nt[i] = t0, k
        if k == 0:
            continue
        tiles_p[i, :k] = tiles[t0:t1]
        patt_p[i, :k] = patt[t0:t1]
        loc = (tile_rb[t0:t1] - step_g_a[i] * RB_PER_BAND).astype(np.int32)
        tgt[i, : k * TILE_R] = (np.repeat(loc, TILE_R) * TILE_R
                                + np.tile(np.arange(TILE_R,
                                                    dtype=np.int32), k))

    return _btile(
        dict(tiles=tiles_p.reshape(nsteps * tg * TILE_R, TILE_C),
             patt=patt_p.reshape(nsteps * tg * TILE_R, TILE_C), tgt=tgt,
             step_g=step_g_a, step_cb=step_cb_a, step_t0=step_t0,
             step_nt=step_nt, tile_rb=tile_rb.astype(np.int32),
             tile_cb=tile_cb.astype(np.int32)),
        dict(shape=(m, n), nnz=nnz, nnz_expanded=csr.nnz_expanded,
             ntiles=ntiles, nsteps=nsteps, tg=tg, ngroups=ngroups, ncb=ncb))


# ---------------------------------------------------------------- SpMM

def _pad_rows(M: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(M.to(torch.float32), (0, 0, 0, rows - M.shape[0]))


def _spmm_args(A: BTile, X: torch.Tensor) -> tuple:
    return (A.tiles, A.tgt, A.step_g, A.step_cb, A.step_nt, A.band_ptr,
            _pad_rows(X, A.ncb * TILE_C), A.ngroups, A.max_band_steps)


@register_spmm("BTILE", "torch")
def spmm_btile_torch(A: BTile, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X in plain PyTorch, on any device (the kernel's plain
    version: one batched tile product per step, then a scatter-add)."""
    return K.btile_spmm_torch(*_spmm_args(A, X))[: A.m]


@register_spmm("BTILE", "cuda")
def spmm_btile_cuda(A: BTile, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through the hand-written CUDA kernel (CUDA tensors only)."""
    if X.device.type != "cuda" or A.device != X.device:
        raise ValueError(f"BTILE/cuda needs the program and X on one CUDA "
                         f"device, got {A.device} and {X.device}")
    return K.btile_spmm(*_spmm_args(A, X))[: A.m]


def execute_btile_numpy(A: BTile, X: np.ndarray) -> np.ndarray:
    """float64 host reference of the compiled program semantics."""
    n, k = X.shape
    xp = np.zeros((A.ncb * TILE_C, k))
    xp[:n] = X
    xb = xp.reshape(A.ncb, TILE_C, k)
    tiles = A.tiles.cpu().numpy().astype(np.float64).reshape(
        A.nsteps, A.tg, TILE_R, TILE_C)
    y = np.zeros((A.ngroups * BAND, k))
    sg = A.step_g.cpu().numpy()
    scb = A.step_cb.cpu().numpy()
    tgt = A.tgt.cpu().numpy().reshape(A.nsteps, A.tg, TILE_R)
    for i in range(A.nsteps):
        p = tiles[i] @ xb[scb[i]]                 # (tg, 8, K)
        base = sg[i] * BAND
        for t in range(A.tg):
            y[base + tgt[i, t, 0]: base + tgt[i, t, 0] + TILE_R] += p[t]
    return y[: A.m]


# ---------------------------------------------------------------- SDDMM

def _sddmm_args(A: BTile, Am: torch.Tensor, Bm: torch.Tensor) -> tuple:
    return (A.patt, A.tgt, A.step_g, A.step_cb, A.step_nt,
            _pad_rows(Am, A.ngroups * BAND), _pad_rows(Bm, A.ncb * TILE_C))


@register_sddmm("BTILE", "torch")
def sddmm_btile_torch(A: BTile, Am: torch.Tensor, Bm: torch.Tensor
                      ) -> torch.Tensor:
    """The C slab (nsteps·tg·8, 128) of (Am·Bmᵀ) ∘ pattern(A), nonzero only
    at A's slots, in plain PyTorch on any device (the kernel's plain
    version)."""
    return K.btile_sddmm_torch(*_sddmm_args(A, Am, Bm))


@register_sddmm("BTILE", "cuda")
def sddmm_btile_cuda(A: BTile, Am: torch.Tensor, Bm: torch.Tensor
                     ) -> torch.Tensor:
    """The C slab through the hand-written CUDA kernel (CUDA tensors only)."""
    if Am.device.type != "cuda" or A.device != Am.device:
        raise ValueError(f"BTILE/cuda needs the program and A on one CUDA "
                         f"device, got {A.device} and {Am.device}")
    return K.btile_sddmm(*_sddmm_args(A, Am, Bm))


def sddmm_slab_to_csr_values(A: BTile, slab, csr: HostCSR) -> np.ndarray:
    """Per-nnz values in CSR order from the slab layout (host)."""
    sl = (slab.cpu().numpy() if isinstance(slab, torch.Tensor)
          else np.asarray(slab)).reshape(A.nsteps, A.tg, TILE_R, TILE_C)
    rows, ja, order, _, tile_of = _tile_keys(csr, A.ncb)
    # tile -> (step, slot) from the build's recorded per-step tile ranges
    t0s = A.step_t0.cpu().numpy().astype(np.int64)
    nts = A.step_nt.cpu().numpy().astype(np.int64)
    slot = (np.arange(int(nts.sum()))
            - np.repeat(np.cumsum(nts) - nts, nts))
    tile_ids = np.repeat(t0s, nts) + slot
    step_of_tile = np.empty(A.ntiles, np.int64)
    slot_of_tile = np.empty(A.ntiles, np.int64)
    step_of_tile[tile_ids] = np.repeat(np.arange(A.nsteps), nts)
    slot_of_tile[tile_ids] = slot
    out = np.empty(csr.nnz)
    out[order] = sl[step_of_tile[tile_of], slot_of_tile[tile_of],
                    rows[order] & 7, ja[order] & 127]
    return out
