"""SPMD distributed SELLR: shape-uniform per-shard engine programs.

Counterpart of ``spmv_research_tpu/parallel/dist_sellr.py``. Every shard's
SELLR program is padded to one canonical shape (dead chunks are inert:
zero emask, flush 0), the same stacked arrays as the JAX builder's, and
every rank runs the same body on its own slice: B14's place and flush
(``ops/sellr.py:sellr_raw``, the kernels of ``ops/sell_cuda.py`` on the
card) with the flush order taken from the shard's live chunks.

Strategies (the halo-exchange triple):

* ``allgather``: rows nnz-balanced across ranks, x gathered whole each
  SpMV;
* ``ring``: rows × column blocks; rank d holds x block d; at ring step j it
  multiplies its (row shard × column block (d+j) mod k) program against
  the x block it holds, the next block's transfer posted before the
  product. Each step's work is that block's nnz only;
* ``psum_scatter``: column-sharded A, a full-height partial y a rank,
  summed by a reduce-scatter over row blocks.

``plan_dist_sellr`` is the host half (all k shards, no process group);
``build_dist_sellr`` gives this rank's ``DistSellR``. The per-shard SELLR
builds go through the format cache; the padded plans are not cached.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..convert.cache import cached_build
from ..core.host import HostCSR
from ..ops.clos_route import LANES, SUB
from ..ops.sellr import (_XY_VMEM_ROWS, GROUP, NB, SMEM_BLK, build_sellr,
                         raw_flush_order, sellr_raw)
from . import comm
from .dist import _rows_slice, mesh_rank, partition_rows_nnz_balanced


def _cols_slice(csr: HostCSR, c0: int, c1: int) -> HostCSR:
    keep = (csr.ja >= c0) & (csr.ja < c1)
    rows = np.repeat(np.arange(csr.m, dtype=np.int64), csr.row_lengths())
    lens = np.bincount(rows[keep], minlength=csr.m)
    ia = np.zeros(csr.m + 1, np.int64)
    np.cumsum(lens, out=ia[1:])
    return HostCSR(a=csr.a[keep].copy(), ia=ia.astype(np.int32),
                   ja=(csr.ja[keep] - c0).astype(np.int32),
                   m=csr.m, n=c1 - c0)


@dataclasses.dataclass(frozen=True)
class _Program:
    """A shard's SELLR program as numpy arrays and the meta the padding
    reads."""

    word: np.ndarray
    vals: np.ndarray
    smeta: np.ndarray
    nchunks: int
    stages: int
    rolls: Tuple[Tuple[int, int], ...]


def _program(F) -> _Program:
    return _Program(word=F.word.numpy(), vals=F.vals.numpy(),
                    smeta=F.smeta.numpy(), nchunks=F.nchunks,
                    stages=F.stages, rolls=F.rolls)


def _empty_program(dtype) -> _Program:
    """One dead step: inert under the kernel (emask 0, flush 0)."""
    return _Program(word=np.zeros((NB * SUB, LANES), np.int32),
                    vals=np.zeros((NB * SUB, LANES), np.dtype(dtype)),
                    smeta=np.zeros(SMEM_BLK, np.int32), nchunks=0, stages=0,
                    rolls=())


def _pad_program(F: _Program, nsteps_t: int,
                 rolls_t: Tuple[Tuple[int, int], ...]) -> tuple:
    """(word, vals, smeta) padded to nsteps_t steps, each step's roll mask
    remapped onto the union roll set (bit j of a mask names rolls_t[j])."""
    nsteps = F.word.shape[0] // SUB // NB
    word = np.zeros((nsteps_t * NB * SUB, LANES), np.int32)
    vals = np.zeros((nsteps_t * NB * SUB, LANES), F.vals.dtype)
    smeta = np.zeros(nsteps_t * SMEM_BLK, np.int32)
    word[: F.word.shape[0]] = F.word
    vals[: F.vals.shape[0]] = F.vals
    sm = F.smeta.reshape(nsteps, SMEM_BLK).copy()
    bit_of = {rw: j for j, rw in enumerate(rolls_t)}
    for i in range(nsteps):
        old = int(sm[i, NB * SUB + NB])
        new = 0
        for j, rw in enumerate(F.rolls):
            if (old >> j) & 1:
                new |= 1 << bit_of[rw]
        sm[i, NB * SUB + NB] = new
    smeta[: nsteps * SMEM_BLK] = sm.reshape(-1)
    return word, vals, smeta


def _uniformize(programs, x_rows: int, y_rows: int, dtype):
    """Pad per-shard programs (or None) to one canonical shape: stacked
    (k, …) word, vals, smeta, the static meta, and each shard's live
    chunk count."""
    progs = [p if p is not None else _empty_program(dtype)
             for p in programs]
    nsteps_t = max(p.word.shape[0] // SUB // NB for p in progs)
    rolls_t = tuple(sorted(set().union(*[set(p.rolls) for p in progs])))
    stages_t = max(p.stages for p in progs)
    padded = [_pad_program(p, nsteps_t, rolls_t) for p in progs]
    word, vals, smeta = (np.stack([p[i] for p in padded]) for i in range(3))
    return word, vals, smeta, dict(stages=stages_t, rolls=rolls_t,
                                   x_rows=x_rows, y_rows=y_rows), \
        np.array([p.nchunks for p in progs])


@dataclasses.dataclass(frozen=True)
class DistSellRPlan:
    """The whole shape-uniform program set on the host (JAX's stacked
    arrays) and each program's live chunk count."""

    word: np.ndarray      # allgather/psum: (k, S8, 128); ring: (k, k, S8, 128)
    vals: np.ndarray
    smeta: np.ndarray
    nchunks: np.ndarray   # (k,) or (k, k) live chunks a program
    strategy: str
    k: int
    row_splits: np.ndarray
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    meta: dict            # static kernel meta (stages/rolls/x_rows/y_rows)
    shard_nnz: np.ndarray  # per (shard[, block]) nnz — work accounting

    def shard(self, rank: int, device, mesh=None,
              axis: str = "rows") -> "DistSellR":
        def order(i):
            g, c = raw_flush_order(self.smeta[i], int(self.nchunks[i]),
                                   self.meta["y_rows"])
            return g.to(device), c.to(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        if self.strategy == "ring":
            flush = [order((rank, b)) for b in range(self.k)]
            gptr = tuple(f[0] for f in flush)
            gchunk = tuple(f[1] for f in flush)
            nchunks = tuple(int(c) for c in self.nchunks[rank])
        else:
            gptr, gchunk = order(rank)
            nchunks = int(self.nchunks[rank])
        return DistSellR(word=t(self.word[rank]), vals=t(self.vals[rank]),
                         smeta=t(self.smeta[rank]), gptr=gptr,
                         gchunk=gchunk, nchunks=nchunks,
                         strategy=self.strategy, k=self.k, rank=rank,
                         mesh=mesh, axis=axis, row_splits=self.row_splits,
                         shape=self.shape, nnz=self.nnz,
                         nnz_expanded=self.nnz_expanded, meta=self.meta,
                         shard_nnz=self.shard_nnz)


@dataclasses.dataclass(frozen=True)
class DistSellR:
    """This rank's part of the shape-uniform distributed SELLR program set
    (ring: its k block programs, stacked)."""

    word: torch.Tensor    # allgather/psum: (S8, 128); ring: (k, S8, 128)
    vals: torch.Tensor
    smeta: torch.Tensor
    gptr: object          # a tensor; ring: a tuple of k (one a block)
    gchunk: object
    nchunks: object       # int; ring: a tuple of k
    strategy: str
    k: int
    rank: int
    mesh: object
    axis: str
    row_splits: np.ndarray        # (k+1,) global row split
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    meta: dict
    shard_nnz: np.ndarray

    format_name = "SELLR_DIST"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @functools.cached_property
    def group(self):
        """The mesh's process group (looked up once: a SpMV reads it)."""
        return self.mesh.get_group(self.axis) if self.mesh else None

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def mem_footprint_bytes(self) -> int:
        """This rank's program bytes."""
        return int(self.word.numel() * 4 + self.vals.numel()
                   * self.vals.element_size() + self.smeta.numel() * 4)


def plan_dist_sellr(csr: HostCSR, k: int, strategy: str = "ring",
                    dtype=np.float32,
                    max_slot_factor: float = 6.0) -> DistSellRPlan:
    """The JAX ``build_dist_sellr``'s arrays for k shards (host only)."""
    x_rows_g = -(-csr.n // (k * LANES)) * k      # global x rows, k-divisible

    def build(part):
        if part.nnz == 0:
            return None
        return _program(cached_build(build_sellr, part, "sellr",
                                     dtype=dtype,
                                     max_slot_factor=max_slot_factor))

    if strategy == "allgather":
        splits = partition_rows_nnz_balanced(csr, k)
        shards = [_rows_slice(csr, int(splits[j]), int(splits[j + 1]))
                  for j in range(k)]
        y_rows_t = max(-(-s.m // GROUP) * SUB for s in shards)
        # a shard is built at the padded width x_rows_g·128 where that is
        # within the builder's x limit: the program arrays do not depend
        # on n there, and at k = 1 the ring's and psum_scatter's block is
        # then the same matrix, so the three strategies build it once
        # (the JAX builder sets x_rows = x_rows_g after the build)
        if x_rows_g <= _XY_VMEM_ROWS:
            shards = [dataclasses.replace(s, n=x_rows_g * LANES)
                      for s in shards]
        progs = [build(s) for s in shards]
        word, vals, smeta, meta, live = _uniformize(progs, x_rows_g,
                                                    y_rows_t, dtype)
        shard_nnz = np.array([s.nnz for s in shards])
    elif strategy == "ring":
        splits = partition_rows_nnz_balanced(csr, k)
        xw_rows = x_rows_g // k                   # x rows per block
        y_rows_t, blocks = 0, []
        for j in range(k):
            rs = _rows_slice(csr, int(splits[j]), int(splits[j + 1]))
            y_rows_t = max(y_rows_t, -(-rs.m // GROUP) * SUB)
            blocks.append([_cols_slice(rs, b * xw_rows * LANES,
                                       (b + 1) * xw_rows * LANES)
                           for b in range(k)])
        flat = [build(blocks[j][b]) for j in range(k) for b in range(k)]
        word, vals, smeta, meta, live = _uniformize(flat, xw_rows, y_rows_t,
                                                    dtype)
        word, vals, smeta, live = (a.reshape(k, k, *a.shape[1:])
                                   for a in (word, vals, smeta, live))
        shard_nnz = np.array([[blocks[j][b].nnz for b in range(k)]
                              for j in range(k)])
    elif strategy == "psum_scatter":
        xw_rows = x_rows_g // k
        y_rows_t = -(-(-(-csr.m // GROUP) * SUB) // k) * k  # k-divisible
        cols = [_cols_slice(csr, b * xw_rows * LANES,
                            (b + 1) * xw_rows * LANES) for b in range(k)]
        progs = [build(c) for c in cols]
        word, vals, smeta, meta, live = _uniformize(progs, xw_rows, y_rows_t,
                                                    dtype)
        splits = (np.arange(k + 1) * (y_rows_t // k) * LANES)
        shard_nnz = np.array([c.nnz for c in cols])
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return DistSellRPlan(word=word, vals=vals, smeta=smeta, nchunks=live,
                         strategy=strategy, k=k,
                         row_splits=np.asarray(splits),
                         shape=(csr.m, csr.n), nnz=csr.nnz,
                         nnz_expanded=csr.nnz_expanded, meta=meta,
                         shard_nnz=shard_nnz)


def build_dist_sellr(csr: HostCSR, mesh, strategy: str = "ring",
                     dtype=np.float32, max_slot_factor: float = 6.0,
                     axis: str = "rows") -> DistSellR:
    """This rank's ``DistSellR`` over ``mesh``."""
    _, k, rank, device = mesh_rank(mesh, axis)
    return plan_dist_sellr(csr, k, strategy, dtype, max_slot_factor).shard(
        rank, device, mesh, axis)


def _pad_x(D: DistSellR, x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """This rank's part of the padded x: allgather pads to x_rows·128 (each
    rank 1/k of it), ring and psum_scatter to x_rows·128·k."""
    n_pad = D.meta["x_rows"] * LANES
    if D.strategy != "allgather":
        n_pad *= D.k
    part = n_pad // D.k
    xp = torch.zeros(n_pad, dtype=dtype)
    xp[: D.n] = torch.as_tensor(np.asarray(x), dtype=dtype)
    return xp[D.rank * part:(D.rank + 1) * part].to(D.device)


def _kern(D: DistSellR, b=None):
    """The SELLR body of this rank's program (ring: of block ``b``)."""
    meta = D.meta
    if b is None:
        return lambda x: sellr_raw(D.word, D.vals, D.smeta, D.gptr, D.gchunk,
                                   x, nchunks=D.nchunks,
                                   stages=meta["stages"],
                                   rolls=meta["rolls"])
    return lambda x: sellr_raw(D.word[b], D.vals[b], D.smeta[b], D.gptr[b],
                               D.gchunk[b], x, nchunks=D.nchunks[b],
                               stages=meta["stages"], rolls=meta["rolls"])


def dist_spmv_sellr(D: DistSellR, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of y = A @ x; ``x`` is this rank's part of the
    padded vector (:func:`_pad_x`). allgather and ring give the rank's
    y_rows·128 rows, psum_scatter its 1/k of them."""
    if D.strategy == "allgather":
        return _kern(D)(comm.all_gather(x, D.group)).reshape(-1)
    if D.strategy == "ring":
        return comm.ring_sum(x, D.group,
                             lambda b, xb: _kern(D, b)(xb)).reshape(-1)
    if D.strategy == "psum_scatter":
        return comm.reduce_scatter(_kern(D)(x).reshape(-1), D.group)
    raise ValueError(D.strategy)


def dist_spmv_sellr_host(D: DistSellR, x: np.ndarray) -> np.ndarray:
    """Host convenience: pad x, run, reassemble the global y (a
    collective: every rank gets the whole y)."""
    y = comm.all_gather(dist_spmv_sellr(D, _pad_x(D, x, D.vals.dtype)),
                        D.group).cpu().numpy()
    if D.strategy in ("allgather", "ring"):
        y2 = y.reshape(D.k, -1)
        out = np.zeros(D.m)
        for j in range(D.k):
            r0, r1 = int(D.row_splits[j]), int(D.row_splits[j + 1])
            out[r0:r1] = y2[j, : r1 - r0]
        return out
    return y.reshape(-1)[: D.m].astype(np.float64)


def dist_cg_step_sellr(D: DistSellR, b: np.ndarray):
    """One CG-style step (SpMV, then global dots by all-reduce and an axpy)
    on the distributed engine: returns ``(step, xp)``, ``step(x)`` giving
    this rank's y·(1 + α·1e-30), α = y·y / max(x[0]², 1e-30) over the
    global vectors."""
    xp = _pad_x(D, b, D.vals.dtype)

    def step(x):
        y = dist_spmv_sellr(D, x)
        x0 = x[:1] if D.rank == 0 else x.new_zeros(1)
        dots = comm.all_reduce(torch.stack([torch.dot(y, y),
                                            torch.dot(x0, x0)]), D.group)
        alpha = dots[0] / torch.clamp(dots[1], min=1e-30)
        return y * (1.0 + alpha * 1e-30)

    return step, xp
