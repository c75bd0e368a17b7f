"""SPMD distributed CLOSGX — the scattered-matrix multi-device path.

Counterpart of ``spmv_research_tpu/parallel/dist_closgx.py``. CLOSGX
(``ops/clos_xl.py``) forces every chunk to one canonical shape; this
module extends that across shards: each rank's chunk stack is padded to
the shard maximum (dead chunks are inert — zero guards and values,
empty-bit extraction groups, unreferenced by ``ymap``), every static
(stages, W, mrp, C) is the max over shards, and every rank runs the same
body: a port ``ClosGX`` (``clos_xl._closgx``, so ``wstart_abs`` is derived
as for any CLOSGX) through its pipeline — B1, ``clos_r2`` and B15 on the
card.

Rows are nnz-balanced across ranks (128-aligned boundaries); x is sharded
by rank and all-gathered each SpMV, the right exchange for scattered
matrices whose column support spans the whole vector (ring column blocks
pay off with column locality, which is SELLR's domain, ``dist_sellr.py``).

With ``overlap=True`` each shard's entries whose columns fall in the
rank's own x block form a second program family, run on the local x block
while the all-gather is in flight (started with ``async_op=True``), then
the rest on the gathered x: the counterpart of XLA's latency-hiding
schedule of the JAX module.

``plan_dist_closgx`` is the host half (all k shards, no process group);
``build_dist_closgx`` gives this rank's ``DistClosGX``. The per-shard
CLOSGX builds go through the format cache; the padded plans are not
cached. The shard accounting (``shard_nnz``, ``shard_slots``) is the
plan's; a rank's program carries ``nnz = 0`` (the padded statics), so
work is counted from ``shard_nnz``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..convert.cache import cached_build
from ..core.host import HostCSR
from ..ops.clos_route import LANES
from ..ops.clos_xl import ClosGX, _closgx, build_clos_gather_xl
from ..ops.dispatch import spmv
from . import comm
from .dist import _rows_slice, mesh_rank, partition_rows_nnz_balanced

_LEAF_FIELDS = ("rowidx", "vals", "r1", "r2", "r3", "ysel_w", "wstart",
                "border", "clsmeta", "ymap")


def _pad_family(shards, chunk_N, Rp_floor=0):
    """Pad a per-shard ClosGX program list to shard-uniform shapes;
    returns (leaves: name → (k, …) numpy, statics, Rp)."""
    C = max(s.n_chunks for s in shards)
    stages = max(s.stages for s in shards)
    W = max(s.W for s in shards)
    mrp = max(s.mrp for s in shards)
    nb = max(s.border.shape[1] for s in shards)
    Rp = max(max(s.ymap.shape[0] for s in shards), Rp_floor)
    S = shards[0].rowidx.shape[1]
    V = shards[0].V

    def pad_leaf(name):
        outs = []
        for s in shards:
            a = getattr(s, name).numpy()
            if name == "ymap":
                # a shard's ymap names rows of its own (C_s, mrp_s) stack:
                # renumber them for the family's mrp (the JAX builder keeps
                # them as they are, which is right only where mrp_s = mrp)
                a = (a // s.mrp) * mrp + a % s.mrp
                outs.append(np.concatenate(
                    [a, np.zeros(Rp - a.shape[0], a.dtype)]))
                continue
            tgt = {"rowidx": (C, S), "vals": (C, S, LANES),
                   "r1": (C, S, LANES), "r2": (C,) + a.shape[1:],
                   "r3": (C, S, LANES), "ysel_w": (C, mrp, LANES),
                   "wstart": (C, mrp), "border": (C, nb),
                   "clsmeta": (C,) + a.shape[1:]}[name]
            out = np.zeros(tgt, a.dtype)
            if name == "ysel_w":
                out |= (1 << 16)      # empty bit for padded groups
            out[tuple(slice(0, d) for d in a.shape)] = a
            outs.append(out)
        return np.stack(outs)

    leaves = {f: pad_leaf(f) for f in _LEAF_FIELDS}
    n = shards[0].n
    statics = dict(shape=(Rp * LANES, n), nnz=0, nnz_expanded=0,
                   N=chunk_N, V=V, x_rows=(n + LANES - 1) // LANES,
                   stages=stages, W=W, mrp=mrp)
    return leaves, statics, Rp


def _nonempty(h: HostCSR) -> HostCSR:
    """The CLOSGX build needs ≥ 1 nnz: inject one zero-value entry
    (inert)."""
    if h.nnz:
        return h
    ia = np.zeros(h.m + 1, np.int32)
    ia[1:] = 1
    return HostCSR(a=np.zeros(1), ia=ia, ja=np.zeros(1, np.int32),
                   m=h.m, n=h.n)


def _split_cols(h: HostCSR, lo: int, hi: int):
    """(local cols in [lo,hi) shifted to 0, remote cols unchanged)."""
    rows = np.repeat(np.arange(h.m), np.diff(h.ia.astype(np.int64)))
    loc = (h.ja >= lo) & (h.ja < hi)

    def mk(mask, ja, n):
        ia = np.zeros(h.m + 1, np.int64)
        np.add.at(ia, rows[mask] + 1, 1)
        np.cumsum(ia, out=ia)
        return HostCSR(a=h.a[mask].copy(), ia=ia.astype(np.int32),
                       ja=ja[mask].astype(np.int32), m=h.m, n=n)

    return (mk(loc, h.ja - lo, hi - lo), mk(~loc, h.ja, h.n))


@dataclasses.dataclass(frozen=True)
class DistClosGXPlan:
    """The whole program set on the host: JAX's stacked leaves (name →
    (k, …) numpy) and statics, and the shard accounting."""

    leaves: dict
    statics: dict
    row_starts: Tuple[int, ...]   # k+1 row boundaries (128-aligned)
    m: int
    n: int
    n_pad: int                    # x length padded to a k·128 multiple
    shard_nnz: Tuple[int, ...]
    shard_slots: Tuple[int, ...]  # live chunk slots a shard (C_live·N)
    leaves_loc: Optional[dict] = None   # the local-column family (overlap)
    statics_loc: Optional[dict] = None

    @property
    def k(self):
        return len(self.row_starts) - 1

    def shard(self, rank: int, device, mesh=None,
              axis: str = "d") -> "DistClosGX":
        def prog(leaves, statics):
            return _closgx({f: leaves[f][rank] for f in _LEAF_FIELDS},
                           dict(statics)).to(device)

        return DistClosGX(
            prog=prog(self.leaves, self.statics),
            prog_loc=(None if self.leaves_loc is None
                      else prog(self.leaves_loc, self.statics_loc)),
            mesh=mesh, axis=axis, rank=rank, row_starts=self.row_starts,
            m=self.m, n=self.n, n_pad=self.n_pad, shard_nnz=self.shard_nnz,
            shard_slots=self.shard_slots)


@dataclasses.dataclass(frozen=True)
class DistClosGX:
    """This rank's ClosGX program (and, overlapped, its local-column
    program)."""

    prog: ClosGX
    prog_loc: Optional[ClosGX]
    mesh: object
    axis: str
    rank: int
    row_starts: Tuple[int, ...]
    m: int
    n: int
    n_pad: int
    shard_nnz: Tuple[int, ...]
    shard_slots: Tuple[int, ...]

    @property
    def k(self):
        return len(self.row_starts) - 1

    @property
    def overlapped(self):
        return self.prog_loc is not None

    @functools.cached_property
    def group(self):
        """The mesh's process group (looked up once: a SpMV reads it)."""
        return self.mesh.get_group(self.axis) if self.mesh else None

    @property
    def device(self) -> torch.device:
        return self.prog.device

    def mem_footprint_bytes(self) -> int:
        """This rank's program bytes."""
        return int(self.prog.mem_footprint_bytes() + (
            self.prog_loc.mem_footprint_bytes() if self.prog_loc else 0))


def plan_dist_closgx(csr: HostCSR, k: int, dtype=np.float32,
                     chunk_N: int = 1 << 20, max_chunks: int = 256,
                     overlap: bool = False) -> DistClosGXPlan:
    """The JAX ``build_dist_closgx``'s leaves and statics for k shards
    (host only). The port's CLOSGX builder makes fp32 programs only."""
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"CLOSGX programs are float32, not {dtype}")
    m, n = csr.m, csr.n
    if m < k * LANES:
        raise ValueError(
            f"matrix too small for {k}-way 128-aligned sharding "
            f"(m={m} < {k * LANES}); use fewer devices or the single-device "
            "path (collapsed zero-row shards fail obscurely)")
    starts = partition_rows_nnz_balanced(csr, k)
    starts = [min((s + LANES - 1) // LANES * LANES, m) for s in starts]
    starts[0], starts[-1] = 0, m
    for i in range(1, k):          # no shard collapsed by the alignment
        if starts[i] <= starts[i - 1]:
            starts[i] = min(starts[i - 1] + LANES, m)
    n_pad = ((n + k * LANES - 1) // (k * LANES)) * (k * LANES)
    row_slices = [_rows_slice(csr, starts[d], starts[d + 1])
                  for d in range(k)]

    def build(h):
        return cached_build(build_clos_gather_xl, _nonempty(h), "closgx",
                            chunk_N=chunk_N, max_chunks=max_chunks)

    if not overlap:
        shards = [build(h) for h in row_slices]
        leaves, statics, _ = _pad_family(shards, chunk_N)
        return DistClosGXPlan(
            leaves=leaves, statics=statics, row_starts=tuple(starts), m=m,
            n=n, n_pad=n_pad, shard_nnz=tuple(s.nnz for s in shards),
            shard_slots=tuple(s.n_chunks * chunk_N for s in shards))

    # overlap: each shard's columns split into the rank's own x block
    # (computed from the local x, under the gather) and the remote rest
    nloc = n_pad // k
    loc_h, rem_h = [], []
    for d, h in enumerate(row_slices):
        lo = d * nloc
        loc, rem = _split_cols(h, lo, lo + nloc)
        loc_h.append(HostCSR(a=loc.a, ia=loc.ia, ja=loc.ja, m=loc.m,
                             n=nloc))   # n = nloc even past the matrix
        rem_h.append(rem)
    shards_rem = [build(h) for h in rem_h]
    shards_loc = [build(h) for h in loc_h]
    _, _, Rp0 = _pad_family(shards_rem, chunk_N)
    _, _, Rp1 = _pad_family(shards_loc, chunk_N)
    Rp = max(Rp0, Rp1)             # one y padding, so the adds line up
    leaves, statics, _ = _pad_family(shards_rem, chunk_N, Rp_floor=Rp)
    leaves_l, statics_l, _ = _pad_family(shards_loc, chunk_N, Rp_floor=Rp)
    return DistClosGXPlan(
        leaves=leaves, statics=statics, row_starts=tuple(starts), m=m, n=n,
        n_pad=n_pad, shard_nnz=tuple(h.nnz for h in row_slices),
        shard_slots=tuple(s.n_chunks * chunk_N for s in shards_rem),
        leaves_loc=leaves_l, statics_loc=statics_l)


def build_dist_closgx(csr: HostCSR, mesh, axis: str = "d",
                      dtype=np.float32, chunk_N: int = 1 << 20,
                      max_chunks: int = 256,
                      overlap: bool = False) -> DistClosGX:
    """This rank's ``DistClosGX`` over ``mesh``."""
    _, k, rank, device = mesh_rank(mesh, axis)
    return plan_dist_closgx(csr, k, dtype, chunk_N, max_chunks,
                            overlap).shard(rank, device, mesh, axis)


def dist_spmv_closgx(D: DistClosGX, x_local: torch.Tensor) -> torch.Tensor:
    """This rank's stacked local y (Rp·128,) from its x block (n_pad/k,);
    assemble with :func:`assemble_y` or slice by ``row_starts``."""
    if D.overlapped:
        # start the gather first, then the local-column program on the
        # local block, which does not wait for it
        pend = comm.all_gather(x_local, D.group, async_op=True)
        y_loc = spmv(D.prog_loc, x_local)
        y_rem = spmv(D.prog, pend.wait()[: D.n])
        return y_loc + y_rem
    return spmv(D.prog, comm.all_gather(x_local, D.group)[: D.n])


def shard_x(D: DistClosGX, x: np.ndarray) -> torch.Tensor:
    """This rank's block (n_pad/k,) of the padded x."""
    xp = np.zeros(D.n_pad, np.float32)
    xp[: x.shape[0]] = x
    part = D.n_pad // D.k
    return torch.from_numpy(xp[D.rank * part:(D.rank + 1) * part].copy()).to(
        D.device)


def assemble_y(D: DistClosGX, y_local: torch.Tensor) -> np.ndarray:
    """The global y (m,) from every rank's stacked y (a collective)."""
    yk = comm.all_gather(y_local, D.group).cpu().numpy().reshape(D.k, -1)
    out = np.zeros(D.m, np.float64)
    for d in range(D.k):
        r0, r1 = D.row_starts[d], D.row_starts[d + 1]
        out[r0:r1] = yk[d, : r1 - r0]
    return out


def dist_spmv_closgx_host(D: DistClosGX, x: np.ndarray) -> np.ndarray:
    return assemble_y(D, dist_spmv_closgx(D, shard_x(D, x)))
