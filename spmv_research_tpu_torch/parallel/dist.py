"""Multi-device distribution layer: row-, ring- and column-sharded CSR.

Counterpart of ``spmv_research_tpu/parallel/dist.py``. A 1-D mesh of k
ranks (one process a device, ``torch.distributed``), rows partitioned
nnz-balanced per rank (the prefix-sum partitioner of
``lib/parallel_util.h:156``), x sharded by the same row partition, and the
halo exchange of x by strategy (collectives in ``comm.py``):

* ``allgather`` — x gathered whole on every rank before the local SpMV;
* ``ring`` — x shards rotate around the ring; each step multiplies the
  column block of the shard it holds, the next shard's transfer posted
  before the product;
* ``psum_scatter`` — column-partitioned A; partial y summed with a
  reduce-scatter (the 1.5-D variant).

Each builder is a plain host half, ``plan_*`` (the whole plan: all k
shards padded to one shape, the arrays the JAX builder stacks on its
``(k, …)`` axis, needing no process group), and ``.shard(rank, device)``,
which keeps one rank's slice on its device. ``build_*`` take a mesh and
give this rank's shard. The local product is the JAX package's XLA
``segment_sum``, here ``index_add_``: there is no kernel in this module.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.host import INDEX_DTYPE, HostCSR
from . import comm


def make_sparse_mesh(n_devices: int, axis: str = "rows",
                     device: str = "cuda"):
    """A 1-D ``DeviceMesh`` of the ``n_devices`` ranks of the process group
    (made by ``init_multihost``), its one dimension named ``axis``."""
    from torch.distributed.device_mesh import init_device_mesh
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n_devices:
        raise ValueError(f"need {n_devices} devices, have {have} ranks in "
                         "the process group")
    if device == "cuda":
        torch.cuda.set_device(comm.rank_device(device))
    return init_device_mesh(device, (n_devices,), mesh_dim_names=(axis,))


def mesh_rank(mesh, axis: str) -> Tuple[object, int, int, torch.device]:
    """(group, k, this rank's index on ``axis``, its device)."""
    return (mesh.get_group(axis), mesh.size(), mesh.get_local_rank(axis),
            comm.rank_device(mesh.device_type))


def partition_rows_nnz_balanced(csr: HostCSR, k: int) -> np.ndarray:
    """Row split points (k+1,) equalizing nnz per part — the reference's
    ``loop_partitioner_balance_prefix_sums`` computed vectorized."""
    targets = (np.arange(k + 1) * (csr.nnz / k)).astype(np.int64)
    splits = np.searchsorted(csr.ia, targets, side="left")
    splits[0], splits[-1] = 0, csr.m
    return np.maximum.accumulate(splits.astype(np.int64))


def _rows_slice(csr: HostCSR, r0: int, r1: int) -> HostCSR:
    """Rows [r0, r1) as a CSR of their own (int32 indices, copies)."""
    ia = csr.ia.astype(np.int64)
    e0, e1 = int(ia[r0]), int(ia[r1])
    return HostCSR(a=csr.a[e0:e1].copy(),
                   ia=(csr.ia[r0:r1 + 1] - csr.ia[r0]).astype(np.int32),
                   ja=csr.ja[e0:e1].copy(), m=r1 - r0, n=csr.n)


def _to(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class ShardedCSRPlan:
    """The whole row-sharded plan on the host: JAX's stacked arrays."""

    data: np.ndarray          # (k, nnz_pad)
    cols: np.ndarray          # (k, nnz_pad) int32, padded-global indices
    rows: np.ndarray          # (k, nnz_pad) int32, local rows (pad: rows_pad)
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int
    row_splits: np.ndarray    # (k+1,)
    data_blk: Optional[np.ndarray] = None   # (k·k, Bmax), None past budget
    cols_blk: Optional[np.ndarray] = None   # block-local column ids
    rows_blk: Optional[np.ndarray] = None

    def shard(self, rank: int, device, mesh=None,
              axis: str = "rows") -> "ShardedCSR":
        blk = (slice(rank * self.k, (rank + 1) * self.k),)
        return ShardedCSR(
            data=_to(self.data[rank], device), cols=_to(self.cols[rank],
                                                        device),
            rows=_to(self.rows[rank], device), shape=self.shape,
            nnz=self.nnz, k=self.k, rows_pad=self.rows_pad,
            row_splits=self.row_splits, mesh=mesh, axis=axis, rank=rank,
            data_blk=None if self.data_blk is None
            else _to(self.data_blk[blk], device),
            cols_blk=None if self.cols_blk is None
            else _to(self.cols_blk[blk], device),
            rows_blk=None if self.rows_blk is None
            else _to(self.rows_blk[blk], device))


@dataclasses.dataclass
class ShardedCSR:
    """One rank's shard of the row-sharded padded CSR: columns remapped to
    the padded global index space (shard j's rows live at
    [j·rows_pad, j·rows_pad + rows_j))."""

    data: torch.Tensor        # (nnz_pad,)
    cols: torch.Tensor        # (nnz_pad,) int32
    rows: torch.Tensor        # (nnz_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int
    row_splits: np.ndarray
    mesh: object
    axis: str
    rank: int
    # the ring layout: the shard's entries grouped by owner column block
    # at build time, so ring step s touches only its block; None where the
    # k²·pad blow-up passes the budget (the masked body runs instead)
    data_blk: Optional[torch.Tensor] = None   # (k, Bmax)
    cols_blk: Optional[torch.Tensor] = None
    rows_blk: Optional[torch.Tensor] = None

    @property
    def m_pad(self) -> int:
        return self.k * self.rows_pad

    @functools.cached_property
    def group(self):
        """The mesh's process group (looked up once: a SpMV reads it)."""
        return self.mesh.get_group(self.axis) if self.mesh else None

    @property
    def device(self) -> torch.device:
        return self.data.device

    def pad_vector(self, x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        """This rank's part (rows_pad,) of a global vector (n,) in the
        padded sharded layout."""
        s, e = self.row_splits[self.rank], self.row_splits[self.rank + 1]
        out = torch.zeros(self.rows_pad, dtype=dtype)
        out[: e - s] = torch.as_tensor(np.asarray(x[s:e]), dtype=dtype)
        return out.to(self.device)

    def unpad_vector(self, y: torch.Tensor) -> np.ndarray:
        """The global vector (m,) from every rank's part (a collective:
        every rank calls it and gets the whole)."""
        yg = comm.all_gather(y, self.group).cpu().numpy()
        out = np.zeros(self.shape[0], dtype=yg.dtype)
        for j in range(self.k):
            s, e = self.row_splits[j], self.row_splits[j + 1]
            out[s:e] = yg[j * self.rows_pad: j * self.rows_pad + (e - s)]
        return out


def plan_sharded_csr(csr: HostCSR, k: int, dtype=np.float32,
                     nnz_align: int = 256) -> ShardedCSRPlan:
    """The JAX ``build_sharded_csr``'s arrays for k shards (host only)."""
    if csr.m != csr.n:
        raise ValueError("distributed SpMV requires square matrices "
                         "(x ≡ row space)")
    splits = partition_rows_nnz_balanced(csr, k)
    rows_pad = int(max(np.diff(splits).max(), 1))
    owner = np.searchsorted(splits, csr.ja, side="right") - 1
    owner = np.clip(owner, 0, k - 1)
    cols_remap = owner * rows_pad + (csr.ja.astype(np.int64) - splits[owner])

    lengths = csr.row_lengths()
    grows = np.repeat(np.arange(csr.m, dtype=np.int64), lengths)
    nnz_per = np.diff(csr.ia[splits]).astype(np.int64)
    nnz_pad = int(((int(nnz_per.max()) + nnz_align - 1) // nnz_align)
                  * nnz_align)
    nnz_pad = max(nnz_pad, nnz_align)

    data = np.zeros((k, nnz_pad), dtype=np.dtype(dtype))
    cols = np.zeros((k, nnz_pad), dtype=INDEX_DTYPE)
    rows = np.full((k, nnz_pad), rows_pad, dtype=INDEX_DTYPE)
    for j in range(k):
        s, e = csr.ia[splits[j]], csr.ia[splits[j + 1]]
        cnt = e - s
        data[j, :cnt] = csr.a[s:e]
        cols[j, :cnt] = cols_remap[s:e]
        rows[j, :cnt] = grows[s:e] - splits[j]

    # ring-blocked layout: each shard's entries grouped by owner block
    blk = {}
    counts = np.zeros((k, k), np.int64)
    for j in range(k):
        s_, e_ = csr.ia[splits[j]], csr.ia[splits[j + 1]]
        counts[j] = np.bincount(owner[s_:e_], minlength=k)
    Bmax = int(((counts.max() + nnz_align - 1) // nnz_align) * nnz_align)
    Bmax = max(Bmax, nnz_align)
    if k * Bmax <= 4 * nnz_pad:        # blow-up budget (skewed columns)
        data_blk = np.zeros((k * k, Bmax), dtype=np.dtype(dtype))
        cols_blk = np.zeros((k * k, Bmax), dtype=INDEX_DTYPE)
        rows_blk = np.full((k * k, Bmax), rows_pad, dtype=INDEX_DTYPE)
        for j in range(k):
            s_, e_ = csr.ia[splits[j]], csr.ia[splits[j + 1]]
            ow = owner[s_:e_]
            order = np.argsort(ow, kind="stable")   # rows stay sorted
            for b in range(k):
                sel = order[ow[order] == b]
                cnt = sel.size
                r0 = j * k + b
                data_blk[r0, :cnt] = csr.a[s_:e_][sel]
                cols_blk[r0, :cnt] = cols_remap[s_:e_][sel] - b * rows_pad
                rows_blk[r0, :cnt] = grows[s_:e_][sel] - splits[j]
        blk = dict(data_blk=data_blk, cols_blk=cols_blk, rows_blk=rows_blk)
    return ShardedCSRPlan(data=data, cols=cols, rows=rows,
                          shape=(csr.m, csr.n), nnz=csr.nnz, k=k,
                          rows_pad=rows_pad, row_splits=splits, **blk)


def build_sharded_csr(csr: HostCSR, mesh, axis: str = "rows",
                      dtype=np.float32, nnz_align: int = 256) -> ShardedCSR:
    """This rank's shard of the row-sharded CSR over ``mesh``."""
    _, k, rank, device = mesh_rank(mesh, axis)
    return plan_sharded_csr(csr, k, dtype, nnz_align).shard(
        rank, device, mesh, axis)


def _local_spmv(data, cols, rows, x_full, rows_pad):
    """Local padded-CSR SpMV (padding rows land in the overflow row, which
    is sliced off)."""
    prod = data * x_full.index_select(0, cols)
    y = prod.new_zeros(rows_pad + 1).index_add_(0, rows, prod)
    return y[:rows_pad]


def _ring_masked(A: ShardedCSR, data, cols, rows,
                 xs: torch.Tensor) -> torch.Tensor:
    """The ring over the plain layout: each step masks the shard's entries
    to the columns of the block it holds."""
    rp = A.rows_pad

    def product(owner, xblk):
        local = cols.long() - owner * rp
        mask = (local >= 0) & (local < rp)
        xi = xblk.index_select(0, local.clamp(0, rp - 1))
        prod = torch.where(mask, data * xi, 0.0)
        return prod.new_zeros(rp + 1).index_add_(0, rows, prod)[:rp]

    return comm.ring_sum(xs, A.group, product)


def distributed_spmv(A: ShardedCSR, x: torch.Tensor,
                     strategy: str = "allgather") -> torch.Tensor:
    """This rank's part of y = A @ x, x and y sharded by the row partition
    (``x`` this rank's part, from :meth:`ShardedCSR.pad_vector`)."""
    if strategy == "allgather":
        return _local_spmv(A.data, A.cols, A.rows,
                           comm.all_gather(x, A.group), A.rows_pad)
    if strategy == "ring":
        if A.data_blk is None:
            return _ring_masked(A, A.data, A.cols, A.rows, x)
        # the build-time block layout: step s multiplies only the slice
        # of the block it holds
        return comm.ring_sum(x, A.group, lambda owner, xblk: _local_spmv(
            A.data_blk[owner], A.cols_blk[owner], A.rows_blk[owner], xblk,
            A.rows_pad))
    raise ValueError(f"unknown strategy {strategy!r}")


def distributed_spmv_arrays(A: ShardedCSR, data, cols, rows, x,
                            strategy: str = "allgather") -> torch.Tensor:
    """``distributed_spmv`` over explicit shard arrays (the ring through
    the masked body, as the JAX function)."""
    if strategy == "allgather":
        return _local_spmv(data, cols, rows, comm.all_gather(x, A.group),
                           A.rows_pad)
    if strategy == "ring":
        return _ring_masked(A, data, cols, rows, x)
    raise ValueError(f"unknown strategy {strategy!r}")


@dataclasses.dataclass
class ColShardedCSRPlan:
    """The whole column-sharded plan on the host: JAX's stacked arrays."""

    data: np.ndarray      # (k, nnz_pad)
    cols: np.ndarray      # (k, nnz_pad) int32 local column ids
    rows: np.ndarray      # (k, nnz_pad) int32 global padded row ids
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int
    cols_pad: int
    col_splits: np.ndarray

    def shard(self, rank: int, device, mesh=None,
              axis: str = "rows") -> "ColShardedCSR":
        return ColShardedCSR(
            data=_to(self.data[rank], device), cols=_to(self.cols[rank],
                                                        device),
            rows=_to(self.rows[rank], device), shape=self.shape,
            nnz=self.nnz, k=self.k, rows_pad=self.rows_pad,
            cols_pad=self.cols_pad, col_splits=self.col_splits, mesh=mesh,
            axis=axis, rank=rank)


@dataclasses.dataclass
class ColShardedCSR:
    """One rank's shard of the column-partitioned CSR: rank j owns the
    column block [splits[j], splits[j+1]); rows stay global (padded).
    Local partial y over all rows, combined by a reduce-scatter."""

    data: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    k: int
    rows_pad: int         # rows padded so k | m_pad (y scatter granularity)
    cols_pad: int
    col_splits: np.ndarray
    mesh: object
    axis: str
    rank: int

    @property
    def m_pad(self):
        return self.k * self.rows_pad

    @functools.cached_property
    def group(self):
        """The mesh's process group (looked up once: a SpMV reads it)."""
        return self.mesh.get_group(self.axis) if self.mesh else None

    def pad_x(self, x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
        """This rank's column block (cols_pad,) of x."""
        s, e = self.col_splits[self.rank], self.col_splits[self.rank + 1]
        out = torch.zeros(self.cols_pad, dtype=dtype)
        out[: e - s] = torch.as_tensor(np.asarray(x[s:e]), dtype=dtype)
        return out.to(self.data.device)

    def unpad_y(self, y: torch.Tensor) -> np.ndarray:
        """The global y (m,) from every rank's part (a collective)."""
        return comm.all_gather(y, self.group).cpu().numpy()[: self.shape[0]]


def plan_col_sharded_csr(csr: HostCSR, k: int, dtype=np.float32,
                         nnz_align: int = 256) -> ColShardedCSRPlan:
    """The JAX ``build_col_sharded_csr``'s arrays for k shards: nnz by
    column owner, nnz-balanced over a column prefix sum (host only)."""
    col_counts = np.bincount(csr.ja, minlength=csr.n)
    cum = np.concatenate([[0], np.cumsum(col_counts)])
    targets = (np.arange(k + 1) * (csr.nnz / k)).astype(np.int64)
    splits = np.searchsorted(cum, targets, side="left")
    splits[0], splits[-1] = 0, csr.n
    splits = np.maximum.accumulate(splits)
    cols_pad = int(max(np.diff(splits).max(), 1))
    rows_pad = ((csr.m + k - 1) // k)

    lengths = csr.row_lengths()
    grows = np.repeat(np.arange(csr.m, dtype=np.int64), lengths)
    owner = np.clip(np.searchsorted(splits, csr.ja, side="right") - 1, 0,
                    k - 1)
    local_cols = csr.ja.astype(np.int64) - splits[owner]
    per = np.bincount(owner, minlength=k)
    nnz_pad = int(((int(per.max()) + nnz_align - 1) // nnz_align)
                  * nnz_align)
    nnz_pad = max(nnz_pad, nnz_align)

    data = np.zeros((k, nnz_pad), dtype=np.dtype(dtype))
    cols = np.zeros((k, nnz_pad), dtype=INDEX_DTYPE)
    rows = np.full((k, nnz_pad), k * rows_pad, dtype=INDEX_DTYPE)
    order = np.argsort(owner, kind="stable")
    for j in range(k):
        sel = order[np.searchsorted(owner[order], j, "left"):
                    np.searchsorted(owner[order], j, "right")]
        cnt = sel.size
        data[j, :cnt] = csr.a[sel]
        cols[j, :cnt] = local_cols[sel]
        rows[j, :cnt] = grows[sel]
    return ColShardedCSRPlan(data=data, cols=cols, rows=rows,
                             shape=(csr.m, csr.n), nnz=csr.nnz, k=k,
                             rows_pad=rows_pad, cols_pad=cols_pad,
                             col_splits=splits)


def build_col_sharded_csr(csr: HostCSR, mesh, axis: str = "rows",
                          dtype=np.float32,
                          nnz_align: int = 256) -> ColShardedCSR:
    """This rank's shard of the column-sharded CSR over ``mesh``."""
    _, k, rank, device = mesh_rank(mesh, axis)
    return plan_col_sharded_csr(csr, k, dtype, nnz_align).shard(
        rank, device, mesh, axis)


def distributed_spmv_psum_scatter(A: ColShardedCSR,
                                  x: torch.Tensor) -> torch.Tensor:
    """Column-partitioned SpMV: each rank computes partial y over all rows
    from its column block; the partials are summed by a reduce-scatter, so
    y comes out row-sharded (this rank's m_pad / k rows)."""
    m_pad = A.m_pad
    prod = A.data * x.index_select(0, A.cols)
    y_partial = prod.new_zeros(m_pad + 1).index_add_(0, A.rows, prod)
    return comm.reduce_scatter(y_partial[:m_pad], A.group)


def _vdot(a: torch.Tensor, b: torch.Tensor, group) -> torch.Tensor:
    """The global dot product of two row-sharded vectors."""
    return comm.all_reduce(torch.dot(a, b).reshape(1), group)[0]


def distributed_cg_step(csr: HostCSR, mesh, axis: str = "rows",
                        strategy: str = "allgather"):
    """One Jacobi-preconditioned CG iteration over the mesh: SpMV, global
    dots (all-reduce) and axpys, each rank on its shard. Returns a
    zero-argument callable that runs the step: (this rank's x_new, the
    global r·r)."""
    A = build_sharded_csr(csr, mesh, axis=axis)
    rng = np.random.Generator(np.random.PCG64(0))
    b = A.pad_vector(rng.uniform(size=csr.n))
    x0 = A.pad_vector(np.zeros(csr.n))
    diag = np.ones(csr.n)  # Jacobi preconditioner placeholder
    Kinv = A.pad_vector(1.0 / diag)
    g = A.group

    def run():
        r = b - distributed_spmv_arrays(A, A.data, A.cols, A.rows, x0,
                                        strategy)
        z = Kinv * r
        rho = _vdot(r, z, g)
        p = z
        Ap = distributed_spmv_arrays(A, A.data, A.cols, A.rows, p, strategy)
        alpha = rho / torch.clamp(_vdot(p, Ap, g), min=1e-30)
        x_new = x0 + alpha * p
        r_new = r - alpha * Ap
        return x_new, _vdot(r_new, r_new, g)

    return run
