"""Distributed CLOSG: nnz-balanced row shards, one routed program a device.

Counterpart of ``spmv_research_tpu/parallel/dist_closg.py``. A compiled
Clos routing program is per-matrix static metadata (N, scan stages,
extraction classes differ per shard), so the sharded engine runs
MPMD-style in one process: each device holds its own program for its row
block and runs its own SpMV. x is copied to every device first (the
``allgather`` halo strategy), and y is the concatenation of the
per-device outputs on the first device (row-contiguous by construction of
the nnz-balanced split). The launches are asynchronous, so the k devices'
kernels run concurrently where they are different cards.

The devices default to every visible card; a list that names one card k
times runs the k shards there one after the other. Each shard's program
is built through the format cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert.cache import cached_build
from ..core.host import HostCSR
from ..ops.clos_gather import _rows_slice, build_clos_gather_auto
from ..ops.dispatch import spmv
from ..ops.sellw import SellWBuildError, build_sellw
from .dist import partition_rows_nnz_balanced


def _devices(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("no CUDA device visible: pass devices=")
    return tuple(torch.device(d) for d in devices)


@dataclasses.dataclass
class ShardedClosG:
    """Per-device compiled programs over an nnz-balanced row split."""

    shards: Tuple[object, ...]          # ClosG / ClosGChunked / SellW ...
    devices: Tuple[torch.device, ...]
    row_splits: np.ndarray              # (k+1,)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CLOSG_DIST"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def k(self):
        return len(self.shards)

    def mem_footprint_bytes(self) -> int:
        return int(sum(s.mem_footprint_bytes() for s in self.shards))


def _sharded(csr: HostCSR, devices, build) -> ShardedClosG:
    devices = _devices(devices)
    splits = partition_rows_nnz_balanced(csr, len(devices))
    shards = tuple(
        build(_rows_slice(csr, int(splits[j]), int(splits[j + 1]))).to(d)
        for j, d in enumerate(devices))
    return ShardedClosG(shards=shards, devices=devices, row_splits=splits,
                        shape=(csr.m, csr.n), nnz=csr.nnz,
                        nnz_expanded=csr.nnz_expanded)


def build_sharded_closg(csr: HostCSR, devices: Sequence = None,
                        dtype=np.float32) -> ShardedClosG:
    """One ``build_clos_gather_auto`` program a row shard, on its device
    (the port's CLOSG programs are fp32)."""
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"CLOSG programs are float32, not {dtype}")
    return _sharded(csr, devices, lambda part: cached_build(
        build_clos_gather_auto, part, "closg"))


def distributed_spmv_closg(A: ShardedClosG, x: torch.Tensor,
                           impl: Optional[str] = None) -> torch.Tensor:
    """x copied to every device, the k per-device SpMVs launched in turn
    (impl ``cuda`` on a card, as each device's tensors decide, unless
    ``impl`` is named), the row blocks concatenated on the first device."""
    ys = [spmv(s, x.to(d), impl=impl) for s, d in zip(A.shards, A.devices)]
    return torch.cat([y.to(A.devices[0]) for y in ys])


def build_sharded_best(csr: HostCSR, devices: Sequence = None,
                       dtype=np.float32) -> ShardedClosG:
    """nnz-balanced row shards, each compiled to its best single-device
    engine: SELLW where the shard has column locality, CLOSG otherwise
    (shards of one matrix may pick different engines; the reference's
    kernel-selection map ``config.sh:458-661`` applied per shard)."""
    def build(part):
        try:
            return cached_build(build_sellw, part, "sellw", dtype=dtype)
        except SellWBuildError:
            return cached_build(build_clos_gather_auto, part, "closg")

    return _sharded(csr, devices, build)
