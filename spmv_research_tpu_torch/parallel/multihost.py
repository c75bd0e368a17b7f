"""Multi-process runtime set-up and weak-scaling measurement.

Counterpart of ``spmv_research_tpu/parallel/multihost.py``. The reference
has no distributed backend (its SLURM scripts launch independent
single-node jobs); here a run of several processes is one
``torch.distributed`` process group, one rank a device, and
``weak_scaling_efficiency`` measures the scaling target (≥ 70% efficiency
at N ≥ 2 devices) by growing the synthetic problem with the ranks while
each rank's work stays the same.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..gen import ArtificialParams, artificial_matrix_generation
from . import comm
from .dist import build_sharded_csr, distributed_spmv_arrays


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "nccl") -> None:
    """Make the default process group (nothing if one exists).

    * ``num_processes`` > 1: ``coordinator_address`` is ``host:port`` of
      rank 0 (``tcp://``) or a full ``tcp://`` or ``file://`` init method;
      ``process_id`` is this process's rank.
    * otherwise, under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
      ``MASTER_ADDR`` set): ``env://``, the counterpart of JAX's
      detection on managed TPU VMs.
    * otherwise a group of one rank on an in-memory store, so that the
      collectives of the layer run in a single process.

    ``backend`` is ``"nccl"`` (the card) unless the caller names
    ``"gloo"`` (the CPU, or several ranks on one card)."""
    if dist.is_initialized():
        return
    if num_processes is not None and num_processes > 1:
        addr = coordinator_address or ""
        method = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(backend, init_method=method,
                                world_size=num_processes, rank=process_id)
    elif all(v in os.environ for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if backend == "nccl":
        torch.cuda.set_device(comm.rank_device("cuda"))


def _bench_dist_spmv(A, x: torch.Tensor, strategy: str,
                     reps: int = 8) -> float:
    """Median seconds of one distributed SpMV: a chain of 10 less a chain
    of 2, over 8 (CUDA events on the card, ``perf_counter`` on the CPU),
    the slowest rank's."""
    cuda = x.device.type == "cuda"

    def chain(k):
        v = x
        for _ in range(k):
            y = distributed_spmv_arrays(A, A.data, A.cols, A.rows, v,
                                        strategy)
            v = v + y * 1e-30
        return v[:8].sum()

    def timed(k):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            float(chain(k))
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3
        t0 = time.perf_counter()
        float(chain(k))
        return time.perf_counter() - t0

    float(chain(2))
    float(chain(10))
    ts = []
    for _ in range(reps):
        t_lo = timed(2)
        t_hi = timed(10)
        ts.append((t_hi - t_lo) / 8)
    pos = [t for t in ts if t > 0] or [1e-9]
    t = torch.tensor([float(np.median(pos))], dtype=torch.float64,
                     device=x.device)
    return float(comm.all_reduce(t, A.group, dist.ReduceOp.MAX)[0])


def weak_scaling_efficiency(rows_per_device: int = 100_000,
                            avg_nnz_per_row: float = 8.0,
                            strategy: str = "allgather",
                            device_counts=None, seed: int = 14,
                            device: str = "cuda") -> dict:
    """Weak scaling: the problem grows with the ranks, each rank's part
    stays the same. Every rank of the process group calls it; the first k
    ranks form the mesh at k (a sub-mesh: making it is collective), and
    every rank returns rank 0's dict.

    Two efficiencies per k (both ideal 1.0):
      * ``efficiency``          = t(1 dev, W) / t(k dev, k·W) — the classic
        definition; only meaningful on k real devices.
      * ``efficiency_overhead`` = t(1 dev, k·W) / t(k dev, k·W) — the
        sharding and collective overhead at equal total work; the honest
        number where the k ranks share one socket or one card, where the
        classic metric has a 1/k floor by construction.
    """
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    me = dist.get_rank()
    device_counts = device_counts or [k for k in (1, 2, 4, 8) if k <= world]
    out = {}
    t1 = None
    for k in device_counts:
        m = rows_per_device * k
        p = ArtificialParams(m, m, avg_nnz_per_row, avg_nnz_per_row / 3,
                             "normal", "random", bw=0.05, skew=1.0,
                             avg_num_neighbours=0.5,
                             cross_row_similarity=0.3, seed=seed)
        host, _ = artificial_matrix_generation(p)
        rng = np.random.Generator(np.random.PCG64(0))
        xv = rng.uniform(size=m)
        mesh1 = DeviceMesh(device, [0], mesh_dim_names=("rows",))
        meshk = DeviceMesh(device, list(range(k)), mesh_dim_names=("rows",))
        t_1dev = t = None
        if me == 0:
            A1 = build_sharded_csr(host, mesh1)
            t_1dev = _bench_dist_spmv(A1, A1.pad_vector(xv), strategy)
        if k == 1:
            t = t_1dev
        elif me < k:
            A = build_sharded_csr(host, meshk)
            t = _bench_dist_spmv(A, A.pad_vector(xv), strategy)
        if me == 0:
            if t1 is None:
                t1 = t
            out[k] = {"time": t, "efficiency": t1 / t if t > 0 else 0.0,
                      "efficiency_overhead": t_1dev / t if t > 0 else 0.0,
                      "nnz": host.nnz}
    box = [out]
    dist.broadcast_object_list(box, src=0)
    return box[0]
