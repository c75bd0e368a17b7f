"""The collectives of the distributed layer, on ``torch.distributed``.

The JAX package runs one process over a mesh of k devices and writes each
strategy as a ``shard_map`` body with ``jax.lax`` collectives. Here each
device is driven by a process of its own (a *rank*) that runs that body
itself, and the collectives are these:

==========================  ===============================================
JAX                         here
==========================  ===============================================
``all_gather(tiled=True)``  :func:`all_gather` (``all_gather_into_tensor``)
``ppermute``, pairs         :func:`ring_shift`: rank i sends to i−1 and
``(i, (i−1) % k)``          receives from i+1 (``batch_isend_irecv``),
                            posted before the step's product
``psum_scatter``            :func:`reduce_scatter`
                            (``reduce_scatter_tensor``)
``psum``, ``vdot``          :func:`all_reduce`
==========================  ===============================================

The backend is the group's own (``nccl`` on the card unless a caller
asked for ``gloo`` when the group was made). One fixed rule: under gloo a
CUDA tensor goes through pinned host memory for the exchange and back,
and ``STAGED["bytes"]`` counts the bytes so copied (both ways). Under NCCL
nothing is staged. (NCCL refuses two ranks on one card, so a run of k > 1
ranks on one card names gloo.)
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

# bytes copied between the card and pinned host memory for gloo, since the
# last reset_staged(), as the kernels' launch counters
STAGED = {"bytes": 0}


def reset_staged() -> None:
    STAGED["bytes"] = 0


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % cards}`` for ``"cuda"``
    (the rank within its node, as torchrun sets it, else the global rank),
    or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def _staged(group, *ts: torch.Tensor) -> bool:
    return (dist.get_backend(group) == "gloo"
            and any(t.device.type == "cuda" for t in ts))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``, counted."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    return h


def _back(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    STAGED["bytes"] += h.numel() * h.element_size()
    return h.to(device)


class Pending:
    """A collective in flight: :meth:`wait` gives its result on the device
    of the tensor it was started with."""

    def __init__(self, out: torch.Tensor, works, device: torch.device):
        self.out, self.works, self.device = out, works, device

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.out.device != self.device:
            return _back(self.out, self.device)
        return self.out


def all_gather(x: torch.Tensor, group=None, async_op: bool = False):
    """The ranks' ``x`` (1-D, one length on every rank) end to end, in rank
    order, on every rank; with ``async_op`` a :class:`Pending`."""
    k = dist.get_world_size(group)
    src = _host(x) if _staged(group, x) else x
    out = src.new_empty(k * x.numel())
    work = dist.all_gather_into_tensor(out, src, group=group,
                                       async_op=async_op)
    pend = Pending(out, [work] if async_op else [], x.device)
    return pend if async_op else pend.wait()


def ring_shift(x: torch.Tensor, group=None) -> Pending:
    """Start the ring step: send ``x`` to rank i−1, receive rank i+1's
    (group ranks). Returns the :class:`Pending` receive; the caller runs
    the step's product before it waits. Never called with one rank: a ring
    of one is one local step."""
    k, me = dist.get_world_size(group), dist.get_rank(group)
    if k == 1:
        raise ValueError("a ring of one rank has no shift")
    src = _host(x) if _staged(group, x) else x
    recv = torch.empty_like(src)
    to = dist.get_global_rank(group, (me - 1) % k) if group else (me - 1) % k
    frm = dist.get_global_rank(group, (me + 1) % k) if group else (me + 1) % k
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    return Pending(recv, works, x.device)


def ring_sum(x: torch.Tensor, group, product: Callable) -> torch.Tensor:
    """The ring of k steps: at step j this rank holds the x block of rank
    (me + j) % k and adds ``product(owner, block)``; the next block's
    shift is posted before the product (none after the last step, and
    none at all for one rank)."""
    k, me = dist.get_world_size(group), dist.get_rank(group)
    acc, xcur = None, x
    for j in range(k):
        pend = ring_shift(xcur, group) if j < k - 1 else None
        part = product((me + j) % k, xcur)
        acc = part if acc is None else acc + part
        if pend is not None:
            xcur = pend.wait()
    return acc


def reduce_scatter(y: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``y`` (1-D, its length a multiple of k), of
    which rank i keeps the i-th of k equal parts."""
    k = dist.get_world_size(group)
    src = _host(y) if _staged(group, y) else y
    out = src.new_empty(y.numel() // k)
    dist.reduce_scatter_tensor(out, src, group=group)
    return Pending(out, [], y.device).wait()


def all_reduce(t: torch.Tensor, group=None,
               op: Optional[dist.ReduceOp] = None) -> torch.Tensor:
    """The sum (or ``op``) over ranks of ``t``, on every rank (a new
    tensor)."""
    src = _host(t) if _staged(group, t) else t.clone()
    dist.all_reduce(src, op=op or dist.ReduceOp.SUM, group=group)
    return Pending(src, [], t.device).wait()
