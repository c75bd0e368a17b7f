"""Per-iteration timing of a chain of dependent SpMVs (or SpMMs, SDDMMs).

Counterpart of ``spmv_research_tpu/utils/timing.py``. The protocol is kept:
each iteration applies ``fn`` and folds its output back into its input as
``x + y·1e-30`` (y resized to x's shape: for non-square matrices, and for
a 2-D X, whose fold takes the output's elements in order, cycled or cut to
X's size), so no iteration is independent of the one before. On a CUDA
device each iteration is bracketed by CUDA events on the current stream,
which time the device's own clock; the JAX package's differential lo/hi
chains existed only because ``block_until_ready`` did not synchronise on
its TPU runtime, and are not needed here. On the CPU, where PyTorch runs synchronously, the host clock
times each iteration; the result names its device so that a CPU time is
never read as a device time.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def fold(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y·1e-30, y resized to x's shape: the next iterate depends on y."""
    n = x.numel()
    y = y.reshape(-1).to(x.dtype)
    if y.numel() < n:
        y = y.repeat(-(-n // y.numel()))
    # a longer y is cut, not copied: an SDDMM slab can be 100× X's size
    return x + y[:n].view(x.shape) * 1e-30


def time_chain(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               min_num_loops: int, min_time_s: float,
               batch: int = 64) -> np.ndarray:
    """Seconds of each iteration of ``x ← fold(x, fn(x))``, over at least
    ``min_num_loops`` iterations and at least ``min_time_s`` seconds."""
    cuda = x.device.type == "cuda"
    out = []
    t_start = time.perf_counter()
    while (len(out) < min_num_loops
           or time.perf_counter() - t_start < min_time_s):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(batch + 1)]
            ev[0].record()
            for i in range(batch):
                x = fold(x, fn(x))
                ev[i + 1].record()
            torch.cuda.synchronize(x.device)
            out += [ev[i].elapsed_time(ev[i + 1]) * 1e-3
                    for i in range(batch)]
        else:
            for _ in range(batch):
                t0 = time.perf_counter()
                x = fold(x, fn(x))
                out.append(time.perf_counter() - t0)
    return np.asarray(out)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
