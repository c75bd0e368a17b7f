"""Build, load and launch the port's hand-written CUDA libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ctypes (``CudaLib``). A library is
built at its first CUDA use into ``spmv_research_tpu_torch/_build/``
(git-ignored), keyed on a hash of its own source and the flags; importing a
module that holds a ``CudaLib`` builds and loads nothing. nvcc's output
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept beside
the library as ``.log``.

Also here: the argument checks every kernel wrapper makes before a launch,
and the grid of a persistent launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin on PATH)")
    return path


class CudaLib:
    """One ``csrc/<name>.cu`` source and its library.

    ``bind(lib)`` sets the argtypes of the library's entry points; every
    entry point returns ``cudaGetLastError()`` as an int, and
    ``<name>_error_string`` turns it into a message."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = os.path.join(_PKG, "csrc", f"{name}.cu")
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> str:
        """Compile the source unless a library for this exact source and
        flag set exists; returns the library's path."""
        with open(self.source, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib = os.path.join(BUILD_DIR, f"lib{self.name}_{key[:16]}.so")
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        return lib

    def build_log(self) -> str:
        """nvcc's output for the current source (builds it if needed)."""
        with open(self.build()[:-3] + ".log") as f:
            return f.read()

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            err = getattr(lib, f"{self.name}_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [ctypes.c_int]
            self._bind(lib)
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        lib = self.lib()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{fn}: CUDA error {rc}: {msg}")


def on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when every tensor
    is on the CPU; raises otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_aligned(**tensors: torch.Tensor) -> None:
    """Each named tensor must start 16-byte aligned: the kernel moves it 16
    bytes at a time (or by TMA)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel moves it 16 bytes at a "
                             f"time, so it must be 16-byte aligned")


def persistent_grid(n_items: int, n_sms: int, per_sm: int) -> int:
    """Blocks of a persistent launch over ``n_items`` work items (chunks,
    tiles): as many as the card's ``n_sms`` SMs hold at ``per_sm`` each,
    and no more than there are items; a block walks every grid-th item."""
    if n_items < 1 or n_sms < 1 or per_sm < 1:
        raise ValueError(f"no persistent grid for {n_items} work items on "
                         f"{n_sms} SMs at {per_sm} blocks an SM")
    return min(n_items, n_sms * per_sm)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
