"""BFLY: the routed-butterfly SpMV engine.

Counterpart of ``spmv_research_tpu/ops/bfly.py`` and of the executors of
``spmv_research_tpu/ops/bfly_pallas.py``: the ``Bfly`` program (flat (N,)
planes), ``build_bfly`` (the JAX package's arrays; it refuses N > 2^22
slots with ``RoutingError``), ``bfly_from_jax``, ``_spread_x``, and two
SpMV impls:

* ``"cuda"`` — ``spmv_bfly_pallas``'s chain on kernel B9 (``bfly_cuda.py``):
  the widen network, the fill, the perm network, × vals, the scan, the
  compact network, × out_valid. The two products stay PyTorch elementwise
  passes, as they were XLA passes in the JAX package;
* ``"torch"`` — the same chain on the kernels' plain versions, in the role
  of the JAX package's ``xla`` impl (``torch.roll`` where it has
  ``jnp.roll``).

``spmv_bfly_cuda_fused`` runs the whole program through kernel B10 (one
launch per phase of ``bfly_cuda.plan_phases``, 9 for scircuit's 132
stages).
The JAX package leaves its counterpart (``spmv_bfly_pallas_fused``)
unregistered, and so does the port: it adds no format impl that the JAX
package lacks, and is called directly.

The program compiler (Beneš/Waksman routes, fill and scan bits) is the
host code of ``routing.py`` and ``waksman.py``; x enters spread at slots
c << sigma_x, y leaves at slots r << sigma_y.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.formats import _move
from ..core.host import HostCSR
from . import bfly_cuda as K
from .dispatch import register_spmv
from .routing import build_bfly_program

DATA_FIELDS = ("widen_B", "fill_words", "perm_B", "vals", "scan_guards",
               "compact_B", "out_valid")
META_FIELDS = ("shape", "nnz", "nnz_expanded", "N", "L", "sigma_x",
               "sigma_y", "widen_stages", "fill_stages", "perm_stages",
               "scan_stages", "compact_stages")


@dataclasses.dataclass(frozen=True)
class Bfly:
    """Routed-butterfly SpMV program (field for field the JAX ``Bfly``).

    The three networks are exact Waksman routes run with default-keep
    selects (out = B ? partner : v), so only the take-partner planes are
    stored; a network with no stage keeps one all-zero word plane."""

    widen_B: torch.Tensor     # (W, N) int32 take-partner bit planes
    fill_words: torch.Tensor  # (N,) int32
    perm_B: torch.Tensor
    vals: torch.Tensor        # (N,) values in CSR slot order
    scan_guards: torch.Tensor  # (N,) int32
    compact_B: torch.Tensor
    out_valid: torch.Tensor   # (N,) 0/1 in the value type
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    N: int
    L: int
    sigma_x: int
    sigma_y: int
    widen_stages: Tuple[Tuple[int, int, int], ...]
    fill_stages: Tuple[int, ...]
    perm_stages: Tuple[Tuple[int, int, int], ...]
    scan_stages: Tuple[int, ...]
    compact_stages: Tuple[Tuple[int, int, int], ...]

    format_name = "BFLY"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "Bfly":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        words = (self.widen_B.shape[0] + self.perm_B.shape[0]
                 + self.compact_B.shape[0]) * 4
        return self.N * (self.vals.element_size() + 8 + words) + self.N

    def planes(self) -> tuple:
        """The program's arrays and stage lists in ``bfly_full``'s order."""
        return (self.widen_B, self.fill_words, self.perm_B, self.vals,
                self.scan_guards, self.compact_B, self.out_valid,
                self.widen_stages, self.fill_stages, self.perm_stages,
                self.scan_stages, self.compact_stages)


def _planes(arr: np.ndarray) -> np.ndarray:
    if arr.shape[0] == 0:
        arr = np.zeros((1,) + arr.shape[1:], arr.dtype)
    return arr.view(np.int32)


def _bfly(arrays: dict, meta: dict) -> Bfly:
    """Bfly from numpy program arrays and meta fields (on the CPU)."""
    return Bfly(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                   for k in DATA_FIELDS}, **meta)


def bfly_from_jax(leaves: dict, meta: dict) -> Bfly:
    """The port's ``Bfly`` for a program built by the JAX package:
    ``leaves`` maps each data field to its array (``np.asarray`` of the JAX
    leaf), ``meta`` each meta field to its value."""
    return _bfly({k: np.array(leaves[k]) for k in DATA_FIELDS},
                 {k: meta[k] for k in META_FIELDS})


def build_bfly(csr: HostCSR, dtype=np.float32, max_N: int = 1 << 22) -> Bfly:
    """Compile host CSR into a BFLY program (the arrays of the JAX
    package's ``build_bfly``)."""
    dt = np.dtype(dtype)
    prog = build_bfly_program(csr, dtype=dt, max_N=max_N)
    return _bfly(dict(
        widen_B=_planes(prog.widen.B),
        fill_words=prog.fill_words.view(np.int32),
        perm_B=_planes(prog.perm.B),
        vals=prog.vals.astype(dt),
        scan_guards=prog.scan_guards.view(np.int32),
        compact_B=_planes(prog.compact.B),
        out_valid=prog.out_valid.astype(dt)), dict(
        shape=(prog.m, prog.n), nnz=prog.nnz,
        nnz_expanded=prog.nnz_expanded, N=prog.N, L=prog.L,
        sigma_x=prog.sigma_x, sigma_y=prog.sigma_y,
        widen_stages=prog.widen.stages, fill_stages=prog.fill_stages,
        perm_stages=prog.perm.stages, scan_stages=prog.scan_stages,
        compact_stages=prog.compact.stages))


def _spread_x(x: torch.Tensor, n: int, N: int, sigma: int) -> torch.Tensor:
    """x[c] at slot c << sigma of an (N,) plane, zeros elsewhere."""
    xp = F.pad(x, (0, (N >> sigma) - x.shape[0]))
    return F.pad(xp[:, None], (0, (1 << sigma) - 1)).reshape(N)


def _y(A: Bfly, v: torch.Tensor) -> torch.Tensor:
    """y[r] from slot r << sigma_y."""
    return v[: A.m << A.sigma_y: 1 << A.sigma_y]


def _chain(A: Bfly, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """One SpMV through the wrappers of ``bfly_cuda`` (``plain``: their
    plain PyTorch versions, on any device)."""
    def k(name):
        return getattr(K, name + "_torch" if plain else name)

    v = _spread_x(x.to(A.vals.dtype), A.n, A.N, A.sigma_x)
    v = k("bfly_xor_net")(v, A.widen_B, A.widen_stages)
    v = k("bfly_fill")(v, A.fill_words, A.fill_stages)
    v = k("bfly_xor_net")(v, A.perm_B, A.perm_stages) * A.vals
    v = k("bfly_scan")(v, A.scan_guards, A.scan_stages)
    v = k("bfly_xor_net")(v, A.compact_B, A.compact_stages) * A.out_valid
    return _y(A, v)


def _need_cuda(A: Bfly, x: torch.Tensor) -> None:
    if x.device.type != "cuda" or A.device != x.device:
        raise ValueError(f"BFLY/cuda needs the program and x on one CUDA "
                         f"device, got {A.device} and {x.device}")


@register_spmv("BFLY", "torch")
def spmv_bfly_torch(A: Bfly, x: torch.Tensor) -> torch.Tensor:
    """BFLY in plain PyTorch, on any device (the kernels' plain versions;
    the JAX ``xla`` impl's role)."""
    return _chain(A, x, plain=True)


@register_spmv("BFLY", "cuda")
def spmv_bfly_cuda(A: Bfly, x: torch.Tensor) -> torch.Tensor:
    """BFLY through kernel B9, one launch per stage (CUDA tensors only)."""
    _need_cuda(A, x)
    return _chain(A, x, plain=False)


def spmv_bfly_cuda_fused(A: Bfly, x: torch.Tensor) -> torch.Tensor:
    """BFLY through kernel B10, the whole program in phases (CUDA tensors
    only; not registered, as ``spmv_bfly_pallas_fused`` is not)."""
    _need_cuda(A, x)
    v = _spread_x(x.to(A.vals.dtype), A.n, A.N, A.sigma_x)
    return _y(A, K.bfly_full(v, *A.planes()))

