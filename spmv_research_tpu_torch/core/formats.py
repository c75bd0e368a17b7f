"""Device-side sparse formats as frozen dataclasses of torch tensors.

Counterpart of ``spmv_research_tpu/core/formats.py``. Only ``CSR`` is ported
here (the baseline of the main path); the engines' formats live in their
``ops`` modules. A format is built on the host and moved with an explicit
``.to(device)``: there is no default device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch


def tree_map(fn, obj):
    """``obj`` with ``fn`` applied to every tensor it holds, through nested
    dataclass fields and tuples (e.g. the ``ClosG`` programs of a
    ``ClosGChunked``); other leaves are kept as they are. The role of
    ``jax.tree_util.tree_map`` over a format pytree."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(tree_map(fn, o) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _move(fmt, device):
    """Copy of ``fmt`` with every tensor it holds moved to ``device``."""
    return tree_map(lambda t: t.to(device), fmt)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Padded CSR (+ explicit per-nnz row ids for the row reduction).

    ``data/indices/rows`` have length ``nnz_pad`` (a tile multiple); padding
    entries have value 0, column 0, row ``m`` (an overflow row sliced off).
    """

    data: torch.Tensor      # (nnz_pad,) values
    indices: torch.Tensor   # (nnz_pad,) int32 column indices
    rows: torch.Tensor      # (nnz_pad,) int32 row indices (sorted)
    indptr: torch.Tensor    # (m+1,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CSR"

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def nnz_pad(self):
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "CSR":
        return _move(self, device)

    def mem_footprint_bytes(self) -> int:
        """True (unpadded) footprint, reference model ``spmv_kernel.h:21-24``."""
        vb = self.data.element_size()
        return self.nnz * (vb + 4) + (self.m + 1) * 4

    @functools.cached_property
    def sparse_csr(self) -> torch.Tensor:
        """The matrix as a ``torch.sparse_csr_tensor`` viewing the live
        entries (no copy, no invariants check), built at first use and
        kept: CSR/sparse's operand. Its build took 30 of a CSR/sparse
        call's 70 µs of host time on an H100 machine (``chip_smoke.py``
        phase 16)."""
        return torch.sparse_csr_tensor(self.indptr, self.indices[:self.nnz],
                                       self.data[:self.nnz], size=self.shape,
                                       check_invariants=False)
