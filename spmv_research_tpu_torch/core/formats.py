"""Device-side sparse formats as frozen dataclasses of torch tensors.

Counterpart of ``spmv_research_tpu/core/formats.py``: CSR (the baseline of
the main path) and the classic formats COO, ELL, SELL-C-σ, BSR, DIA, LDU,
CSC and CSR_SYM, each with the JAX class's ``format_name``, fields and
``mem_footprint_bytes``; the engines' formats live in their ``ops``
modules. A format is built on the host and moved with an explicit
``.to(device)``: there is no default device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def tree_map(fn, obj, leaf=torch.Tensor):
    """``obj`` with ``fn`` applied to every tensor it holds, through nested
    dataclass fields, tuples (e.g. the ``ClosG`` programs of a
    ``ClosGChunked``) and dicts (SELLG's slabs by width); other leaves are
    kept as they are. The role of ``jax.tree_util.tree_map`` over a format
    pytree. ``leaf`` is the type ``fn`` is applied to (the format cache
    maps its skeleton's leaf indices back to tensors with it). A dataclass
    comes back as a fresh ``dataclasses.replace``: nothing a
    ``cached_property`` stored on the old instance is carried over."""
    if isinstance(obj, leaf):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(tree_map(fn, o, leaf) for o in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v, leaf) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name), leaf)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _move(fmt, device):
    """Copy of ``fmt`` with every tensor it holds moved to ``device``."""
    return tree_map(lambda t: t.to(device), fmt)


class _Format:
    """What every format class here shares: its shape, the device of its
    tensors and ``.to``. ``data_fields`` and ``meta_fields`` are the JAX
    class's pytree fields (``format_from_jax`` reads them)."""

    data_fields: Tuple[str, ...] = ("data",)
    meta_fields: Tuple[str, ...] = ("shape", "nnz", "nnz_expanded")

    @property
    def m(self):
        return self.shape[0]

    @property
    def n(self):
        return self.shape[1]

    @property
    def device(self) -> torch.device:
        return getattr(self, self.data_fields[0]).device

    def to(self, device):
        return _move(self, device)


@dataclasses.dataclass(frozen=True)
class CSR(_Format):
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
    data_fields = ("data", "indices", "rows", "indptr")

    @property
    def nnz_pad(self):
        return self.data.shape[0]

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


@dataclasses.dataclass(frozen=True)
class COO(_Format):
    """Padded COO triplets (row-major sorted). Padding: value 0, row m, col 0."""

    data: torch.Tensor  # (nnz_pad,)
    rows: torch.Tensor  # (nnz_pad,) int32
    cols: torch.Tensor  # (nnz_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "COO"
    data_fields = ("data", "rows", "cols")

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.element_size() + 8)


@dataclasses.dataclass(frozen=True)
class ELL(_Format):
    """ELLPACK: rows padded to the max row length (reference ``ell.cpp``).

    Stored row-major ``(m_pad, width)``; padding entries value 0, column 0.
    """

    data: torch.Tensor  # (m_pad, width)
    cols: torch.Tensor  # (m_pad, width) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    width: int

    format_name = "ELL"
    data_fields = ("data", "cols")
    meta_fields = ("shape", "nnz", "nnz_expanded", "width")

    def mem_footprint_bytes(self) -> int:
        m_pad, w = self.data.shape
        return m_pad * w * (self.data.element_size() + 4)


@dataclasses.dataclass(frozen=True)
class SellCS(_Format):
    """SELL-C-σ in a 2-D slab layout (the JAX package's).

    Rows are σ-sorted by length (windowed), grouped into slices of C rows,
    and each slice padded to its own max length L_s (reference
    ``sell.cpp`` / ``sell_sorted.cpp``). One dense slab of shape
    ``(C, total_width)`` holds them, slice s in the column range
    ``[off_s, off_s + L_s)``: every slab column is one step of C rows.

    ``slice_of_col[t]`` gives the slice owning slab column t;
    ``lane_rows[s*C + c]`` the output row of lane c in slice s (m for
    padding lanes, sliced off after the reduction).
    """

    data: torch.Tensor          # (C, total_width)
    cols: torch.Tensor          # (C, total_width) int32
    perm: torch.Tensor          # (m,) int32 σ-sort permutation (new ← old)
    slice_of_col: torch.Tensor  # (total_width,) int32
    lane_rows: torch.Tensor     # (n_slices * C,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    C: int
    sigma: int
    n_slices: int
    total_width: int

    format_name = "SELL-C-s"
    data_fields = ("data", "cols", "perm", "slice_of_col", "lane_rows")
    meta_fields = ("shape", "nnz", "nnz_expanded", "C", "sigma", "n_slices",
                   "total_width")

    def mem_footprint_bytes(self) -> int:
        c, w = self.data.shape
        return c * w * (self.data.element_size() + 4) + self.m * 4


@dataclasses.dataclass(frozen=True)
class BSR(_Format):
    """Block-sparse rows: dense (br × bc) blocks (role of the reference's
    MKL-BSR adapters, block sizes 2..64 — ``Makefile_in:363-374``).

    ``data``: (n_blocks_pad, br, bc); ``block_cols``: block-column index;
    ``block_rows``: block-row index per block (sorted); padding blocks are
    all-zero with block_row = mb.
    """

    data: torch.Tensor          # (n_blocks_pad, br, bc)
    block_cols: torch.Tensor    # (n_blocks_pad,) int32
    block_rowptr: torch.Tensor  # (mb+1,) int32
    block_rows: torch.Tensor    # (n_blocks_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    br: int
    bc: int
    n_blocks: int

    format_name = "BSR"
    data_fields = ("data", "block_cols", "block_rowptr", "block_rows")
    meta_fields = ("shape", "nnz", "nnz_expanded", "br", "bc", "n_blocks")

    def mem_footprint_bytes(self) -> int:
        return (self.n_blocks * self.br * self.bc * self.data.element_size()
                + self.n_blocks * 4 + self.block_rowptr.shape[0] * 4)


@dataclasses.dataclass(frozen=True)
class DIA(_Format):
    """Diagonal storage (reference ``dia.cpp``): ``data[d, i] = A[i,
    i+off_d]``; the offsets are plain ints, so the SpMV is a static loop of
    shifted axpys."""

    data: torch.Tensor  # (n_diags, m)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int
    offsets: Tuple[int, ...]

    format_name = "Custom_DIA"
    meta_fields = ("shape", "nnz", "nnz_expanded", "offsets")

    def mem_footprint_bytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + len(self.offsets) * 4)


@dataclasses.dataclass(frozen=True)
class LDU(_Format):
    """OpenFOAM-style lower/diagonal/upper split storage (reference
    ``ldu.cpp``): one diagonal value per row plus per-face (owner,
    neighbour) coefficient pairs: y[o] += u[f]·x[n]; y[n] += l[f]·x[o]."""

    diag: torch.Tensor       # (m,)
    lower: torch.Tensor      # (n_faces_pad,)
    upper: torch.Tensor      # (n_faces_pad,)
    owner: torch.Tensor      # (n_faces_pad,) int32
    neighbour: torch.Tensor  # (n_faces_pad,) int32
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "LDU"
    data_fields = ("diag", "lower", "upper", "owner", "neighbour")

    def mem_footprint_bytes(self) -> int:
        vb = self.diag.element_size()
        return self.m * vb + self.lower.shape[0] * (2 * vb + 8)


@dataclasses.dataclass(frozen=True)
class CSC(_Format):
    """Compressed-sparse-column as padded column-major triplets (role of
    the reference's MKL_CSC adapter); the SpMV scatters per-column
    contributions into y. Padding: value 0, row m, col 0."""

    data: torch.Tensor  # (nnz_pad,) column-major sorted
    rows: torch.Tensor  # (nnz_pad,) int32 row indices
    cols: torch.Tensor  # (nnz_pad,) int32 column indices (sorted)
    shape: Tuple[int, int]
    nnz: int
    nnz_expanded: int

    format_name = "CSC"
    data_fields = ("data", "rows", "cols")

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.element_size() + 4) + (self.n + 1) * 4


@dataclasses.dataclass(frozen=True)
class CSRSym(_Format):
    """Symmetric SpMV on lower-triangle storage (reference ``csr_sym.cpp``
    "CSR_SYM_CPU"): y = L·x + strict(L)ᵀ·x from the stored triangle only.

    Triplets are row-major sorted; padding: value 0, row m, col 0.
    """

    data: torch.Tensor  # (nnz_pad,) lower-triangle values (incl. diagonal)
    rows: torch.Tensor  # (nnz_pad,) int32
    cols: torch.Tensor  # (nnz_pad,) int32
    shape: Tuple[int, int]
    nnz: int            # stored (triangle) nonzeros
    nnz_expanded: int

    format_name = "CSR_SYM"
    data_fields = ("data", "rows", "cols")

    def mem_footprint_bytes(self) -> int:
        return self.nnz * (self.data.element_size() + 4) + (self.m + 1) * 4


CLASSIC_FORMATS = {cls.format_name: cls
                   for cls in (COO, ELL, SellCS, BSR, DIA, LDU, CSC, CSRSym)}


def format_from_jax(format_name: str, leaves: dict, meta: dict):
    """The port's instance of a classic format built by the JAX package:
    ``format_name`` is the JAX class's (COO, CSC and CSR_SYM share their
    field names), ``leaves`` maps each data field to its array
    (``np.asarray`` of the JAX leaf), ``meta`` each meta field to its
    value. CPU tensors, as a builder returns them."""
    cls = CLASSIC_FORMATS[format_name]
    return cls(**{k: torch.from_numpy(np.array(leaves[k]))
                  for k in cls.data_fields},
               **{k: meta[k] for k in cls.meta_fields})
