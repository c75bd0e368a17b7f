"""MatrixMarket I/O.

Counterpart of ``spmv_research_tpu/io/matrix_market.py``, giving its
arrays. It reproduces the reference's parallel MTX parser
(``lib/storage_formats/matrix_market/matrix_market.c:258`` ``mtx_read``):

* coordinate real / integer / pattern / complex fields (integer→real,
  complex→real by keeping the real part, pattern→dummy value, matching
  ``mtx_values_convert_to_real`` — ``matrix_market.h:75``), and the dense
  array format, sparsified;
* general / symmetric / skew-symmetric / hermitian symmetries, with optional
  symmetric expansion at read time;
* 1-based to 0-based index conversion.

A coordinate body is parsed by the native library's ``mtx_parse_body``
(``io/native.py``) where it is built, else by splitting the whole buffer
in numpy; both tiers give the same arrays.
"""

from __future__ import annotations

import numpy as np

from ..core.host import HostCOO, INDEX_DTYPE
from . import native as _native


class MTXHeader:
    def __init__(self, fmt: str, field: str, symmetry: str):
        self.format = fmt  # coordinate | array
        self.field = field  # real | integer | pattern | complex
        self.symmetry = symmetry  # general | symmetric | skew-symmetric | hermitian


def _parse_header(line: bytes) -> MTXHeader:
    parts = line.decode().strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket" or parts[1] != "matrix":
        raise ValueError(f"not a MatrixMarket file: header {line!r}")
    return MTXHeader(parts[2].lower(), parts[3].lower(), parts[4].lower())


def mtx_read(
    path: str,
    expand_symmetry: bool = True,
    pattern_dummy_value: float = 1.0,
    keep_diagonal: bool = True,
) -> HostCOO:
    """Read a MatrixMarket coordinate file into :class:`HostCOO`.

    ``expand_symmetry`` mirrors the reference flag: symmetric/skew/hermitian
    inputs are expanded to full storage (both triangles); when False the stored
    (lower) triangle is kept and ``HostCOO.symmetric`` is set.
    """
    with open(path, "rb") as f:
        data = f.read()

    # Header
    nl = data.index(b"\n")
    header = _parse_header(data[:nl])
    if header.format != "coordinate":
        return _read_array_mtx(data, nl, header)

    # Skip comment lines
    pos = nl + 1
    while pos < len(data) and data[pos : pos + 1] == b"%":
        pos = data.index(b"\n", pos) + 1
    # Size line
    nl2 = data.index(b"\n", pos)
    m, n, nnz_decl = (int(t) for t in data[pos:nl2].split())
    body = data[nl2 + 1 :]

    if header.field == "pattern":
        cols_per_line = 2
    elif header.field == "complex":
        cols_per_line = 4
    else:
        cols_per_line = 3

    if _native.have_native():
        rows, cols, vals = _native.mtx_parse_body(body, nnz_decl, cols_per_line)
        if header.field == "pattern":
            vals = np.full(rows.shape, pattern_dummy_value, dtype=np.float64)
    else:
        flat = np.array(body.split(), dtype=np.float64)
        if flat.size % cols_per_line != 0:
            raise ValueError("malformed MTX body")
        table = flat.reshape(-1, cols_per_line)
        if table.shape[0] != nnz_decl:
            raise ValueError(
                f"MTX declares {nnz_decl} entries, found {table.shape[0]}")
        rows = table[:, 0].astype(INDEX_DTYPE) - 1
        cols = table[:, 1].astype(INDEX_DTYPE) - 1
        if header.field == "pattern":
            vals = np.full(rows.shape, pattern_dummy_value, dtype=np.float64)
        else:
            vals = table[:, 2].astype(np.float64)  # complex: real part (ref semantics)

    symmetric = header.symmetry in ("symmetric", "skew-symmetric", "hermitian")
    # skew/hermitian storage carries a sign on the mirrored triangle that
    # HostCOO.symmetric (plain symmetric) cannot represent — always expand
    if header.symmetry in ("skew-symmetric", "hermitian"):
        expand_symmetry = True
    if symmetric and expand_symmetry:
        off = rows != cols
        orows, ocols, ovals = rows[off], cols[off], vals[off]
        if header.symmetry == "skew-symmetric":
            ovals = -ovals
        rows = np.concatenate([rows, ocols])
        cols = np.concatenate([cols, orows])
        vals = np.concatenate([vals, ovals])
        symmetric = False

    if not keep_diagonal:
        on = rows != cols
        rows, cols, vals = rows[on], cols[on], vals[on]

    coo = HostCOO(rows=rows, cols=cols, vals=vals, m=m, n=n, symmetric=symmetric)
    coo.validate()
    return coo


def _read_array_mtx(data: bytes, nl: int, header: MTXHeader) -> HostCOO:
    """Dense 'array' format — read and sparsify (rare; completeness)."""
    pos = nl + 1
    while data[pos : pos + 1] == b"%":
        pos = data.index(b"\n", pos) + 1
    nl2 = data.index(b"\n", pos)
    m, n = (int(t) for t in data[pos:nl2].split())
    vals = np.array(data[nl2 + 1 :].split(), dtype=np.float64)
    if header.symmetry in ("symmetric", "skew-symmetric"):
        # array-symmetric stores the lower triangle column by column
        # (m*(m+1)/2 values), so reshape-to-dense does not apply
        full = np.zeros((m, n))
        k = 0
        for j in range(n):
            cnt = m - j
            full[j:, j] = vals[k : k + cnt]
            k += cnt
        sgn = -1.0 if header.symmetry == "skew-symmetric" else 1.0
        dense = full + sgn * np.triu(full.T, 1)
    else:
        dense = vals.reshape(n, m).T  # column-major per MTX spec
    r, c = np.nonzero(dense)
    return HostCOO(
        rows=r.astype(INDEX_DTYPE),
        cols=c.astype(INDEX_DTYPE),
        vals=dense[r, c],
        m=m,
        n=n,
    )


def mtx_write(path: str, coo: HostCOO, field: str = "real", comment: str = "") -> None:
    """Write HostCOO as a coordinate MTX file (reference `mtx_write` analog)."""
    with open(path, "w") as f:
        sym = "general"
        f.write(f"%%MatrixMarket matrix coordinate {field} {sym}\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.m} {coo.n} {coo.nnz}\n")
        if field == "pattern":
            arr = np.stack([coo.rows + 1, coo.cols + 1], axis=1)
            np.savetxt(f, arr, fmt="%d %d")
        else:
            np.savetxt(
                f,
                np.stack([coo.rows + 1, coo.cols + 1, coo.vals], axis=1),
                fmt="%d %d %.17g",
            )
