"""OpenFOAM mesh-matrix reader.

Counterpart of ``spmv_research_tpu/io/openfoam.py``, giving its arrays; the
analog of the reference's ``read_openfoam_matrix_dir``
(``lib/storage_formats/openfoam/openfoam_matrix.c:120``): an OpenFOAM LDU
matrix directory contains ``owner`` and ``neighbour`` files listing, per
internal face, the owning and neighbouring cell; the sparse matrix has one
diagonal entry per cell plus one (lower, upper) pair per face:

    A[owner[f], neighbour[f]] = upper coefficient  (upper triangle)
    A[neighbour[f], owner[f]] = lower coefficient  (lower triangle)

Without coefficient files, unit coefficients are used (structure-only), which is
what the reference does for benchmark purposes.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..core.host import HostCOO, INDEX_DTYPE


def _read_foam_label_list(path: str) -> np.ndarray:
    """Parse an OpenFOAM labelList file: optional FoamFile header dict, then
    ``<count> ( v0 v1 ... )``."""
    with open(path, "r") as f:
        text = f.read()
    # strip comments
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//.*", " ", text)
    # strip FoamFile { ... } header if present
    text = re.sub(r"FoamFile\s*\{[^}]*\}", " ", text, flags=re.S)
    mo = re.search(r"(\d+)\s*\(([^)]*)\)", text, flags=re.S)
    if not mo:
        raise ValueError(f"cannot parse OpenFOAM label list: {path}")
    count = int(mo.group(1))
    vals = np.array(mo.group(2).split(), dtype=np.int64)
    if vals.size != count:
        raise ValueError(f"{path}: declared {count} labels, found {vals.size}")
    return vals


def read_openfoam_matrix_dir(dirname: str, with_diagonal: bool = True) -> HostCOO:
    owner = _read_foam_label_list(os.path.join(dirname, "owner"))
    neigh = _read_foam_label_list(os.path.join(dirname, "neighbour"))
    if owner.size != neigh.size:
        # OpenFOAM 'owner' may list boundary faces too; internal faces = len(neighbour)
        owner = owner[: neigh.size]
    ncells = int(max(owner.max(initial=-1), neigh.max(initial=-1)) + 1)

    rows = [owner, neigh]
    cols = [neigh, owner]
    if with_diagonal:
        diag = np.arange(ncells, dtype=np.int64)
        rows.append(diag)
        cols.append(diag)
    r = np.concatenate(rows).astype(INDEX_DTYPE)
    c = np.concatenate(cols).astype(INDEX_DTYPE)
    v = np.ones(r.shape, dtype=np.float64)
    coo = HostCOO(rows=r, cols=c, vals=v, m=ncells, n=ncells)
    coo.validate()
    return coo
