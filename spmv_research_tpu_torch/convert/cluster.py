"""Row-clustering locality reordering (k-means over row features).

Counterpart of ``spmv_research_tpu/convert/cluster.py``, the same numpy
steps (seeded PCG64 draw of the first centres, ``argmin`` assignment, a
stable ``argsort`` of the clusters and a ``lexsort`` of the rows), so the
permutation is array-identical to the JAX package's. Role of the
reference's ``lib/kmeans`` (``kmeans.h:9-12``, kmeans2_csr/csc — row
clustering for locality-reordering experiments): group rows with similar
column footprints so adjacent rows share x-windows, improving gather
locality for windowed/slab kernels and shrinking routed spans for BFLY.
"""

from __future__ import annotations

import numpy as np

from ..core.host import HostCSR
from .coo_csr import csr_row_permute


def row_feature_vectors(csr: HostCSR) -> np.ndarray:
    """Per-row features: (mean column, column spread, log degree)."""
    lengths = csr.row_lengths().astype(np.float64)
    m = csr.m
    mean_col = np.zeros(m)
    rows = np.repeat(np.arange(m), csr.row_lengths())
    sums = np.zeros(m)
    np.add.at(sums, rows, csr.ja.astype(np.float64))
    nz = lengths > 0
    mean_col[nz] = sums[nz] / lengths[nz]
    mn = np.full(m, np.inf)
    mx = np.full(m, -np.inf)
    np.minimum.at(mn, rows, csr.ja.astype(np.float64))
    np.maximum.at(mx, rows, csr.ja.astype(np.float64))
    spread = np.where(np.isfinite(mn), mx - mn, 0.0)
    n = max(csr.n, 1)
    return np.stack([mean_col / n, spread / n,
                     np.log1p(lengths) / np.log1p(max(lengths.max(), 1))],
                    axis=1)


def kmeans_rows(csr: HostCSR, k: int = 16, iters: int = 20,
                seed: int = 0) -> np.ndarray:
    """Cluster rows; returns a permutation grouping rows by cluster (clusters
    ordered by mean column so the global order stays roughly diagonal)."""
    feats = row_feature_vectors(csr)
    rng = np.random.Generator(np.random.PCG64(seed))
    k = min(k, max(csr.m, 1))
    centers = feats[rng.choice(csr.m, k, replace=False)] if csr.m >= k else feats
    for _ in range(iters):
        d = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for c in range(centers.shape[0]):
            sel = assign == c
            if sel.any():
                centers[c] = feats[sel].mean(0)
    order_clusters = np.argsort(centers[:, 0], kind="stable")
    rank = np.empty_like(order_clusters)
    rank[order_clusters] = np.arange(order_clusters.size)
    # rows sorted by (cluster rank, mean col within cluster)
    perm = np.lexsort((feats[:, 0], rank[assign]))
    return perm.astype(np.int64)


def kmeans_reorder(csr: HostCSR, k: int = 16, **kw):
    """``(csr with its rows in kmeans_rows' order, the permutation)``: new
    row i is old row ``perm[i]``; the columns keep their labels, so
    ``y_new = y_old[perm]`` for the same x."""
    perm = kmeans_rows(csr, k=k, **kw)
    return csr_row_permute(csr, perm, permute_columns=False), perm
