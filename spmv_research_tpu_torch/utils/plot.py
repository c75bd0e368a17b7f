"""Matrix spy plots and structural histograms.

Counterpart of ``spmv_research_tpu/utils/plot.py``. Role of the reference's
pure-C plotting library (``lib/plot/plot.c``, ``csr_plot`` / density-map
hooks — ``csr_util_gen.h:125-150``): visualize a matrix's sparsity pattern
and its structural-feature distributions. matplotlib replaces the PPM
renderer and is imported only by the functions that draw, so the rest of
the port runs where it is not installed (the GPU machine lists none).
"""

from __future__ import annotations

import numpy as np

from ..core.host import HostCSR


def spy_density(csr: HostCSR, bins: int = 512) -> np.ndarray:
    """2-D nnz density map (bins × bins), the reference's density-map plot."""
    rows = np.repeat(np.arange(csr.m), csr.row_lengths())
    r = (rows * bins // max(csr.m, 1)).clip(0, bins - 1)
    c = (csr.ja.astype(np.int64) * bins // max(csr.n, 1)).clip(0, bins - 1)
    H = np.zeros((bins, bins), dtype=np.int64)
    np.add.at(H, (r, c), 1)
    return H


def save_spy(csr: HostCSR, path: str, bins: int = 512, title: str = "") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H = spy_density(csr, bins)
    fig, ax = plt.subplots(figsize=(6, 6))
    with np.errstate(divide="ignore"):
        img = np.log1p(H)
    ax.imshow(img, cmap="viridis", interpolation="nearest")
    ax.set_title(title or f"m={csr.m} n={csr.n} nnz={csr.nnz}")
    ax.set_xlabel("column")
    ax.set_ylabel("row")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_degree_histogram(csr: HostCSR, path: str, title: str = "") -> None:
    """nnz-per-row histogram (reference ``csr_degrees_histogram_plot``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    deg = csr.row_lengths()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(deg, bins=min(100, max(int(deg.max()), 1)), log=True)
    ax.set_xlabel("nnz per row")
    ax.set_ylabel("rows (log)")
    ax.set_title(title or "degree distribution")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
