"""The benchmark's matrices: a frozen copy of the suite's twin generator and
of the two SPD transforms, and their on-disk cache.

The generator is the port's ``gen/artificial.py`` (itself the JAX
package's, bit for bit), copied without its feature extraction: a table
line of the reference's twin table (``benchmark_code/BENCH/config.sh``,
``datasets/validation_twins.txt``) and its seed give the same matrix as the
port's generator. It is frozen here so that a later change to the program
cannot change the matrices it is measured on.

Transforms (a configuration names one):

* ``make_spd``: the port's ``convert/coo_csr.py:make_spd``, (A + Aᵀ)/2 off
  the diagonal, the diagonal set to the off-diagonal row 1-norm + 1
  (``bench_cg.cpp``'s SPD role);
* ``mirror_spd``: the strictly lower triangle mirrored, L + Lᵀ, with the
  same diagonal rule. It keeps the table line's density where
  (A + Aᵀ)/2 would nearly double it.

A matrix is cached as an uncompressed ``.npz`` (``ia``, ``ja``, ``a``,
``shape``) in ``benchmark/.cache/matrices/``, keyed by the configuration
file's bytes and this file's source, so that an edit to either makes a new
entry. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(HERE, ".cache", "matrices")


@dataclasses.dataclass
class Csr:
    """A CSR matrix on the host: int32 ``ia`` (m + 1) and ``ja``, float64
    ``a``."""
    ia: np.ndarray
    ja: np.ndarray
    a: np.ndarray
    m: int
    n: int

    @property
    def nnz(self) -> int:
        return int(self.ja.shape[0])

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.m, dtype=np.int64),
                         np.diff(self.ia.astype(np.int64)))

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.a, self.ja, self.ia),
                             shape=(self.m, self.n))

    @staticmethod
    def from_scipy(mat) -> "Csr":
        mat = mat.tocsr()
        mat.sort_indices()
        return Csr(ia=np.asarray(mat.indptr, dtype=np.int32),
                   ja=np.asarray(mat.indices, dtype=np.int32),
                   a=np.asarray(mat.data, dtype=np.float64),
                   m=int(mat.shape[0]), n=int(mat.shape[1]))


# --- the twin generator (frozen copy) ---------------------------------------

@dataclasses.dataclass
class TwinParams:
    nr_rows: int
    nr_cols: int
    avg_nnz_per_row: float
    std_nnz_per_row: float
    distribution: str = "normal"
    placement: str = "random"
    bw: float = 1.0
    skew: float = 0.0
    avg_num_neighbours: float = 0.0
    cross_row_similarity: float = 0.0
    seed: int = 14

    @staticmethod
    def from_line(line: str) -> "TwinParams":
        a = line.split()
        return TwinParams(int(a[0]), int(a[1]), float(a[2]), float(a[3]),
                          str(a[4]), str(a[5]), float(a[6]), float(a[7]),
                          float(a[8]), float(a[9]), int(float(a[10])))


def _sample_row_lengths(p: TwinParams, rng) -> np.ndarray:
    avg, std = p.avg_nnz_per_row, max(p.std_nnz_per_row, 1e-12)
    if p.distribution == "normal":
        snd = rng.normal(loc=avg, scale=std, size=p.nr_rows)
    elif p.distribution == "gamma":
        snd = rng.gamma(shape=(avg * avg) / (std * std), scale=(std * std) / avg,
                        size=p.nr_rows)
    else:
        raise ValueError(f"unknown distribution {p.distribution!r}")
    lengths = np.abs(snd).astype(np.int64)
    np.minimum(lengths, p.nr_cols, out=lengths)

    target_max = int(round(avg * (1.0 + max(p.skew, 0.0))))
    target_max = min(max(target_max, 1), p.nr_cols)

    if std > 1.5 * avg and p.skew > 10 and target_max > 4 * avg and p.nr_rows > 1:
        V = p.nr_rows * std * std
        rho = 0.8
        lvl_f = target_max * rho ** np.arange(64, dtype=np.float64)
        lvl_f = lvl_f[lvl_f >= max(2.0 * avg, 2.0)]
        if lvl_f.size == 0:
            lvl_f = np.array([float(target_max)])
        tot_sq = float(np.sum(lvl_f * lvl_f))
        if tot_sq < V:
            mult = min(int(np.ceil(V / tot_sq)), max(p.nr_rows // 128, 1))
            lvl_f = np.repeat(lvl_f, mult)
            lvl_f[::-1].sort()
        h = int(np.searchsorted(np.cumsum(lvl_f * lvl_f), V)) + 1
        h = min(h, lvl_f.size, max(p.nr_rows // 20, 1))
        h_mass = int(np.searchsorted(np.cumsum(lvl_f[:h]),
                                     0.9 * avg * p.nr_rows))
        h = max(min(h, max(h_mass, 1)), 1)
        heavy = np.round(lvl_f[:h]).astype(np.int64)
        mu_l = max(avg - heavy.sum() / p.nr_rows, 0.05 * avg)
        lengths = np.abs(
            rng.normal(loc=mu_l, scale=mu_l / 2.0, size=p.nr_rows)
        ).astype(np.int64)
        np.minimum(lengths, p.nr_cols, out=lengths)
        heavy_rows = rng.choice(p.nr_rows, size=h, replace=False)
        lengths[heavy_rows] = heavy
        return lengths

    if p.skew > 0 and p.nr_rows > 0:
        np.minimum(lengths, target_max, out=lengths)
        cur_max = int(lengths.max()) if lengths.size else 0
        if target_max > cur_max:
            n_heavy = max(1, p.nr_rows // 10000)
            heavy_rows = rng.choice(p.nr_rows, size=n_heavy, replace=False)
            scale = np.geomspace(1.0, max(avg, 1.0) / target_max, n_heavy)
            lengths[heavy_rows] = np.maximum(
                lengths[heavy_rows], (target_max * scale).astype(np.int64))
    return lengths


def _window_bounds(p: TwinParams, lengths: np.ndarray):
    m, n = p.nr_rows, p.nr_cols
    diag = np.arange(m, dtype=np.float64) * (n / max(m, 1))
    placement = p.placement
    d_f = 0.5
    if placement.startswith("diagonal_"):
        d_f = float(placement.split("_", 1)[1])
        placement = "diagonal"
    if placement == "diagonal":
        half = np.maximum(lengths / max(d_f, 1e-6), lengths)
        w0 = np.floor(diag - half)
        w1 = np.ceil(diag + half) + 1
    elif placement == "simple":
        w0 = np.floor(diag)
        w1 = w0 + np.maximum(lengths, 1)
    else:
        t = min(max(p.avg_num_neighbours, 0.0), 1.98)
        run_len = 2.0 / (2.0 - t)
        g = np.maximum(np.round(lengths / run_len), 1.0)
        inflate = np.where(g >= 2, (g + 1.0) / np.maximum(g - 1.0, 1.0), 1.0)
        W = np.maximum(np.round(p.bw * n * inflate),
                       np.maximum(lengths, 1).astype(np.float64))
        w0 = np.round(diag - W / 2.0)
        w1 = w0 + W
    w0 = np.clip(w0, 0, None)
    shift = np.clip(w1 - n, 0, None)
    w0 = np.clip(w0 - shift, 0, None)
    w1 = np.clip(w1, None, n)
    return w0.astype(np.int64), w1.astype(np.int64)


def _dedupe_sorted_rows(cols: np.ndarray, lengths: np.ndarray, n: int) -> np.ndarray:
    total = cols.size
    if total == 0:
        return cols
    live = lengths > 0
    row_of = np.repeat(np.arange(lengths.size)[live], lengths[live])
    starts = np.cumsum(lengths) - lengths
    pos = np.arange(total) - starts[row_of]
    base = np.int64(n + 2)
    d = (cols.astype(np.int64) - pos) + row_of * base
    np.maximum.accumulate(d, out=d)
    r = (d - row_of * base) + pos
    np.minimum(r, (np.int64(n) - lengths[row_of]) + pos, out=r)
    return r


def _place_columns(p: TwinParams, lengths: np.ndarray, rng) -> np.ndarray:
    m, n = p.nr_rows, p.nr_cols
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int32)
    w0, w1 = _window_bounds(p, lengths)
    wsize = np.maximum(w1 - w0, 1)
    t = min(max(p.avg_num_neighbours, 0.0), 1.98)
    run_len = 2.0 / (2.0 - t)
    nruns = np.maximum(np.round(lengths / run_len).astype(np.int64), 1)
    nruns = np.minimum(nruns, np.maximum(lengths, 1))
    base = lengths // nruns
    rem = lengths - base * nruns
    total_runs = int(nruns.sum())
    run_row = np.repeat(np.arange(m), nruns)
    run_rank = np.arange(total_runs) - np.repeat(np.cumsum(nruns) - nruns,
                                                 nruns)
    run_lengths = base[run_row] + (run_rank < rem[run_row]).astype(np.int64)
    u = rng.random(total_runs)
    span = np.maximum(wsize[run_row] - run_lengths, 1)
    run_starts = w0[run_row] + np.floor(u * span).astype(np.int64)
    nnz_run = np.repeat(np.arange(total_runs), run_lengths)
    offs = np.arange(total) - np.repeat(np.cumsum(run_lengths) - run_lengths,
                                        run_lengths)
    cols = run_starts[nnz_run] + offs
    s = min(max(p.cross_row_similarity, 0.0), 1.0)
    row_of = np.repeat(np.arange(m), lengths)
    if s > 0 and m > 1:
        block_len = 16
        starts = np.concatenate([[0], np.cumsum(lengths)])
        head = (np.arange(m) // block_len) * block_len
        ncopy = np.ceil(s * lengths).astype(np.int64)
        ncopy = np.minimum(ncopy, lengths[head])
        pos_in_row = np.arange(total) - starts[row_of]
        copy_mask = (pos_in_row < ncopy[row_of]) & (row_of != head[row_of])
        src = starts[head[row_of]] + pos_in_row
        cols = np.where(copy_mask, cols[np.clip(src, 0, total - 1)], cols)
    cols = np.clip(cols, 0, n - 1)
    order = np.lexsort((cols, row_of))
    cols = _dedupe_sorted_rows(cols[order], lengths, n)
    return cols.astype(np.int32)


def generate_twin(line: str) -> Csr:
    """The twin of one table line (nr_rows nr_cols avg std distribution
    placement bw skew neighbours similarity seed [name])."""
    p = TwinParams.from_line(line)
    rng = np.random.Generator(np.random.PCG64(p.seed))
    lengths = _sample_row_lengths(p, rng)
    cols = _place_columns(p, lengths, rng)
    ia = np.zeros(p.nr_rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=ia[1:])
    vals = rng.uniform(0.01, 1.0, size=cols.size)
    return Csr(ia=ia.astype(np.int32), ja=cols, a=vals, m=p.nr_rows,
               n=p.nr_cols)


# --- the SPD transforms ------------------------------------------------------

def _with_dominant_diagonal(B) -> Csr:
    """B (scipy, zero diagonal) plus diag(off-diagonal row 1-norm + 1)."""
    import scipy.sparse as sp
    B = B.tocsr()
    B.setdiag(0)
    B.eliminate_zeros()
    d = np.asarray(np.abs(B).sum(axis=1)).ravel() + 1.0
    return Csr.from_scipy((B + sp.diags(d)).tocsr())


def make_spd(csr: Csr) -> Csr:
    """(A + Aᵀ)/2 off the diagonal, diagonal = off-diagonal row 1-norm + 1."""
    S = csr.to_scipy()
    return _with_dominant_diagonal((S + S.T) * 0.5)


def mirror_spd(csr: Csr) -> Csr:
    """L + Lᵀ of the strictly lower triangle L, with make_spd's diagonal."""
    import scipy.sparse as sp
    L = sp.tril(csr.to_scipy(), k=-1).tocsr()
    return _with_dominant_diagonal(L + L.T)


TRANSFORMS = {"make_spd": make_spd, "mirror_spd": mirror_spd}


# --- the cache ---------------------------------------------------------------

def cache_path(config_file: str) -> str:
    h = hashlib.sha256()
    with open(config_file, "rb") as f:
        h.update(f.read())
    with open(os.path.abspath(__file__), "rb") as f:
        h.update(f.read())
    name = os.path.splitext(os.path.basename(config_file))[0]
    return os.path.join(CACHE_DIR, f"{name}_{h.hexdigest()[:16]}.npz")


def build_matrix(config: dict) -> Csr:
    """The configuration's matrix: its twin line through its transform."""
    return TRANSFORMS[config["transform"]](generate_twin(config["twin_line"]))


def load_matrix(config: dict, config_file: str) -> Csr:
    """The configuration's matrix from the cache, made and saved on a miss."""
    path = cache_path(config_file)
    if os.path.exists(path):
        with np.load(path) as z:
            m, n = (int(v) for v in z["shape"])
            return Csr(ia=z["ia"], ja=z["ja"], a=z["a"], m=m, n=n)
    csr = build_matrix(config)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    np.savez(tmp, ia=csr.ia, ja=csr.ja, a=csr.a,
             shape=np.array([csr.m, csr.n], dtype=np.int64))
    os.replace(tmp, path)
    return csr
