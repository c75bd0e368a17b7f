"""Small CLOSG cases shared by the port's tests (no JAX, so the GPU tests
can import them on a machine without it)."""

import numpy as np
import scipy.sparse as sp

# bench.py's scircuit twin line, cut to 2000 rows (V=16, W=2, capped scan
# with 10 accumulate records)
TWIN_LINE = ("2000 2000 5.6 4.39 normal random 0.297 61.9 0.803 0.633 14 "
             "scircuit_twin")


def capped_scan_matrix(seed=1234):
    """tests/test_clos_gather.py:117's matrix: 3-nnz rows plus 5 rows of 600
    nnz, so the scan is capped and accumulate classes appear."""
    rng = np.random.Generator(np.random.PCG64(seed))
    m = n = 4000
    rows, cols = [], []
    for i in range(m):
        k = 600 if i in (17, 901, 902, 2500, 3999) else 3
        rows.append(np.full(k, i))
        cols.append(rng.choice(n, k, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.uniform(-1, 1, rows.shape[0])
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


# datasets/validation_twins.txt's shipsec1 line (the SuiteSparse DNVS
# ship-section FEM matrix), cut to 2000 rows: banded, so SELLR and SELLW
# both accept it
BANDED_LINE = ("2000 2000 55.4637761404 11.0748106399 normal random "
               "0.0458755451 0.8390381452 1.7123850245 0.8734443677 14 "
               "shipsec1_twin")


def banded_matrix(m, n, band, nnzpr_hi, seed):
    """tests/test_sellr.py's _band: rows of 1..nnzpr_hi-1 random columns in
    a window of ``band`` columns that follows the diagonal."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(m):
        k = rng.integers(1, nnzpr_hi)
        c0 = max(0, min(n - 1 - band, int(r * n / m) - band // 2))
        cs = np.unique(rng.integers(c0, min(c0 + band, n), k))
        rows += [r] * len(cs)
        cols += list(cs)
    vals = np.random.default_rng(seed + 1).standard_normal(len(rows))
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    mat.sort_indices()
    return mat


def btile_banded(m, n, nnz_row, bw, seed):
    """tests/test_btile.py's _banded: nnz_row entries per row within bw
    columns of the scaled diagonal, values uniform in [0.1, 1)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_row)
    ctr = (rows * n) // max(m, 1)
    cols = np.clip(ctr + rng.integers(-bw, bw + 1, rows.size), 0, n - 1)
    vals = rng.uniform(0.1, 1.0, rows.size)
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def dirty_sellr_matrix():
    """tests/test_sellr.py:78's matrix: a band plus one 1900-nnz row, whose
    128-lane parts land far from their target sublanes, so SELLR needs
    wrap rolls and dirty (one-by-one flushed) chunks."""
    mat = banded_matrix(2000, 2000, 150, 7, 6).tolil()
    mat[500, :1900] = 1.5
    mat = mat.tocsr()
    mat.sort_indices()
    return mat


def tridiagonal(n, seed):
    """Seeded n×n tridiagonal matrix, values uniform in [-1, 1)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    diags = [rng.uniform(-1, 1, n - 1), rng.uniform(-1, 1, n),
             rng.uniform(-1, 1, n - 1)]
    mat = sp.diags(diags, [-1, 0, 1], shape=(n, n), format="csr")
    mat.sort_indices()
    return mat


def scattered_matrix(seed=5):
    """2000 × 200000, 6 uniformly scattered nnz per row: no column
    locality, so SELLR and SELLW refuse it."""
    rng = np.random.Generator(np.random.PCG64(seed))
    m, n, k = 2000, 200000, 6
    cols = np.sort(rng.choice(n, (m, k)), axis=1).reshape(-1)
    mat = sp.csr_matrix((rng.uniform(-1, 1, m * k), cols,
                         np.arange(0, m * k + 1, k)), shape=(m, n))
    mat.sum_duplicates()
    return mat


def w0_matrix(m=130, k=520, heavy=0, seed=3):
    """m rows of k distinct random columns each over max(4096, heavy)
    columns (the middle row holds ``heavy`` nnz instead, if given). The row
    ends of one 128-row group lie k/128 slot rows apart, so with k = 520 a
    group spans more than 64 window octaves and CLOSG builds its W = 0
    (candidate-plane) back end; a row past 2^15 nnz needs scan stage 15,
    whose guards live in the scan_hi plane."""
    rng = np.random.Generator(np.random.PCG64(seed))
    n = max(4096, heavy)
    rows, cols = [], []
    for i in range(m):
        kk = heavy if heavy and i == m // 2 else k
        rows.append(np.full(kk, i))
        cols.append(rng.choice(n, kk, replace=False))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    mat = sp.csr_matrix((rng.uniform(-1, 1, rows.size), (rows, cols)),
                        shape=(m, n))
    mat.sort_indices()
    return mat


def random_matrix(m, n, density, seed, levels=0):
    """Seeded uniform random m × n matrix, values uniform in [-1, 1), or
    drawn from ``levels`` seeded values (a quantised matrix)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    mat = sp.random(m, n, density=density, format="csr",
                    random_state=np.random.RandomState(seed),
                    data_rvs=lambda s: rng.uniform(-1, 1, s))
    if levels:
        mat.data = rng.choice(rng.uniform(-1, 1, levels), mat.nnz)
    mat.sort_indices()
    return mat


def skewed_matrix(seed=1234):
    """tests/test_rowsplit.py's _skewed_host: a sparse 600 × 600 background
    plus rows of 1500 (capped at 600 columns), 900, 641 and 100 nnz."""
    rng = np.random.Generator(np.random.PCG64(seed))
    m = n = 600
    bg = sp.random(m, n, density=0.004, random_state=np.random.RandomState(3),
                   format="lil")
    for r, deg in ((7, 1500), (200, 900), (599, 641), (300, 100)):
        cols = rng.choice(n, size=min(deg, n), replace=False)
        bg[r, cols] = rng.uniform(0.5, 1.0, cols.size)
    mat = bg.tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def skewed_xl_matrix():
    """3000 × 800 uniform background plus three rows of 700 nnz: past a
    lowered split threshold of 512, and at max_N = 8192 the split matrix
    needs several chunks (RSPLIT over CLOSGX with max_chunks = 1)."""
    mat = random_matrix(3000, 800, 0.01, 9).tolil()
    rng = np.random.Generator(np.random.PCG64(10))
    for r in (5, 1700, 2999):
        cols = rng.choice(800, 700, replace=False)
        mat[r, cols] = rng.uniform(-1, 1, 700)
    mat = mat.tocsr()
    mat.sort_indices()
    return mat


def rel_err(mat, x, y):
    """max |y − A·x| / (|A|·|x|), in float64."""
    x = np.asarray(x, np.float64)
    scale = np.abs(mat) @ np.abs(x) + 1e-30
    return float(np.max(np.abs(np.asarray(y, np.float64) - mat @ x) / scale))


def ds_banded(m=2500, max_k=50, seed=0, lognormal=True):
    """tests/test_sellw_ds.py's _banded: rows of 1..max_k-1 columns within
    ±250 of the diagonal, values uniform in [-1, 1) and, with
    ``lognormal``, spread over many magnitudes (the double-single
    formats' test matrix)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        k = int(rng.integers(1, max_k))
        c = np.clip(i + rng.integers(-250, 250, k), 0, m - 1)
        v = rng.uniform(-1, 1, k)
        if lognormal:
            v = v * rng.lognormal(0, 3, k)
        rows += [i] * k
        cols += c.tolist()
        vals += v.tolist()
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return mat
