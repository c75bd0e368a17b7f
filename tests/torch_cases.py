"""Small CLOSG cases shared by the port's tests (no JAX, so the GPU tests
can import them on a machine without it)."""

import atexit
import os
import shutil
import tempfile

import numpy as np
import scipy.sparse as sp
import torch

from spmv_research_tpu_torch.ops.clos import _stage_bit

torch.set_num_threads(1)   # the test workers (pytest -n 6) share the cores

# the format cache of this test process (convert/cache.py reads the
# variable at each call): no test writes under the repository, and no two
# worker processes share entries. A test that monkeypatches a cached
# builder or its constants, or asserts a cold build, sets its own
# tmp_path cache.
os.environ["SPARSE_FORMAT_CACHE_TORCH"] = tempfile.mkdtemp(
    prefix="format_cache_torch_")
atexit.register(shutil.rmtree, os.environ["SPARSE_FORMAT_CACHE_TORCH"], True)

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


# the smallest program a W = 0 chunk fits: a 128-row group of w0_matrix's
# rows spans 66,560 slots, past the 64 window octaves (65,536 slots) of a
# 2^17-slot program
W0_CHUNK_N = 1 << 17


def w0_chunked_matrix():
    """``w0_matrix(600, 520)``: under ``max_N = W0_CHUNK_N`` a ClosGChunked
    of 3 chunks (rows [0, 226), [226, 452), [452, 600): none a multiple of
    128), each with W = 0 and C = 128."""
    return w0_matrix(600, 520)


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


def clos_hi_matrix():
    """Column 5 in 33,000 rows and row 7 with 33,000 columns: a column run
    and a row reach past 2^15, so a CLOS program's fill and scan stages 15
    and up read its fill_hi and scan_hi planes (N = 2^17)."""
    rng = np.random.Generator(np.random.PCG64(5))
    m = n = 34000
    rows = np.concatenate([np.arange(33000), np.full(33000, 7)])
    cols = np.concatenate([np.full(33000, 5), rng.choice(n, 33000, False)])
    mat = sp.coo_matrix((rng.uniform(-1, 1, rows.size), (rows, cols)),
                        shape=(m, n)).tocsr()
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def bfly_pathological():
    """tests/test_bfly.py's pathological matrix: an 80 × 80 3% random
    matrix with row 7 dense and row 20 empty."""
    mat = sp.random(80, 80, 0.03, random_state=0).tolil()
    mat[7, :] = 1.5
    mat[20, :] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.sort_indices()
    return mat


def staged_sellw_matrix(m_short=33024, m_long=1400, run=100, seed=3):
    """A matrix whose SELLW program (part_cap 128) has two stage classes:
    m_short diagonal rows (one-slot parts) and m_long rows of ``run``
    consecutive columns about the diagonal (parts up to 100 lanes, 7
    scan stages)."""
    n = m_short + m_long
    rows, cols = list(range(m_short)), list(range(m_short))
    for r in range(m_short, n):
        c0 = min(max(r - run // 2, 0), n - run)
        rows += [r] * run
        cols += list(range(c0, c0 + run))
    vals = np.random.default_rng(seed).standard_normal(len(rows))
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    mat.sort_indices()
    return mat


def ds_staged_matrix(chunks=160, seed=11):
    """A matrix whose SELLW program (part_cap 128) has a stage class at
    every scan depth 0..7: for each d, rows of 2^d consecutive columns, 128
    / 2^d of them per 128-column x window (one full sublane), about
    ``chunks`` chunks of them; values spread over many magnitudes, as
    ``ds_banded``'s."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    r0 = 0
    for d in range(8):
        L = 1 << d
        n_rows = chunks * 1024 // L
        r = np.arange(n_rows)
        rows.append(np.repeat(r + r0, L))
        cols.append((r[:, None] * L + np.arange(L)).reshape(-1))
        r0 += n_rows
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.uniform(-1, 1, rows.size) * rng.lognormal(0, 3, rows.size)
    return sp.csr_matrix((vals, (rows, cols)), shape=(r0, chunks * 1024))


def btile_special_matrix():
    """``btile_banded(2500, 2500, 12, 200, 1)`` with the special tiles of
    the BTILE SpMM: band 1 (rows [1024, 2048)) empty, so the builder gives
    it a filler step; the tile of rows 8..15 and columns 0..127 full (no
    stored zero); and a live tile of stored zeros only, rows 2048..2055 at
    columns 0..7, far from the band."""
    mat = btile_banded(2500, 2500, 12, 200, 1).tocoo()
    keep = (mat.row < 1024) | (mat.row >= 2048)
    dense_r, dense_c = np.divmod(np.arange(8 * 128), 128)
    rows = np.concatenate([mat.row[keep], dense_r + 8, 2048 + np.arange(8)])
    cols = np.concatenate([mat.col[keep], dense_c, np.arange(8)])
    vals = np.concatenate([mat.data[keep],
                           np.linspace(0.25, 1.0, 1024), np.zeros(8)])
    out = sp.coo_matrix((vals, (rows, cols)), shape=mat.shape).tocsr()
    out.sort_indices()
    return out


def fill_chunks(u, w3, hi, stages, chunk):
    """B8's forward fill over flat slots, the shift rolling within each run
    of ``chunk`` slots (``clos_r3_fill_torch``'s stages, chunk by chunk):
    the reference of the phased fill on a stack of chunks."""
    u, w3, hi = u.view(-1, chunk), w3.reshape(-1, chunk), hi.view(-1, chunk)
    for k in stages:
        u = torch.where(_stage_bit(k, w3, hi), torch.roll(u, 1 << k, dims=1),
                        u)
    return u.reshape(-1, 128)


def random_cand_parts(rng, ms):
    """Random inputs of B6 over programs of ms[i] rows of y: (scr, ycand,
    ysel) each — a scanned plane, C candidate rows of each 128-row group of
    y (C random in 1..128), ysel picking a lane and a candidate."""
    parts = []
    for m in ms:
        m_rows = -(-m // 128)
        C = int(rng.integers(1, 129))
        S = int(rng.integers(8, 40))
        parts.append((
            torch.from_numpy(rng.uniform(-1, 1, (S, 128)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, S, C * m_rows).astype(np.int32)),
            torch.from_numpy((rng.integers(0, 128, (m_rows, 128))
                              | rng.integers(0, C, (m_rows, 128)) << 7
                              ).astype(np.int32))))
    return parts


def random_win_inputs(rng, n_tiles, n_x, dense):
    """Random inputs of B7 over x of n_x and n_tiles 1024-slot tiles:
    (gbase, nbids, perm_r1, vals, x) as numpy arrays — every x block, or a
    sorted 3/4 of them, compacted (nbids); group bases anywhere in the
    compacted plane, the last at its last row, so its windows pass it;
    random words (any rotation) and values."""
    x_rows = -(-n_x // 128)
    nbids = (np.arange(x_rows) if dense else np.sort(
        rng.choice(x_rows, 3 * x_rows // 4, replace=False))).astype(np.int32)
    gbase = rng.integers(0, nbids.size, n_tiles).astype(np.int32)
    gbase[-1] = nbids.size - 1
    S = 8 * n_tiles
    perm_r1 = (rng.integers(0, 128, (S, 128))
               | rng.integers(0, 8, (S, 128)) << 7
               | rng.integers(0, 128, (S, 128)) << 10
               | rng.integers(0, 1 << 15, (S, 128)) << 17
               ).astype(np.uint32).view(np.int32)
    vals = rng.uniform(-1, 1, S * 128).astype(np.float32)
    x = rng.uniform(-1, 1, n_x).astype(np.float32)
    return gbase, nbids, perm_r1, vals, x


def random_lut_inputs(rng, n_tiles, n_x):
    """Random inputs of B4: rowidx anywhere in x's rows (every third one
    the last, partial row, whose window passes n), random words (bit 31
    set at random: the dictionary index is bits [24, 31) only), a random
    (8, 128) dictionary plane whose rows past 0 the kernel must not read,
    and x."""
    x_rows = -(-n_x // 128)
    S = 8 * n_tiles
    rowidx = rng.integers(0, x_rows, S).astype(np.int32)
    rowidx[::3] = x_rows - 1
    perm_r1 = (rng.integers(0, 128, (S, 128))
               | rng.integers(0, 8, (S, 128)) << 7
               | rng.integers(0, 128, (S, 128)) << 10
               | rng.integers(0, 1 << 15, (S, 128)) << 17
               ).astype(np.uint32).view(np.int32)
    dict_plane = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    x = rng.uniform(-1, 1, n_x).astype(np.float32)
    return rowidx, perm_r1, dict_plane, x
