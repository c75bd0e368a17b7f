"""The distributed layer's test matrices and its spawned gloo runs.

No JAX here: the rank processes (``torch_dist_worker.py``) import this
module too. ``dist_runs`` starts k rank processes on a ``FileStore``
under pytest's temporary directory (never a fixed port), each through
``subprocess`` with a 120 s limit, and loads what rank 0 wrote: every
case's global y (one array a case, ``<case>`` keys) and the weak-scaling
dict. A run is made once a pytest session and k: the xdist workers share
it through a lock file in the session's temporary root.
"""

import fcntl
import json
import os
import subprocess
import sys

import numpy as np
import scipy.sparse as sp

from torch_cases import banded_matrix, random_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
SPAWN_TIMEOUT = 120
KS = (2, 4)
CHUNK_N = 1 << 14
CHUNK_N_LOCAL = 1 << 13     # tests/test_dist_overlap.py's, for its case
CHUNK_N_MULTI = 1 << 13     # several chunks a shard


def csr_case():
    """tests/test_parallel.py's random_host_csr(400, 400, 0.04)."""
    return random_matrix(400, 400, 0.04, 21)


def skewed_case():
    """tests/test_parallel.py's skewed-rows matrix: one dense row."""
    base = sp.random(300, 300, 0.02, random_state=0).tolil()
    base[5, :] = 1.0
    mat = base.tocsr()
    mat.sort_indices()
    return mat


def col_case():
    """tests/test_parallel.py's psum_scatter matrix (320 × 320, 0.05)."""
    return random_matrix(320, 320, 0.05, 22)


def spd_case(m=256):
    """tests/test_parallel.py's CG matrix: A·Aᵀ + m·I."""
    a = sp.random(m, m, 0.03, random_state=1)
    spd = (a @ a.T + sp.identity(m) * m).tocsr()
    spd.sort_indices()
    return spd


def ring_case():
    """tests/test_dist_overlap.py's ring matrix (1600, 0.01, seed 5)."""
    mat = sp.random(1600, 1600, 0.01, random_state=np.random.RandomState(5),
                    format="csr")
    mat.sort_indices()
    return mat


def col_skewed_case(m=1024):
    """Every column in the first 64: at k = 8 the ring's block layout
    passes its blow-up budget (none is built, the masked body runs)."""
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(m), 4)
    cols = rng.integers(0, 64, rows.size)
    mat = sp.csr_matrix((rng.uniform(-1, 1, rows.size), (rows, cols)),
                        shape=(m, m))
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def sellr_case():
    """tests/test_dist_sellr.py's banded matrix cut to 1000 rows."""
    return banded_matrix(1000, 1000, 300, 8, 11)


def sellr_empty_case():
    """Columns only in the first fifth: at k = 2 and 4 some column blocks
    hold no nnz, so psum_scatter and ring get empty programs."""
    mat = banded_matrix(1000, 200, 60, 6, 12)
    return sp.csr_matrix((mat.data, mat.indices, mat.indptr),
                         shape=(1000, 1000))


def closgx_case():
    """tests/test_dist_closgx.py's scattered matrix cut to 1000 rows."""
    rng = np.random.RandomState(3)
    mat = sp.random(1000, 1000, density=0.004, format="csr",
                    random_state=rng,
                    data_rvs=lambda k: rng.uniform(-1, 1, k))
    mat.sort_indices()
    return mat


def closgx_local_case():
    """tests/test_dist_overlap.py's empty-local-blocks matrix (every
    column in rank 0's x block) at 1000 rows."""
    m = 1000
    rng = np.random.default_rng(4)
    rows = rng.integers(0, m, 2000)
    cols = rng.integers(0, 120, 2000)
    mat = sp.csr_matrix((rng.standard_normal(2000), (rows, cols)),
                        shape=(m, m))
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def closgx_rect_case():
    """tests/test_dist_closgx.py's skewed rectangular matrix, 1200 × 900."""
    rng = np.random.default_rng(11)
    m, n = 1200, 900
    rows, cols = [], []
    for r in range(m):
        deg = min(1 + int(rng.pareto(1.2)), 200)
        cs = rng.integers(0, n, deg)
        rows += [r] * len(cs)
        cols += cs.tolist()
    mat = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                        shape=(m, n))
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def closgx_multichunk_case():
    """6000 × 6000, three quarters of the nnz in the first third of the
    rows: at k = 2 and 4 and chunks of 2^13 slots the shards hold several
    chunks each, of unequal row counts (mrp), so the padded stack must
    renumber each shard's ymap."""
    rng = np.random.RandomState(3)
    rows = np.concatenate([rng.randint(0, 2000, 30000),
                           rng.randint(2000, 6000, 12000)])
    cols = rng.randint(0, 6000, rows.size)
    mat = sp.csr_matrix((rng.uniform(-1, 1, rows.size), (rows, cols)),
                        shape=(6000, 6000))
    mat.sum_duplicates()
    mat.sort_indices()
    return mat


def dryrun_sellr_case(k):
    """__graft_entry__.dryrun_multichip's banded matrix, m = 1024·k."""
    m = 1024 * k
    rng = np.random.default_rng(5)
    rows, cols = [], []
    band = 4 * 128
    for r in range(m):
        kk = int(rng.integers(1, 6))
        c0 = max(0, min(m - 1 - band, r - band // 2))
        cs = np.unique(rng.integers(c0, c0 + band, kk))
        rows += [r] * len(cs)
        cols += cs.tolist()
    mat = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                        shape=(m, m))
    mat.sort_indices()
    return mat


def x_for(mat, seed=1):
    return np.random.default_rng(seed).standard_normal(mat.shape[1])


def near(y, want, tol):
    """max |y − want| ≤ tol · max |want|."""
    y, want = np.asarray(y, np.float64), np.asarray(want, np.float64)
    assert y.shape == want.shape
    err = float(np.abs(y - want).max() / max(np.abs(want).max(), 1e-30))
    assert err <= tol, f"max |y - want| / max |want| = {err} > {tol}"
    return err


def spawn(k, out_dir, argv=(), timeout=SPAWN_TIMEOUT):
    """Run ``torch_dist_worker.py`` as k gloo ranks on a FileStore in
    ``out_dir``; returns rank 0's stdout. A rank that fails or passes the
    time limit fails the run (the others are killed)."""
    store = os.path.join(out_dir, "store")
    if os.path.exists(store):          # a FileStore starts from no file
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, WORKER, "--k", str(k), "--store", store,
           "--out", str(out_dir), *argv]
    others = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(1, k)]
    try:
        res = subprocess.run(cmd + ["--rank", "0"], env=env, text=True,
                             capture_output=True, timeout=timeout)
        outs = [p.communicate(timeout=30)[0] for p in others]
    finally:
        for p in others:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [o for p, o in zip(others, outs) if p.returncode]
    if res.returncode or bad:
        raise AssertionError(f"k={k} ranks failed: rank 0 rc "
                             f"{res.returncode}\n{res.stdout}\n{res.stderr}"
                             + "\n".join(bad))
    return res.stdout


def dist_runs(request, tmp_path_factory) -> dict:
    """k → {case: global y, "weak": the weak-scaling dict, "info": the
    world's facts}, for k in KS, from one spawned run each this session
    (the runs for the k's not yet made are started together)."""
    from concurrent.futures import ThreadPoolExecutor

    base = tmp_path_factory.getbasetemp()
    if hasattr(request.config, "workerinput"):      # an xdist worker
        base = base.parent
    dirs = {k: base / f"torch_dist_k{k}" for k in KS}
    locks = []
    try:
        for k in KS:                    # in one order: no deadlock
            dirs[k].mkdir(exist_ok=True)
            locks.append(open(dirs[k] / "lock", "w"))
            fcntl.flock(locks[-1], fcntl.LOCK_EX)
        todo = [k for k in KS if not (dirs[k] / "done").exists()]
        with ThreadPoolExecutor(len(KS)) as ex:
            list(ex.map(lambda k: spawn(k, str(dirs[k])), todo))
        for k in todo:
            (dirs[k] / "done").write_text("ok")
    finally:
        for lk in locks:
            lk.close()
    out = {}
    for k in KS:
        with np.load(dirs[k] / "results.npz") as z:
            res = {key: z[key] for key in z.files}
        with open(dirs[k] / "results.json") as f:
            res.update(json.load(f))
        out[k] = res
    return out
