"""Host-layer parity of the PyTorch port with the JAX package.

The port carries the numpy host layer over (generator, features, RCM, the
CLOSG program compiler); the same inputs must give bit-identical results.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_research_tpu.convert.coo_csr import coo_to_csr as jax_coo_to_csr
from spmv_research_tpu.convert.reorder import rcm_if_beneficial as jax_rcm
from spmv_research_tpu.convert.reorder import rcm_reorder as jax_rcm_reorder
from spmv_research_tpu.core.host import HostCOO as JaxHostCOO
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.gen import generate_from_line as jax_generate
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build

from spmv_research_tpu_torch.convert.coo_csr import coo_to_csr, csr_to_coo
from spmv_research_tpu_torch.convert.reorder import (rcm_if_beneficial,
                                                     rcm_reorder)
from spmv_research_tpu_torch.core.host import HostCOO, HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.ops.clos_gather import (
    DATA_FIELDS, META_FIELDS, build_clos_gather, build_clos_gather_auto)
from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError

from torch_cases import TWIN_LINE, capped_scan_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_csr(a, b):
    assert (a.m, a.n, a.nnz, a.nnz_expanded) == (b.m, b.n, b.nnz,
                                                 b.nnz_expanded)
    for f in ("ia", "ja", "a"):
        got, want = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f


def test_generate_from_line_identical():
    h, feats = generate_from_line(TWIN_LINE)
    hj, feats_j = jax_generate(TWIN_LINE)
    assert_same_csr(h, hj)
    assert dataclasses.asdict(feats) == dataclasses.asdict(feats_j)


def test_rcm_if_beneficial_identical():
    h, _ = generate_from_line(TWIN_LINE)
    hj, _ = jax_generate(TWIN_LINE)
    for port_fn, jax_fn in ((rcm_if_beneficial, jax_rcm),
                            (rcm_reorder, jax_rcm_reorder)):
        h2, perm = port_fn(h)
        hj2, perm_j = jax_fn(hj)
        assert np.array_equal(perm, perm_j)
        assert_same_csr(h2, hj2)
    # the reorder itself permutes (rcm_if_beneficial keeps it or not)
    assert not np.array_equal(rcm_reorder(h)[1], np.arange(h.m))


@pytest.mark.parametrize("symmetric", [False, True])
def test_coo_to_csr_identical(symmetric):
    rng = np.random.Generator(np.random.PCG64(5))
    rows = rng.integers(0, 300, 2000).astype(np.int32)
    cols = rng.integers(0, 200, 2000).astype(np.int32)
    vals = rng.uniform(-1, 1, 2000)
    csr = coo_to_csr(HostCOO(rows, cols, vals, 300, 200, symmetric))
    assert_same_csr(csr, jax_coo_to_csr(
        JaxHostCOO(rows, cols, vals, 300, 200, symmetric)))
    back = csr_to_coo(csr)
    assert np.array_equal(back.cols, csr.ja) and back.nnz == 2000


def _twin_pair():
    h, _ = rcm_if_beneficial(generate_from_line(TWIN_LINE)[0])
    hj, _ = jax_rcm(jax_generate(TWIN_LINE)[0])
    return h, hj


def _capped_pair():
    mat = capped_scan_matrix()
    return HostCSR.from_scipy(mat), JaxHostCSR.from_scipy(mat)


@pytest.mark.parametrize("case", ["twin", "capped_scan"])
def test_build_clos_gather_identical(case):
    h, hj = _twin_pair() if case == "twin" else _capped_pair()
    A, Aj = build_clos_gather(h), jax_build(hj)
    for f in DATA_FIELDS:
        got, want = getattr(A, f).numpy(), np.asarray(getattr(Aj, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    for f in META_FIELDS:
        assert getattr(A, f) == getattr(Aj, f), f
    assert A.scan_cap and len(A.scan_cap) < len(A.scan_stages)
    assert any(c[3] for c in A.yext_classes)        # accumulate classes
    assert A.mem_footprint_bytes() == Aj.mem_footprint_bytes()


def test_from_arrays_copies_jax_host():
    _, hj = _twin_pair()
    h = HostCSR.from_arrays(hj.ia, hj.ja, hj.a, hj.m, hj.n)
    assert_same_csr(h, hj)


def test_build_auto_refuses_what_is_not_ported():
    mat = sp.random(200, 200, 0.05, random_state=3, format="csr")
    mat.sort_indices()
    h = HostCSR.from_scipy(mat)
    assert build_clos_gather_auto(h).N == 8192
    # a program has at least 8192 slots: no row block fits in 4096
    with pytest.raises(ClosRoutingError, match="exceed a single"):
        build_clos_gather_auto(h, max_N=4096)
    # the XL tier and the long-row split are ported: past max_chunks the
    # matrix gets a CLOSGX stack, a row past 16,384 nnz the RSPLIT wrapper
    wide = sp.random(3000, 3000, 0.003, random_state=3, format="csr")
    wide.sort_indices()
    assert build_clos_gather_auto(HostCSR.from_scipy(wide), max_N=8192,
                                  max_chunks=4).format_name == "CLOSGX"
    long_row = sp.csr_matrix((np.ones(20000), (np.zeros(20000, int),
                                               np.arange(20000))),
                             shape=(30000, 30000))
    A = build_clos_gather_auto(HostCSR.from_scipy(long_row))
    assert A.format_name == "RSPLIT" and A.heavy_rows.tolist() == [0]


def test_port_imports_no_jax():
    code = ("import sys, spmv_research_tpu_torch, spmv_research_tpu_torch.bench;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spmv_research_tpu'));"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_native_library_loads_once_under_threads(monkeypatch):
    """The chunked CLOSG build routes chunks in threads: every thread must
    see the loaded library, never the numpy tier's None."""
    import threading
    from spmv_research_tpu_torch.io import native
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    start = threading.Barrier(8)
    got = []

    def load():
        start.wait()
        got.append(native.get_lib())

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and got[0] is not None
    assert all(lib is got[0] for lib in got)
