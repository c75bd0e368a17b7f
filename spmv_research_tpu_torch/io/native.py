"""ctypes bindings for the native host library (native/sparse_host.cpp).

Counterpart of ``spmv_research_tpu/io/native.py``. It loads the same
``native/libsparse_host.so`` (the C++ stays single-sourced) and keeps the
same behaviour: when the library is missing but its sources exist, try
``make -C native`` once. Only the entry points the port's modules call are
bound (COO→CSR, RCM, feature extraction, the Clos Euler edge coloring, the
SELLW packer); the MTX parser and the Waksman router follow their modules.

This is a host library: its numpy fallbacks give the same results (the
Euler coloring a different but equally valid one) more slowly, and are not a
device fallback. ``have_native()`` says which tier is in use.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()

_c_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_c_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_c_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_c_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _find_lib() -> Optional[str]:
    for cand in (os.path.join(_REPO, "native", "libsparse_host.so"),
                 os.environ.get("SPARSE_HOST_LIB", "")):
        if cand and os.path.exists(cand):
            return cand
    return None


def _try_build() -> None:
    """Build libsparse_host.so from source if the checkout is fresh (the .so
    is a build artifact, not in git). Tried once, quietly: a failed build
    leaves the numpy tiers in use, which ``have_native()`` reports."""
    import subprocess
    ndir = os.path.join(_REPO, "native")
    if not os.path.exists(os.path.join(ndir, "Makefile")):
        return
    try:
        subprocess.run(["make", "-C", ndir], check=False, timeout=120,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except (OSError, subprocess.SubprocessError):
        pass


def get_lib() -> Optional[ctypes.CDLL]:
    # under a lock: the chunked CLOSG build routes two chunks in threads,
    # and a second caller must not see _TRIED before _LIB is set (it would
    # take the numpy tier: valid, but different program arrays)
    with _LOCK:
        if not _TRIED:
            _load()
    return _LIB


def _load() -> None:
    global _LIB, _TRIED
    _TRIED = True
    path = _find_lib()
    if path is None:
        _try_build()
        path = _find_lib()
    if path is None:
        return
    lib = ctypes.CDLL(path)

    lib.coo_to_csr.restype = None
    lib.coo_to_csr.argtypes = [
        _c_i32p, _c_i32p, _c_f64p, ctypes.c_int64, ctypes.c_int64,
        _c_i32p, _c_i32p, _c_f64p]

    lib.rcm.restype = None
    lib.rcm.argtypes = [_c_i32p, _c_i32p, ctypes.c_int64, _c_i32p]

    lib.row_neighbours_avg.restype = ctypes.c_double
    lib.row_neighbours_avg.argtypes = [
        _c_i32p, _c_i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]

    lib.cross_row_similarity_avg.restype = ctypes.c_double
    lib.cross_row_similarity_avg.argtypes = [
        _c_i32p, _c_i32p, ctypes.c_int64, ctypes.c_int64]

    if hasattr(lib, "euler_edge_color"):  # stale .so: degrade politely
        lib.euler_edge_color.restype = ctypes.c_int32
        lib.euler_edge_color.argtypes = [
            _c_i64p, _c_i64p, ctypes.c_int64, ctypes.c_int32, _c_i32p]

    if hasattr(lib, "sellw_pack2"):  # stale pre-SELLW .so: degrade politely
        lib.sellw_pack2.restype = ctypes.c_int64
        lib.sellw_pack2.argtypes = [
            _c_i64p, _c_i32p, _c_f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, _c_i32p, ctypes.c_void_p]

    _LIB = lib


def have_native() -> bool:
    return get_lib() is not None


def coo_to_csr_native(rows, cols, vals, m):
    lib = get_lib()
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    nnz = rows.size
    ia = np.empty(m + 1, np.int32)
    ja = np.empty(nnz, np.int32)
    a = np.empty(nnz, np.float64)
    lib.coo_to_csr(rows, cols, vals, nnz, m, ia, ja, a)
    return ia, ja, a


def rcm_native(ia, ja, m):
    lib = get_lib()
    perm = np.empty(m, np.int32)
    lib.rcm(np.ascontiguousarray(ia, np.int32),
            np.ascontiguousarray(ja, np.int32), m, perm)
    return perm.astype(np.int64)


def row_neighbours_avg_native(ia, ja, m, nnz, window=1):
    lib = get_lib()
    return float(lib.row_neighbours_avg(
        np.ascontiguousarray(ia, np.int32),
        np.ascontiguousarray(ja, np.int32), m, nnz, window))


def cross_row_similarity_avg_native(ia, ja, m, window=1):
    lib = get_lib()
    return float(lib.cross_row_similarity_avg(
        np.ascontiguousarray(ia, np.int32),
        np.ascontiguousarray(ja, np.int32), m, window))


def have_euler_edge_color() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "euler_edge_color")


def euler_edge_color_native(left, right, levels):
    """Returns per-edge colors, or None when the native guard declines
    (key space too large) — caller falls back to numpy."""
    lib = get_lib()
    left = np.ascontiguousarray(left, np.int64)
    right = np.ascontiguousarray(right, np.int64)
    color = np.empty(left.size, np.int32)
    rc = lib.euler_edge_color(left, right, left.size, levels, color)
    return color if rc == 0 else None


def have_sellw_pack() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "sellw_pack2")


def sellw_pack_native(ia, ja, a_f32, m, part_cap: int = 128,
                      want_idx: bool = False):
    """Two-pass native SELLW packer (``sellw_pack2``; the library's
    ``sellw_pack`` is it with part_cap = 128): count, allocate exact, pack.

    Returns (word (nchunks·8,128) int32, vals likewise float32,
    wrow (nchunks·8,), pair (nchunks,), bids (nchunks,) uint8, max_part
    [, idx (nchunks·8,128) int32: the source nnz of each slot, -1 where the
    slot is empty, with ``want_idx``])."""
    lib = get_lib()
    ia = np.ascontiguousarray(ia, np.int64)
    ja = np.ascontiguousarray(ja, np.int32)
    a_f32 = np.ascontiguousarray(a_f32, np.float32)
    mp = np.zeros(1, np.int32)

    def call(cap, count_only, *bufs, idx=None):
        return lib.sellw_pack2(ia, ja, a_f32, m, cap, count_only, part_cap,
                               *bufs, mp, idx)

    n = call(0, 1, None, None, None, None, None)
    word = np.zeros((max(int(n), 1) * 8, 128), np.int32)
    vals = np.zeros((max(int(n), 1) * 8, 128), np.float32)
    wrow = np.zeros(max(int(n), 1) * 8, np.int32)
    pair = np.zeros(max(int(n), 1), np.int32)
    bids = np.zeros(max(int(n), 1), np.uint8)
    idx = (np.zeros((max(int(n), 1) * 8, 128), np.int32) if want_idx
           else None)
    n2 = call(int(n), 0, *(b.ctypes.data_as(ctypes.c_void_p)
                           for b in (word, vals, wrow, pair, bids)),
              idx=None if idx is None else idx.ctypes.data_as(
                  ctypes.c_void_p))
    assert n2 == n, (n2, n)
    out = (word[: int(n) * 8], vals[: int(n) * 8], wrow[: int(n) * 8],
           pair[: int(n)], bids[: int(n)], int(mp[0]))
    return out + (idx[: int(n) * 8],) if want_idx else out
