"""The port's format cache (``convert/cache.py``) and k-means row
clustering (``convert/cluster.py``) against the JAX package's on the CPU.

The digest equals JAX's for the same twin; every format kind that the sweep
and ``build_best`` cache comes back from disk with each tensor
``torch.equal`` to the fresh build's (dtype included) and the same plain
SpMV (SpMM for BTILE); a hit never calls the builder and keeps the cold
build's seconds; a truncated or stale entry is rebuilt, and a schema change
misses. The clustering's features and permutation are array-identical to
JAX's on two twins at k = 1, 8 and 16.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import spmv_research_tpu.convert.cache as jax_cache
from spmv_research_tpu.convert import cluster as jax_cluster
from spmv_research_tpu.gen import generate_from_line as jax_generate

from spmv_research_tpu_torch.convert import cache, cluster
from spmv_research_tpu_torch.convert.build_best import build_best
from spmv_research_tpu_torch.core.formats import tree_map
from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.ops import (build_bfly, build_btile, build_clos,
                                         build_clos_gather_auto,
                                         build_clos_gather_xl, build_sellr,
                                         build_sellw, build_sellwds, spmm,
                                         spmv)
import spmv_research_tpu_torch.ops.clos_gather as cg
from spmv_research_tpu_torch.convert import build_csr

from torch_cases import (BANDED_LINE, TWIN_LINE, W0_CHUNK_N, random_matrix,
                         skewed_matrix, w0_chunked_matrix)


def _twin(line):
    return generate_from_line(line)[0]


def _scipy(mat):
    return lambda: HostCSR.from_scipy(mat)


def _rsplit(host, **kw):
    """An RSPLIT program: the split threshold lowered to 512 nnz, as
    tests/test_torch_rowsplit.py builds it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cg, "SPLIT_ROW_NNZ", 512)
    try:
        return build_clos_gather_auto(host, **kw)
    finally:
        mp.undo()


# kind -> (host maker, builder, cache key, build kwargs, format_name)
KINDS = {
    "closg": (lambda: _twin(TWIN_LINE), build_clos_gather_auto, "closg", {},
              "CLOSG"),
    "closg_w0_chunked": (_scipy(w0_chunked_matrix()), build_clos_gather_auto,
                         "closg", {"max_N": W0_CHUNK_N}, "CLOSG"),
    "closg_chunked": (lambda: _twin(TWIN_LINE), build_clos_gather_auto,
                      "closg", {"max_N": 1 << 13}, "CLOSG"),
    "rsplit": (_scipy(skewed_matrix()), _rsplit, "closg", {}, "RSPLIT"),
    "closgx": (_scipy(random_matrix(4000, 900, 0.008, 5)),
               build_clos_gather_xl, "closgx", {"chunk_N": 8192}, "CLOSGX"),
    "clos": (_scipy(random_matrix(300, 300, 0.01, 1)), build_clos, "clos",
             {}, "CLOS"),
    "bfly": (_scipy(random_matrix(120, 120, 0.06, 2)), build_bfly, "bfly", {},
             "BFLY"),
    "sellr": (lambda: _twin(BANDED_LINE), build_sellr, "sellr", {}, "SELLR"),
    "sellw": (lambda: _twin(BANDED_LINE), build_sellw, "sellw", {}, "SELLW"),
    "btile": (lambda: _twin(BANDED_LINE), build_btile, "btile", {}, "BTILE"),
    "sellwds": (lambda: _twin(BANDED_LINE), build_sellwds, "sellwds", {},
                "SELLWDS"),
}


def _leaves(fmt):
    out = []
    tree_map(out.append, fmt)
    return out


def _assert_same(got, want):
    """Same class, fields and non-tensor values; every tensor equal in
    dtype, shape and value."""
    assert type(got) is type(want)
    shape = lambda t: (t.dtype, tuple(t.shape))  # noqa: E731
    assert tree_map(shape, got) == tree_map(shape, want)
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x, y)


def _apply(A, seed=7):
    rng = np.random.Generator(np.random.PCG64(seed))
    if A.format_name == "BTILE":          # no SpMV: its SpMM at K = 3
        return spmm(A, torch.as_tensor(rng.uniform(-1, 1, (A.n, 3)),
                                       dtype=torch.float32))
    return spmv(A, torch.as_tensor(rng.uniform(-1, 1, A.n),
                                   dtype=torch.float32))


@pytest.mark.parametrize("line", [TWIN_LINE, BANDED_LINE],
                         ids=["twin", "banded"])
def test_matrix_digest_matches_jax(line):
    assert cache.matrix_digest(_twin(line)) == jax_cache.matrix_digest(
        jax_generate(line)[0])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cached_format_round_trip(kind, tmp_path):
    make, builder, key, kw, name = KINDS[kind]
    host = make()
    A, cold = cache.cached_build_timed(builder, host, key,
                                       cache_dir=str(tmp_path), **kw)
    B, hit = cache.cached_build_timed(builder, host, key,
                                      cache_dir=str(tmp_path), **kw)
    assert A.format_name == name
    assert not cold["from_cache"] and hit["from_cache"]
    assert hit["cold_build_s"] == cold["build_s"] == cold["cold_build_s"]
    _assert_same(B, A)
    assert torch.equal(_apply(B), _apply(A))


@dataclasses.dataclass(frozen=True)
class _Planes:
    """Every dtype the port's programs hold, in the containers tree_map
    walks."""
    u8: torch.Tensor
    parts: tuple
    slabs: dict
    width: int
    note: str


def test_every_leaf_dtype_survives(tmp_path):
    t = torch.arange(-3, 9)
    fmt = _Planes(
        u8=t.to(torch.uint8),
        parts=(t.to(torch.uint16), t.to(torch.uint32), t.to(torch.int8),
               (t.to(torch.int16), t.to(torch.bool))),
        slabs={8: t.to(torch.int64).reshape(3, 4).t(),   # not contiguous
               16: torch.linspace(-1, 1, 5, dtype=torch.float64),
               32: torch.zeros(0, 128, dtype=torch.float32)},
        width=7, note="planes")
    cache.save_format(str(tmp_path / "e"), fmt)
    got = cache.load_format(str(tmp_path / "e"))
    assert (got.width, got.note, sorted(got.slabs)) == (7, "planes",
                                                         [8, 16, 32])
    a, b = _leaves(got), _leaves(fmt)
    assert [x.dtype for x in a] == [y.dtype for y in b]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cached_property_stays_out_of_the_skeleton(tmp_path):
    A = build_csr(_twin(TWIN_LINE))
    A.sparse_csr                          # cached on the instance
    assert "sparse_csr" in A.__dict__
    cache.save_format(str(tmp_path / "csr"), A)
    with open(tmp_path / "csr.tree", "rb") as f:
        skeleton = pickle.load(f)
    assert "sparse_csr" not in skeleton.__dict__
    assert not _leaves(skeleton)          # tensors only in the .npz
    B = cache.load_format(str(tmp_path / "csr"))
    _assert_same(B, A)
    assert torch.equal(B.sparse_csr.to_dense(), A.sparse_csr.to_dense())


def test_counting_builder_called_once(tmp_path):
    """tests/test_workloads_sweep.py:92 (test_format_cache_roundtrip) as a
    port case."""
    mat = random_matrix(120, 120, 0.06, 3)
    h = HostCSR.from_scipy(mat)
    calls = []

    def counting_builder(csr, **kw):
        calls.append(1)
        return build_bfly(csr, **kw)

    A1 = cache.cached_build(counting_builder, h, "bfly",
                            cache_dir=str(tmp_path))
    A2 = cache.cached_build(counting_builder, h, "bfly",
                            cache_dir=str(tmp_path))
    assert len(calls) == 1  # second call served from disk
    x = np.random.Generator(np.random.PCG64(4)).uniform(-1, 1, 120)
    xt = torch.as_tensor(x, dtype=torch.float32)
    y1, y2 = spmv(A1, xt).numpy(), spmv(A2, xt).numpy()
    assert np.array_equal(y1, y2)
    np.testing.assert_allclose(y1, mat @ x, rtol=3e-5, atol=2e-5)


def _entry(tmp_path, builder, host, key):
    """Path of the one entry cached_build_timed made."""
    (npz,) = [f for f in os.listdir(tmp_path) if f.endswith(".npz")
              and f"_{key}_" in f]
    return os.path.join(tmp_path, npz[:-4])


@pytest.mark.parametrize("spoil", ["truncated_npz", "renamed_class",
                                   "missing_leaf"])
def test_unreadable_entry_is_rebuilt(spoil, tmp_path, capsys):
    host = _twin(BANDED_LINE)
    calls = []

    def builder(h):
        calls.append(1)
        return build_sellr(h)

    A, _ = cache.cached_build_timed(builder, host, "sellr",
                                    cache_dir=str(tmp_path))
    path = _entry(tmp_path, builder, host, "sellr")
    if spoil == "truncated_npz":
        data = open(path + ".npz", "rb").read()
        open(path + ".npz", "wb").write(data[:len(data) // 2])
    elif spoil == "renamed_class":
        data = open(path + ".tree", "rb").read()
        assert data.count(b"SellR") == 1
        open(path + ".tree", "wb").write(data.replace(b"SellR", b"SellQ"))
    else:
        z = dict(np.load(path + ".npz"))
        z.pop("leaf_0")
        np.savez(path + ".npz", **z)
    B, info = cache.cached_build_timed(builder, host, "sellr",
                                       cache_dir=str(tmp_path))
    assert len(calls) == 2 and not info["from_cache"]
    assert "# format cache: unreadable entry" in capsys.readouterr().err
    _assert_same(B, A)
    C, info = cache.cached_build_timed(builder, host, "sellr",
                                       cache_dir=str(tmp_path))
    assert len(calls) == 2 and info["from_cache"]   # the rebuild was saved
    _assert_same(C, A)


def test_schema_version_and_kwargs_key_the_entry(tmp_path, monkeypatch):
    host = _twin(TWIN_LINE)
    kw = dict(cache_dir=str(tmp_path))
    assert not cache.cached_build_timed(build_clos_gather_auto, host,
                                        "closg", **kw)[1]["from_cache"]
    assert cache.cached_build_timed(build_clos_gather_auto, host, "closg",
                                    **kw)[1]["from_cache"]
    assert not cache.cached_build_timed(build_clos_gather_auto, host,
                                        "closg", max_N=1 << 13,
                                        **kw)[1]["from_cache"]
    monkeypatch.setattr(cache, "SCHEMA_VERSION", cache.SCHEMA_VERSION + 1)
    assert not cache.cached_build_timed(build_clos_gather_auto, host,
                                        "closg", **kw)[1]["from_cache"]


def test_builder_sources_key_the_entry(tmp_path, monkeypatch):
    """An edit to the code that builds a program misses the cache: the key
    holds a digest of the sources of every cached builder's module."""
    from spmv_research_tpu_torch.harness.sweep import FORMAT_BUILDERS
    pkg = os.path.dirname(os.path.dirname(cache.__file__))
    cached = [b.args[0] for b in FORMAT_BUILDERS.values()
              if getattr(b, "func", None) is cache.cached_build]
    assert len(cached) == 7
    for b in cached:
        rel = os.path.relpath(os.path.dirname(
            os.path.abspath(b.__globals__["__file__"])), pkg)
        assert rel in cache.SOURCE_DIRS, (b.__name__, rel)
    assert cache.source_digest() == cache.source_digest()
    host = _twin(TWIN_LINE)
    kw = dict(cache_dir=str(tmp_path))
    cache.cached_build_timed(build_clos_gather_auto, host, "closg", **kw)
    assert cache.cached_build_timed(build_clos_gather_auto, host, "closg",
                                    **kw)[1]["from_cache"]
    monkeypatch.setattr(cache, "source_digest", lambda: "0" * 16)
    assert not cache.cached_build_timed(build_clos_gather_auto, host,
                                        "closg", **kw)[1]["from_cache"]


def test_stats_count_loads_and_saves(tmp_path):
    """STATS counts the misses' write time beside the hits' saving."""
    host = _twin(TWIN_LINE)
    kw = dict(cache_dir=str(tmp_path))
    saved = dict(cache.STATS)
    try:
        cache.reset_stats()
        cache.cached_build_timed(build_clos_gather_auto, host, "closg", **kw)
        st = dict(cache.STATS)
        assert (st["hits"], st["misses"], st["saved_s"]) == (0, 1, 0.0)
        assert st["save_s"] > 0.0
        _, info = cache.cached_build_timed(build_clos_gather_auto, host,
                                           "closg", **kw)
        assert (cache.STATS["hits"], cache.STATS["save_s"]) == (1,
                                                               st["save_s"])
        assert cache.STATS["saved_s"] == pytest.approx(
            info["cold_build_s"] - info["build_s"])
    finally:
        cache.STATS.update(saved)


def test_unwritable_cache_is_skipped(tmp_path):
    """A save that fails with OSError is best-effort: the build is
    returned, and the next call builds again."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    host = _twin(TWIN_LINE)
    for _ in range(2):
        A, info = cache.cached_build_timed(build_clos_gather_auto, host,
                                           "closg", cache_dir=str(blocker))
        assert not info["from_cache"] and A.format_name == "CLOSG"


def test_cache_dir_read_at_call_time(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSE_FORMAT_CACHE_TORCH", str(tmp_path / "a"))
    assert cache.default_cache_dir() == str(tmp_path / "a")
    monkeypatch.delenv("SPARSE_FORMAT_CACHE_TORCH")
    assert cache.default_cache_dir() == os.path.join(".",
                                                     ".format_cache_torch")


def test_build_best_twice_loads_every_entry(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SPARSE_FORMAT_CACHE_TORCH", str(tmp_path))
    host = _twin(BANDED_LINE)
    first, again = build_best(host), build_best(host)
    assert list(first) == list(again) == ["SELLR", "SELLW", "CLOSG"]
    for k in first:
        assert not first[k][1]["from_cache"] and again[k][1]["from_cache"]
        assert again[k][1]["cold_build_s"] == first[k][1]["build_s"]
        _assert_same(again[k][0], first[k][0])
    err = capsys.readouterr().err
    assert "SELLR cold build" in err and "CLOSG from cache" in err


# ------------------------------------------------------------- clustering

@pytest.mark.parametrize("line", [TWIN_LINE, BANDED_LINE],
                         ids=["twin", "banded"])
def test_row_features_and_kmeans_match_jax(line):
    h, hj = _twin(line), jax_generate(line)[0]
    assert np.array_equal(cluster.row_feature_vectors(h),
                          jax_cluster.row_feature_vectors(hj))
    for k in (1, 8, 16):
        got, want = cluster.kmeans_rows(h, k=k), jax_cluster.kmeans_rows(hj,
                                                                         k=k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k


@pytest.mark.parametrize("line", [TWIN_LINE, BANDED_LINE],
                         ids=["twin", "banded"])
def test_kmeans_reorder_keeps_the_spmv(line):
    h = _twin(line)
    r, perm = cluster.kmeans_reorder(h, k=16)
    rj, permj = jax_cluster.kmeans_reorder(jax_generate(line)[0], k=16)
    assert np.array_equal(perm, permj)
    for f in ("ia", "ja", "a"):
        assert np.array_equal(getattr(r, f), getattr(rj, f)), f
    assert sorted(perm) == list(range(h.m))
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1, 1, h.n)
    assert np.array_equal(r.to_scipy() @ x, (h.to_scipy() @ x)[perm])
