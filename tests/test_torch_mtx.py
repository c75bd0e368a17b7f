"""Real-matrix input in the port against the JAX package: the Matrix Market
reader and writer, the OpenFOAM reader, the DIV codec, ``load_matrix`` on
a ``.mtx`` path, the real-matrix sweep rows, and the ``.mtx`` round trip.

``mtx_read`` must give JAX's arrays (values, dtypes, ``m``, ``n``,
``symmetric``) on files the test writes, in every field and symmetry, in
array format, on the native tier and on the numpy tier (the library
hidden, as ``tests/test_native.py`` hides it); ``read_openfoam_matrix_dir``
likewise; the DIV codec's packets must equal JAX's and round-trip exactly;
a ``.mtx`` sweep must write JAX's real-matrix labels and rows; and the
round trip of ``mtx_sweep`` must give rows equal to the in-memory ones.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spmv_research_tpu.io.native as jax_native
from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.harness import bench as jax_bench
from spmv_research_tpu.harness import sweep as jax_sweep
from spmv_research_tpu.harness.config import BenchConfig as JaxBenchConfig
from spmv_research_tpu.io import div_codec as jax_div
from spmv_research_tpu.io import matrix_market as jax_mm
from spmv_research_tpu.io import openfoam as jax_foam

import spmv_research_tpu_torch.io.native as native
from spmv_research_tpu_torch import mtx_sweep
from spmv_research_tpu_torch.core.host import HostCOO, HostCSR
from spmv_research_tpu_torch.gen import generate_from_line
from spmv_research_tpu_torch.harness import BenchConfig, run_sweep
from spmv_research_tpu_torch.harness.sweep import load_matrix
from spmv_research_tpu_torch.io import (compress_csr, decompress, mtx_read,
                                        mtx_write, read_openfoam_matrix_dir)

from torch_cases import TWIN_LINE, random_matrix

TINY = dict(min_num_loops=2, min_time_s=0.0, warmup_iters=1, inner_iters=2,
            k_dim=8)
FIELDS = ("real", "integer", "pattern", "complex")
SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@pytest.fixture(params=["native", "numpy"])
def tier(request, monkeypatch):
    """Both packages on the native tier, or both with the library hidden."""
    if request.param == "numpy":
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    elif not (native.have_native() and jax_native.have_native()):
        pytest.skip("native/libsparse_host.so is not built")
    return request.param


def _write_coordinate(path, field, symmetry, seed=1):
    """A 30 × 30 (general: 30 × 24) file: entries in random order, the
    lower triangle only where the symmetry says so (none on a
    skew-symmetric diagonal), two comment lines."""
    rng = np.random.Generator(np.random.PCG64(seed))
    m, n = (30, 24) if symmetry == "general" else (30, 30)
    mat = sp.random(m, n, 0.2, random_state=np.random.RandomState(seed),
                    format="coo")
    r, c = mat.row, mat.col
    if symmetry != "general":
        keep = r > c if symmetry == "skew-symmetric" else r >= c
        r, c = r[keep], c[keep]
    order = rng.permutation(r.size)
    r, c = r[order], c[order]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write("% a comment\n%\n")
        f.write(f"{m} {n} {r.size}\n")
        for i, j in zip(r, c):
            if field == "pattern":
                f.write(f"{i + 1} {j + 1}\n")
            elif field == "integer":
                f.write(f"{i + 1} {j + 1} {int(rng.integers(-9, 10))}\n")
            elif field == "complex":
                f.write(f"{i + 1} {j + 1} {rng.uniform(-1, 1):.17g} "
                        f"{rng.uniform(-1, 1):.17g}\n")
            else:
                f.write(f"{i + 1} {j + 1} {rng.uniform(-1, 1):.17g}\n")


def _same_coo(got, want):
    for f in ("rows", "cols", "vals"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.m, got.n, got.symmetric) == (want.m, want.n, want.symmetric)


@pytest.mark.parametrize("symmetry", SYMMETRIES)
@pytest.mark.parametrize("field", FIELDS)
def test_mtx_read_matches_jax(tmp_path, tier, field, symmetry):
    path = str(tmp_path / "a.mtx")
    _write_coordinate(path, field, symmetry)
    for kw in ({}, {"expand_symmetry": False}, {"keep_diagonal": False},
               {"pattern_dummy_value": 2.5}):
        _same_coo(mtx_read(path, **kw), jax_mm.mtx_read(path, **kw))


def test_mtx_read_tiers_agree(tmp_path, monkeypatch):
    """The native parser and the numpy one give the same arrays."""
    if not native.have_native():
        pytest.skip("native/libsparse_host.so is not built")
    path = str(tmp_path / "a.mtx")
    _write_coordinate(path, "real", "symmetric", seed=4)
    fast = mtx_read(path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    _same_coo(fast, mtx_read(path))


@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
def test_mtx_read_array_format_matches_jax(tmp_path, tier, symmetry):
    """The dense array format (column-major; the symmetric kinds store
    the lower triangle column by column, diagonal included, as both
    readers expect, a skew-symmetric one with a zero diagonal), read and
    sparsified."""
    rng = np.random.Generator(np.random.PCG64(2))
    m, n = (7, 5) if symmetry == "general" else (6, 6)
    dense = np.where(rng.random((m, n)) < 0.5, rng.uniform(-1, 1, (m, n)), 0)
    if symmetry == "general":
        vals = dense.T.reshape(-1)
    else:
        if symmetry == "skew-symmetric":
            np.fill_diagonal(dense, 0)
        vals = np.concatenate([dense[j:, j] for j in range(n)])
    path = str(tmp_path / "d.mtx")
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix array real {symmetry}\n% dense\n")
        f.write(f"{m} {n}\n")
        f.writelines(f"{v:.17g}\n" for v in vals)
    _same_coo(mtx_read(path), jax_mm.mtx_read(path))


def test_mtx_read_refuses_as_jax(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket tensor coordinate real general\n1 1 1\n")
    with pytest.raises(ValueError, match="not a MatrixMarket file"):
        mtx_read(str(bad))
    short = tmp_path / "short.mtx"
    short.write_text("%%MatrixMarket matrix coordinate real general\n"
                     "3 3 4\n1 1 1.0\n2 2 2.0\n")
    with pytest.raises(ValueError) as want:
        jax_mm.mtx_read(str(short))
    with pytest.raises(ValueError) as got:
        mtx_read(str(short))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field", ["real", "pattern"])
def test_mtx_write_matches_jax_and_round_trips(tmp_path, field):
    mat = random_matrix(40, 30, 0.1, 3).tocoo()
    coo = HostCOO(rows=mat.row.astype(np.int32), cols=mat.col.astype(
        np.int32), vals=mat.data, m=40, n=30)
    ours, theirs = str(tmp_path / "o.mtx"), str(tmp_path / "j.mtx")
    mtx_write(ours, coo, field=field, comment="two\nlines")
    jax_mm.mtx_write(theirs, coo, field=field, comment="two\nlines")
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    back = mtx_read(ours)
    assert np.array_equal(back.rows, coo.rows)
    assert np.array_equal(back.cols, coo.cols)
    assert np.array_equal(back.vals, coo.vals if field == "real"
                          else np.ones(coo.nnz))


def _foam_dir(path, n_cells=40, seed=5, boundary=6):
    """owner/neighbour label lists of a random face set, with FoamFile
    headers and comments; ``owner`` lists ``boundary`` faces more."""
    rng = np.random.Generator(np.random.PCG64(seed))
    o = rng.integers(0, n_cells - 1, 90)
    nb = o + rng.integers(1, n_cells - o)
    owner = np.concatenate([o, rng.integers(0, n_cells, boundary)])
    os.makedirs(path, exist_ok=True)
    for name, vals in (("owner", owner), ("neighbour", nb)):
        with open(os.path.join(path, name), "w") as f:
            f.write("/* header comment */\nFoamFile\n{\n    version 2.0;\n"
                    f"    object {name};\n}}\n// labels\n\n{vals.size}\n(\n")
            f.write("\n".join(str(v) for v in vals) + "\n)\n")


@pytest.mark.parametrize("with_diagonal", [True, False])
@pytest.mark.parametrize("boundary", [0, 6])
def test_openfoam_matches_jax(tmp_path, with_diagonal, boundary):
    d = str(tmp_path / "foam")
    _foam_dir(d, boundary=boundary)
    _same_coo(read_openfoam_matrix_dir(d, with_diagonal),
              jax_foam.read_openfoam_matrix_dir(d, with_diagonal))


def test_openfoam_refuses_as_jax(tmp_path):
    d = tmp_path / "foam"
    _foam_dir(str(d))
    (d / "neighbour").write_text("5\n(1 2 3)\n")
    with pytest.raises(ValueError) as want:
        jax_foam.read_openfoam_matrix_dir(str(d))
    with pytest.raises(ValueError) as got:
        read_openfoam_matrix_dir(str(d))
    assert str(got.value) == str(want.value)


def _div_cases():
    """The 2000-row scircuit twin (raw packets), a 16-level matrix (RLE
    packets), an empty matrix, and a matrix of empty rows and one row."""
    twin = generate_from_line(TWIN_LINE)[0].to_scipy()
    lv = random_matrix(300, 200, 0.05, 7, levels=16)
    one = sp.csr_matrix((np.ones(5), ([3] * 5, [0, 4, 8, 9, 19])),
                        shape=(6, 20))
    return {"twin": twin, "levels": lv, "one_row": one,
            "empty": sp.csr_matrix((5, 7))}


DIV = _div_cases()


@pytest.mark.parametrize("packet", [64, 4096])
@pytest.mark.parametrize("case", sorted(DIV))
def test_div_codec_matches_jax(case, packet):
    mat = DIV[case]
    h = HostCSR.from_scipy(mat)
    args = (h.ia, h.ja, h.a, h.m, h.n)
    ours = compress_csr(*args, packet_nnz=packet)
    theirs = jax_div.compress_csr(*args, packet_nnz=packet)
    for f in ("m", "n", "nnz", "packet_nnz", "n_packets"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in ("uvals", "rf", "u_ptr", "r_ptr", "vmode", "coords", "c_ptr",
              "row0", "rbits", "cbits"):
        g, w = getattr(ours, f), getattr(theirs, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert ours.mem_footprint_bytes() == theirs.mem_footprint_bytes()
    assert ours.csr_footprint_bytes() == theirs.csr_footprint_bytes()
    assert ours.compression_ratio() == theirs.compression_ratio()
    ia, ja, a = decompress(ours)
    assert np.array_equal(ia, h.ia) and np.array_equal(ja, h.ja)
    assert np.array_equal(a, h.a)
    if case == "levels" and packet == 4096:
        assert ours.vmode.all() and ours.compression_ratio() < 1


@pytest.fixture(scope="module")
def twin_mtx(tmp_path_factory):
    """The 2000-row scircuit twin written as scircuit_twin.mtx."""
    d = tmp_path_factory.mktemp("mtx")
    return mtx_sweep.write_twin(TWIN_LINE, str(d))


@pytest.mark.parametrize("rcm", [False, "auto"])
def test_load_matrix_mtx_matches_jax(twin_mtx, rcm):
    host, name, params = load_matrix(twin_mtx, BenchConfig(
        use_rcm_reordering=rcm))
    hj, nj, pj = jax_sweep.load_matrix(twin_mtx, JaxBenchConfig(
        use_rcm_reordering=rcm))
    assert (name, params) == (nj, pj) == ("scircuit_twin", None)
    for f in ("ia", "ja", "a"):
        assert np.array_equal(getattr(host, f), getattr(hj, f)), f
    twin = generate_from_line(TWIN_LINE)[0]
    if not rcm:
        assert np.array_equal(host.ja, twin.ja)


def test_sweep_mtx_rows_match_jax(twin_mtx, tmp_path):
    """A ``.mtx`` sweep (csr, csr_lut, bsrg; SpMV) writes JAX's real-matrix
    labels and, before the timing columns, JAX's row."""
    fmts = ("csr", "csr_lut", "bsrg")
    res = run_sweep([twin_mtx], formats=fmts, out_dir=str(tmp_path / "o"),
                    config=BenchConfig(**TINY), device="cpu")
    jax_sweep.run_sweep([twin_mtx], formats=fmts, impls=["xla"],
                        out_dir=str(tmp_path / "j"),
                        config=JaxBenchConfig(**TINY))
    labels = jax_bench.csv_labels(synthetic=False)
    for fmt in fmts:
        got = (tmp_path / "o" / f"{fmt}_spmv.csv").read_text().splitlines()
        want = (tmp_path / "j" / f"{fmt}_spmv.csv").read_text().splitlines()
        assert got[0] == want[0] == labels
        g, w = got[-1].split(","), want[1].split(",")
        assert len(g) == len(w) == len(labels.split(","))
        # column 1 is the device count (JAX's CPU mesh has 8)
        assert g[:1] + g[2:6] == w[:1] + w[2:6] and g[11] == w[11]
        assert g[15:20] == w[15:20]
        assert w[14].endswith("_xla") and g[14] == w[14][:-4] + "_torch"
    assert sorted(f"{r.format_name}/{r.impl}" for r in res) == [
        "BSRG/torch", "CSR/sparse", "CSR/torch", "CSR_LUT/torch"]
    for r in res:
        assert r.matrix_name == "scircuit_twin"
        assert r.metrics.max_rel_err < 1e-5


def test_mtx_round_trip_rows_equal(tmp_path):
    """``mtx_sweep.round_trip``: every disk row equals its in-memory row in
    m, n, nnz (an SpMM row: its shape) and the 8 metrics, and carries the
    real-matrix labels; the CLI exits 0 on the same twin."""
    mem, disk, bad = mtx_sweep.round_trip(
        [TWIN_LINE], str(tmp_path), config=BenchConfig(**TINY),
        device="cpu")
    assert bad == [] and len(disk) == len(mem) == 7
    assert sorted(f"{mtx_sweep.row_fields(r)[1]}/{mtx_sweep.row_fields(r)[2]}"
                  f" {mtx_sweep.row_fields(r)[3]}" for r in disk) == sorted(
        ["CSR/torch spmv", "CSR/torch spmm", "CSR_LUT/torch spmv",
         "CSR_LUT/torch spmm", "BSRG/torch spmv", "BSRG/torch spmm",
         "SELLG/torch spmm"])
    for fmt in ("csr", "csr_lut", "bsrg"):
        lines = (tmp_path / "disk" / f"{fmt}_spmv.csv").read_text()
        assert lines.splitlines()[0] == jax_bench.csv_labels(synthetic=False)
        lines = (tmp_path / "memory" / f"{fmt}_spmv.csv").read_text()
        assert lines.splitlines()[0] == jax_bench.csv_labels(synthetic=True)
    assert not torch.are_deterministic_algorithms_enabled()


def test_mtx_round_trip_finds_a_changed_matrix(tmp_path, monkeypatch):
    """A disk matrix that differs from its twin (one value off, written
    after the read-back check) fails the row comparison."""
    real_write = mtx_sweep.write_twin

    def write_and_spoil(line, mtx_dir):
        path = real_write(line, mtx_dir)
        host = generate_from_line(line)[0]
        host.a[0] += 0.5
        mtx_sweep.write_mtx(host, path)
        return path

    monkeypatch.setattr(mtx_sweep, "write_twin", write_and_spoil)
    _, _, bad = mtx_sweep.round_trip([TWIN_LINE], str(tmp_path),
                                     formats=("csr",), workloads=("spmv",),
                                     config=BenchConfig(**TINY),
                                     device="cpu")
    assert bad


def test_mtx_sweep_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MIN_NUM_LOOPS", "2")
    monkeypatch.setenv("MIN_TIME_S", "0")
    monkeypatch.setenv("K_DIM", "8")
    specs = tmp_path / "twins.txt"
    specs.write_text(f"# one twin\n{TWIN_LINE}\n")
    assert mtx_sweep.main(["--matrices", str(specs), "--out",
                           str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert "# 7 disk rows, 0 differ" in capsys.readouterr().out
    assert (tmp_path / "out" / "mtx" / "scircuit_twin.mtx").exists()
