"""The frozen generator and transforms against the port's, on small table
lines; the mirror transform's properties; the matrix cache."""

import json
import os

import numpy as np
import pytest

from benchmark import matrices

from conftest import BENCH_DIR, TINY_ROWS, tiny_config

LINES = [
    # the two configurations' lines, cut to a few thousand rows
    *(tiny_config(json.load(open(os.path.join(BENCH_DIR, "configs", f))))
      ["twin_line"] for f in ("ldoor.json", "shipsec1_spd.json")),
    # raefsky3 and gupta3 (the heavy-tailed branch), cut
    "3000 3000 70.2249056604 6.3269998323 normal random 0.0662003204 "
    "0.1391969736 1.9160003439 0.9630195886 14 raefsky3",
    "3000 3000 555.5280343204 1233.5202594143 normal random 0.5718415058 "
    "25.4109083495 1.9016586927 0.9767488489 14 gupta3",
    # the other distributions and placements
    "2000 2500 10 3 gamma diagonal_0.5 1 2 0.5 0.3 7",
    "2000 2000 5 1 normal simple 1 0 0 0 3",
]


def _same(c, h):
    return (c.m, c.n) == (h.m, h.n) and all(
        np.array_equal(a, b) for a, b in ((c.ia, h.ia), (c.ja, h.ja),
                                          (c.a, h.a)))


@pytest.mark.parametrize("line", LINES)
def test_frozen_generator_equals_the_port(line):
    from spmv_research_tpu_torch.gen.artificial import generate_from_line
    c = matrices.generate_twin(line)
    h, _ = generate_from_line(line)
    assert _same(c, h)
    assert c.ia.dtype == c.ja.dtype == np.int32 and c.a.dtype == np.float64


@pytest.mark.parametrize("line", LINES[:4])
def test_frozen_make_spd_equals_the_port(line):
    from spmv_research_tpu_torch.convert.coo_csr import make_spd
    from spmv_research_tpu_torch.gen.artificial import generate_from_line
    h, _ = generate_from_line(line)
    assert _same(matrices.make_spd(matrices.generate_twin(line)), make_spd(h))


def test_mirror_spd_keeps_the_strict_lower_triangle():
    import scipy.sparse as sp
    c = matrices.generate_twin(LINES[1])
    S = matrices.mirror_spd(c).to_scipy()
    L = sp.tril(c.to_scipy(), k=-1)
    assert abs(S - S.T).max() == 0
    assert abs(sp.tril(S, k=-1) - L).max() == 0
    off = S - sp.diags(S.diagonal())
    assert np.allclose(S.diagonal(), np.abs(off).sum(axis=1).A1 + 1.0)
    # the mirror keeps the line's density; (A + Aᵀ)/2 nearly doubles it
    assert matrices.mirror_spd(c).nnz < 1.2 * c.nnz
    assert matrices.make_spd(c).nnz > 1.6 * c.nnz


def test_matrix_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(matrices, "CACHE_DIR", str(tmp_path))
    cfg_file = tmp_path / "tiny.json"
    cfg = {"twin_line": LINES[1], "transform": "make_spd"}
    cfg_file.write_text(json.dumps(cfg))
    a = matrices.load_matrix(cfg, str(cfg_file))
    path = matrices.cache_path(str(cfg_file))
    assert os.path.exists(path) and a.m == TINY_ROWS
    b = matrices.load_matrix(cfg, str(cfg_file))
    assert _same(a, b)
    # an edit to the configuration's file is a new entry
    cfg_file.write_text(json.dumps(cfg) + "\n")
    assert matrices.cache_path(str(cfg_file)) != path
