"""CLOSG's two opt-in front ends in the port (kernels B4 and B7) against the
JAX package.

* Value LUT (``value_lut=True``, B4): a matrix with at most 128 distinct
  values keeps a 7-bit dictionary index per slot in r1 bits [24,31) and an
  (8, 128) dictionary plane instead of the value plane
  (``_gmul_r1_kernel`` with ``lut=True``).
* Fused windows (``fuse_windows=True``, B7): each 8-row group reads its x
  rows from one base row plus a per-slot rotation in r1 bits [24,27), over
  the non-empty x blocks (``_gmul_r1_win_kernel``); once with every block
  non-empty and once with empty blocks compacted away.

On the card B7 and B4 run B1's persistent tile body: a numpy emulation of
B7's walk (block b takes tiles b, b + grid, ...; the x rows of a tile
fetched ahead, gbase three tiles and nbids two; the tile's 8 windows staged
with columns past n and rows past the compacted plane zero) equals the
plain version, with and without compaction, at n % 128 != 0, on grids of 1,
7 and the card's blocks; and one of B4's (rowidx one tile ahead, the
dictionary staged once a block, each slot's value the dictionary entry at
word bits [24, 31), bit 31 set at random and ignored, windows at x's last,
partial row) equals its plain version on the same grids.

Both packages build the program from the same matrix and must give
identical arrays. The Pallas kernels run in interpret mode; the port runs
the plain versions, which its wrappers take for CPU tensors. A front end is
one gather and one product per slot, so it must match exactly; y is held to
1e-6 of |A|·|x| against the JAX pallas path.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos_gather import (_gmul_r1_kernel, _gmul_win,
                                               _windows)
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import build_clos_gather, spmv
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops.clos_gather import (
    DATA_FIELDS, META_FIELDS, from_jax_program)
from spmv_research_tpu_torch.ops.clos_route import ClosRoutingError

from torch_cases import random_lut_inputs, random_matrix, random_win_inputs


def _compacted_matrix():
    """600 × 4000 with columns only in every third 128-column block, so the
    fused front end compacts the x plane (dense_blocks False)."""
    mat = random_matrix(600, 4000, 0.02, 11).tocoo()
    keep = (mat.col // 128) % 3 == 0
    out = type(mat)((mat.data[keep], (mat.row[keep], mat.col[keep])),
                    shape=mat.shape).tocsr()
    out.sort_indices()
    return out


CASES = {
    "lut": (lambda: random_matrix(400, 400, 0.02, 7, levels=64),
            dict(value_lut=True)),
    "fused": (lambda: random_matrix(500, 700, 0.01, 3),
              dict(fuse_windows=True)),
    "fused_compacted": (_compacted_matrix, dict(fuse_windows=True)),
}


@lru_cache(maxsize=None)
def _case(name):
    """(name, matrix, JAX ClosG, the port's own ClosG, x)."""
    make, opts = CASES[name]
    mat = make()
    Aj = jax_build(JaxHostCSR.from_scipy(mat), **opts)
    A = build_clos_gather(HostCSR.from_scipy(mat), **opts)
    x = np.random.Generator(np.random.PCG64(7)).uniform(-1.0, 1.0,
                                                        mat.shape[1])
    return name, mat, Aj, A, x.astype(np.float32)


@pytest.fixture(params=sorted(CASES))
def case(request):
    return _case(request.param)


def test_program_identical(case):
    name, _, Aj, A, _ = case
    assert A.use_vlut == (name == "lut") and A.fused_win == (name != "lut")
    if name == "lut":
        assert tuple(A.vals_cs.shape) == (8, 128)
    else:
        assert A.dense_blocks == (name == "fused")
    for f in DATA_FIELDS:
        assert np.array_equal(getattr(A, f).numpy(),
                              np.asarray(getattr(Aj, f))), f
    assert ({f: getattr(A, f) for f in META_FIELDS}
            == {f: getattr(Aj, f) for f in META_FIELDS})


def test_front_matches_pallas_front(case):
    name, _, Aj, A, x = case
    xt = torch.from_numpy(x)
    if name == "lut":
        want = _call(partial(_gmul_r1_kernel, True),
                     _windows(Aj, jnp.asarray(x)), Aj.perm_r1, Aj.vals_cs)
        got = K.closg_front_lut_torch(A.rowidx, A.perm_r1, A.vals_cs, xt)
        wrapped = K.closg_front_lut(A.rowidx, A.perm_r1, A.vals_cs, xt)
    else:
        want = _gmul_win(Aj, jnp.asarray(x))
        args = (A.gbase, A.nbids, A.perm_r1, A.vals_cs, xt, A.dense_blocks)
        got = K.closg_front_win_torch(*args)
        wrapped = K.closg_front_win(*args)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(wrapped, got)     # CPU tensors: the plain version


@pytest.mark.parametrize("name", ["fused", "fused_compacted"])
def test_fused_window_row_is_the_gathered_row(name):
    """The builder's assert (clos_gather.py:309) makes base + rotation name
    the x row x2d[rowidx[s]] of every slot: the fused front end equals K1's
    plain version on the same words and values."""
    _, _, _, A, x = _case(name)
    xt = torch.from_numpy(x)
    assert torch.equal(
        K.closg_front_win_torch(A.gbase, A.nbids, A.perm_r1, A.vals_cs, xt,
                                A.dense_blocks),
        K.closg_front_torch(A.rowidx, A.perm_r1, A.vals_cs, xt))


def test_y_matches_jax_pallas(case):
    _, mat, Aj, A, x = case
    want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
    got = spmv(A, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    scale = np.abs(mat) @ np.abs(x).astype(np.float64) + 1e-30
    assert got.shape == (mat.shape[0],)
    assert np.max(np.abs(got - want) / scale) <= 1e-6
    B = from_jax_program({f: np.asarray(getattr(Aj, f)) for f in DATA_FIELDS},
                         {f: getattr(Aj, f) for f in META_FIELDS})
    assert torch.equal(spmv(B, torch.from_numpy(x)), torch.from_numpy(got))


def test_lut_and_fused_windows_are_exclusive():
    """Both options use r1 bits 24+: the builder keeps the LUT, and a
    program that claims both is refused."""
    _, mat, Aj, _, _ = _case("lut")
    A = build_clos_gather(HostCSR.from_scipy(mat), value_lut=True,
                          fuse_windows=True)
    assert A.use_vlut and not A.fused_win
    meta = {f: getattr(Aj, f) for f in META_FIELDS}
    meta["fused_win"] = True
    with pytest.raises(ClosRoutingError, match="both"):
        from_jax_program({f: np.asarray(getattr(Aj, f)) for f in DATA_FIELDS},
                         meta)


# ------------------------------------------------ B7's persistent tile walk

def _emulate_front_win(gbase, nbids, perm_r1, vals, x, dense, grid):
    """``csrc/closg.cu`` ``front_kernel<kFrontWin>`` in numpy: block b walks
    tiles b, b + grid, ... with the kernel's pipeline — a tile's gbase
    fetched three tiles ahead, its windows' x blocks (nbids, or the
    compacted row itself when ``dense``) two, its words, values and x
    windows one — and per tile stages the 8 windows (columns past n, and
    rows past the n_nb compacted rows, 0), multiplies each slot's value by
    window ((s + rot) & 7) at lane λ, and applies the r1 layer's picks."""
    n_tiles, n_x, n_nb = gbase.size, x.size, nbids.size
    w = perm_r1.reshape(-1).view(np.uint32)
    out = np.full(n_tiles * 1024, np.nan, np.float32)
    taken = np.zeros(n_tiles, np.int64)
    rows, cols, i = np.arange(8), np.arange(128), np.arange(1024)

    def base_of(tile):
        return int(gbase[tile]) if tile < n_tiles else 0

    def block_of(tile, base):
        if tile >= n_tiles:
            return np.full(8, -1)
        r = base + rows
        if dense:
            return r
        return np.where(r < n_nb, nbids[np.minimum(r, n_nb - 1)], -1)

    def load(tile, blk):
        col = blk[:, None].astype(np.int64) * 128 + cols
        xs = np.where((blk[:, None] >= 0) & (col < n_x),
                      x[np.clip(col, 0, n_x - 1)], 0.0).astype(np.float32)
        return (w[tile * 1024:(tile + 1) * 1024],
                vals[tile * 1024:(tile + 1) * 1024], xs.reshape(-1))

    for b in range(min(grid, n_tiles)):
        c = b
        cur = load(c, block_of(c, base_of(c)))
        blk_next = block_of(c + grid, base_of(c + grid))
        base_next = base_of(c + 2 * grid)
        while c < n_tiles:
            nxt = (load(c + grid, blk_next) if c + grid < n_tiles else None)
            blk_next = block_of(c + 2 * grid, base_next)
            base_next = base_of(c + 3 * grid)
            ws, vs, xs = cur
            win = (((i >> 7) + (ws >> 24)) & 7) * 128
            p = xs[win + ((ws >> 17) & 0x7F)] * vs
            taken[c] += 1
            out[c * 1024 + i] = _pick(ws, p)
            cur, c = nxt, c + grid
    assert (taken == 1).all()
    return out


def _pick(w, v):
    """The r1 layer's three picks on one 1024-slot tile (rows of 128)."""
    i = np.arange(1024)
    s = i >> 7
    c = (w >> 10) & 0x7F
    rot = (w[s * 128 + c] >> 7) & 7
    s2 = (s & ~7) + (((s & 7) + rot) & 7)
    lane = w[s2 * 128 + c] & 0x7F
    return v[s2 * 128 + lane]


@pytest.mark.parametrize("grid", [1, 7, 528])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "compacted"])
@pytest.mark.parametrize("n_tiles, n_x", [(40, 5037), (600, 20000)])
def test_front_win_persistent_walk_matches_plain(n_tiles, n_x, dense, grid):
    rng = np.random.Generator(np.random.PCG64(n_tiles + n_x + dense))
    gbase, nbids, perm_r1, vals, x = random_win_inputs(rng, n_tiles, n_x,
                                                       dense)
    got = _emulate_front_win(gbase, nbids, perm_r1, vals, x, dense, grid)
    want = K.closg_front_win_torch(
        torch.from_numpy(gbase), torch.from_numpy(nbids),
        torch.from_numpy(perm_r1), torch.from_numpy(vals).view(-1, 128),
        torch.from_numpy(x), dense)
    assert np.array_equal(got, want.numpy().reshape(-1))


@pytest.mark.parametrize("name", ["fused", "fused_compacted"])
def test_front_win_walk_on_built_programs(name):
    """The emulated walk on the built programs (7 blocks) equals the plain
    version and the JAX package's fused front end."""
    _, _, Aj, A, x = _case(name)
    got = _emulate_front_win(A.gbase.numpy(), A.nbids.numpy(),
                             A.perm_r1.numpy(), A.vals_cs.numpy().reshape(-1),
                             x, A.dense_blocks, 7)
    assert np.array_equal(got, np.asarray(_gmul_win(Aj, jnp.asarray(x))
                                          ).reshape(-1))


# ------------------------------------------------ B4's persistent tile walk

def _emulate_front_lut(rowidx, perm_r1, dict_plane, x, grid):
    """``csrc/closg.cu`` ``front_kernel<kFrontLut>`` in numpy: block b
    stages the dictionary (row 0 of the (8, 128) plane) once, then walks
    tiles b, b + grid, ... with the kernel's pipeline — a tile's 8 rowidx
    entries fetched two steps ahead, its words and x windows one — and per
    tile stages the 8 windows (columns past n 0), multiplies each slot's x
    at lane λ of its own row's window by the dictionary entry at word bits
    [24, 31), and applies the r1 layer's picks. No value plane is read."""
    n_tiles, n_x = rowidx.size // 8, x.size
    w = perm_r1.reshape(-1).view(np.uint32)
    out = np.full(n_tiles * 1024, np.nan, np.float32)
    taken = np.zeros(n_tiles, np.int64)
    cols, i = np.arange(128), np.arange(1024)

    def block_of(tile):
        if tile >= n_tiles:
            return np.full(8, -1)
        return rowidx[tile * 8:(tile + 1) * 8].astype(np.int64)

    def load(tile, blk):
        col = blk[:, None] * 128 + cols
        xs = np.where((blk[:, None] >= 0) & (col < n_x),
                      x[np.clip(col, 0, n_x - 1)], 0.0).astype(np.float32)
        return w[tile * 1024:(tile + 1) * 1024], xs.reshape(-1)

    for b in range(min(grid, n_tiles)):
        dict_sh = dict_plane.reshape(-1)[:128].copy()
        c = b
        cur = load(c, block_of(c))
        blk_next = block_of(c + grid)
        while c < n_tiles:
            nxt = (load(c + grid, blk_next) if c + grid < n_tiles else None)
            blk_next = block_of(c + 2 * grid)
            ws, xs = cur
            p = xs[(i & ~127) + ((ws >> 17) & 0x7F)] * dict_sh[
                (ws >> 24) & 0x7F]
            taken[c] += 1
            out[c * 1024 + i] = _pick(ws, p)
            cur, c = nxt, c + grid
    assert (taken == 1).all()
    return out


@pytest.mark.parametrize("grid", [1, 7, 528])
@pytest.mark.parametrize("n_tiles, n_x", [(40, 5037), (600, 20000),
                                          (9, 3 * 128 + 5)])
def test_front_lut_persistent_walk_matches_plain(n_tiles, n_x, grid):
    rng = np.random.Generator(np.random.PCG64(n_tiles + n_x + grid))
    rowidx, perm_r1, dict_plane, x = random_lut_inputs(rng, n_tiles, n_x)
    assert (perm_r1.view(np.uint32) >> 31).any()
    got = _emulate_front_lut(rowidx, perm_r1, dict_plane, x, grid)
    want = K.closg_front_lut_torch(
        torch.from_numpy(rowidx), torch.from_numpy(perm_r1),
        torch.from_numpy(dict_plane), torch.from_numpy(x))
    assert np.array_equal(got, want.numpy().reshape(-1))
    # the dictionary's rows past 0 are never read
    dict_plane[1:] = np.nan
    assert np.array_equal(
        _emulate_front_lut(rowidx, perm_r1, dict_plane, x, grid), got)


def test_front_lut_walk_on_built_program():
    """The emulated walk on the built LUT program (7 blocks) equals the
    plain version and the JAX package's Pallas front end."""
    _, _, Aj, A, x = _case("lut")
    got = _emulate_front_lut(A.rowidx.numpy(), A.perm_r1.numpy(),
                             A.vals_cs.numpy(), x, 7)
    want = _call(partial(_gmul_r1_kernel, True),
                 _windows(Aj, jnp.asarray(x)), Aj.perm_r1, Aj.vals_cs)
    assert np.array_equal(got, np.asarray(want).reshape(-1))
