"""The r2 layer with its transposes (B2's ``clos_r2``) and B1's persistent
front end, on the CPU.

``clos_r2`` computes the JAX package's ``_t_bwd(invreg(_t_fwd(v, V), r2),
V)`` on C stacked natural (8V, 128) planes in one launch, its addressing
doing the transposition. Here:

* its plain version ``clos_r2_torch`` equals that JAX composition
  (``clos_pallas._t_fwd``/``_t_bwd`` around ``clos._invreg_xla``) bit for
  bit, plane by plane, on random words and values made with numpy from a
  seed (a layer is three gathers: nothing rounds);
* a numpy emulation of the kernel's tile addressing — the arithmetic of
  ``csrc/closg.cu`` ``layer_kernel``, with the tile geometry of the host
  mirror ``clos_cuda.r2_geometry`` — writes every slot exactly once and
  equals ``clos_r2_torch`` at every V from 8 to 1024, and, in the natural
  addressing, ``clos_invreg_torch`` at every lane width;
* a numpy emulation of B1's persistent walk (block b takes tiles b, b +
  grid, ...; each tile's 8 x windows staged with the columns past n zero)
  equals ``closg_front_torch``;
* the CLOSG, CLOSGX and CLOS pipelines route their r2 layer through
  ``clos_r2`` (one call a program, a stack, a network).

No Pallas kernel runs here: the kernels' counterparts run on the card
(``test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmv_research_tpu.ops import clos as jax_clos
from spmv_research_tpu.ops import clos_pallas as jax_cp

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import (build_clos, build_clos_gather,
                                         build_clos_gather_xl, spmv)
from spmv_research_tpu_torch.ops import clos as C
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops import clos_gather as CG
from spmv_research_tpu_torch.ops import clos_xl as CX

from torch_cases import random_matrix

ALL_V = [8, 16, 32, 64, 128, 256, 512, 1024]


def _words(rng, S, L):
    """Random in-vreg words of an (S, L) plane (lanes < L, any rotation,
    random payload bits)."""
    return (rng.integers(0, L, (S, L)) | rng.integers(0, 8, (S, L)) << 7
            | rng.integers(0, L, (S, L)) << 10
            | rng.integers(0, 1 << 15, (S, L)) << 17
            ).astype(np.uint32).view(np.int32)


def _r2_inputs(V, n_planes, seed):
    """Values of n_planes stacked natural (8V, 128) planes and their
    stored r2 words, (n_planes·8·1024, V/8)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    v = rng.uniform(-1, 1, (n_planes * 8 * V, 128)).astype(np.float32)
    return v, _words(rng, n_planes * 8 * 1024, V // 8)


@pytest.mark.parametrize("n_planes", [1, 3])
@pytest.mark.parametrize("V", [8, 128, 1024])
def test_clos_r2_torch_equals_jax_composition(V, n_planes):
    v, w = _r2_inputs(V, n_planes, seed=V + n_planes)
    got = K.clos_r2_torch(torch.from_numpy(v), torch.from_numpy(w), V)
    # the CPU wrapper takes the plain version
    assert torch.equal(K.clos_r2(torch.from_numpy(v), torch.from_numpy(w), V),
                       got)
    S, N = 8 * V, 1024 * V
    for c in range(n_planes):
        want = jax_cp._t_bwd(jax_clos._invreg_xla(
            jax_cp._t_fwd(jnp.asarray(v[c * S:(c + 1) * S]), V),
            jnp.asarray(w[c * 8 * 1024:(c + 1) * 8 * 1024])), V)
        assert np.array_equal(got.numpy()[c * S:(c + 1) * S],
                              np.asarray(want)), c
    assert got.shape == (n_planes * S, 128) and N == S * 128


# ------------------------------------------------ the kernel's addressing

def _group_pick(ws, wrow, vs, vbase, vstride, i, lshift):
    """``group_pick`` of csrc/closg.cu, vectorised over slots: the picks of
    group slots i, the group's words from ws[wrow], its slot x's value at
    vs[vbase + x·vstride]."""
    lmask = (1 << lshift) - 1
    c = (ws[wrow + i] >> 10) & lmask
    j = i >> lshift
    j2 = (j + ((ws[wrow + (j << lshift) + c] >> 7) & 7)) & 7
    lane = ws[wrow + (j2 << lshift) + c] & lmask
    return vs[vbase + ((j2 << lshift) + lane) * vstride]


def _quads(threads):
    """The quads the threads of a tile move: thread t takes q = t + e·threads
    for e < R2_QUADS."""
    return (np.arange(threads)[None, :]
            + threads * np.arange(K.R2_QUADS)[:, None]).reshape(-1)


def _emulate_layer(v, word, lanes, V=None):
    """``layer_kernel`` in numpy: kTrans (V given) over stacked natural
    planes of 1024·V slots, the values staged in natural order as its TMA
    boxes land them (nb floats of each of up to 256 natural blocks a box)
    and the output leaving the same way, or the natural addressing of an
    (n / lanes, lanes) plane. Returns (out, how many times each slot was
    written)."""
    v, word = v.reshape(-1), word.reshape(-1).view(np.uint32)
    n = v.size
    nb, slots, rs, threads, smem = K.r2_geometry(V)
    assert threads <= 1024 and smem <= 227 * 1024
    out = np.full(n, np.nan, np.float32)
    written = np.zeros(n, np.int64)
    lshift = lanes.bit_length() - 1
    n_tiles = -(-n // slots)
    if V is not None:
        vlog = V.bit_length() - 1
        assert n % (1024 * V) == 0 and lshift == vlog - 3
        qlog = nb.bit_length() - 3          # __ffs(nb) - 3
        tpp = 1024 // nb
        assert n // slots == n_tiles        # the C entry's grid
    for tile in range(n_tiles):
        q = _quads(threads)
        if V is not None:
            base = (tile // tpp) << (vlog + 10)
            b0 = (tile % tpp) * nb
            wbase = base + (b0 << vlog)
            a, p = q >> qlog, q & ((1 << qlog) - 1)
            vofs = base + (a << 10) + b0 + 4 * p
            wi = ((4 * q) >> vlog) * rs + ((4 * q) & (V - 1))
        else:
            base = wbase = tile * slots
            q = q[q < min(slots, n - base) // 4]
            vofs, wi = base + 4 * q, 4 * q
        vs = np.full(slots, np.nan, np.float32)
        ws = np.zeros(max(slots, nb * rs), np.uint32)
        if V is not None:
            # the TMA boxes: rows [r, r + box) of the plane's blocks, nb
            # floats from b0, landing at vs[r·nb:]
            assert smem == 4 * (2 * slots + ws.size) + 8
            box = min(V, 256)
            blocks = v.reshape(-1, 1024)
            for r in range(0, V, box):
                vs[r * nb:(r + box) * nb] = blocks[
                    (base >> 10) + r:(base >> 10) + r + box,
                    b0:b0 + nb].reshape(-1)
        else:
            assert smem == 4 * (vs.size + ws.size)
            for k in range(4):
                vs[4 * q + k] = v[vofs + k]
        for k in range(4):
            ws[wi + k] = word[wbase + 4 * q + k]
        os_ = np.full(slots, np.nan, np.float32)
        for k in range(4):
            if V is not None:
                beta = 4 * p + k
                r = _group_pick(ws, beta * rs, vs, beta, nb, a, lshift)
                os_[4 * q + k] = r
            else:
                t = 4 * q + k
                g0 = t & ~((8 << lshift) - 1)
                r = _group_pick(ws, g0, vs, g0, 1, t - g0, lshift)
                np.add.at(written, vofs + k, 1)
                out[vofs + k] = r
        if V is not None:              # the TMA stores of the staged output
            o = out.reshape(-1, 1024)
            w_ = written.reshape(-1, 1024)
            for r in range(0, V, box):
                rows = slice((base >> 10) + r, (base >> 10) + r + box)
                o[rows, b0:b0 + nb] = os_[r * nb:(r + box) * nb].reshape(
                    box, nb)
                w_[rows, b0:b0 + nb] += 1
    return out, written


@pytest.mark.parametrize("V", ALL_V)
def test_r2_tile_addressing_covers_each_slot_once(V):
    n_planes = 2 if V <= 256 else 1
    v, w = _r2_inputs(V, n_planes, seed=100 + V)
    out, written = _emulate_layer(v, w, V // 8, V)
    assert (written == 1).all()
    want = K.clos_r2_torch(torch.from_numpy(v), torch.from_numpy(w), V)
    assert np.array_equal(out, want.numpy().reshape(-1))


@pytest.mark.parametrize("lanes, n", [(1, 8192), (2, 8192), (16, 16384),
                                      (128, 8192), (128, 1024),
                                      (64, 9216 + 1024)])
def test_natural_tile_addressing_matches_invreg(lanes, n):
    """``clos_invreg``'s natural addressing at every lane width, a short
    last tile included."""
    rng = np.random.Generator(np.random.PCG64(lanes + n))
    v = rng.uniform(-1, 1, (n // lanes, lanes)).astype(np.float32)
    w = _words(rng, n // lanes, lanes)
    out, written = _emulate_layer(v, w, lanes)
    assert (written == 1).all()
    want = K.clos_invreg_torch(torch.from_numpy(v), torch.from_numpy(w))
    assert np.array_equal(out, want.numpy().reshape(-1))


@pytest.mark.parametrize("V", [128, 256, 512, 1024])
def test_r2_geometry(V):
    """Runs of R2_RUN floats, 128 tiles a plane, and a first pick (a warp
    reads word row beta at its threads' natural blocks a) free of shared
    bank conflicts, from V = 128 up."""
    nb, slots, rs, threads, _ = K.r2_geometry(V)
    assert nb == K.R2_RUN and slots == nb * V and 1024 * V // slots == 128
    assert threads * K.R2_QUADS * 4 == slots
    q = np.arange(32)                       # one warp's first quads
    qlog = nb.bit_length() - 3
    a, p = q >> qlog, q & ((1 << qlog) - 1)
    for k in range(4):
        banks = ((4 * p + k) * rs + a) % 32
        assert np.unique(banks).size == 32
    assert K.r2_geometry(8)[:2] == (128, 1024)      # whole r2 blocks


def _emulate_front(rowidx, perm_r1, vals, x, grid):
    """B1's persistent walk and x staging in numpy: block b takes tiles b,
    b + grid, ...; each tile's 8 windows of 128 x columns (0 past n), the
    product with each slot's value, then the r1 layer's picks."""
    S = rowidx.size
    n_tiles, n_x = S // 8, x.size
    w = perm_r1.reshape(-1).view(np.uint32)
    out = np.full(S * 128, np.nan, np.float32)
    taken = np.zeros(n_tiles, np.int64)
    cols = np.arange(128)
    for b in range(grid):
        for c in range(b, n_tiles, grid):
            taken[c] += 1
            col = rowidx[c * 8:(c + 1) * 8, None].astype(np.int64) * 128 + cols
            xs = np.where(col < n_x, x[np.minimum(col, n_x - 1)], 0.0)
            xs = xs.astype(np.float32).reshape(-1)
            ws = w[c * 1024:(c + 1) * 1024]
            i = np.arange(1024)
            vs = xs[(i & ~127) + ((ws >> 17) & 0x7F)] * vals[c * 1024 + i]
            out[c * 1024 + i] = _group_pick(ws, 0, vs, 0, 1, i, 7)
    assert (taken == 1).all()
    return out


@pytest.mark.parametrize("S, n_x, grid", [(64, 1000, 3), (40, 1001, 8),
                                          (16, 300, 1), (32, 4096, 4)])
def test_front_persistent_walk_matches_plain(S, n_x, grid):
    rng = np.random.Generator(np.random.PCG64(S + n_x))
    rowidx = rng.integers(0, -(-n_x // 128), S).astype(np.int32)
    perm_r1 = _words(rng, S, 128)
    vals = rng.uniform(-1, 1, S * 128).astype(np.float32)
    x = rng.uniform(-1, 1, n_x).astype(np.float32)
    got = _emulate_front(rowidx, perm_r1, vals, x, grid)
    want = K.closg_front_torch(torch.from_numpy(rowidx),
                               torch.from_numpy(perm_r1),
                               torch.from_numpy(vals).view(S, 128),
                               torch.from_numpy(x))
    assert np.array_equal(got, want.numpy().reshape(-1))


# ------------------------------------------------------------ the callers

def _spy(monkeypatch):
    calls = []

    def clos_r2(v, word, V):
        calls.append((tuple(v.shape), V))
        return K.clos_r2_torch(v, word, V)
    monkeypatch.setattr(K, "clos_r2", clos_r2)
    return calls


@pytest.mark.parametrize("kind", ["closg", "closgx", "clos"])
def test_pipelines_take_clos_r2(kind, monkeypatch):
    """Each pipeline's kernel path (the wrappers, here on CPU tensors)
    takes the r2 layer through ``clos_r2`` on the natural planes — once a
    CLOSG program, once a CLOSGX stack, once a CLOS network — and gives
    the plain impl's y."""
    mat = random_matrix(300, 300, 0.01, 1)
    host = HostCSR.from_scipy(mat)
    A, pipe, want_calls = {
        "closg": lambda: (build_clos_gather(host), CG._pipeline, 1),
        "closgx": lambda: (build_clos_gather_xl(host, chunk_N=8192),
                           CX._pipeline, 1),
        "clos": lambda: (build_clos(host), C._pipeline, 3)}[kind]()
    x = torch.from_numpy(np.random.Generator(np.random.PCG64(7)).uniform(
        -1, 1, 300).astype(np.float32))
    calls = _spy(monkeypatch)
    y = pipe(A, x, plain=False)
    assert len(calls) == want_calls
    assert all(shape[1] == 128 for shape, _ in calls)   # natural planes
    assert torch.equal(y, spmv(A, x))
