// Hand-written Hopper (sm_90a) kernels of the CLOSG SpMV engine: the front
// ends (plain, value-LUT, fused windows), the in-vreg layer (natural, and
// the r2 layer with its two transposes folded into its addressing), the
// segmented scan in phases of tiles with a halo (K3's capped scan, B5,
// B15), and the three y extractions (windowed, candidate-plane, CLOSGX);
// and the r3 steps of the exact-CLOS engine (B8: the same phased scan ×
// values, or selecting for the forward fill, and the r3 layer with the
// out-valid mask).
//
// Built by spmv_research_tpu_torch/ops/clos_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Program layout (spmv_research_tpu/ops/clos.py): a slot array is viewed as
// rows of L lanes (L = 128, or V/8 for the r2 layer), grouped in 8-row tiles.
// One packed uint32 word per slot holds the in-vreg layer's indices: bits
// [0,7) lane1, [7,10) sublane rotation, [10,17) lane2, and a 15-bit payload
// [17,32) (r1: x lane λ in [17,24), then the value index [24,31) or the
// window rotation [24,27); r3: scan guards). Words use all 32 bits, so they
// are read as uint32_t.
//
// One in-vreg layer, for output (s, l'):
//   c  = lane2(w[s,l'])
//   s2 = 8*(s/8) + (s%8 + rot(w[s,c])) % 8
//   l  = lane1(w[s2,c])
//   out[s,l'] = v[s2,l]
// A 1024-slot block holds whole 8-row tiles for every L <= 128, so a
// thread block stages its words and values in shared memory and resolves
// the three dependent picks there.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 8;
constexpr int kBlockSlots = 1024;
constexpr int kLanes = 128;

__device__ __forceinline__ float invreg_pick(const uint32_t* w, const float* v,
                                             int t, int lshift) {
  const int L = 1 << lshift;
  const int s = t >> lshift;
  const int c = (w[t] >> 10) & 0x7F;
  const int rot = (w[s * L + c] >> 7) & 0x7;
  const int s2 = (s & ~(kSub - 1)) + (((s & (kSub - 1)) + rot) & (kSub - 1));
  const int l = w[s2 * L + c] & 0x7F;
  return v[s2 * L + l];
}

// B8's valid step — replaces spmv_research_tpu/ops/clos_pallas.py
// `_r3_valid_kernel` (the compact network's r3 layer, then 0 unless bit 17
// of the r3 word, the out-valid bit). One block per 1024 slots, one slot a
// thread. A pick stays inside its 1024-slot block, so the wrapper launches
// only the leading blocks that hold y. Bound: device memory, 12 bytes per
// slot of those blocks.
__global__ void valid_kernel(const float* __restrict__ v,
                             const uint32_t* __restrict__ word,
                             float* __restrict__ out) {
  __shared__ uint32_t w_sh[kBlockSlots];
  __shared__ float v_sh[kBlockSlots];
  const int64_t off = (int64_t)blockIdx.x * kBlockSlots;
  const int t = threadIdx.x;
  w_sh[t] = word[off + t];
  v_sh[t] = v[off + t];
  __syncthreads();
  const float r = invreg_pick(w_sh, v_sh, t, 7);
  out[off + t] = ((w_sh[t] >> 17) & 1u) ? r : 0.0f;
}

// ------------------------------------------------------------------- B2
//
// The in-vreg layer — replaces spmv_research_tpu/ops/clos_pallas.py
// `_invreg_kernel` — in two addressings of one tile body (layer_kernel):
//   `clos_r2` (kTrans): the r2 layer with the transposes around it, the
//     JAX package's _t_bwd(invreg(_t_fwd(v, V), r2), V), on the natural
//     (8V, 128) planes of C stacked programs: no transposed copy of the
//     plane is ever made;
//   `clos_invreg`: one layer on a natural (S, L) plane, L <= 128 (CLOS's
//     r1 layers; L = 128).
// _t_fwd views a plane of N = 1024·V slots as V natural blocks a of 1024
// slots and lays slot (a, b) at b·V + a: an 8-row group of the transposed
// (8·1024, V/8) plane is one offset b of every natural block, and the
// layer's picks stay in it. So a tile of nb consecutive offsets [b0, b0 +
// nb) reads one run of nb floats from each natural block (out is written
// to the same runs) and nb·V consecutive words of the stored r2 plane, and
// its picks need nothing outside it.
// Bound: device memory, 12 bytes per slot (word and value read once, out
// written once); the picks hit shared memory.
// The design: the words are 16-byte loads, streamed past L1 (__ldcs),
// kR2Quads a thread, issued before any use (a 1024-thread tile holds 32 KB
// of them in flight) and staged in transposed order, the rows of V words
// padded by 4 (V >= 32) so that the first pick, a column read of the word
// rows by the threads of one run, is free of bank conflicts at nb = 8.
// The natural addressing loads and stores its values the same way. The
// transposed tile's values are V runs of nb floats 4 KB apart, in and
// out. They move by TMA: one thread issues 2-D tensor copies of boxes of
// nb floats × up to 256 blocks (the plane viewed as rows of 1024 floats,
// 4 KB apart) into shared memory in natural order, completing on an
// mbarrier; after the words' barrier and the copies' mbarrier each thread
// resolves its own 4 natural-order slots' three picks from shared memory
// into a staged natural-order output tile, which goes back by TMA the same
// way. As 16-byte loads and stores through L1 (a warp's request touches
// 16 lines, one 32-byte sector each, for 512 bytes) the tile took 0.0187
// ms cold, 0.0137 warm (H100 SXM, 700 W), with TMA loads and 16-byte
// stores 0.0188 and 0.0122, with TMA both ways 0.0138 and 0.0075; the
// natural addressing, the same bytes in whole lines, takes 0.0117 and
// 0.0056 (time_clos_scans.py).
// The tile width nb follows from V: runs of kR2Run floats (one 32-byte
// sector) where V >= 1024 / kR2Run, so a plane is 1024 / kR2Run = 128
// tiles at every V >= 128 (1024 threads at V = 1024, 2 blocks an SM by the
// launch bounds); whole r2 blocks of 1024 slots below that (longer runs).
// At V = 1024, runs of 4 floats (256 tiles of 512 threads) took 0.0153
// ms cold and runs of 16 (64 tiles) 0.0162, against 0.0137 at 8
// (time_clos_scans.py --set kR2Run=R, the same card). The natural
// addressing stages kR2Run·1024 contiguous slots.
constexpr int kR2Run = 8;  // floats of each natural block a tile reads
// 16-byte quads of values and of words a thread: 1024 threads a tile
constexpr int kR2Quads = kR2Run > 8 ? kR2Run / 4 : 2;
constexpr int kR2MaxThreads = kR2Run * kBlockSlots / (4 * kR2Quads);
constexpr int kTmaBoxRows = 256;   // a TMA box's most rows (natural blocks)

// A tile's geometry: nb b offsets (0 in the natural addressing), its slots,
// the staged word row stride (kTrans), its threads, and its shared bytes.
struct R2Geom {
  int nb, slots, rs, threads, smem;
};

// vlog = log2 V of a transposed tile, or -1 for the natural addressing.
// Mirrored by ops/clos_cuda.py r2_geometry.
__host__ __device__ inline R2Geom r2_geom(int vlog) {
  R2Geom g;
  if (vlog >= 0) {
    g.nb = (kBlockSlots >> vlog) > kR2Run ? kBlockSlots >> vlog : kR2Run;
    g.slots = g.nb << vlog;
    g.rs = (1 << vlog) + (vlog >= 5 ? 4 : 0);
    // values, the output, words, the mbarrier
    g.smem = 4 * (2 * g.slots + g.nb * g.rs) + 8;
  } else {
    g.nb = 0;
    g.slots = kR2Run * kBlockSlots;
    g.rs = 0;
    g.smem = 8 * g.slots;
  }
  g.threads = g.slots / (4 * kR2Quads);
  return g;
}

// The in-vreg pick of slot i = j·L + l' of one 8-row group of L = 2^lshift
// lanes: its words at w[0, 8L), its values at vals[x·vstride] for group
// slot x. Lanes are masked to the row, so a word can never leave its group.
__device__ __forceinline__ float group_pick(const uint32_t* w,
                                            const float* vals, int vstride,
                                            int i, int lshift) {
  const int lmask = (1 << lshift) - 1;
  const int c = (w[i] >> 10) & lmask;
  const int j = i >> lshift;
  const int j2 = (j + ((w[(j << lshift) + c] >> 7) & 0x7)) & (kSub - 1);
  const int l = w[(j2 << lshift) + c] & lmask;
  return vals[((j2 << lshift) + l) * vstride];
}

// TMA: 2-D tensor copies between a plane viewed as rows of 1024 floats and
// shared memory, completing on an mbarrier (loads) or a bulk group
// (stores).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(map), "r"(col), "r"(row),
         "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, int col,
                                          int row, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];"
      :: "l"(map), "r"(col), "r"(row), "r"(smem_addr(src))
      : "memory");
}

// Wait until the mbarrier's phase `parity` completes; trap rather than
// spin forever if the copies never land.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int64_t spins = 0; !done; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && spins > (int64_t(1) << 30)) __trap();
  }
}

// One tile: kTrans, the r2 layer of tile blockIdx.x (plane blockIdx.x /
// (1024 / nb), offsets b0 = nb·(blockIdx.x mod (1024 / nb))) on natural
// planes of 2^(vlog + 10) slots, L = V/8 = 2^lshift, the values in and out
// by TMA through vmap and omap (the planes as rows of 1024 floats, boxes of
// nb × min(V, 256)); else slots [tile·slots, +slots) of a natural (S,
// 2^lshift) plane of n_slots (a multiple of 1024; the last tile may be
// short), the maps unused.
template <bool kTrans>
__global__ void __launch_bounds__(kR2MaxThreads, kR2Quads > 2 ? 1 : 2)
    layer_kernel(const float* __restrict__ v,
                 const uint32_t* __restrict__ word, float* __restrict__ out,
                 int64_t n_slots, int lshift, int vlog,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap) {
  // the only shared memory: its start is aligned as TMA needs (128 B)
  extern __shared__ __align__(128) float r2_sm[];
  const R2Geom g = r2_geom(kTrans ? vlog : -1);
  float* const vs = r2_sm;
  float* const os = r2_sm + g.slots;  // kTrans: the output
  uint32_t* const ws =
      reinterpret_cast<uint32_t*>(r2_sm + (kTrans ? 2 : 1) * g.slots);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(ws + g.nb * g.rs);
  int64_t base;   // the tile's first slot (kTrans: its plane's)
  int64_t wbase;  // its first word
  int b0 = 0, row0 = 0, nq = g.slots >> 2;
  const int qlog = kTrans ? __ffs(g.nb) - 3 : 0;  // log2 quads a run
  const int box = kTrans && vlog < 8 ? 1 << vlog : kTmaBoxRows;
  if (kTrans) {
    const int tpp = kBlockSlots / g.nb;
    row0 = (blockIdx.x / tpp) << vlog;  // the plane's first natural block
    base = (int64_t)row0 << 10;
    b0 = (blockIdx.x % tpp) * g.nb;
    wbase = base + ((int64_t)b0 << vlog);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_addr(bar)), "r"(4 * g.slots) : "memory");
      for (int r = 0; r < (1 << vlog); r += box)
        tma_load(vs + r * g.nb, &vmap, b0, row0 + r, bar);
    }
  } else {
    base = wbase = (int64_t)blockIdx.x * g.slots;
    if (n_slots - base < g.slots) nq = (int)(n_slots - base) >> 2;
  }
  // quad q: kTrans, offsets b0 + 4p.. of natural block a (q = a·nb/4 +
  // p), at 4q in the staged natural-order tiles; else slots base + 4q
  float4 vq[kR2Quads];
  uint4 wq[kR2Quads];
#pragma unroll
  for (int e = 0; e < kR2Quads; ++e) {
    const int q = threadIdx.x + e * g.threads;
    if (q < nq) {
      if (!kTrans)
        vq[e] = __ldcs(reinterpret_cast<const float4*>(v + base + 4 * q));
      wq[e] = __ldcs(reinterpret_cast<const uint4*>(word + wbase + 4 * q));
    }
  }
#pragma unroll
  for (int e = 0; e < kR2Quads; ++e) {
    const int q = threadIdx.x + e * g.threads;
    if (q < nq) {
      if (!kTrans) *reinterpret_cast<float4*>(vs + 4 * q) = vq[e];
      const int wi = kTrans ? ((4 * q) >> vlog) * g.rs +
                                  ((4 * q) & ((1 << vlog) - 1))
                            : 4 * q;
      *reinterpret_cast<uint4*>(ws + wi) = wq[e];
    }
  }
  __syncthreads();
  if (kTrans) mbar_wait(bar, 0);
#pragma unroll
  for (int e = 0; e < kR2Quads; ++e) {
    const int q = threadIdx.x + e * g.threads;
    if (q < nq) {
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kTrans) {
          // slot (a, b0 + beta): transposed group beta, group slot a
          const int beta = 4 * (q & ((1 << qlog) - 1)) + k;
          r[k] = group_pick(ws + beta * g.rs, vs + beta, g.nb, q >> qlog,
                            lshift);
        } else {
          const int t = 4 * q + k;
          const int g0 = t & ~((kSub << lshift) - 1);
          r[k] = group_pick(ws + g0, vs + g0, 1, t - g0, lshift);
        }
      }
      const float4 r4 = make_float4(r[0], r[1], r[2], r[3]);
      if (kTrans)
        *reinterpret_cast<float4*>(os + 4 * q) = r4;
      else
        *reinterpret_cast<float4*>(out + base + 4 * q) = r4;
    }
  }
  if (kTrans) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < (1 << vlog); r += box)
        tma_store(&omap, b0, row0 + r, os + r * g.nb);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// --------------------------------------------------------- B1, B4 and B7
//
// One persistent tile body, front_kernel<kMode>, for three front ends:
//   B1 `closg_front` (kFrontPlain) — replaces
//     spmv_research_tpu/ops/clos_gather.py `_gmul_r1_dma_kernel`: product
//     x2d[rowidx[s], λ] · vals_cs[s, l] (λ = r1 bits [17, 24), columns
//     past n read 0: the x plane's zero padding), then the r1 layer on
//     each 1024-slot tile (8 rows of 128). Also the non-LUT mode of
//     `_gmul_r1_kernel` (x past 4 MB): x is read from device memory at
//     any n.
//   B4 `closg_front_lut` (kFrontLut) — replaces the value-LUT mode of
//     clos_gather.py `_gmul_r1_kernel`: B1's product with the value entry
//     (w >> 24) & 0x7F of the 128-entry dictionary (row 0 of the (8,128)
//     dictionary plane) in place of vals_cs[s, l]; the value plane is not
//     read at all.
//   B7 `closg_front_win` (kFrontWin) — replaces clos_gather.py
//     `_gmul_r1_win_kernel` (fused windows): the tile is one 8-sublane
//     group whose slots read the compacted x rows gbase[c] .. gbase[c] +
//     7; slot (s, l) reads row (s + rot) & 7 of them, rot = r1 bits [24,
//     27). Compacted row r is x block nbids[r] (or r itself when every
//     block is non-empty: nbids == nullptr), and rows past the n_nb
//     compacted rows read 0 (the TPU kernel's 8-row overrun pad).
// Bound: device memory, 12 bytes per slot plus x once (B4: 8 bytes).
// The design, per 1024-slot tile, 256 threads, 4 slots a thread (warp s is
// row s, lane t of it holds lanes 4t..4t+3):
//   * the tile's 8 x windows (8 rows of 128 floats, 4 KB) are staged in
//     shared memory as the TPU kernels staged them in VMEM: thread t loads
//     quad t of window s (B1, B4: x row rowidx[8c + s]; B7: compacted row
//     gbase[c] + s) with one 16-byte load (scalar, masked, where the
//     window passes n or x is not 16-byte aligned), so a warp reads one
//     512-byte window in 4 requests instead of 32 scattered ones;
//   * word and value are one 16-byte streamed load each (B4: the word
//     only; its dictionary is staged in shared memory once per persistent
//     block, not once per tile), the output one 16-byte store;
//   * persistent blocks: the grid is the SMs times the blocks an SM holds
//     (closg_blocks_per_sm, at most one block a tile); a block walks tiles
//     blockIdx.x, + gridDim.x, ..., and issues the next tile's word, value
//     and window loads before this tile's products and picks, so the loads
//     of two tiles are in flight. A window's x row is itself a load (B1,
//     B4: rowidx) or two dependent ones (B7: gbase, then nbids), fetched
//     one tile further ahead per step of the chain (B7: gbase three tiles
//     ahead, nbids two);
//   * two barriers a tile: the windows staged, then the products and words;
//     the picks (invreg_pick) read shared memory. One buffer of each
//     serves: a tile's writes come after a barrier that every thread
//     reaches only when done with the tile before (B4's dictionary, staged
//     before the walk, is read only after the first of them).
constexpr int kFrontThreads = kBlockSlots / 4;
constexpr int kFrontPlain = 0, kFrontWin = 1, kFrontLut = 2;

struct FrontSlots {
  uint4 w;
  float4 v, x;
};

// Quad col..col+3 of x, 0 past n_x (x16: x is 16-byte aligned).
__device__ __forceinline__ float4 x_quad(const float* __restrict__ x,
                                         int64_t n_x, bool x16,
                                         int64_t col) {
  if (x16 && col + 4 <= n_x)
    return __ldg(reinterpret_cast<const float4*>(x + col));
  return make_float4(col < n_x ? __ldg(x + col) : 0.0f,
                     col + 1 < n_x ? __ldg(x + col + 1) : 0.0f,
                     col + 2 < n_x ? __ldg(x + col + 2) : 0.0f,
                     col + 3 < n_x ? __ldg(x + col + 3) : 0.0f);
}

// rows: B1's and B4's rowidx (8 a tile) or B7's gbase (1 a tile); nbids
// and n_nb B7's only; vals: the value plane, or B4's dictionary plane.
template <int kMode>
__global__ void __launch_bounds__(kFrontThreads)
    front_kernel(const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ nbids, int64_t n_nb,
                 const uint32_t* __restrict__ word,
                 const float* __restrict__ vals,
                 const float* __restrict__ x, int64_t n_x, int x16,
                 float* __restrict__ out, int64_t n_tiles) {
  constexpr bool kWin = kMode == kFrontWin, kLut = kMode == kFrontLut;
  __shared__ __align__(16) float xs[kBlockSlots];
  __shared__ __align__(16) float vs[kBlockSlots];
  __shared__ __align__(16) uint32_t ws[kBlockSlots];
  __shared__ float dict_sh[kLut ? kLanes : 1];
  const int i = 4 * threadIdx.x;         // my first slot: row s, lane 4t
  const int row0 = i & ~(kLanes - 1);    // my row's first slot (and window)
  const int s = threadIdx.x >> 5;
  const int64_t step = gridDim.x;
  int64_t c = blockIdx.x;
  if (c >= n_tiles) return;
  if (kLut && threadIdx.x < kLanes) dict_sh[threadIdx.x] = __ldg(vals +
                                                                 threadIdx.x);
  // B7: the group's first compacted x row
  auto base_of = [&](int64_t tile) -> int32_t {
    return tile < n_tiles ? __ldg(rows + tile) : 0;
  };
  // the x block of window s of a tile, or -1: a window of zeros
  auto block_of = [&](int64_t tile, int32_t base) -> int64_t {
    if (tile >= n_tiles) return -1;
    if (!kWin) return __ldg(rows + tile * kSub + s);
    const int64_t r = (int64_t)base + s;
    if (nbids == nullptr) return r;
    return r < n_nb ? __ldg(nbids + r) : -1;
  };
  auto load = [&](int64_t tile, int64_t blk) {
    FrontSlots q{};
    const int64_t off = tile * kBlockSlots + i;
    q.w = __ldcs(reinterpret_cast<const uint4*>(word + off));
    if (!kLut) q.v = __ldcs(reinterpret_cast<const float4*>(vals + off));
    q.x = blk < 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                  : x_quad(x, n_x, x16, blk * kLanes + (i - row0));
    return q;
  };
  FrontSlots cur = load(c, block_of(c, kWin ? base_of(c) : 0));
  int64_t blk_next = block_of(c + step, kWin ? base_of(c + step) : 0);
  int32_t base_next = kWin ? base_of(c + 2 * step) : 0;  // tile c + 2 step
  for (; c < n_tiles; c += step) {
    FrontSlots nxt{};
    if (c + step < n_tiles) nxt = load(c + step, blk_next);
    blk_next = block_of(c + 2 * step, base_next);
    if (kWin) base_next = base_of(c + 3 * step);
    *reinterpret_cast<float4*>(xs + i) = cur.x;
    __syncthreads();
    const uint32_t w[4] = {cur.w.x, cur.w.y, cur.w.z, cur.w.w};
    const float val[4] = {cur.v.x, cur.v.y, cur.v.z, cur.v.w};
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the window: my row's (B1, B4), or rotated by rot (B7)
      const int win = kWin ? ((s + (w[e] >> 24)) & (kSub - 1)) * kLanes
                           : row0;
      p[e] = __fmul_rn(xs[win + ((w[e] >> 17) & 0x7F)],
                       kLut ? dict_sh[(w[e] >> 24) & 0x7F] : val[e]);
    }
    *reinterpret_cast<uint4*>(ws + i) = cur.w;
    *reinterpret_cast<float4*>(vs + i) = make_float4(p[0], p[1], p[2], p[3]);
    __syncthreads();
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = invreg_pick(ws, vs, i + e, 7);
    *reinterpret_cast<float4*>(out + c * kBlockSlots + i) =
        make_float4(r[0], r[1], r[2], r[3]);
    cur = nxt;
  }
}

// One Hillis–Steele stage of the segmented scan over the whole plane: the
// global phase of the phased scan (below), for a stage no tiling serves:
//   dst[p] = src[p] + (guard_k[p] ? src[p - 2^k] : 0)
// with guard_k bit 17+k of the r3 word (k < 15) or bit k-15 of scan_hi.
// The slots are runs of `chunk` (a power of two: one program, or one of
// CLOSGX's stacked chunks), and the shift wraps within its run like the
// JAX package's roll; a set guard never wraps, so no value crosses a
// chunk. kSelect: a stage of B8's forward fill, the take bits where the
// guards are:
//   dst[p] = take_k[p] ? src[p - 2^k] : src[p]
// over one CLOS program (chunk = N), wrapping like the JAX package's roll.
// Bound: device memory, 12 bytes per slot.
template <bool kSelect>
__global__ void scan_step_kernel(const float* __restrict__ src,
                                 float* __restrict__ dst,
                                 const uint32_t* __restrict__ w3,
                                 const uint32_t* __restrict__ hi, int k,
                                 int64_t n, int64_t chunk) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t g = k < 15 ? (w3[p] >> (17 + k)) & 1u
                            : (hi[p] >> (k - 15)) & 1u;
  const int64_t base = p & ~(chunk - 1);
  const int64_t q = base + ((p - base - (int64_t(1) << k)) & (chunk - 1));
  if (kSelect) {
    dst[p] = g ? src[q] : src[p];
  } else {
    const float shifted = g ? src[q] : 0.0f;
    dst[p] = src[p] + shifted;
  }
}

// ------------------------------------------------------- K3, B5, B8, B15
//
// The r3 layer and a segmented scan in phases of tiles. It replaces, in
// spmv_research_tpu/ops/clos_pallas.py:
//   K3 `closg_r3_scan_yext` — `_r3_scan_yext_kernel`: the capped scan,
//     then yext_kernel (below) over the scanned plane;
//   B5 `closg_r3_scan` — `_r3_scan_kernel_noval` (the W = 0 back end's r3
//     layer + full segmented scan);
//   B8 `clos_r3_scan` — `_r3_scan_kernel`: `vals` given, phase 0 multiplies
//     each window slot's r3 pick by vals at its plane slot (__fmul_rn, so
//     nvcc cannot contract it into an FMA with the scan's add: the plain
//     version rounds the product on its own);
//   B8 `clos_r3_fill` — `_r3_fill_kernel` (kSelect): each stage is
//     v[p] = take_k[p] ? v[p − 2^k] : v[p], the take bits where the
//     guards are (bit 17+k of widen_r3, or bit k−15 of fill_hi), over one
//     program (chunk = N) wrapping like the JAX package's roll;
// and the scan of B15 `closgx_r3_scan_yext` — clos_xl.py
// `_r3_scan_yext_dyn_kernel`, whose extraction is yext_kernel. The plane is
// C runs of `chunk` slots (one program: C = 1), each scanned on its own
// with the shift wrapping inside it. One launch a stage moved 12 bytes a
// slot a stage; here the host planner
// (ops/clos_cuda.py `plan_scan_phases`) cuts the stages into phases, one
// launch each, that one tiling of the plane serves:
//   contiguous (phase 0 only): tile t holds 2^T consecutive slots of a
//     chunk, T = min(kScanTileLog, log2 chunk), plus the 1024-slot r3 block
//     before it (read modulo the chunk, as torch.roll wraps) when its
//     stages' shifts 2^k sum to a halo in (0, 1024]. The window starts on
//     a block boundary and the r3 picks stay inside their 8-row, 1024-slot
//     block (invreg_pick), so the r3 layer of the whole window, halo
//     included, is exact; each slot's word is read once, for its pick and
//     its guards. When the chunk is one tile the shifts wrap inside it and
//     every stage runs here.
//   strided: the stages k0..k1 that follow, 2^k0 >= 32. A chunk is viewed
//     as p = j·2^k0 + r; stage k is then a shift of 2^(k−k0) along j for
//     each residue r, wrapping modulo J = chunk / 2^k0. A tile holds 32
//     residues (a j row is one 128-byte read) times 2^(T−5) rows, plus a
//     halo of Σ 2^(k−k0) rows before them (at most 32), or all J rows
//     (no halo, the shift wrapping inside the tile) where J <= 2^(T−5).
//   global: a stage neither serves (2^k >= chunk, or k0 < 5), one
//     scan_step_kernel launch over the plane.
// In a tiled phase the window (W <= 2^13 + 1024 slots) is indexed so that
// each stage is a shift by D window slots (2^k, or 32·2^(k−k0)); a block
// of 1024 threads holds it in registers, kScanE slots a thread at most,
// with their guard bits. A shift of whole rows of 32 goes through shared
// memory: the values are stored to one of two buffers, one
// __syncthreads(), and each slot adds the value D slots back (the buffers
// alternate, so one barrier a stage); the contiguous phase runs its
// stages under a row (k < 5) in registers instead (scan_contig_kernel).
// A window slot whose read would leave the window reads garbage (the
// padding before a shared buffer, or a lane the halo row never got) and
// is garbage itself, which no tile slot reads: after a phase's stages a
// slot depends only on the slots within the sum of the phase's shifts
// before it, and the halo holds that sum. This holds for the select as
// for the add, since either takes the value D slots back or keeps its own.
// The add is a select of the read value or 0, then __fadd_rn, in the
// per-stage order of the plain version, so the result equals it bit for
// bit; so does the select, which rounds nothing. Only the tile's own slots
// are written; phases ping-pong two buffers and never read the one they
// write.
// Bound: device memory, v and the word read once (and vals, scan_hi or
// fill_hi where read), the plane written once, against a phase per 10 or
// so stages here: on a 2^20-slot chunk of 14 stages, 2 launches instead
// of 15; K3's and B8's scircuit programs (7, 6 and 9 stages) one each.

constexpr int kScanContig = 0;
constexpr int kScanStrided = 1;
constexpr int kScanGlobal = 2;
constexpr int kScanTileLog = 13;        // 2^13-slot tiles, whole r3 blocks
constexpr int kScanHaloMax = 1024;      // window slots of halo, both tilings
constexpr int kScanE = 9;               // window slots a thread holds
constexpr int kScanMaxStages = 31;      // stages k in [0, 30]
constexpr int kScanMaxPhases = 32;
constexpr int kScanThreads = 1024;

struct ScanStages {
  int k[kScanMaxStages];
};

struct ScanPhase {
  int first, count, tiling, halo;
};

// The window of a tiled phase: W slots, the first H of them the halo;
// `whole`: the tile spans its whole wrap (a chunk, or all J rows); R: log2
// of the tile's slots (contiguous) or rows (strided); tiles a chunk.
struct ScanGeom {
  int W, H, R;
  bool whole;
  int64_t tiles;
};

__host__ __device__ inline ScanGeom scan_geom(const ScanPhase& f, int k0,
                                              int log_chunk) {
  ScanGeom g;
  if (f.tiling == kScanContig) {
    g.R = kScanTileLog < log_chunk ? kScanTileLog : log_chunk;
    g.whole = g.R == log_chunk;
    g.H = g.whole || f.halo == 0 ? 0 : kBlockSlots;
    g.W = (1 << g.R) + g.H;
    g.tiles = int64_t(1) << (log_chunk - g.R);
  } else {
    const int jl = log_chunk - k0;
    g.R = kScanTileLog - 5 < jl ? kScanTileLog - 5 : jl;
    g.whole = g.R == jl;
    g.H = g.whole ? 0 : 32 * f.halo;
    g.W = (32 << g.R) + g.H;
    g.tiles = int64_t(1) << (k0 - 5 + jl - g.R);
  }
  return g;
}

// A stage's step on one slot: v + the value read where the guard is set,
// or (kSelect) the value read where the take bit is set, else v.
template <bool kSelect>
__device__ __forceinline__ float stage_op(float v, bool g, float read) {
  if (kSelect) return g ? read : v;
  return __fadd_rn(v, g ? read : 0.0f);
}

// One stage through shared memory on the n window slots base + e·kStride
// (e < n) a thread holds: store them to b, one barrier, and apply to each
// slot, with its guard bit m, the value d slots back, modulo W where the
// tile spans its whole wrap. Before window slot 0, b has kScanHaloMax
// slots of garbage: a read there feeds only garbage slots.
template <int kE, int kStride, bool kSelect>
__device__ __forceinline__ void shared_stage(float (&v)[kE],
                                             const uint32_t (&gd)[kE],
                                             uint32_t m, int d, float* b,
                                             int base, int n, int W,
                                             bool whole) {
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (e < n) b[base + e * kStride] = v[e];
  __syncthreads();
  if (whole) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < n) {
        const float sh = b[(base + e * kStride - d) & (W - 1)];
        v[e] = stage_op<kSelect>(v[e], gd[e] & m, sh);
      }
  } else {
    const float* const bd = b + base - d;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < n) v[e] = stage_op<kSelect>(v[e], gd[e] & m, bd[e * kStride]);
  }
}

// Stage k's guard is bit k of (hi << 15 | w3 >> 17); a phase keeps it
// shifted down by its first stage k0.
__device__ __forceinline__ uint32_t scan_guards(uint32_t w, uint32_t h,
                                                int k0) {
  return (uint32_t)(((uint64_t)h << 15 | (w >> 17)) >> k0);
}

// The contiguous phase (phase 0). Warp w owns window rows [w·rpw,
// (w+1)·rpw) of 32 slots (rpw = W / 1024), one slot a lane and row, and
// also holds the row before them (the warp's own one-row halo). The words
// and values of the window are staged in the two shared buffers for the
// r3 picks (× vals, where given), which then serve the stages. Stages with
// k < 5 (shifts under a row) run in registers: slot i − 2^k is lane − 2^k
// of the same row or lane + 32 − 2^k of the row before, one __shfl_sync a
// row and stage, no barrier; the one-row halo holds their shifts (at most
// 1 + 2 + 4 + 8 + 16 = 31 slots), so each owned slot is exact and the halo
// row's own garbage reaches none. Stages with k >= 5 go through shared
// memory. kVals: the picks are multiplied by vals (B8's scan); without it
// the kernel never reads vals, so K3's, B5's and B15's code is unchanged.
template <int kR, bool kSelect, bool kVals>
__global__ void __launch_bounds__(kScanThreads)
    scan_contig_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       const uint32_t* __restrict__ w3,
                       const uint32_t* __restrict__ hi,
                       const float* __restrict__ vals,
                       const __grid_constant__ ScanStages S, ScanPhase f,
                       int log_chunk) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31;
  const int k0 = f.count ? S.k[0] : 0;
  const ScanGeom g = scan_geom(f, k0, log_chunk);
  const int W = g.W, H = g.H;
  const int rpw = W >> 10;  // rows a warp owns, at most kR
  const int base = (threadIdx.x >> 5) * rpw * 32 + lane;
  const int64_t t = blockIdx.x;
  const int64_t cbase = (t / g.tiles) << log_chunk;
  const int local = (int)(t % g.tiles);
  // window slot i → plane slot (a 32-bit offset inside the chunk)
  auto glob = [&](int i) -> int64_t {
    return cbase + (((local << g.R) + i - H) & ((1 << log_chunk) - 1));
  };
  const bool use_hi = f.count && S.k[f.count - 1] >= 15;
  float* const b0 = sm + kScanHaloMax;
  float* const b1 = b0 + W + kScanHaloMax;
  uint32_t* const ws = reinterpret_cast<uint32_t*>(b0);
  float v[kR], vh = 0.0f;
  uint32_t gd[kR], gh = 0u;
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    const int i = base + e * 32;
    if (e < rpw) {
      const int64_t p = glob(i);
      const uint32_t w = w3[p];
      gd[e] = scan_guards(w, use_hi ? hi[p] : 0u, k0);
      ws[i] = w;
      b1[i] = src[p];
    }
  }
  __syncthreads();
  // the r3 layer (× vals), block by block, of the owned rows and the row
  // before (for warp 0 the window's last row where the tile wraps, else
  // unused)
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    const int i = base + e * 32;
    if (e < rpw) {
      const int bl = i & ~(kBlockSlots - 1);
      v[e] = invreg_pick(ws + bl, b1 + bl, i - bl, 7);
      if (kVals) v[e] = __fmul_rn(v[e], vals[glob(i)]);
    }
  }
  const int hr = base >= 32 ? base - 32 : (g.whole ? W - 32 + lane : -1);
  if (hr >= 0) {
    const int bl = hr & ~(kBlockSlots - 1);
    vh = invreg_pick(ws + bl, b1 + bl, hr - bl, 7);
    if (kVals) vh = __fmul_rn(vh, vals[glob(hr)]);
    gh = scan_guards(ws[hr], use_hi ? hi[glob(hr)] : 0u, k0);
  }
  __syncthreads();  // the picks are done: both buffers are free
  int s = 0;
  for (; s < f.count && S.k[s] < 5; ++s) {
    const int d = 1 << S.k[s];
    const uint32_t m = 1u << (S.k[s] - k0);
    const int from = (lane - d) & 31;
    const bool prev = lane >= 32 - d;  // my value feeds the next row
#pragma unroll
    for (int e = kR - 1; e >= 0; --e) {  // the row before still old
      if (e < rpw) {
        const float x = __shfl_sync(0xffffffffu,
                                    prev ? (e ? v[e - 1] : vh) : v[e], from);
        v[e] = stage_op<kSelect>(v[e], gd[e] & m, x);
      }
    }
    const float x = __shfl_sync(0xffffffffu, vh, from);
    vh = stage_op<kSelect>(vh, gh & m, x);
  }
  for (int st = 0; s < f.count; ++s, ++st)
    shared_stage<kR, 32, kSelect>(v, gd, 1u << (S.k[s] - k0), 1 << S.k[s],
                                  (st & 1) ? b1 : b0, base, rpw, W, g.whole);
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    const int i = base + e * 32;
    if (e < rpw && i >= H) dst[glob(i)] = v[e];
  }
}

// A strided phase: thread tid holds window slots tid + e·1024, one row of
// 32 a warp and e; every shift is whole rows, through shared memory.
template <int kE, bool kSelect>
__global__ void __launch_bounds__(kScanThreads)
    scan_strided_kernel(const float* __restrict__ src,
                        float* __restrict__ dst,
                        const uint32_t* __restrict__ w3,
                        const uint32_t* __restrict__ hi,
                        const __grid_constant__ ScanStages S, ScanPhase f,
                        int log_chunk) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x;
  const int k0 = S.k[f.first];
  const ScanGeom g = scan_geom(f, k0, log_chunk);
  const int W = g.W, H = g.H;
  const int n = W > tid ? (W - tid + kScanThreads - 1) / kScanThreads : 0;
  const int64_t t = blockIdx.x;
  const int64_t cbase = (t / g.tiles) << log_chunk;
  const int local = (int)(t % g.tiles);
  const int jl = log_chunk - k0;
  // window slot i → plane slot (32-bit offsets inside the chunk)
  auto glob = [&](int i) -> int64_t {
    const int jt = local & ((1 << (jl - g.R)) - 1);
    const int rg = local >> (jl - g.R);
    const int j = ((jt << g.R) + (i >> 5) - (H >> 5)) & ((1 << jl) - 1);
    return cbase + ((j << k0) | (rg << 5) | (i & 31));
  };
  float* const b0 = sm + kScanHaloMax;
  float* const b1 = b0 + W + kScanHaloMax;
  const bool use_lo = k0 < 15;
  const bool use_hi = S.k[f.first + f.count - 1] >= 15;
  float v[kE];
  uint32_t gd[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if (e < n) {
      const int64_t p = glob(tid + e * kScanThreads);
      gd[e] = scan_guards(use_lo ? w3[p] : 0u, use_hi ? hi[p] : 0u, k0);
      v[e] = src[p];
    }
  }
  for (int s = 0; s < f.count; ++s)
    shared_stage<kE, kScanThreads, kSelect>(
        v, gd, 1u << (S.k[f.first + s] - k0), 32 << (S.k[f.first + s] - k0),
        (s & 1) ? b1 : b0, tid, n, W, g.whole);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = tid + e * kScanThreads;
    if (e < n && i >= H) dst[glob(i)] = v[e];
  }
}

__device__ __forceinline__ float y_pick(const float* __restrict__ scr,
                                        const uint32_t* __restrict__ ysel_w,
                                        const int32_t* __restrict__ wstart,
                                        int64_t row, int j) {
  const uint32_t sel = ysel_w[row * kLanes + j];
  if ((sel >> 16) & 1u) return 0.0f;  // empty matrix row: reads no slot
  const int64_t r = (int64_t)wstart[row] + ((sel >> 7) & 0x1FF);
  return scr[r * kLanes + (sel & 0x7F)];
}

// K3(c) y extraction. One block per y batch (8 groups of 128 rows), one
// thread per y element. The base record of batch bd is read at bd itself;
// the accumulate records that complete rows longer than the scan cap are
// then added in the order the host listed them (acc_ptr/acc_src, the JAX
// kernel's class order), so the sums are deterministic and no two blocks
// write one element. Each element is read directly at its window row
// instead of looping over the record's W window octaves as the TPU kernel
// did. Bound: the scattered 4-byte reads of the scanned plane (one per
// matrix row, from L2 for the records' nearby windows).
// B15's extraction is the same kernel with acc_ptr == nullptr (CLOSGX
// chunks carry no accumulate records) over all stacked chunks' batches,
// each window start already offset by its chunk's rows.
__global__ void yext_kernel(const float* __restrict__ scr,
                            const uint32_t* __restrict__ ysel_w,
                            const int32_t* __restrict__ wstart,
                            const int32_t* __restrict__ acc_ptr,
                            const int32_t* __restrict__ acc_src,
                            float* __restrict__ y) {
  const int bd = blockIdx.x;
  const int g = threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;
  const int64_t row = (int64_t)bd * kSub + g;
  float acc = y_pick(scr, ysel_w, wstart, row, j);
  if (acc_ptr != nullptr)
    for (int r = acc_ptr[bd]; r < acc_ptr[bd + 1]; ++r)
      acc = acc + y_pick(scr, ysel_w, wstart, (int64_t)acc_src[r] * kSub + g,
                         j);
  y[row * kLanes + j] = acc;
}

// B6 `closg_cand_yext` — replaces spmv_research_tpu/ops/clos_gather.py
// `_extract_y_kernel` (the W = 0 back end's extraction), over a list of W =
// 0 programs in one launch. Element (j, l) of program c, with cid = bits
// [7,14) and lane = bits [0,7) of ysel_c[j,l], is
//   y[row0_c + 128·j + l] = scr_c[ycand_c[cid·m_rows_c + j], lane],
// written only where 128·j + l < m_c. The candidates are read in place:
// the TPU path first copied the C candidate planes out with an XLA gather
// and then looped over C in the kernel. Empty rows read slot nnz, which
// the scan leaves exactly 0.
// Bound: ysel and y (8 bytes per element) plus one 4-byte ycand read and
// one scattered 4-byte scr read each; on a gupta3 chunk (≈ 1,700 rows) a
// launch is launch and load latency, not bytes, and the JAX package's
// chunked dispatch ran one launch a chunk.
// The design: the programs come by value in the launch's parameters
// (YextChunks, at most kYextMaxChunks; the wrapper makes as few launches
// as the cap allows), so one launch extracts every chunk of a
// ClosGChunked straight into its rows of y: no per-chunk launch, no
// concatenation, no host-to-device copy. Each block belongs to one
// program, found by a walk over the prefix of block counts. A thread
// takes kYextQuads 16-byte ysel quads (rows of 512 bytes: 16-byte
// aligned) and issues each of the three dependent loads for all of its
// elements before the next: 4 chains in flight a thread. The chains are
// latency, so small blocks on many SMs won: on gupta3's 10 chunks, cold
// and warm, 1 quad and 64 threads took 0.00856 and 0.00322 ms, 1 and
// 128 0.0086 and 0.0034, 2 and 128 0.0106 and 0.0042, 4 and 128 0.0120
// and 0.0054 (time_clos_scans.py --set, H100 SXM, 700 W).
constexpr int kYextMaxChunks = 32;  // programs a launch takes by value
constexpr int kYextThreads = 64;
constexpr int kYextQuads = 1;       // 16-byte ysel quads a thread
constexpr int kYextBlockElems = 4 * kYextQuads * kYextThreads;  // 2 y rows

struct YextChunks {
  const float* scr[kYextMaxChunks];
  const int32_t* ycand[kYextMaxChunks];
  const uint32_t* ysel[kYextMaxChunks];
  int64_t m_rows[kYextMaxChunks];
  int64_t m[kYextMaxChunks];      // elements of y the program writes
  int64_t row0[kYextMaxChunks];   // its first element of y
  int32_t block0[kYextMaxChunks + 1];  // its first block; [n]: the grid
};

__global__ void __launch_bounds__(kYextThreads)
    cand_yext_kernel(const __grid_constant__ YextChunks P,
                     float* __restrict__ y) {
  int c = 0;
  while ((int)blockIdx.x >= P.block0[c + 1]) ++c;
  const float* __restrict__ scr = P.scr[c];
  const int32_t* __restrict__ ycand = P.ycand[c];
  const uint32_t* __restrict__ ysel = P.ysel[c];
  const int64_t m_rows = P.m_rows[c], m = P.m[c];
  const int64_t e0 =
      (int64_t)((int)blockIdx.x - P.block0[c]) * kYextBlockElems;
  uint32_t sel[kYextQuads][4];
  int32_t row[kYextQuads][4];
  float v[kYextQuads][4];
#pragma unroll
  for (int q = 0; q < kYextQuads; ++q) {
    const int64_t e = e0 + 4 * (threadIdx.x + q * kYextThreads);
    if (e < m) {
      const uint4 s4 = __ldcs(reinterpret_cast<const uint4*>(ysel + e));
      sel[q][0] = s4.x;
      sel[q][1] = s4.y;
      sel[q][2] = s4.z;
      sel[q][3] = s4.w;
    }
  }
#pragma unroll
  for (int q = 0; q < kYextQuads; ++q) {
    const int64_t e = e0 + 4 * (threadIdx.x + q * kYextThreads);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < m)
        row[q][k] = __ldg(ycand + (int64_t)((sel[q][k] >> 7) & 0x7F) * m_rows +
                          (e >> 7));
  }
#pragma unroll
  for (int q = 0; q < kYextQuads; ++q) {
    const int64_t e = e0 + 4 * (threadIdx.x + q * kYextThreads);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < m)
        v[q][k] = __ldg(scr + (int64_t)row[q][k] * kLanes + (sel[q][k] & 0x7F));
  }
  float* const yc = y + P.row0[c];
#pragma unroll
  for (int q = 0; q < kYextQuads; ++q) {
    const int64_t e = e0 + 4 * (threadIdx.x + q * kYextThreads);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < m) yc[e + k] = v[q][k];
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime's entry
// point query (the library does not link libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The TMA map of n_slots floats at p (16-byte aligned) viewed as rows of
// 1024, 4 KB apart, in boxes of nb floats × rows rows.
cudaError_t plane_map(CUtensorMap* map, const void* p, int64_t n_slots,
                      int nb, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kBlockSlots,
                              (cuuint64_t)(n_slots / kBlockSlots)};
  const cuuint64_t strides[1] = {kBlockSlots * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)nb, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The layer kernels' shared memory past 48 KB, once per device before the
// first launch.
cudaError_t allow_layer_smem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev])) return err;
  int smem = r2_geom(-1).smem;
  for (int vlog = 3; vlog <= 10; ++vlog)
    smem = r2_geom(vlog).smem > smem ? r2_geom(vlog).smem : smem;
  err = cudaFuncSetAttribute(layer_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(layer_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

}  // namespace

extern "C" {

const char* closg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One layer on a natural (n_slots / lanes, lanes) plane: n_slots a positive
// multiple of 1024, lanes a power of two <= 128.
int closg_invreg(const void* v, const void* word, void* out, int64_t n_slots,
                 int lanes, void* stream) {
  int lshift = 0;
  while ((1 << lshift) < lanes) ++lshift;
  if (n_slots <= 0 || n_slots % kBlockSlots || (1 << lshift) != lanes ||
      lanes > kLanes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_layer_smem();
  if (err != cudaSuccess) return (int)err;
  const R2Geom g = r2_geom(-1);
  const CUtensorMap unused{};
  layer_kernel<false><<<(unsigned)((n_slots + g.slots - 1) / g.slots),
                        g.threads, g.smem, (cudaStream_t)stream>>>(
      (const float*)v, (const uint32_t*)word, (float*)out, n_slots, lshift,
      -1, unused, unused);
  return (int)cudaGetLastError();
}

// The r2 layer with its transposes on n_slots / (1024·V) stacked natural
// planes of (8V, 128); word: the stored r2 planes, (n_slots / (V/8), V/8).
// V a power of two in [8, 1024]; v and out 16-byte aligned (TMA).
int clos_r2(const void* v, const void* word, void* out, int64_t n_slots,
            int V, void* stream) {
  int vlog = 0;
  while ((1 << vlog) < V) ++vlog;
  if ((1 << vlog) != V || vlog < 3 || vlog > 10 || n_slots <= 0 ||
      n_slots % ((int64_t)V * kBlockSlots))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_layer_smem();
  if (err != cudaSuccess) return (int)err;
  const R2Geom g = r2_geom(vlog);
  const int rows = V < kTmaBoxRows ? V : kTmaBoxRows;
  CUtensorMap vmap, omap;
  err = plane_map(&vmap, v, n_slots, g.nb, rows);
  if (err == cudaSuccess) err = plane_map(&omap, out, n_slots, g.nb, rows);
  if (err != cudaSuccess) return (int)err;
  layer_kernel<true><<<(unsigned)(n_slots / g.slots), g.threads, g.smem,
                       (cudaStream_t)stream>>>(
      (const float*)v, (const uint32_t*)word, (float*)out, n_slots, vlog - 3,
      vlog, vmap, omap);
  return (int)cudaGetLastError();
}

// B8's valid step on 128-lane rows, over the leading n_slots slots (a
// positive multiple of 1024) of the plane.
int clos_r3_valid(const void* v, const void* word, void* out, int64_t n_slots,
                  void* stream) {
  valid_kernel<<<(unsigned)(n_slots / kBlockSlots), kBlockSlots, 0,
                 (cudaStream_t)stream>>>(
      (const float*)v, (const uint32_t*)word, (float*)out);
  return (int)cudaGetLastError();
}

// Blocks of the persistent front_kernel<mode> (kFrontPlain: B1, kFrontWin:
// B7, kFrontLut: B4) an SM holds, into *blocks; the grid of a launch is at
// most the SMs times this (cuda_lib.persistent_grid).
int closg_blocks_per_sm(int* blocks, int mode) {
  if (mode == kFrontPlain)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, front_kernel<kFrontPlain>, kFrontThreads, 0);
  if (mode == kFrontWin)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, front_kernel<kFrontWin>, kFrontThreads, 0);
  if (mode == kFrontLut)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, front_kernel<kFrontLut>, kFrontThreads, 0);
  return (int)cudaErrorInvalidValue;
}

// B1 over n_slots (a positive multiple of 1024) rows of 128 lanes, on grid
// persistent blocks.
int closg_front(const void* rowidx, const void* perm_r1, const void* vals,
                const void* x, int64_t n_x, void* out, int64_t n_slots,
                int grid, void* stream) {
  if (n_slots <= 0 || n_slots % kBlockSlots || grid < 1)
    return (int)cudaErrorInvalidValue;
  front_kernel<kFrontPlain><<<(unsigned)grid, kFrontThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)rowidx, nullptr, 0, (const uint32_t*)perm_r1,
      (const float*)vals, (const float*)x, n_x, ((uintptr_t)x & 15) == 0,
      (float*)out, n_slots / kBlockSlots);
  return (int)cudaGetLastError();
}

// B4 as B1, with vals the (8,128) dictionary plane.
int closg_front_lut(const void* rowidx, const void* perm_r1, const void* vals,
                    const void* x, int64_t n_x, void* out, int64_t n_slots,
                    int grid, void* stream) {
  if (n_slots <= 0 || n_slots % kBlockSlots || grid < 1)
    return (int)cudaErrorInvalidValue;
  front_kernel<kFrontLut><<<(unsigned)grid, kFrontThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)rowidx, nullptr, 0, (const uint32_t*)perm_r1,
      (const float*)vals, (const float*)x, n_x, ((uintptr_t)x & 15) == 0,
      (float*)out, n_slots / kBlockSlots);
  return (int)cudaGetLastError();
}

// B7 over n_slots (a positive multiple of 1024) rows of 128 lanes, on grid
// persistent blocks; gbase holds one compacted row a tile. nbids may be
// null (every x block is non-empty: no compaction, n_nb unused).
int closg_front_win(const void* gbase, const void* nbids, int64_t n_nb,
                    const void* perm_r1, const void* vals, const void* x,
                    int64_t n_x, void* out, int64_t n_slots, int grid,
                    void* stream) {
  if (n_slots <= 0 || n_slots % kBlockSlots || grid < 1)
    return (int)cudaErrorInvalidValue;
  front_kernel<kFrontWin><<<(unsigned)grid, kFrontThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)gbase, (const int32_t*)nbids, n_nb,
      (const uint32_t*)perm_r1, (const float*)vals, (const float*)x, n_x,
      ((uintptr_t)x & 15) == 0, (float*)out, n_slots / kBlockSlots);
  return (int)cudaGetLastError();
}

// The phased scan (K3's, B5's and B15's; B8's scan with vals, B8's fill
// with select != 0): the r3 layer (× vals where vals is not null) and the
// stages `stages` (strictly increasing, each in [0, 30]) over n_slots slots
// in runs of `chunk` (a power of two >= 1024 dividing n_slots, at most
// 2^30), in the phases of `phases` (4 ints a phase: first stage, stage
// count, tiling, halo; phase 0 and no other contiguous, a global phase one
// stage), tiles of 2^kScanTileLog slots. The last phase writes out, the
// others alternate with tmp (null when there is one phase). scan_hi (the
// fill's fill_hi) may be null when no stage is >= 15; select refuses vals.
// One launch a phase.
int closg_scan_phases(const void* v, const void* perm_r3, const void* scan_hi,
                      const void* vals, int select, void* out, void* tmp,
                      int64_t n_slots, int64_t chunk, const int32_t* stages,
                      int n_stages, const int32_t* phases, int n_phases,
                      void* stream) {
  int log_chunk = 0;
  while ((int64_t(1) << log_chunk) < chunk) ++log_chunk;
  if ((int64_t(1) << log_chunk) != chunk || chunk < kBlockSlots ||
      log_chunk > 30 || n_slots <= 0 || n_slots % chunk || n_stages < 0 ||
      n_stages > kScanMaxStages || n_phases < 1 ||
      n_phases > kScanMaxPhases || (n_phases > 1 && tmp == nullptr) ||
      (select && vals != nullptr))
    return (int)cudaErrorInvalidValue;
  ScanStages S;
  for (int i = 0; i < n_stages; ++i) {
    S.k[i] = stages[i];
    if (S.k[i] < 0 || S.k[i] > 30 || (i && S.k[i] <= S.k[i - 1]) ||
        (S.k[i] >= 15 && scan_hi == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  ScanPhase P[kScanMaxPhases];
  int covered = 0;
  for (int i = 0; i < n_phases; ++i) {
    const ScanPhase f = {phases[4 * i], phases[4 * i + 1], phases[4 * i + 2],
                         phases[4 * i + 3]};
    if (f.first != covered || f.count < 0 || f.halo < 0 ||
        (f.tiling == kScanContig) != (i == 0) ||
        (f.tiling == kScanGlobal && f.count != 1) ||
        (f.tiling == kScanStrided && f.count < 1) || f.tiling < kScanContig ||
        f.tiling > kScanGlobal || covered + f.count > n_stages)
      return (int)cudaErrorInvalidValue;
    if (f.tiling != kScanGlobal) {
      // the halo must hold the sum of the phase's shifts, within the budget
      const int k0 = f.count ? S.k[f.first] : 0;
      const ScanGeom g = scan_geom(f, k0, log_chunk);
      int64_t need = 0;
      for (int s = f.first; s < f.first + f.count; ++s) {
        if (f.tiling == kScanStrided &&
            (S.k[s] >= log_chunk || k0 < 5))
          return (int)cudaErrorInvalidValue;
        need += int64_t(1) << (S.k[s] - (f.tiling == kScanStrided ? k0 : 0));
      }
      if (!g.whole && (need > f.halo ||
                       (f.tiling == kScanContig ? f.halo
                                                : 32 * f.halo) > kScanHaloMax))
        return (int)cudaErrorInvalidValue;
      if (g.whole && f.halo)
        return (int)cudaErrorInvalidValue;
    }
    covered += f.count;
    P[i] = f;
  }
  if (covered != n_stages) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the phase kernels: contiguous (adding, × vals, selecting), strided
  // (adding, selecting)
  const void* kernels[5] = {
      (const void*)scan_contig_kernel<kScanE, false, false>,
      (const void*)scan_contig_kernel<kScanE, false, true>,
      (const void*)scan_contig_kernel<kScanE, true, false>,
      (const void*)scan_strided_kernel<kScanE, false>,
      (const void*)scan_strided_kernel<kScanE, true>};
  // past 48 KB of shared memory, once per device before the first launch
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    const int smem_max = 2 * sizeof(float) * ((1 << kScanTileLog) +
                                              2 * kScanHaloMax);
    for (int m = 0; m < 5 && err == cudaSuccess; ++m)
      err = cudaFuncSetAttribute(kernels[m],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_max);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  const uint32_t* w3 = (const uint32_t*)perm_r3;
  const uint32_t* hi = (const uint32_t*)scan_hi;
  const float* vl = (const float*)vals;
  const float* src = (const float*)v;
  for (int i = 0; i < n_phases; ++i) {
    float* dst = (float*)(((n_phases - 1 - i) & 1) ? tmp : out);
    const ScanPhase f = P[i];
    if (f.tiling == kScanGlobal) {
      const int threads = 256;
      const unsigned grid = (unsigned)((n_slots + threads - 1) / threads);
      if (select)
        scan_step_kernel<true><<<grid, threads, 0, st>>>(
            src, dst, w3, hi, S.k[f.first], n_slots, chunk);
      else
        scan_step_kernel<false><<<grid, threads, 0, st>>>(
            src, dst, w3, hi, S.k[f.first], n_slots, chunk);
      err = cudaGetLastError();
    } else {
      const ScanGeom g = scan_geom(f, f.count ? S.k[f.first] : 0, log_chunk);
      // two buffers of the window, each after kScanHaloMax slots
      const size_t smem = 2 * sizeof(float) * (g.W + kScanHaloMax);
      const unsigned grid = (unsigned)(n_slots / chunk * g.tiles);
      void* contig_args[] = {&src, &dst, &w3, &hi, &vl, &S, (void*)&f,
                             &log_chunk};
      void* strided_args[] = {&src, &dst, &w3, &hi, &S, (void*)&f,
                              &log_chunk};
      const bool contig = f.tiling == kScanContig;
      const int which = !contig ? (select ? 4 : 3)
                                : (select ? 2 : (vl != nullptr ? 1 : 0));
      err = cudaLaunchKernel(kernels[which], dim3(grid), dim3(kScanThreads),
                             contig ? contig_args : strided_args, smem, st);
    }
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return (int)cudaSuccess;
}

// acc_ptr and acc_src may be null (no accumulate records).
int closg_yext(const void* scr, const void* ysel_w, const void* wstart,
               const void* acc_ptr, const void* acc_src, void* y,
               int n_batches, void* stream) {
  yext_kernel<<<(unsigned)n_batches, kSub * kLanes, 0,
                (cudaStream_t)stream>>>(
      (const float*)scr, (const uint32_t*)ysel_w, (const int32_t*)wstart,
      (const int32_t*)acc_ptr, (const int32_t*)acc_src, (float*)y);
  return (int)cudaGetLastError();
}

// B6 over n programs (1 <= n <= kYextMaxChunks): program i's scanned
// plane scr[i], candidate rows ycand[i] and ysel[i] (m_rows[i] rows of
// 128, 16-byte aligned) write their first m[i] <= 128·m_rows[i] elements
// to y at row0[i]. One launch.
int closg_cand_yext(int n, const void* const* scr, const void* const* ycand,
                    const void* const* ysel, const int64_t* m_rows,
                    const int64_t* m, const int64_t* row0, void* y,
                    void* stream) {
  if (n < 1 || n > kYextMaxChunks) return (int)cudaErrorInvalidValue;
  YextChunks P{};
  int64_t blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (m_rows[i] < 0 || m[i] < 0 || m[i] > m_rows[i] * kLanes ||
        row0[i] < 0 || ((uintptr_t)ysel[i] & 15))
      return (int)cudaErrorInvalidValue;
    P.scr[i] = (const float*)scr[i];
    P.ycand[i] = (const int32_t*)ycand[i];
    P.ysel[i] = (const uint32_t*)ysel[i];
    P.m_rows[i] = m_rows[i];
    P.m[i] = m[i];
    P.row0[i] = row0[i];
    P.block0[i] = (int32_t)blocks;
    blocks += (m[i] + kYextBlockElems - 1) / kYextBlockElems;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  }
  for (int i = n; i <= kYextMaxChunks; ++i) P.block0[i] = (int32_t)blocks;
  if (blocks == 0) return (int)cudaSuccess;
  cand_yext_kernel<<<(unsigned)blocks, kYextThreads, 0,
                     (cudaStream_t)stream>>>(P, (float*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
