// Hand-written Hopper (sm_90a) kernels of the column-locality engines,
// SELLW and SELLR, and of SELLW's double-single variant, SELLWDS.
//
// Built by spmv_research_tpu_torch/ops/sell_cuda.py (through cuda_lib.py)
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Both formats cut the matrix into chunks of 8 sublanes x 128 lanes = 1024
// slots. Sublane s of chunk c is bound to one row of x viewed as
// (x_rows, 128): wrow[8c + s]. One packed word per slot (read as uint32):
//   [0,7)   lane pick: the slot's x element is x2d[wrow, lane]
//   [7,14)  scan guards: bit 7+k set where the slot's in-part position is
//           >= 2^k, so a guarded read never leaves its part (nor its row)
//   [14,21) eidx: the lane of a part's end, stored at the part's target lane
//   [21]    emask: (s, l) holds a live part end
//   SELLW [22,25) bid: the y block of the chunk's group the part belongs to
//   SELLR [22,25) roll r, [25] wrap: the part's target sublane is
//           (s + r) mod 8 within the same chunk
//
// Every kernel holds a chunk's slots in registers, a warp a sublane (the
// layout is described before lane_scan below), and runs the segmented lane
// scan in shuffles. The product is rounded before any add (__fmul_rn: nvcc
// would otherwise contract it with the first scan add into an fma, which
// the TPU kernels do not), and every sum runs in a fixed order, so the
// plain PyTorch versions in sell_cuda.py reproduce the results exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 8;
constexpr int kLanes = 128;
constexpr int kChunk = kSub * kLanes;
// SELLR's smeta: per step of kNB chunks, kSmemBlk ints.
constexpr int kNB = 64;
constexpr int kSmemBlk = 1024;
// The register-layout kernels (B11-B14): a warp a sublane, 4 lanes a thread.
constexpr int kRowThreads = kSub * 32;

// The SpMV kernels of SELLW (B11) and SELLR (B14's place) share the layout
// of sellw_spmm_kernel below, at one column, in persistent blocks:
//   * 256 threads a block: warp s is sublane s, and lane t of it holds the
//     row's lanes 4t..4t+3 (word and value read as one 16-byte load each,
//     streamed past L1 and early out of L2: they are read once; the four
//     x picks read straight into registers through the read-only path);
//   * a block walks the chunks blockIdx.x, blockIdx.x + gridDim.x, ...; the
//     grid is the SMs times the blocks an SM holds
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, sell_blocks_per_sm),
//     at most one block a chunk (sell_cuda.persistent_grid);
//   * loads stay in flight through registers, double-buffered: the word,
//     values and x row of the chunk after next are requested before the
//     next chunk's x picks, and those picks before this chunk's barrier,
//     so an SM holds about 40 KB of loads in flight while it scans and sums
//     (the card's 3.35 TB/s times ~1 us of latency is ~25 KB an SM). A
//     cp.async.bulk ring behind mbarriers would hold more, but needs a
//     producer warp and a ring per block; the registers reach the bytes in
//     flight that the card needs with no more code than a swap;
//   * the product __fmul_rn(x, val) and the guarded stages of the segmented
//     lane scan in registers (lane_scan: stage k adds the value 2^k lanes
//     back where guard bit 7+k is set, from the stage's old values; for
//     2^k = 1 and 2 from the same thread or one lane back, for 2^k >= 4 the
//     same element 2^k / 4 threads back; lanes wrap modulo 128, and a
//     guarded read never leaves its part);
//   * the warp stores its scanned sublane to shared memory once (one
//     16-byte store a thread) and, after a __syncwarp, reads each slot's
//     pick at its eidx; the picks and a byte of tag per slot (SELLW: the
//     bid where live, SELLR: the roll code where live; else 0xFF) go to a
//     double-buffered shared plane, 16 and 4 bytes a thread, so one
//     __syncthreads() a chunk orders them;
//   * after it, each warp reads eight sublanes' picks and tags at its own
//     four lanes (16 + 4 bytes a sublane) and adds them in the plain
//     version's order, and writes its result as one 16-byte store a thread.
// The products, stages, picks and sums are the plain versions' (sublanes
// 0..7 in order, the roll sources by r), so the results equal them bit for
// bit. The first kernels (a 1024-thread block a chunk, the scan
// ping-ponging two shared buffers with a barrier a stage, 2 blocks an SM)
// moved ~1.0 TB/s on an H100 SXM.
constexpr int kSpmvMinBlocks = 4;  // <= 64 registers a thread

// One thread's four slots of a chunk: words, values and the x plane's
// offset of their sublane's row (SELLR: also the stages its step scans).
struct Slots {
  uint4 w;
  float4 v;
  int64_t xrow;
  int nst;
};

__device__ __forceinline__ Slots load_slots(const uint32_t* __restrict__ word,
                                            const float* __restrict__ vals,
                                            int64_t c, int s, int lane) {
  const int64_t off = c * kChunk + s * kLanes + 4 * lane;
  Slots q;
  q.w = __ldcs(reinterpret_cast<const uint4*>(word + off));
  q.v = __ldcs(reinterpret_cast<const float4*>(vals + off));
  return q;
}

// The slots' x picks x2d[row, lane], zero past n_x (the x plane's padding).
__device__ __forceinline__ void gather_x(const float* __restrict__ x,
                                         int64_t n_x, const Slots& q,
                                         float (&xv)[4]) {
  const uint32_t w[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t col = q.xrow + (w[e] & 0x7F);
    xv[e] = col < n_x ? __ldg(x + col) : 0.0f;
  }
}

// The first nst (<= kMax, uniform over the block) guarded stages of the
// segmented lane scan of the warp's sublane, in registers.
template <int kMax>
__device__ __forceinline__ void lane_scan(float (&v)[4],
                                          const uint32_t (&w)[4], int lane,
                                          int nst) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k >= nst) break;
    float o[4];  // each element's value 2^k lanes back
    if (k == 0) {
      o[0] = __shfl_sync(full, v[3], (lane - 1) & 31);
      o[1] = v[0];
      o[2] = v[1];
      o[3] = v[2];
    } else if (k == 1) {
      o[0] = __shfl_sync(full, v[2], (lane - 1) & 31);
      o[1] = __shfl_sync(full, v[3], (lane - 1) & 31);
      o[2] = v[0];
      o[3] = v[1];
    } else {
      const int src = (lane - (1 << (k - 2))) & 31;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __shfl_sync(full, v[e], src);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((w[e] >> (7 + k)) & 1u) v[e] = v[e] + o[e];
  }
}

// Products and scan of the thread's slots, then the picks at eidx: the warp
// stores its scanned sublane to row (its own 128 floats) and reads the
// picks back; the picks go to pick[s*128 + 4*lane ..] and the four tag
// bytes (from tag_of(word)) to tag[s*32 + lane].
template <int kMax, typename TagOf>
__device__ __forceinline__ void scan_and_pick(const Slots& q,
                                              const float (&xv)[4],
                                              int nst, int s, int lane,
                                              float* row, float* pick,
                                              uint32_t* tag, TagOf tag_of) {
  const uint32_t w[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
  float v[4] = {__fmul_rn(xv[0], q.v.x), __fmul_rn(xv[1], q.v.y),
                __fmul_rn(xv[2], q.v.z), __fmul_rn(xv[3], q.v.w)};
  lane_scan<kMax>(v, w, lane, nst);
  float* r = row + s * kLanes;
  *reinterpret_cast<float4*>(r + 4 * lane) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
  __syncwarp();
  float p[4];
  uint32_t tg = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    p[e] = r[(w[e] >> 14) & 0x7F];
    tg |= ((w[e] >> 21) & 1u ? tag_of(w[e]) : 0xFFu) << (8 * e);
  }
  *reinterpret_cast<float4*>(pick + s * kLanes + 4 * lane) =
      make_float4(p[0], p[1], p[2], p[3]);
  tag[s * 32 + lane] = tg;
}

__device__ __forceinline__ uint32_t tag_byte(uint32_t tags, int e) {
  return (tags >> (8 * e)) & 0xFFu;
}

// SELLW SpMV (entry sellw_spmv, kernel B11) — replaces spmv_research_tpu/
// ops/sellw.py `_sellw_kernel` and `_sellw_stream_kernel`. The chunks
// [chunk0, chunk0 + n_chunks) of one stage class, kStages scan stages (one
// instance per depth 0..7, so the stages unroll). The TPU kernels first
// copied each sublane's 128-wide x row into VMEM (or, for n > 2^20,
// streamed windows that XLA pre-gathered); here each thread reads its x
// picks straight from device memory, so one kernel serves both program
// kinds and a stream_wins program moves 12 B/slot less.
// Output: G planes at out, plane g at rows [g*npad, (g+1)*npad); row c of
// plane g is, per lane, the sum over sublanes 0..7, in order, of the part
// ends whose bid is g (acc = acc + (bid == g ? pick : 0)), which warp g
// adds and writes.
// Bound: device memory, 8 bytes per slot (word, value), x from L2 (its
// rows are shared by neighbouring chunks), 512*G bytes written per chunk.
template <int kStages>
__global__ void __launch_bounds__(kRowThreads, kSpmvMinBlocks)
    sellw_spmv_kernel(const uint32_t* __restrict__ word,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ wrow,
                      const float* __restrict__ x, int64_t n_x,
                      float* __restrict__ out, int64_t npad, int64_t chunk0,
                      int64_t n_chunks, int G) {
  __shared__ __align__(16) float row[kChunk];
  __shared__ __align__(16) float pick[2][kChunk];
  __shared__ uint32_t tag[2][kChunk / 4];
  const int t = threadIdx.x;
  const int s = t >> 5;
  const int lane = t & 31;
  const int64_t step = gridDim.x;
  const uint32_t gmask = (uint32_t)(G - 1);
  auto load = [&](int64_t i) {
    Slots q = load_slots(word, vals, chunk0 + i, s, lane);
    q.xrow = (int64_t)wrow[(chunk0 + i) * kSub + s] * kLanes;
    q.nst = kStages;
    return q;
  };
  int64_t i = blockIdx.x;
  if (i >= n_chunks) return;
  Slots cur = load(i);
  Slots nxt{};
  if (i + step < n_chunks) nxt = load(i + step);
  float xv[4];
  gather_x(x, n_x, cur, xv);
  for (int b = 0; i < n_chunks; i += step, b ^= 1) {
    scan_and_pick<kStages>(cur, xv, kStages, s, lane, row, pick[b], tag[b],
                           [gmask](uint32_t w) { return (w >> 22) & gmask; });
    Slots after{};
    if (i + 2 * step < n_chunks) after = load(i + 2 * step);
    if (i + step < n_chunks) {
      cur = nxt;
      gather_x(x, n_x, cur, xv);
      nxt = after;
    }
    __syncthreads();
    if (s < G) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int si = 0; si < kSub; ++si) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&pick[b][si * kLanes + 4 * lane]);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const uint32_t tg = tag[b][si * 32 + lane];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = a[e] + (tag_byte(tg, e) == (uint32_t)s ? p[e] : 0.0f);
      }
      *reinterpret_cast<float4*>(
          out + ((int64_t)s * npad + chunk0 + i) * kLanes + 4 * lane) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

using SellwSpmv = void (*)(const uint32_t*, const float*, const int32_t*,
                          const float*, int64_t, float*, int64_t, int64_t,
                          int64_t, int);
const SellwSpmv kSellwSpmv[] = {
    sellw_spmv_kernel<0>, sellw_spmv_kernel<1>, sellw_spmv_kernel<2>,
    sellw_spmv_kernel<3>, sellw_spmv_kernel<4>, sellw_spmv_kernel<5>,
    sellw_spmv_kernel<6>, sellw_spmv_kernel<7>};

// SELLW SpMM (entry sellw_spmm, kernel B12) — replaces spmv_research_tpu/
// ops/sellw.py `_sellw_spmm_kernel`. The SpMV pipeline (product, guarded
// Hillis-Steele lane scan, pick at eidx, ordered sum over sublanes per
// bid) for each of the n_cols columns of X, with the chunk's slot structure
// decoded once and the scan held in registers:
//   * one block of 256 threads per chunk: warp s is sublane s, and lane t
//     of it holds the row's lanes 4t..4t+3 (their words, values and x
//     column indices read once, as one 16-byte load each);
//   * per column, the four products __fmul_rn(x, val) and the class's
//     scan stages in registers (lane_scan; one kernel instance per depth,
//     so the stages unroll);
//   * the scanned row goes to shared memory once (one 16-byte store a
//     thread), and thread (h, l) (l = lane, h = t / 128) sums, for each
//     bid g ≡ h mod 2, the picks of sublanes 0..7 at lane l in order,
//     acc = acc + (bid == g ? pick : 0), each pick one shared read from an
//     address it decoded once (s·128 + eidx where the entry is live and of
//     bid g, else a zero kept at the row's end: the add of +0 the plain
//     version makes);
//   * kCols columns per pass, double-buffered: one __syncthreads() a pass;
//     the next pass's x is loaded while this pass scans and sums.
// Shared-memory traffic per slot and column: one write and at most one
// read, against ~80-100 B in the first SpMM kernel's shared scan (the
// first SpMV kernel with four columns a pass). The products, stages, picks
// and sums are the SpMV's, in its order, so the planes equal
// sellw_spmm_planes_torch exactly.
// Output: per column k, sellw_spmv_kernel's G planes at out + k *
// plane_stride.
// Bound: device memory; at K = 128 the planes (512 * G bytes per chunk and
// column) are most of it, x read once per column from L2.
constexpr int kCols = 4;
// a scanned row and, at kChunk, a zero the sums of dead entries read
constexpr int kRow = kChunk + 4;

// 3 blocks an SM: <= 80 registers, no spills (the x of two passes in
// flight); one instance per scan depth, so the stages unroll.
template <int kStages>
__global__ void __launch_bounds__(kRowThreads, 3)
    sellw_spmm_kernel(const uint32_t* __restrict__ word,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ wrow,
                      const float* __restrict__ xt, int64_t n_x, int n_cols,
                      float* __restrict__ out, int64_t plane_stride,
                      int64_t npad, int64_t chunk0, int G) {
  __shared__ __align__(16) float buf[2][kCols][kRow];
  const int t = threadIdx.x;
  if (t < 2 * kCols) buf[t / kCols][t % kCols][kChunk] = 0.0f;
  const int s = t >> 5;
  const int lane = t & 31;
  const int64_t c = chunk0 + blockIdx.x;
  const int64_t off = c * kChunk + s * kLanes + 4 * lane;
  const uint4 w4 = *reinterpret_cast<const uint4*>(word + off);
  const float4 v4 = *reinterpret_cast<const float4*>(vals + off);
  const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
  const float val[4] = {v4.x, v4.y, v4.z, v4.w};
  const int xrow = wrow[c * kSub + s] * kLanes;  // n_x < 2^31
  int col[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) col[e] = xrow + (w[e] & 0x7F);
  // the sum thread's picks: sublane si's entry at lane l is
  // (bid << 10 | si*128 + eidx) where live, else -1 (it reads the zero)
  const int l = t & (kLanes - 1);
  const int h = t >> 7;
  int ent[kSub];
#pragma unroll
  for (int si = 0; si < kSub; ++si) {
    const uint32_t we = word[c * kChunk + si * kLanes + l];
    ent[si] = (we >> 21) & 1u
                  ? (int)(((we >> 22) & (uint32_t)(G - 1)) << 10 |
                          (si * kLanes + ((we >> 14) & 0x7F)))
                  : -1;
  }
  // x of the next pass is loaded while this pass scans and sums
  float xn[kCols][4];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        // the x plane's zero padding past n_x, as gather_x
        xn[q][e] = k0 + q < n_cols && col[e] < n_x
                       ? xt[(int64_t)(k0 + q) * n_x + col[e]]
                       : 0.0f;
  };
  load_x(0);
  for (int k0 = 0, pass = 0; k0 < n_cols; k0 += kCols, pass ^= 1) {
    const int nc = min(kCols, n_cols - k0);
    float v[kCols][4];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[q][e] = __fmul_rn(xn[q][e], val[e]);
    if (k0 + kCols < n_cols) load_x(k0 + kCols);
#pragma unroll
    for (int q = 0; q < kCols; ++q) lane_scan<kStages>(v[q], w, lane, kStages);
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      *reinterpret_cast<float4*>(&buf[pass][q][s * kLanes + 4 * lane]) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
    __syncthreads();  // one pass: the other buffer's reads ended before
    for (int gg = h; gg < G; gg += 2) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (q >= nc) break;
        const float* E = buf[pass][q];
        float acc = 0.0f;
#pragma unroll
        for (int si = 0; si < kSub; ++si)
          acc = acc + E[(ent[si] >> 10) == gg ? (ent[si] & 1023) : kChunk];
        out[(int64_t)(k0 + q) * plane_stride + (gg * npad + c) * kLanes +
            l] = acc;
      }
    }
  }
}

// SELLW's combine (entry sellw_combine, kernel B12c) — replaces the XLA
// gather and sum after the Pallas kernels, spmv_research_tpu/ops/sellw.py
// `_combine_y` (PyTorch ran it as planes[..., yidx, :] and .sum(dim=-3): a
// (cols, K, nb, 128) intermediate written and read back). For each y block
// b, lane l and column c of n_cols:
//   Y[128b + l][c] = 0 + planes[c][yidx[0][b]][l] + ...
//                      + planes[c][yidx[K-1][b]][l]
// in that order, the planes of B11 (n_cols = 1, y of length m) or B12
// (Y (m, n_cols) row-major):
//   * a unit is one (y block, column) sum; a block of 256 threads takes a
//     tile of 8 * kUnits units, kUnits a warp: ct = min(n_cols, 8 * kUnits)
//     columns of 8 * kUnits / ct y blocks (at n_cols >= 32 one y block, a
//     warp its columns w, w + 8, w + 16, w + 24), and lane t of a warp
//     holds the row's lanes 4t..4t+3 of each of its units;
//   * the tile's yidx columns go to shared memory first (coalesced over the
//     y blocks); each unit stops after its last entry that names a live
//     row, and skips entries that name the zero row G·npad (the builder
//     puts them last in each column). Both are exact: the sum starts at +0
//     and so is never -0, and adding +0 to it changes no bit;
//   * each live plane row is read once, as 16-byte streamed loads (each
//     plane row is named by at most one yidx entry): 8 loads a thread in
//     flight, then their adds in k order; kUnits = 4 at n_cols >= 4 (two
//     rows of each unit ahead), kUnits = 1 below (eight rows ahead: a
//     SpMV's 1101 y blocks on shipsec1 are 138 blocks, not 35);
//   * the units' sums are staged through shared memory (one 16-byte store
//     a thread and unit, rows padded to 132 floats) and each Y row of the
//     tile goes out as contiguous stores, 16 bytes a thread where n_cols
//     is a multiple of 4 (columns c0..c0+ct of rows 128b..128b+127).
// So the sums are sellw_combine_torch's, in its order, bit for bit.
// Bound: device memory, the live plane rows read once and Y written once:
// 4 * (128 * live entries + m) * n_cols bytes (shipsec1_spd at K = 128:
// 1.654 GB + 72 MB, 0.515 ms at 3.35 TB/s; this kernel 0.592 ms on an H100
// SXM, the gather and sum it replaced 3.72 ms).
constexpr int kCombThreads = 256;
constexpr int kCombLoads = 8;    // loads a thread keeps in flight
constexpr int kCombMaxUnits = 32;
constexpr int kCombMaxK = 64;    // the builder's cap on yidx rows
constexpr int kCombRow = kLanes + 4;  // a staged sum, 16-byte aligned

template <int kUnits>
__global__ void __launch_bounds__(kCombThreads, 3)
    sellw_combine_kernel(const float* __restrict__ planes,
                         int64_t plane_stride,
                         const int32_t* __restrict__ yidx, int K, int64_t nb,
                         int32_t zero_row, int64_t m, int n_cols, int ct,
                         float* __restrict__ y) {
  constexpr int kAhead = kCombLoads / kUnits;  // rows of a unit ahead
  __shared__ int32_t ys[kCombMaxK][kCombMaxUnits];
  __shared__ int n_live[kCombMaxUnits];
  __shared__ __align__(16) float tile[kCombMaxUnits * kCombRow];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int bbn = 8 * kUnits / ct;  // y blocks a tile
  const int n_ct = (n_cols + ct - 1) / ct;
  const int64_t b0 = (int64_t)(blockIdx.x / n_ct) * bbn;
  const int c0 = (blockIdx.x % n_ct) * ct;
  const int ncw = min(ct, n_cols - c0);  // the tile's columns
  for (int i = t; i < K * bbn; i += kCombThreads) {
    const int k = i / bbn, bb = i % bbn;
    ys[k][bb] = b0 + bb < nb ? yidx[k * nb + b0 + bb] : zero_row;
  }
  __syncthreads();
  if (t < bbn) {
    int n = K;
    while (n > 0 && ys[n - 1][t] == zero_row) --n;
    n_live[t] = n;
  }
  __syncthreads();
  int bb[kUnits], n[kUnits];
  const float* src[kUnits];
  int kmax = 0;
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = warp + 8 * j;
    bb[j] = u / ct;
    const int c = u % ct;
    n[j] = bb[j] < bbn && c < ncw ? n_live[bb[j]] : 0;
    kmax = max(kmax, n[j]);
    src[j] = planes + (int64_t)(c0 + min(c, ncw - 1)) * plane_stride +
             4 * lane;
  }
  float4 acc[kUnits];
#pragma unroll
  for (int j = 0; j < kUnits; ++j)
    acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < kmax; k0 += kAhead) {
    float4 v[kUnits][kAhead];
#pragma unroll
    for (int j = 0; j < kUnits; ++j)
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int k = k0 + q;
        const int32_t row = k < n[j] ? ys[k][bb[j]] : zero_row;
        v[j][q] = row != zero_row
                      ? __ldcs(reinterpret_cast<const float4*>(
                            src[j] + (int64_t)row * kLanes))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
    for (int j = 0; j < kUnits; ++j)
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        acc[j].x = acc[j].x + v[j][q].x;
        acc[j].y = acc[j].y + v[j][q].y;
        acc[j].z = acc[j].z + v[j][q].z;
        acc[j].w = acc[j].w + v[j][q].w;
      }
  }
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    const int u = warp + 8 * j;
    if (u < bbn * ct)
      *reinterpret_cast<float4*>(&tile[u * kCombRow + 4 * lane]) = acc[j];
  }
  __syncthreads();
  // row r of the tile is Y row 128 * b0 + r: y block r / 128, lane r % 128
  const int64_t r0 = b0 * kLanes;
  const int rows = (int)min((int64_t)bbn * kLanes, m - r0);
  if ((n_cols & 3) == 0) {  // then ct and c0 are multiples of 4 too
    const int q4 = ncw >> 2;
    for (int i = t; i < rows * q4; i += kCombThreads) {
      const int r = i / q4, c = 4 * (i % q4);
      const float* s = &tile[((r >> 7) * ct + c) * kCombRow + (r & 127)];
      *reinterpret_cast<float4*>(y + (r0 + r) * n_cols + c0 + c) =
          make_float4(s[0], s[kCombRow], s[2 * kCombRow], s[3 * kCombRow]);
    }
  } else {
    for (int i = t; i < rows * ncw; i += kCombThreads) {
      const int r = i / ncw, c = i % ncw;
      y[(r0 + r) * n_cols + c0 + c] =
          tile[((r >> 7) * ct + c) * kCombRow + (r & 127)];
    }
  }
}

// SELLR kernel 1 (entry sellr_place, B14 with kernel 2) — with kernel 2,
// replaces spmv_research_tpu/ops/sellr.py `_sellr_kernel`. The live chunks
// [0, n_chunks) in persistent blocks, on the layout above: per chunk the
// placed plane R (8 x 128), the part sums P (the picks of live part ends)
// each moved from its sublane s to its target sublane (s + r) mod 8 of the
// same chunk. The scan runs the stages the chunk's step needs (smeta's
// smax, capped by `stages`; uniform over a chunk, so one guarded unrolled
// loop over 0..6 serves). Warp s then builds target sublane s: per cell the
// sources in the order of the JAX kernel's roll set, sorted by r: R = P[s]
// where its code (r, wrap) is (0, 0), then + P[(s - r) mod 8] for r = 1..7
// where that source's code is (r, wrap) with wrap = (s - r < 0), each read
// as 16 bytes of picks and 4 of codes; R written as 16-byte stores.
// Bound: device memory, 8 bytes per slot read and 4 written (R); x from L2.
__global__ void __launch_bounds__(kRowThreads, kSpmvMinBlocks)
    sellr_place_kernel(const uint32_t* __restrict__ word,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ smeta,
                       const float* __restrict__ x, int64_t n_x,
                       float* __restrict__ R, int64_t n_chunks, int stages) {
  __shared__ __align__(16) float row[kChunk];
  __shared__ __align__(16) float pick[2][kChunk];
  __shared__ uint32_t code[2][kChunk / 4];
  const int t = threadIdx.x;
  const int s = t >> 5;
  const int lane = t & 31;
  const int64_t step = gridDim.x;
  auto load = [&](int64_t c) {
    Slots q = load_slots(word, vals, c, s, lane);
    const int32_t* sm = smeta + (c / kNB) * kSmemBlk;
    q.xrow = (int64_t)sm[(c % kNB) * kSub + s] * kLanes;
    q.nst = min(stages, (int)sm[kNB * kSub + kNB + 1]);
    return q;
  };
  int64_t c = blockIdx.x;
  if (c >= n_chunks) return;
  Slots cur = load(c);
  Slots nxt{};
  if (c + step < n_chunks) nxt = load(c + step);
  float xv[4];
  gather_x(x, n_x, cur, xv);
  for (int b = 0; c < n_chunks; c += step, b ^= 1) {
    scan_and_pick<kSub - 1>(cur, xv, cur.nst, s, lane, row, pick[b], code[b],
                            [](uint32_t w) { return (w >> 22) & 0xFu; });
    Slots after{};
    if (c + 2 * step < n_chunks) after = load(c + 2 * step);
    if (c + step < n_chunks) {
      cur = nxt;
      gather_x(x, n_x, cur, xv);
      nxt = after;
    }
    __syncthreads();
    const float4 p0 =
        *reinterpret_cast<const float4*>(&pick[b][s * kLanes + 4 * lane]);
    const uint32_t c0 = code[b][s * 32 + lane];
    float a[4] = {tag_byte(c0, 0) == 0 ? p0.x : 0.0f,
                  tag_byte(c0, 1) == 0 ? p0.y : 0.0f,
                  tag_byte(c0, 2) == 0 ? p0.z : 0.0f,
                  tag_byte(c0, 3) == 0 ? p0.w : 0.0f};
#pragma unroll
    for (int r = 1; r < kSub; ++r) {
      const int src = (s - r) & (kSub - 1);
      const uint32_t want = r | ((src + r >= kSub) << 3);
      const float4 p4 =
          *reinterpret_cast<const float4*>(&pick[b][src * kLanes + 4 * lane]);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      const uint32_t cr = code[b][src * 32 + lane];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tag_byte(cr, e) == want) a[e] = a[e] + p[e];
    }
    *reinterpret_cast<float4*>(R + c * kChunk + s * kLanes + 4 * lane) =
        make_float4(a[0], a[1], a[2], a[3]);
  }
}

// SELLR kernel 2 (entry sellr_flush): the run-flush. On the TPU the chunks
// ran in order with one run accumulator (acc += R_c; on a flush chunk
// y[group] += acc and acc = 0) and y resident in VMEM. Here each y group (8
// x 128 cells) replays its chunks in that order from the host-made list
// (gptr, gchunk = chunk<<1 | flush), so no two blocks write one cell: no
// atomics, deterministic, the TPU kernel's sums. A group's 1024 cells are
// split over kFlushSplit blocks of kFlushThreads threads, four cells (one
// 16-byte load of R a chunk) a thread, so a shipsec1 SpMV runs 552 blocks
// on 132 SMs, not 138. Each thread keeps kAhead chunks' R loads in flight:
// it reads the list kAhead entries ahead, issues the next kAhead loads, then
// adds them in the listed order. (Two such batches in flight measured no
// faster on an H100 SXM.)
// Bound: reading R once (4 B/slot), y written once.
constexpr int kFlushThreads = 64;
constexpr int kFlushSplit = kChunk / (4 * kFlushThreads);
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kFlushThreads)
    sellr_flush_kernel(const float* __restrict__ R,
                       const int32_t* __restrict__ gptr,
                       const int32_t* __restrict__ gchunk,
                       float* __restrict__ y) {
  const int g = blockIdx.x / kFlushSplit;
  const int cell =
      ((blockIdx.x % kFlushSplit) * kFlushThreads + threadIdx.x) * 4;
  const int end = gptr[g + 1];
  int i = gptr[g];
  int e[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) e[j] = i + j < end ? gchunk[i + j] : 0;
  float yv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (; i < end; i += kAhead) {
    float4 r[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (i + j < end)
        r[j] = __ldcs(reinterpret_cast<const float4*>(
            R + (int64_t)(e[j] >> 1) * kChunk + cell));
    int en[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      en[j] = i + kAhead + j < end ? gchunk[i + kAhead + j] : 0;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (i + j >= end) break;
      const float rv[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = acc[q] + rv[q];
      if (e[j] & 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          yv[q] = yv[q] + acc[q];
          acc[q] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) e[j] = en[j];
  }
  *reinterpret_cast<float4*>(y + (int64_t)g * kChunk + cell) =
      make_float4(yv[0], yv[1], yv[2], yv[3]);
}

// Double-single arithmetic for SELLWDS. Every multiply, add and subtract is
// an __f*_rn intrinsic: nvcc never contracts those into an fma, and Dekker's
// TwoProd and Knuth's TwoSum are exact only when each step is rounded on its
// own (the TPU kernel's arithmetic; an fma would change the error terms).
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// Dekker's split into 12 + 12-bit halves (4097 = 2^12 + 1); the builder
// refuses |a| >= 8e34, where 4097 * a would overflow.
__device__ __forceinline__ void split32(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// SELLWDS (entry sellwds_spmv, kernel B13) — replaces
// spmv_research_tpu/ops/sellw_ds.py `_sellwds_kernel`. SELLW's pipeline
// with every value an (hi, lo) fp32 pair, on sellw_spmm_kernel's register
// layout:
//   * one block of 256 threads per chunk of one stage class: warp s is
//     sublane s, and lane t of it holds the row's lanes 4t..4t+3 (word,
//     vhi and vlo read as one 16-byte load each; the x hi and lo picks
//     x hi[col], x lo[col] straight into registers, zero past n_x);
//   * p + e = TwoProd(vhi, x hi) (Dekker: p = vhi * x hi, e = ((ahi * bhi
//     - p) + ahi * blo + alo * bhi) + alo * blo), then e += vhi * x lo,
//     then e += vlo * x hi;
//   * the class's guarded stages of the segmented lane scan on the (s, e)
//     pair, in registers (one kernel instance per depth, so the stages
//     unroll): t = s + rs; bb = t - s; err = (s - (t - bb)) + (rs - bb);
//     e = (e + re) + err; s = t, with (rs, re) the pair 2^k lanes back
//     where the slot's guard bit 7 + k is set, else (0, 0). Both come from
//     the stage's old values: for 2^k = 1 and 2 from the same thread or
//     one lane back, for 2^k >= 4 from the same element 2^k / 4 threads
//     back (shuffles), lane indices modulo 128;
//   * the scanned s and e rows go to shared memory once (one 16-byte
//     store each a thread), and thread (h, l) (l = lane, h = t / 128)
//     folds, for each y block g ≡ h mod 2 of the chunk's group, the picks
//     of sublanes 0..7 at lane l in order with TwoSum: S, e1 = TwoSum(S,
//     pick s); E = (E + e1) + pick e. A pick is one shared read from an
//     address decoded once (s·128 + eidx where the entry is live and of
//     block g, else a zero kept at the row's end: the +0 the plain version
//     adds).
// Every multiply, add and subtract is an __f*_rn intrinsic, in the plain
// version's order (sellwds_planes_torch), so the planes equal it bit for
// bit. Output: plane g of out_s and out_e at rows [g*npad, (g+1)*npad),
// as sellw_spmv_kernel's.
// Bound: device memory, 12 bytes per slot read (word, vhi, vlo), x hi and
// lo from L2, 2 * 512 * G bytes written per chunk. The first kernel (one
// 1024-thread block a chunk, the product and the scan through four
// shared buffers with a barrier a stage) ran 3.0x this bound.
template <int kStages>
__global__ void __launch_bounds__(kRowThreads, 4)
    sellwds_kernel(const uint32_t* __restrict__ word,
                   const float* __restrict__ vhi,
                   const float* __restrict__ vlo,
                   const int32_t* __restrict__ wrow,
                   const float* __restrict__ xh,
                   const float* __restrict__ xl, int64_t n_x,
                   float* __restrict__ out_s, float* __restrict__ out_e,
                   int64_t npad, int64_t chunk0, int G) {
  __shared__ __align__(16) float bs[kRow];
  __shared__ __align__(16) float be[kRow];
  const int t = threadIdx.x;
  if (t == 0) {
    bs[kChunk] = 0.0f;
    be[kChunk] = 0.0f;
  }
  const int s = t >> 5;
  const int lane = t & 31;
  const int64_t c = chunk0 + blockIdx.x;
  const int64_t off = c * kChunk + s * kLanes + 4 * lane;
  const uint4 w4 = *reinterpret_cast<const uint4*>(word + off);
  const float4 a4 = *reinterpret_cast<const float4*>(vhi + off);
  const float4 b4 = *reinterpret_cast<const float4*>(vlo + off);
  const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
  const int64_t xrow = (int64_t)wrow[c * kSub + s] * kLanes;
  float sv[4], ev[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t col = xrow + (w[q] & 0x7F);
    // the x planes' zero padding past n_x
    const float gh = col < n_x ? xh[col] : 0.0f;
    const float gl = col < n_x ? xl[col] : 0.0f;
    const float p = __fmul_rn(a[q], gh);
    float ahi, alo, bhi, blo;
    split32(a[q], ahi, alo);
    split32(gh, bhi, blo);
    const float e = __fadd_rn(
        __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p),
                            __fmul_rn(ahi, blo)),
                  __fmul_rn(alo, bhi)),
        __fmul_rn(alo, blo));
    sv[q] = p;
    ev[q] = __fadd_rn(__fadd_rn(e, __fmul_rn(a[q], gl)),
                      __fmul_rn(b[q], gh));
  }
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    float os[4], oe[4];  // each element's pair 2^k lanes back
    if (k == 0) {
      os[0] = __shfl_sync(full, sv[3], (lane - 1) & 31);
      oe[0] = __shfl_sync(full, ev[3], (lane - 1) & 31);
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        os[q] = sv[q - 1];
        oe[q] = ev[q - 1];
      }
    } else if (k == 1) {
      os[0] = __shfl_sync(full, sv[2], (lane - 1) & 31);
      os[1] = __shfl_sync(full, sv[3], (lane - 1) & 31);
      oe[0] = __shfl_sync(full, ev[2], (lane - 1) & 31);
      oe[1] = __shfl_sync(full, ev[3], (lane - 1) & 31);
#pragma unroll
      for (int q = 2; q < 4; ++q) {
        os[q] = sv[q - 2];
        oe[q] = ev[q - 2];
      }
    } else {
      const int src = (lane - (1 << (k - 2))) & 31;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        os[q] = __shfl_sync(full, sv[q], src);
        oe[q] = __shfl_sync(full, ev[q], src);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool guard = (w[q] >> (7 + k)) & 1u;
      const float rs = guard ? os[q] : 0.0f;
      const float re = guard ? oe[q] : 0.0f;
      const float s1 = __fadd_rn(sv[q], rs);
      const float bb = __fsub_rn(s1, sv[q]);
      const float err = __fadd_rn(__fsub_rn(sv[q], __fsub_rn(s1, bb)),
                                  __fsub_rn(rs, bb));
      ev[q] = __fadd_rn(__fadd_rn(ev[q], re), err);
      sv[q] = s1;
    }
  }
  *reinterpret_cast<float4*>(&bs[s * kLanes + 4 * lane]) =
      make_float4(sv[0], sv[1], sv[2], sv[3]);
  *reinterpret_cast<float4*>(&be[s * kLanes + 4 * lane]) =
      make_float4(ev[0], ev[1], ev[2], ev[3]);
  // the fold thread's picks: sublane si's entry at lane l is
  // (block << 10 | si*128 + eidx) where live, else -1 (it reads the zero)
  const int l = t & (kLanes - 1);
  const int h = t >> 7;
  int ent[kSub];
#pragma unroll
  for (int si = 0; si < kSub; ++si) {
    const uint32_t we = word[c * kChunk + si * kLanes + l];
    ent[si] = (we >> 21) & 1u
                  ? (int)(((we >> 22) & (uint32_t)(G - 1)) << 10 |
                          (si * kLanes + ((we >> 14) & 0x7F)))
                  : -1;
  }
  __syncthreads();
  for (int g = h; g < G; g += 2) {
    float S = 0.0f, E = 0.0f;
#pragma unroll
    for (int si = 0; si < kSub; ++si) {
      const int at = (ent[si] >> 10) == g ? (ent[si] & 1023) : kChunk;
      float s1, e1;
      two_sum(S, bs[at], s1, e1);
      S = s1;
      E = __fadd_rn(__fadd_rn(E, e1), be[at]);
    }
    out_s[(g * npad + c) * kLanes + l] = S;
    out_e[(g * npad + c) * kLanes + l] = E;
  }
}

// SELLWDS's combine (entry sellwds_combine) — replaces the XLA combine of
// spmv_research_tpu/ops/sellw_ds.py (`_combine_y_ds`, the per-y-block
// TwoSum over the yidx rows that followed the Pallas kernel; PyTorch ran
// it as eight elementwise launches a row). One thread per (y block b,
// lane l), one block of 128 threads per y block: for k = 0..K-1 in order,
// the pair (s, e) = (planes_s, planes_e)[yidx[k][b]][l] (padding entries
// name the zero row G·npad), S, e1 = TwoSum(S, s); E = (E + e1) + e, every
// step an __f*_rn intrinsic as in sellwds_combine_torch, so the result
// equals it bit for bit. Writes s = S and e = E of y element 128b + l < m,
// or, given y, the fp32 y = S + E.
// Bound: device memory, the planes' live rows read once (each plane row
// is named by at most one yidx entry), y written once.
__global__ void __launch_bounds__(kLanes)
    sellwds_combine_kernel(const float* __restrict__ planes_s,
                           const float* __restrict__ planes_e,
                           const int32_t* __restrict__ yidx, int K,
                           int64_t nb, int64_t m, float* __restrict__ out_s,
                           float* __restrict__ out_e, float* __restrict__ y) {
  const int64_t b = blockIdx.x;
  const int l = threadIdx.x;
  float S = 0.0f, E = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const int64_t row = yidx[k * nb + b];
    float s1, e1;
    two_sum(S, planes_s[row * kLanes + l], s1, e1);
    S = s1;
    E = __fadd_rn(__fadd_rn(E, e1), planes_e[row * kLanes + l]);
  }
  const int64_t i = b * kLanes + l;
  if (i >= m) return;
  if (y) {
    y[i] = __fadd_rn(S, E);
  } else {
    out_s[i] = S;
    out_e[i] = E;
  }
}

}  // namespace

extern "C" {

const char* sell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks an SM holds of a persistent SpMV kernel (kernel 0: B11 at the
// given scan depth, 1: SELLR's place), into *blocks; the grid of a launch
// is at most the SMs times this (sell_cuda.persistent_grid).
int sell_blocks_per_sm(int kernel, int stages, int* blocks) {
  if (stages < 0 || stages > 7 || kernel < 0 || kernel > 1)
    return (int)cudaErrorInvalidValue;
  return kernel == 0 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, kSellwSpmv[stages], kRowThreads, 0)
                     : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, sellr_place_kernel, kRowThreads, 0);
}

// Chunks [chunk0, chunk0 + n_chunks) of one stage class, n_chunks > 0, on
// grid persistent blocks; out holds G planes of npad rows each.
int sellw_spmv(const void* word, const void* vals, const void* wrow,
               const void* x, int64_t n_x, void* out, int64_t npad,
               int64_t chunk0, int64_t n_chunks, int stages, int G, int grid,
               void* stream) {
  if (stages < 0 || stages > 7 || grid < 1) return (int)cudaErrorInvalidValue;
  kSellwSpmv[stages]<<<(unsigned)grid, kRowThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)wrow,
      (const float*)x, n_x, (float*)out, npad, chunk0, n_chunks, G);
  return (int)cudaGetLastError();
}

// As sellw_spmv for the n_cols columns of xt (n_cols, n_x), through
// sellw_spmm_kernel; column k's G planes start at out + k * plane_stride.
int sellw_spmm(const void* word, const void* vals, const void* wrow,
               const void* xt, int64_t n_x, int n_cols, void* out,
               int64_t plane_stride, int64_t npad, int64_t chunk0,
               int64_t n_chunks, int stages, int G, void* stream) {
  using Kernel = void (*)(const uint32_t*, const float*, const int32_t*,
                         const float*, int64_t, int, float*, int64_t, int64_t,
                         int64_t, int);
  static const Kernel kernels[] = {
      sellw_spmm_kernel<0>, sellw_spmm_kernel<1>, sellw_spmm_kernel<2>,
      sellw_spmm_kernel<3>, sellw_spmm_kernel<4>, sellw_spmm_kernel<5>,
      sellw_spmm_kernel<6>, sellw_spmm_kernel<7>};
  if (stages < 0 || stages > 7) return (int)cudaErrorInvalidValue;
  kernels[stages]<<<(unsigned)n_chunks, kRowThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)wrow,
      (const float*)xt, n_x, n_cols, (float*)out, plane_stride, npad, chunk0,
      G);
  return (int)cudaGetLastError();
}

// R: (n_chunks * 1024,), the placed planes of the n_chunks > 0 live chunks,
// on grid persistent blocks.
int sellr_place(const void* word, const void* vals, const void* smeta,
                const void* x, int64_t n_x, void* R, int64_t n_chunks,
                int stages, int grid, void* stream) {
  if (stages < 0 || stages > 7 || grid < 1) return (int)cudaErrorInvalidValue;
  sellr_place_kernel<<<(unsigned)grid, kRowThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)smeta,
      (const float*)x, n_x, (float*)R, n_chunks, stages);
  return (int)cudaGetLastError();
}

// y: (n_groups * 1024,), n_groups > 0, from R and the listed run order;
// kFlushSplit blocks a group.
int sellr_flush(const void* R, const void* gptr, const void* gchunk, void* y,
                int n_groups, void* stream) {
  sellr_flush_kernel<<<(unsigned)n_groups * kFlushSplit, kFlushThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)R, (const int32_t*)gptr, (const int32_t*)gchunk,
      (float*)y);
  return (int)cudaGetLastError();
}

// Chunks [chunk0, chunk0 + n_chunks) of one stage class; out_s and out_e
// hold G planes of npad rows each.
int sellwds_spmv(const void* word, const void* vhi, const void* vlo,
                 const void* wrow, const void* xh, const void* xl,
                 int64_t n_x, void* out_s, void* out_e, int64_t npad,
                 int64_t chunk0, int64_t n_chunks, int stages, int G,
                 void* stream) {
  using Kernel = void (*)(const uint32_t*, const float*, const float*,
                         const int32_t*, const float*, const float*, int64_t,
                         float*, float*, int64_t, int64_t, int);
  static const Kernel kernels[] = {
      sellwds_kernel<0>, sellwds_kernel<1>, sellwds_kernel<2>,
      sellwds_kernel<3>, sellwds_kernel<4>, sellwds_kernel<5>,
      sellwds_kernel<6>, sellwds_kernel<7>};
  if (stages < 0 || stages > 7) return (int)cudaErrorInvalidValue;
  kernels[stages]<<<(unsigned)n_chunks, kRowThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vhi, (const float*)vlo,
      (const int32_t*)wrow, (const float*)xh, (const float*)xl, n_x,
      (float*)out_s, (float*)out_e, npad, chunk0, G);
  return (int)cudaGetLastError();
}

// Y (m, n_cols) row-major (at n_cols = 1, y of length m) from the n_cols
// columns' planes, column c at planes + c * plane_stride, their zero row
// zero_row, and yidx (K, nb), 0 < K <= 64, m > 0.
int sellw_combine(const void* planes, int64_t plane_stride, const void* yidx,
                  int K, int64_t nb, int zero_row, int64_t m, int n_cols,
                  void* y, void* stream) {
  if (K < 1 || K > kCombMaxK || n_cols < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int units = n_cols >= 4 ? 4 : 1;  // a warp's units
  const int ct = min(n_cols, 8 * units);
  const int bbn = 8 * units / ct;
  const int64_t grid = (nb + bbn - 1) / bbn * ((n_cols + ct - 1) / ct);
  if (grid >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  auto kernel =
      units == 4 ? &sellw_combine_kernel<4> : &sellw_combine_kernel<1>;
  kernel<<<(unsigned)grid, kCombThreads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, plane_stride, (const int32_t*)yidx, K, nb,
      zero_row, m, n_cols, ct, (float*)y);
  return (int)cudaGetLastError();
}

// y of length m from the s and e planes and yidx (K, nb), nb > 0: s and e
// into out_s and out_e, or, when y is not null, y = s + e.
int sellwds_combine(const void* planes_s, const void* planes_e,
                    const void* yidx, int K, int64_t nb, int64_t m,
                    void* out_s, void* out_e, void* y, void* stream) {
  sellwds_combine_kernel<<<(unsigned)nb, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)planes_s, (const float*)planes_e, (const int32_t*)yidx,
      K, nb, m, (float*)out_s, (float*)out_e, (float*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
