// Hand-written Hopper (sm_90a) kernels of the BFLY routed-butterfly SpMV
// engine: one phase of stages per launch over tiles of the plane, for one
// exchange network, one fill or one scan (B9) and for the whole routing
// program (B10). Both run the same phase kernel, `full_kernel`.
//
// Built by spmv_research_tpu_torch/ops/bfly_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing, and
// returns a cudaError_t as an int so the wrapper can raise on a refused
// launch.
//
// Program layout (spmv_research_tpu/ops/bfly.py): a flat plane of N = 2^L
// float32 slots; bit planes of uint32 words, one bit per stage. An exchange
// stage (w, b, k) of a network reads take bit b of word plane w:
//   out[p] = bit ? v[p ^ 2^k] : v[p]
// (default-keep select; the partner p ^ 2^k is what the TPU kernel built
// from two lane or sublane rolls and a select). A fill stage k reads bit k
// of the fill words, a scan stage k bit k of the scan guards:
//   fill: out[p] = take ? v[p - 2^k] : v[p]
//   scan: out[p] = v[p] + (guard ? v[p - 2^k] : 0)
// with p - 2^k wrapping over the N slots like jnp.roll (a set bit never
// wraps).
//
// B9 `bfly_xor_net`, `bfly_fill`, `bfly_scan` — replace spmv_research_tpu/
// ops/bfly_pallas.py `_xor_net_kernel`, `_fill_kernel` and `_scan_kernel`,
// each of which ran all of its stages in VMEM in one call. Here each
// wrapper's stages become B10's stage codes (one network, or one run of
// shifts, without × vals and × valid: the wrapper passes no vals and no
// valid plane, which `finish` honours) and run in B10's phases below, one
// launch a phase: a Waksman network of L = 20 in three (contiguous,
// strided, contiguous), the fill and the scan in one contiguous phase each
// (halo 63 and 511 slots), 11 launches per SpMV where one a stage took
// 132. Bound: device memory, the value plane and the network's or run's
// word planes read once and the plane written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCodes = 256;

// B10's stage codes: bits [0,5) k, [5,10) b, [10,16) w, [16,18) kind,
// [18,20) network (exchange stages), bit 20: multiply each value this stage
// reads by vals first (the first stage after the perm network; × vals was
// its own XLA pass in JAX).
enum Kind { kExchange = 0, kFill = 1, kScan = 2 };
enum Net { kWiden = 0, kPerm = 1, kCompact = 2 };

// ---------------------------------------------------------------- B10
//
// B10 `bfly_full` — replaces bfly_pallas.py `_full_kernel`: the whole
// program (widen, fill, perm, × vals, scan, compact, × valid) in a few
// launches. A stage's partner can lie anywhere in the plane, so a
// launch boundary is needed somewhere; this kernel needs one per PHASE,
// not one per stage. The host planner (ops/bfly_cuda.py `plan_phases`)
// cuts the stage codes into phases, maximal runs of consecutive stages that
// one tiling of the plane into blocks of 2^T slots serves:
//   contiguous: tile t holds slots [t·2^T, (t+1)·2^T). It serves exchange
//     stages with k < T, after a leading run of fill or scan stages given a
//     halo: the `halo` slots before the tile (read modulo N, as torch.roll
//     wraps), with halo >= the sum of the run's shifts 2^k, so that every
//     tile slot's chain of reads stays inside the window (a halo slot whose
//     read would leave the window is garbage nothing valid reads). When
//     T = L the tile is the whole plane and the shifts wrap inside it.
//   strided: tile t holds the slots whose middle bits [5, L−T+5) equal t:
//     a run of 32 (bits [0,5), one coalesced 128 B row per warp) times the
//     2^(T−5) values of the top T−5 bits. It serves exchange stages with
//     k < 5 or k >= L − T + 5.
//   global: one stage no tiling serves (an exchange at T <= k < L−T+5, a
//     shift past the halo budget), a thread per slot over the whole plane.
// Together the two tilings serve every exchange stage while L <= 2T − 5.
// The Waksman networks run k = 0..L−1..0, so at L = 20, T = 13 a network
// takes three phases (contiguous 0..12, strided 13..19..12, contiguous
// 11..0), the fill and scan each open the contiguous phase that runs the
// next network's first stages, and the scircuit program takes 9 phases
// (132 stages). The phases ping-pong two buffers, x is read by the first,
// out written by the last. One launch a phase: on the H100 a single
// cooperative launch with grid.sync() between phases spilled (the barrier
// costs registers at 1024 threads) and was slower (PERF.md).
//
// Inside a phase a block holds its tile in registers: J slots a thread
// (tile-local index li = lane | j << 5 | warp << (5 + jb), J = 2^jb = 8,
// 16 at T = 14, so 1024 threads a block from T = 13: 32 warps an SM hide
// the latencies that 8 warps of 32 slots each did not). An exchange stage
// flips one bit of li: a lane bit is one __shfl_xor_sync, a j bit a select
// between two of the thread's own registers, and a warp bit goes through
// shared memory (a store, one __syncthreads(), a load; two buffers
// alternate). Each slot's 32-bit word sits in a
// register for as long as the stages read the same word plane (one read
// of a word per plane and phase). A run of fill or scan stages runs in
// shared memory on the window, halo included (two value buffers, one
// __syncthreads() a stage, the shift words read once into a third), and
// is then read back into the registers.
//
// Bit-exactness: exchange and fill stages are selects; each scan stage is
// one v[p] + (g ? v[p − 2^k] : 0) per slot, the halo recomputing exactly
// those operations; × vals (the stage after the perm network, code bit 20)
// multiplies the values before that stage and × valid (× vals too when no
// stage follows the perm network) is applied as the last phase writes out,
// both __fmul_rn (never contracted into an FMA). So the result equals B9's
// chain and the plain version bit for bit.
//
// Bound: device memory, the program's planes read once (the phases'
// re-reads of the 4 MB value plane and the word planes hit L2).

constexpr int kMaxTileLog = 14;    // 64 KB of fp32 a tile
constexpr int kPhaseThreads = 1024;
constexpr int kHaloMax = 1024;     // slots of halo a window may carry
constexpr int kMaxPhases = 128;
enum Tiling { kContig = 0, kStrided = 1, kGlobal = 2 };

struct Phase {
  int first, count, tiling, halo;
};

struct Program {
  int n_codes;
  int premul_final;        // the final × valid pass reads × vals too
  int n_phases;
  int log_n;               // L
  int tile_log;            // T (T = L: the whole plane is one tile)
  int halo_max;            // the largest halo of any phase
  uint32_t code[kMaxCodes];
  Phase phase[kMaxPhases];
};

struct Planes {
  const float* x;
  float* buf0;
  float* buf1;
  const uint32_t* widen_b;
  const uint32_t* fill_words;
  const uint32_t* perm_b;
  const float* vals;
  const uint32_t* scan_guards;
  const uint32_t* compact_b;
  const float* valid;
  float* out;
  int64_t n;
};

// One stage code, decoded: kind, shift or exchange distance exponent k,
// the bit it tests in its word plane, × vals first, and the word plane.
struct Stage {
  int kind, k, bit;
  bool premul;
  const uint32_t* plane;
};

__device__ __forceinline__ Stage decode(const Planes& a, uint32_t c) {
  Stage st;
  st.k = c & 31;
  st.kind = (c >> 16) & 3;
  st.premul = (c >> 20) & 1;
  if (st.kind == kExchange) {
    const int net = (c >> 18) & 3;
    st.bit = (c >> 5) & 31;
    st.plane = (net == kWiden ? a.widen_b : net == kPerm ? a.perm_b
                                                         : a.compact_b) +
               (int64_t)((c >> 10) & 63) * a.n;
  } else {
    st.bit = st.k;
    st.plane = st.kind == kFill ? a.fill_words : a.scan_guards;
  }
  return st;
}

// The last phase's write: × vals when no stage followed the perm network,
// then × valid (none for a B9 program, whose valid is null).
__device__ __forceinline__ float finish(const Planes& a, const Program& P,
                                        float v, int64_t g) {
  if (P.premul_final) v = __fmul_rn(v, a.vals[g]);
  return a.valid ? __fmul_rn(v, a.valid[g]) : v;
}

// A phase reads the buffer the launch before it wrote (plain loads).
__device__ __forceinline__ float load(const float* src,
                                      const float* __restrict__ vals,
                                      int64_t i, bool premul) {
  return premul ? __fmul_rn(src[i], vals[i]) : src[i];
}

// A global phase: one stage over the whole plane (none: the copy), slots
// start, start + stride, ...
__device__ void global_stage(const Planes& a, const Program& P,
                             const Phase& f, const float* src, float* dst,
                             bool last, int64_t start, int64_t stride) {
  const int64_t n = a.n;
  if (f.count == 0) {
    for (int64_t p = start; p < n; p += stride)
      dst[p] = last ? finish(a, P, src[p], p) : src[p];
    return;
  }
  const Stage st = decode(a, P.code[f.first]);
  const int64_t d = int64_t(1) << st.k;
  for (int64_t p = start; p < n; p += stride) {
    const uint32_t g = (st.plane[p] >> st.bit) & 1u;
    float v;
    if (st.kind == kExchange) {
      v = load(src, a.vals, g ? (p ^ d) : p, st.premul);
    } else {
      const int64_t q = (p - d) & (n - 1);
      if (st.kind == kFill) {
        v = load(src, a.vals, g ? q : p, st.premul);
      } else {
        const float shifted = g ? load(src, a.vals, q, st.premul) : 0.0f;
        v = load(src, a.vals, p, st.premul) + shifted;
      }
    }
    dst[p] = last ? finish(a, P, v, p) : v;
  }
}

// An exchange stage on a j bit: slots j and j | M of the thread swap where
// their take bit is set (both read the stage's old values).
template <int M, int kJ>
__device__ __forceinline__ void swap_j(float (&v)[kJ],
                                       const uint32_t (&wd)[kJ], int bit,
                                       int J) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if ((j & M) || (j | M) >= J) continue;
    const float lo = v[j], hi = v[j | M];
    if ((wd[j] >> bit) & 1u) v[j] = hi;
    if ((wd[j | M] >> bit) & 1u) v[j | M] = lo;
  }
}

// For each window slot i in [lo, hi) of this thread (lo + tid, lo + tid +
// nt, ...): store(i, load(i)), eight slots at a time, their loads issued
// before their stores so that eight are in flight at once (a plain loop
// would wait out a load's latency per slot: the stores may alias them).
template <class Load, class Store>
__device__ __forceinline__ void batched(int lo, int hi, int tid, int nt,
                                        Load load, Store store) {
  for (int i0 = lo + tid; i0 < hi; i0 += 8 * nt) {
    decltype(load(0)) t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nt < hi) t[u] = load(i0 + u * nt);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * nt < hi) store(i0 + u * nt, t[u]);
  }
}

// A contiguous or strided phase on one tile. Shared memory: value buffers
// vb0, vb1 and the shift words ws, each 2^T + halo_max slots (window
// slot i < halo: the halo).
template <int kJ>
__device__ void tile_phase(const Planes& a, const Program& P, const Phase& f,
                           int64_t tile, const float* src, float* dst,
                           bool last, float* sm) {
  const int T = P.tile_log;
  const int L = P.log_n;
  const int H = f.halo;
  const int W = (1 << T) + H;
  const int stride = (1 << T) + P.halo_max;
  const bool whole = T == L;
  const bool strided = f.tiling == kStrided;
  const int nt = blockDim.x;
  const int J = (1 << T) / nt;  // at most kJ
  const int jb = __ffs(J) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t n = a.n;
  float* const vb0 = sm;
  float* const vb1 = sm + stride;
  uint32_t* ws = reinterpret_cast<uint32_t*>(sm + 2 * stride);
  // window slot i → plane slot (tile-local slot i − H), for the shift runs
  auto glob = [&](int i) -> int64_t {
    return ((tile << T) + i - H) & (n - 1);
  };
  // the thread's slot j: tile-local base + j·32; plane slot gb + j << gsh
  // (strided: the j bits are plane bits L−T+5..). Recomputed where used,
  // from 32-bit indices (the entry refuses n > 2^30), so that no 32
  // addresses stay live beside the 64 registers of values and words.
  const int base = lane | (tid >> 5) << (5 + jb);
  const int gsh = strided ? L - T + 5 : 5;
  int gb = strided ? (base >> 5) << gsh | (int)tile << 5 | lane
                   : ((int)tile << T) + base;
  float v[kJ];
  uint32_t wd[kJ];
  const uint32_t* wp = nullptr;   // the word plane in wd
  const uint32_t* wsp = nullptr;  // the word plane in ws
  int cur = 0;                    // the value buffer a shift run reads
  int xb = 0;                     // the buffer the next exchange writes
  bool regs = f.count == 0 ||
              ((P.code[f.first] >> 16) & 3) == kExchange;
  if (regs) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if (j < J) v[j] = src[gb + (j << gsh)];
  } else {
    batched(0, W, tid, nt, [&](int i) { return src[glob(i)]; },
            [&](int i, float x) { vb0[i] = x; });
    __syncthreads();
  }
  for (int s = f.first; s < f.first + f.count; ++s) {
    const Stage st = decode(a, P.code[s]);
    if (st.kind != kExchange) {
      if (regs) {  // only a whole-plane phase shifts after an exchange
        __syncthreads();  // an exchange stage's reads of vb0 are done
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if (j < J) vb0[base + (j << 5)] = v[j];
        cur = 0;
        regs = false;
        __syncthreads();
      }
      float* const c = cur ? vb1 : vb0;
      float* const o = cur ? vb0 : vb1;
      if (st.plane != wsp) {
        batched(0, W, tid, nt, [&](int i) { return st.plane[glob(i)]; },
                [&](int i, uint32_t w) { ws[i] = w; });
        wsp = st.plane;
      }
      if (st.premul)
        batched(0, W, tid, nt, [&](int i) { return a.vals[glob(i)]; },
                [&](int i, float m) { c[i] = __fmul_rn(c[i], m); });
      __syncthreads();
      const int d = 1 << st.k;
      const bool fill = st.kind == kFill;
      batched(0, W, tid, nt, [&](int i) {
        int q = i - d;
        if (q < 0 && whole) q += W;
        const bool take = ((ws[i] >> st.bit) & 1u) && q >= 0;
        return fill ? (take ? c[q] : c[i]) : c[i] + (take ? c[q] : 0.0f);
      }, [&](int i, float x) { o[i] = x; });
      __syncthreads();
      cur ^= 1;
      continue;
    }
    if (!regs) {
      const float* c = (cur ? vb1 : vb0) + H;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j < J) v[j] = c[base + (j << 5)];
      regs = true;
      xb = cur ^ 1;
      __syncthreads();  // before an exchange stage writes the buffers
    }
    if (st.premul || st.plane != wp) {
      asm volatile("" : "+r"(gb));  // keep the 32 indices out of registers
      if (st.premul) {
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if (j < J) v[j] = __fmul_rn(v[j], a.vals[gb + (j << gsh)]);
      }
      if (st.plane != wp) {
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          if (j < J) wd[j] = st.plane[gb + (j << gsh)];
        wp = st.plane;
      }
    }
    // the tile-local bit the stage flips
    const int lb = strided && st.k >= 5 ? st.k - L + T : st.k;
    if (lb < 5) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (j >= J) continue;
        const float o = __shfl_xor_sync(0xffffffffu, v[j], 1 << lb);
        if ((wd[j] >> st.bit) & 1u) v[j] = o;
      }
    } else if (lb < 5 + jb) {
      switch (lb - 5) {
        case 0: swap_j<1>(v, wd, st.bit, J); break;
        case 1: swap_j<2>(v, wd, st.bit, J); break;
        case 2: swap_j<4>(v, wd, st.bit, J); break;
        default: swap_j<(kJ > 8 ? 8 : 1)>(v, wd, st.bit, J); break;
      }
    } else {
      float* const x = (xb ? vb1 : vb0) + base;
      xb ^= 1;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j < J) x[j << 5] = v[j];
      __syncthreads();
      const float* const y = x - base + (base ^ (1 << lb));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j < J && ((wd[j] >> st.bit) & 1u)) v[j] = y[j << 5];
    }
  }
  asm volatile("" : "+r"(gb));
  if (regs) {
    if (last) {  // every load of vals and valid before the first store
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j < J) v[j] = finish(a, P, v[j], gb + (j << gsh));
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      if (j < J) dst[gb + (j << gsh)] = v[j];
  } else {
    const float* c = cur ? vb1 : vb0;
    batched(H, W, tid, nt, [&](int i) {
      return last ? finish(a, P, c[i], glob(i)) : c[i];
    }, [&](int i, float x) { dst[glob(i)] = x; });
  }
}

// Phase ph of the program, a block per tile (a thread per slot in a
// global phase): it reads x (ph = 0) or the buffer phase ph − 1 wrote, and
// writes buf[ph & 1], or out if it is the last.
template <int kJ>
__global__ void __launch_bounds__(kPhaseThreads)
    full_kernel(const Planes a, const __grid_constant__ Program P, int ph) {
  extern __shared__ float sm[];
  const Phase& f = P.phase[ph];
  const bool last = ph == P.n_phases - 1;
  const float* src = ph == 0 ? a.x : (ph & 1) ? a.buf0 : a.buf1;
  float* dst = last ? a.out : (ph & 1) ? a.buf1 : a.buf0;
  if (f.tiling == kGlobal)
    global_stage(a, P, f, src, dst, last,
                 (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                 (int64_t)gridDim.x * blockDim.x);
  else
    tile_phase<kJ>(a, P, f, blockIdx.x, src, dst, last, sm);
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* bfly_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// A program: codes[0, n_codes) in the phases of `phases` (4 ints a phase:
// first code, code count, tiling, halo), on tiles of 2^tile_log slots
// (tile_log <= 14, and >= 5 where a phase is tiled; 2^tile_log / 8
// threads a block, / 16 at 14, at least 32), one launch per phase. n is a
// power of two, <= 2^30. B10 passes every plane; a B9 wrapper only x, the
// buffers its phases need, out and the word plane its codes name, with
// vals and valid null and premul_final 0 (its codes carry no × vals). A
// code whose plane is null is refused.
int bfly_full(const void* x, void* buf0, void* buf1, const void* widen_b,
              const void* fill_words, const void* perm_b, const void* vals,
              const void* scan_guards, const void* compact_b,
              const void* valid, void* out, int64_t n, const uint32_t* codes,
              int n_codes, int premul_final, const int32_t* phases,
              int n_phases, int tile_log, void* stream) {
  int log_n = 0;
  while ((int64_t(1) << log_n) < n) ++log_n;
  if (n_codes < 0 || n_codes > kMaxCodes || n_phases < 1 ||
      n_phases > kMaxPhases || tile_log < 0 || tile_log > kMaxTileLog ||
      tile_log > log_n || (int64_t(1) << log_n) != n || log_n > 30)
    return (int)cudaErrorInvalidValue;
  Program P;
  P.n_codes = n_codes;
  P.premul_final = premul_final;
  P.n_phases = n_phases;
  P.log_n = log_n;
  P.tile_log = tile_log;
  P.halo_max = 0;
  const void* nets[] = {widen_b, perm_b, compact_b};
  for (int i = 0; i < n_codes; ++i) {
    const uint32_t c = codes[i];
    const int kind = (c >> 16) & 3, net = (c >> 18) & 3;
    const void* plane = kind == kExchange ? (net < 3 ? nets[net] : nullptr)
                        : kind == kFill   ? fill_words
                        : kind == kScan   ? scan_guards
                                          : nullptr;
    if (!plane || (((c >> 20) & 1) && !vals))
      return (int)cudaErrorInvalidValue;
    P.code[i] = c;
  }
  if (premul_final && !vals) return (int)cudaErrorInvalidValue;
  bool shifts = false;
  int covered = 0;
  for (int i = 0; i < n_phases; ++i) {
    Phase f = {phases[4 * i], phases[4 * i + 1], phases[4 * i + 2],
               phases[4 * i + 3]};
    // phases cover the codes in order; a global phase runs one stage or
    // none (the copy of a program without stages)
    if (f.first != covered || f.count < 0 || f.tiling < kContig ||
        f.tiling > kGlobal || f.halo < 0 || f.halo > kHaloMax ||
        (f.tiling == kGlobal && f.count > 1) ||
        (f.tiling != kGlobal && tile_log < 5) ||
        (f.tiling == kStrided && f.halo))
      return (int)cudaErrorInvalidValue;
    for (int c = f.first; c < f.first + f.count && f.tiling != kGlobal; ++c)
      shifts |= ((codes[c] >> 16) & 3) != kExchange;
    covered += f.count;
    if (f.halo > P.halo_max) P.halo_max = f.halo;
    P.phase[i] = f;
  }
  if (covered != n_codes) return (int)cudaErrorInvalidValue;
  // two value buffers, and the shift words where a tiled phase shifts
  const size_t smem =
      (shifts ? 3 : 2) * sizeof(float) * ((1 << tile_log) + P.halo_max);
  const int64_t n_tiles = n >> tile_log;
  // 8 slots a thread (16 at T = 14): 1024 threads a tile from T = 13
  const bool j16 = tile_log >= 14;
  const int threads = tile_log >= 8 ? (1 << tile_log) / (j16 ? 16 : 8) : 32;
  Planes a = {(const float*)x,          (float*)buf0,
              (float*)buf1,             (const uint32_t*)widen_b,
              (const uint32_t*)fill_words, (const uint32_t*)perm_b,
              (const float*)vals,       (const uint32_t*)scan_guards,
              (const uint32_t*)compact_b, (const float*)valid,
              (float*)out,              n};
  const void* kern = j16 ? (const void*)full_kernel<16>
                          : (const void*)full_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int ph = 0; ph < n_phases; ++ph) {
    const unsigned grid = P.phase[ph].tiling == kGlobal
                              ? blocks_for(n, threads)
                              : (unsigned)n_tiles;
    void* args[] = {&a, &P, &ph};
    err = cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, smem,
                           (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
