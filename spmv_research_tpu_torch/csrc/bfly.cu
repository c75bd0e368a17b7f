// Hand-written Hopper (sm_90a) kernels of the BFLY routed-butterfly SpMV
// engine: one exchange stage, one fill stage and one scan stage per launch
// (B9), and the whole routing program in one persistent cooperative launch
// (B10).
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
// wraps). Every stage reads the previous stage's whole plane, so the
// stages ping-pong two buffers. At N = 2^20 a plane is 4 MB and both stay
// in the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCodes = 256;

// B10's stage codes: bits [0,5) k, [5,10) b, [10,16) w, [16,18) kind,
// [18,20) network (exchange stages), bit 20: multiply each value this stage
// reads by vals first (the first stage after the perm network; × vals was
// its own XLA pass in JAX).
enum Kind { kExchange = 0, kFill = 1, kScan = 2 };
enum Net { kWiden = 0, kPerm = 1, kCompact = 2 };

struct Program {
  int n_codes;
  int premul_final;        // the final × valid pass reads × vals too
  uint32_t code[kMaxCodes];
};

// B9 `bfly_xor_net`, one stage — replaces spmv_research_tpu/ops/
// bfly_pallas.py `_xor_net_kernel` (which ran all of a network's stages in
// VMEM; here each stage is one launch over the flat plane). Bound: device
// memory, 12 bytes per slot (value, word, out); the partner read hits the
// same or a neighbouring line for 2^k < 32 and L2 otherwise.
__global__ void xor_stage_kernel(const float* __restrict__ src,
                                 float* __restrict__ dst,
                                 const uint32_t* __restrict__ plane, int b,
                                 int k, int64_t n) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t bit = (plane[p] >> b) & 1u;
  dst[p] = bit ? src[p ^ (int64_t(1) << k)] : src[p];
}

// B9 `bfly_fill` / `bfly_scan`, one stage — replace bfly_pallas.py
// `_fill_kernel` (kSelect) and `_scan_kernel`, whose `_flat_shift` built
// v[p - 2^k] from rolls. The select is exact; the add is one fp32 add per
// slot, in the plain version's order. Bound: device memory, 12 bytes per
// slot.
template <bool kSelect>
__global__ void shift_stage_kernel(const float* __restrict__ src,
                                   float* __restrict__ dst,
                                   const uint32_t* __restrict__ words, int k,
                                   int64_t n) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t g = (words[p] >> k) & 1u;
  const int64_t q = (p - (int64_t(1) << k)) & (n - 1);
  if (kSelect) {
    dst[p] = g ? src[q] : src[p];
  } else {
    const float shifted = g ? src[q] : 0.0f;
    dst[p] = src[p] + shifted;
  }
}

// The ping-pong buffers are written during B10, so they are read through
// plain loads (not the read-only path): grid.sync() makes one stage's
// writes visible to the next stage's reads in every block.
__device__ __forceinline__ float load(const float* src,
                                      const float* __restrict__ vals,
                                      int64_t i, bool premul) {
  return premul ? __fmul_rn(src[i], vals[i]) : src[i];
}

// B10 `bfly_full` — replaces bfly_pallas.py `_full_kernel`: the whole
// program (widen, fill, perm, × vals, scan, compact, × valid) in one
// launch. Stages whose partner lies in another block need a grid-wide
// barrier, so this is a persistent cooperative kernel: a grid of as many
// blocks as are co-resident, grid-stride loops over the slots, and
// grid.sync() after every stage. × vals is folded into the reads of the
// stage after the perm network and × valid into the last pass, both as
// __fmul_rn (never contracted into an FMA), so the result equals B9's
// chain and the plain version bit for bit. Bound: device memory, each
// plane read once by the program (the stages' re-reads of the 4 MB value
// plane hit L2).
__global__ void __launch_bounds__(kThreads)
    full_kernel(const float* x, float* buf0, float* buf1,
                const uint32_t* __restrict__ widen_b,
                const uint32_t* __restrict__ fill_words,
                const uint32_t* __restrict__ perm_b,
                const float* __restrict__ vals,
                const uint32_t* __restrict__ scan_guards,
                const uint32_t* __restrict__ compact_b,
                const float* __restrict__ valid, float* out, int64_t n,
                Program prog) {
  cg::grid_group grid = cg::this_grid();
  const int64_t start = (int64_t)grid.thread_rank();
  const int64_t stride = (int64_t)grid.num_threads();
  const float* src = x;
  float* dst = buf0;
  for (int s = 0; s < prog.n_codes; ++s) {
    const uint32_t c = prog.code[s];
    const int k = c & 31;
    const int b = (c >> 5) & 31;
    const int w = (c >> 10) & 63;
    const int kind = (c >> 16) & 3;
    const int net = (c >> 18) & 3;
    const bool pm = (c >> 20) & 1;
    const int64_t d = int64_t(1) << k;
    if (kind == kExchange) {
      const uint32_t* plane =
          (net == kWiden ? widen_b : net == kPerm ? perm_b : compact_b) +
          (int64_t)w * n;
      for (int64_t p = start; p < n; p += stride) {
        const uint32_t bit = (plane[p] >> b) & 1u;
        dst[p] = load(src, vals, bit ? (p ^ d) : p, pm);
      }
    } else {
      const uint32_t* words = kind == kFill ? fill_words : scan_guards;
      for (int64_t p = start; p < n; p += stride) {
        const uint32_t g = (words[p] >> k) & 1u;
        const int64_t q = (p - d) & (n - 1);
        if (kind == kFill) {
          dst[p] = load(src, vals, g ? q : p, pm);
        } else {
          const float shifted = g ? load(src, vals, q, pm) : 0.0f;
          dst[p] = load(src, vals, p, pm) + shifted;
        }
      }
    }
    grid.sync();
    src = dst;
    dst = dst == buf0 ? buf1 : buf0;
  }
  for (int64_t p = start; p < n; p += stride)
    out[p] = __fmul_rn(load(src, vals, p, prog.premul_final != 0), valid[p]);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* bfly_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// plane: the word plane of the stage (B + w*n), n a power of two.
int bfly_xor_stage(const void* src, void* dst, const void* plane, int b,
                   int k, int64_t n, void* stream) {
  xor_stage_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, (const uint32_t*)plane, b, k, n);
  return (int)cudaGetLastError();
}

// select != 0: a fill stage; else a scan stage. n a power of two.
int bfly_shift_stage(const void* src, void* dst, const void* words, int k,
                     int64_t n, int select, void* stream) {
  if (select)
    shift_stage_kernel<true><<<blocks_for(n), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)src, (float*)dst, (const uint32_t*)words, k, n);
  else
    shift_stage_kernel<false><<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)src, (float*)dst, (const uint32_t*)words, k, n);
  return (int)cudaGetLastError();
}

// The whole program: codes[0, n_codes) as full_kernel decodes them. The
// grid is the co-resident maximum (occupancy × SMs, at most one thread per
// slot); a grid that cannot be co-resident is refused by the launch, and
// its error is returned.
int bfly_full(const void* x, void* buf0, void* buf1, const void* widen_b,
              const void* fill_words, const void* perm_b, const void* vals,
              const void* scan_guards, const void* compact_b,
              const void* valid, void* out, int64_t n, const uint32_t* codes,
              int n_codes, int premul_final, void* stream) {
  if (n_codes < 0 || n_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  Program prog;
  prog.n_codes = n_codes;
  prog.premul_final = premul_final;
  for (int i = 0; i < n_codes; ++i) prog.code[i] = codes[i];
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, full_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = (unsigned)(per_sm * sms);
  if (grid > blocks_for(n)) grid = blocks_for(n);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  const float* xp = (const float*)x;
  float* b0 = (float*)buf0;
  float* b1 = (float*)buf1;
  const uint32_t* wb = (const uint32_t*)widen_b;
  const uint32_t* fw = (const uint32_t*)fill_words;
  const uint32_t* pb = (const uint32_t*)perm_b;
  const float* vl = (const float*)vals;
  const uint32_t* sg = (const uint32_t*)scan_guards;
  const uint32_t* cb = (const uint32_t*)compact_b;
  const float* vd = (const float*)valid;
  float* op = (float*)out;
  void* args[] = {&xp, &b0, &b1, &wb, &fw, &pb, &vl, &sg, &cb, &vd, &op,
                  &n, &prog};
  err = cudaLaunchCooperativeKernel((const void*)full_kernel, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
