// Hand-written Hopper (sm_90a) kernels of the column-locality engines,
// SELLW and SELLR.
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
// Both kernels run one block of 1024 threads per chunk, thread (s, l). The
// product is rounded before any add (__fmul_rn: nvcc would otherwise
// contract it with the first scan add into an fma, which the TPU kernels do
// not), the scan stages ping-pong two shared buffers (each stage reads the
// previous stage's whole row), and every sum runs in a fixed order, so the
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

// Shared steps of both kernels for thread (s, l) of one chunk: the gathered
// product x2d[wrow, lane] * val, `stages` guarded Hillis-Steele stages of
// the segmented lane scan, then the pick of the part end at eidx. Returns
// the pick; buf[2][1024] is the block's scratch.
__device__ __forceinline__ float scan_pick(uint32_t w, float val, int32_t wr,
                                           const float* __restrict__ x,
                                           int64_t n_x, int stages,
                                           float (*buf)[kChunk]) {
  const int t = threadIdx.x;
  const int row = t & ~(kLanes - 1);
  const int l = t & (kLanes - 1);
  const int64_t col = (int64_t)wr * kLanes + (w & 0x7F);
  const float xv = col < n_x ? x[col] : 0.0f;  // the x plane's zero padding
  int cur = 0;
  buf[0][t] = __fmul_rn(xv, val);
  __syncthreads();
  for (int k = 0; k < stages; ++k) {
    float v = buf[cur][t];
    if ((w >> (7 + k)) & 1u) v = v + buf[cur][row + ((l - (1 << k)) & 127)];
    buf[cur ^ 1][t] = v;
    __syncthreads();
    cur ^= 1;
  }
  return buf[cur][row + ((w >> 14) & 0x7F)];
}

// SELLW — replaces spmv_research_tpu/ops/sellw.py `_sellw_kernel` and
// `_sellw_stream_kernel`. One block per chunk of one stage class. The TPU
// kernels first copied each sublane's 128-wide x row into VMEM (or, for
// n > 2^20, streamed windows that XLA pre-gathered); here each thread reads
// its x element straight from device memory, so one kernel serves both
// program kinds and a stream_wins program moves 12 B/slot less.
// Output: G planes, plane g at rows [g*npad, (g+1)*npad); row c of plane g
// is the sum over sublanes 0..7, in order, of the part ends whose bid is g.
// Bound: device memory, 8 bytes per slot (word, value), x from L2 (its rows
// are shared by neighbouring chunks), 512*G bytes written per chunk.
__global__ void __launch_bounds__(kChunk)
    sellw_kernel(const uint32_t* __restrict__ word,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ wrow,
                 const float* __restrict__ x, int64_t n_x,
                 float* __restrict__ out, int64_t npad, int64_t chunk0,
                 int stages, int G) {
  __shared__ float buf[2][kChunk];
  __shared__ int8_t tag[kChunk];
  const int t = threadIdx.x;
  const int64_t c = chunk0 + blockIdx.x;
  const int64_t off = c * kChunk + t;
  const uint32_t w = word[off];
  const float e = scan_pick(w, vals[off], wrow[c * kSub + t / kLanes], x,
                            n_x, stages, buf);
  // the last scan stage's reads are done: buf[1] is free for E when stages
  // is even (cur = 0), buf[0] when it is odd; write E to the buffer the
  // pick did not read
  float* E = buf[(stages & 1) ^ 1];
  const bool live = (w >> 21) & 1u;
  E[t] = e;
  tag[t] = live ? (int8_t)((w >> 22) & (uint32_t)(G - 1)) : (int8_t)-1;
  __syncthreads();
  if (t < G * kLanes) {
    const int g = t / kLanes;
    const int l = t % kLanes;
    float acc = 0.0f;
    for (int s = 0; s < kSub; ++s)
      acc = acc + (tag[s * kLanes + l] == g ? E[s * kLanes + l] : 0.0f);
    out[(g * npad + c) * kLanes + l] = acc;
  }
}

// SELLR kernel 1 (entry sellr_place) — with kernel 2, replaces
// spmv_research_tpu/ops/sellr.py `_sellr_kernel`. One block per live chunk
// computes the chunk's placed
// plane R (8 x 128): the part sums P = (emask ? pick : 0), each moved from
// its sublane s to its target sublane (s + r) mod 8 of the same chunk. Per
// target cell the sources are added in the order of the JAX kernel's roll
// set, sorted by r: R = P[t] where (r, wrap) = (0, 0), then + P[(t - r) mod
// 8] for r = 1..7 where that source's code is (r, wrap). The scan runs only
// the stages the chunk's step needs (smeta's smax; the rest are no-ops).
// Bound: device memory, 8 bytes per slot read and 4 written (R).
__global__ void __launch_bounds__(kChunk)
    sellr_place_kernel(const uint32_t* __restrict__ word,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ smeta,
                       const float* __restrict__ x, int64_t n_x,
                       float* __restrict__ R, int stages) {
  __shared__ float buf[2][kChunk];
  __shared__ int8_t code[kChunk];
  const int t = threadIdx.x;
  const int s = t / kLanes;
  const int l = t % kLanes;
  const int64_t c = blockIdx.x;
  const int32_t* sm = smeta + (c / kNB) * kSmemBlk;
  const int nst = min(stages, (int)sm[kNB * kSub + kNB + 1]);
  const int64_t off = c * kChunk + t;
  const uint32_t w = word[off];
  const float e = scan_pick(w, vals[off], sm[(c % kNB) * kSub + s], x, n_x,
                            nst, buf);
  float* P = buf[(nst & 1) ^ 1];
  const bool live = (w >> 21) & 1u;
  P[t] = live ? e : 0.0f;
  code[t] = live ? (int8_t)((w >> 22) & 0xF) : (int8_t)-1;
  __syncthreads();
  float acc = code[t] == 0 ? P[t] : 0.0f;
  for (int r = 1; r < kSub; ++r) {
    const int src = (s - r) & (kSub - 1);
    const int want = r | ((src + r >= kSub) << 3);
    if (code[src * kLanes + l] == want) acc = acc + P[src * kLanes + l];
  }
  R[off] = acc;
}

// SELLR kernel 2 (entry sellr_flush): the run-flush. On the TPU the chunks ran in order with
// one run accumulator (acc += R_c; on a flush chunk y[group] += acc and
// acc = 0) and y resident in VMEM. Here one block per y group (8 x 128
// cells) replays its chunks in that order from the host-made list (gptr,
// gchunk = chunk<<1 | flush), so no two blocks write one cell: no atomics,
// deterministic, the TPU kernel's sums. Bound: reading R once (4 B/slot).
__global__ void __launch_bounds__(kChunk)
    sellr_flush_kernel(const float* __restrict__ R,
                       const int32_t* __restrict__ gptr,
                       const int32_t* __restrict__ gchunk,
                       float* __restrict__ y) {
  const int t = threadIdx.x;
  const int g = blockIdx.x;
  float yv = 0.0f, acc = 0.0f;
  for (int i = gptr[g]; i < gptr[g + 1]; ++i) {
    const int32_t e = gchunk[i];
    acc = acc + R[(int64_t)(e >> 1) * kChunk + t];
    if (e & 1) {
      yv = yv + acc;
      acc = 0.0f;
    }
  }
  y[(int64_t)g * kChunk + t] = yv;
}

}  // namespace

extern "C" {

const char* sell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Chunks [chunk0, chunk0 + n_chunks) of one stage class; out holds G planes
// of npad rows each.
int sellw_spmv(const void* word, const void* vals, const void* wrow,
               const void* x, int64_t n_x, void* out, int64_t npad,
               int64_t chunk0, int64_t n_chunks, int stages, int G,
               void* stream) {
  sellw_kernel<<<(unsigned)n_chunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)wrow,
      (const float*)x, n_x, (float*)out, npad, chunk0, stages, G);
  return (int)cudaGetLastError();
}

// R: (n_chunks * 1024,), the placed planes of the n_chunks > 0 live chunks.
int sellr_place(const void* word, const void* vals, const void* smeta,
                const void* x, int64_t n_x, void* R, int64_t n_chunks,
                int stages, void* stream) {
  sellr_place_kernel<<<(unsigned)n_chunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)smeta,
      (const float*)x, n_x, (float*)R, stages);
  return (int)cudaGetLastError();
}

// y: (n_groups * 1024,), n_groups > 0, from R and the listed run order.
int sellr_flush(const void* R, const void* gptr, const void* gchunk, void* y,
                int n_groups, void* stream) {
  sellr_flush_kernel<<<(unsigned)n_groups, kChunk, 0, (cudaStream_t)stream>>>(
      (const float*)R, (const int32_t*)gptr, (const int32_t*)gchunk,
      (float*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
