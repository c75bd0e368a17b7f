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
// `_sellw_stream_kernel` (SpMV: entry sellw_spmv, one column, NC = 1) and
// `_sellw_spmm_kernel` (SpMM: entry sellw_spmm, n_cols columns, NC = 4).
// One block per chunk of one stage class. The TPU kernels first copied each
// sublane's 128-wide x row into VMEM (or, for n > 2^20, streamed windows
// that XLA pre-gathered); here each thread reads its x element straight
// from device memory, so one kernel serves both program kinds and a
// stream_wins program moves 12 B/slot less. For SpMM the block keeps its
// slot's word, value and x row index in registers and runs the SpMV
// pipeline for NC columns of X at a time (column k's x at x + k * n_x: X
// transposed, so a sublane's 128 lanes read one 512-byte row), one shared
// buffer pair per column, so that the NC columns share each scan stage's
// barrier and their x loads are in flight together (two blocks of 1024
// threads fit an SM at 32 registers a thread); the TPU kernel re-ran
// the pipeline per column of a k-tile of 8 with word and vals resident in
// VMEM. Word and vals are read once for all columns, and stream_wins
// programs take the same kernel. Each column's arithmetic is the SpMV's,
// step for step (scan_pick's).
// Output: per column k, G planes at out + k * plane_stride, plane g at rows
// [g*npad, (g+1)*npad); row c of plane g is the sum over sublanes 0..7, in
// order, of the part ends whose bid is g.
// Bound: device memory. SpMV: 8 bytes per slot (word, value), x from L2
// (its rows are shared by neighbouring chunks), 512*G bytes written per
// chunk. SpMM: the same 8 bytes per slot once, then per column x and the
// 512*G bytes of planes per chunk, which dominate at K = 128.
template <int NC>
__global__ void __launch_bounds__(kChunk, 2)
    sellw_kernel(const uint32_t* __restrict__ word,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ wrow,
                 const float* __restrict__ x, int64_t n_x, int n_cols,
                 float* __restrict__ out, int64_t plane_stride, int64_t npad,
                 int64_t chunk0, int stages, int G) {
  __shared__ float buf[2][NC][kChunk];
  __shared__ int8_t tag[kChunk];
  const int t = threadIdx.x;
  const int row = t & ~(kLanes - 1);
  const int l = t & (kLanes - 1);
  const int64_t c = chunk0 + blockIdx.x;
  const int64_t off = c * kChunk + t;
  const uint32_t w = word[off];
  const float val = vals[off];
  const int64_t col =
      (int64_t)wrow[c * kSub + t / kLanes] * kLanes + (w & 0x7F);
  const int pick = row + ((w >> 14) & 0x7F);
  tag[t] = (w >> 21) & 1u ? (int8_t)((w >> 22) & (uint32_t)(G - 1))
                          : (int8_t)-1;
  for (int k0 = 0; k0 < n_cols; k0 += NC) {
    const int nc = min(NC, n_cols - k0);
    if (k0) __syncthreads();  // the last columns' sums have read E
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      // the x plane's zero padding past n_x, as scan_pick
      const float xv = q < nc && col < n_x ? x[(k0 + q) * n_x + col] : 0.0f;
      buf[0][q][t] = __fmul_rn(xv, val);
    }
    __syncthreads();
    int cur = 0;
    for (int k = 0; k < stages; ++k) {
      const bool guard = (w >> (7 + k)) & 1u;
      const int src = row + ((l - (1 << k)) & 127);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        float v = buf[cur][q][t];
        if (guard) v = v + buf[cur][q][src];
        buf[cur ^ 1][q][t] = v;
      }
      __syncthreads();
      cur ^= 1;
    }
    // the last stage's reads of buf[cur ^ 1] are done: E goes there, the
    // buffer the picks do not read
#pragma unroll
    for (int q = 0; q < NC; ++q) buf[cur ^ 1][q][t] = buf[cur][q][pick];
    __syncthreads();
    if (t < G * kLanes) {
      const int g = t / kLanes;
      for (int q = 0; q < nc; ++q) {
        const float* E = buf[cur ^ 1][q];
        float acc = 0.0f;
        for (int s = 0; s < kSub; ++s)
          acc = acc + (tag[s * kLanes + l] == g ? E[s * kLanes + l] : 0.0f);
        out[(k0 + q) * plane_stride + (g * npad + c) * kLanes + l] = acc;
      }
    }
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
// spmv_research_tpu/ops/sellw_ds.py `_sellwds_kernel`. SELLW's layout and
// routing (one block of 1024 threads per chunk of one stage class, thread
// (s, l), x read from device memory), with every value an (hi, lo) fp32
// pair:
//   1. the picks x hi[col] and x lo[col] of the slot;
//   2. p + e = TwoProd(vhi, x hi) (Dekker: p = vhi * x hi, e = ((ahi * bhi
//      - p) + ahi * blo + alo * bhi) + alo * blo), then e += vhi * x lo,
//      then e += vlo * x hi;
//   3. `stages` guarded stages of the segmented lane scan on the (s, e)
//      pair: t = s + rs; bb = t - s; err = (s - (t - bb)) + (rs - bb);
//      e = (e + re) + err; s = t, with (rs, re) the pair 2^k lanes back
//      where the slot's guard bit 7 + k is set, else 0. Each stage reads
//      the previous stage's whole row, so two shared buffers per plane
//      ping-pong (16 KiB a block);
//   4. the pick of the (s, e) pair at eidx;
//   5. for each of the G y blocks of the chunk's group, a sequential TwoSum
//      fold over sublanes 0..7 of the picks whose live bit (21) is set and
//      whose bid (bits 22 and up) is that block's.
// Output: plane g of out_s and out_e at rows [g*npad, (g+1)*npad), as
// sellw_kernel's. Each chunk is computed on its own: the TPU kernel's grid
// steps shared nothing but the resident x planes. The arithmetic is the
// JAX kernel's step for step, in its order, so the plain PyTorch version
// (every operation rounded on its own) gives the same bits.
// Bound: device memory, 12 bytes per slot read (word, vhi, vlo), x hi and
// lo from L2, 2 * 512 * G bytes written per chunk.
__global__ void __launch_bounds__(kChunk)
    sellwds_kernel(const uint32_t* __restrict__ word,
                   const float* __restrict__ vhi,
                   const float* __restrict__ vlo,
                   const int32_t* __restrict__ wrow,
                   const float* __restrict__ xh,
                   const float* __restrict__ xl, int64_t n_x,
                   float* __restrict__ out_s, float* __restrict__ out_e,
                   int64_t npad, int64_t chunk0, int stages, int G) {
  __shared__ float bs[2][kChunk];
  __shared__ float be[2][kChunk];
  __shared__ int8_t tag[kChunk];
  const int t = threadIdx.x;
  const int row = t & ~(kLanes - 1);
  const int l = t & (kLanes - 1);
  const int64_t c = chunk0 + blockIdx.x;
  const int64_t off = c * kChunk + t;
  const uint32_t w = word[off];
  const float a = vhi[off];
  const float b = vlo[off];
  const int64_t col =
      (int64_t)wrow[c * kSub + t / kLanes] * kLanes + (w & 0x7F);
  // the x planes' zero padding past n_x
  const float gh = col < n_x ? xh[col] : 0.0f;
  const float gl = col < n_x ? xl[col] : 0.0f;
  const float p = __fmul_rn(a, gh);
  float ahi, alo, bhi, blo;
  split32(a, ahi, alo);
  split32(gh, bhi, blo);
  float e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p),
                          __fmul_rn(ahi, blo)),
                __fmul_rn(alo, bhi)),
      __fmul_rn(alo, blo));
  e = __fadd_rn(__fadd_rn(e, __fmul_rn(a, gl)), __fmul_rn(b, gh));
  bs[0][t] = p;
  be[0][t] = e;
  tag[t] = (w >> 21) & 1u ? (int8_t)((w >> 22) & (uint32_t)(G - 1))
                          : (int8_t)-1;
  __syncthreads();
  int cur = 0;
  for (int k = 0; k < stages; ++k) {
    const bool guard = (w >> (7 + k)) & 1u;
    const int src = row + ((l - (1 << k)) & 127);
    const float s0 = bs[cur][t];
    const float rs = guard ? bs[cur][src] : 0.0f;
    const float re = guard ? be[cur][src] : 0.0f;
    const float s1 = __fadd_rn(s0, rs);
    const float bb = __fsub_rn(s1, s0);
    const float err =
        __fadd_rn(__fsub_rn(s0, __fsub_rn(s1, bb)), __fsub_rn(rs, bb));
    be[cur ^ 1][t] = __fadd_rn(__fadd_rn(be[cur][t], re), err);
    bs[cur ^ 1][t] = s1;
    __syncthreads();
    cur ^= 1;
  }
  // the picks go to the buffers the last stage did not write
  const int pick = row + ((w >> 14) & 0x7F);
  bs[cur ^ 1][t] = bs[cur][pick];
  be[cur ^ 1][t] = be[cur][pick];
  __syncthreads();
  if (t < G * kLanes) {
    const int g = t / kLanes;
    const float* Es = bs[cur ^ 1];
    const float* Ee = be[cur ^ 1];
    float S = 0.0f, E = 0.0f;
    for (int si = 0; si < kSub; ++si) {
      const bool m = tag[si * kLanes + l] == g;
      float s1, e1;
      two_sum(S, m ? Es[si * kLanes + l] : 0.0f, s1, e1);
      S = s1;
      E = __fadd_rn(__fadd_rn(E, e1), m ? Ee[si * kLanes + l] : 0.0f);
    }
    out_s[(g * npad + c) * kLanes + l] = S;
    out_e[(g * npad + c) * kLanes + l] = E;
  }
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
  sellw_kernel<1><<<(unsigned)n_chunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)wrow,
      (const float*)x, n_x, 1, (float*)out, 0, npad, chunk0, stages, G);
  return (int)cudaGetLastError();
}

// As sellw_spmv for the n_cols columns of xt (n_cols, n_x); column k's G
// planes start at out + k * plane_stride.
int sellw_spmm(const void* word, const void* vals, const void* wrow,
               const void* xt, int64_t n_x, int n_cols, void* out,
               int64_t plane_stride, int64_t npad, int64_t chunk0,
               int64_t n_chunks, int stages, int G, void* stream) {
  sellw_kernel<4><<<(unsigned)n_chunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vals, (const int32_t*)wrow,
      (const float*)xt, n_x, n_cols, (float*)out, plane_stride, npad, chunk0,
      stages, G);
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

// Chunks [chunk0, chunk0 + n_chunks) of one stage class; out_s and out_e
// hold G planes of npad rows each.
int sellwds_spmv(const void* word, const void* vhi, const void* vlo,
                 const void* wrow, const void* xh, const void* xl,
                 int64_t n_x, void* out_s, void* out_e, int64_t npad,
                 int64_t chunk0, int64_t n_chunks, int stages, int G,
                 void* stream) {
  sellwds_kernel<<<(unsigned)n_chunks, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (const float*)vhi, (const float*)vlo,
      (const int32_t*)wrow, (const float*)xh, (const float*)xl, n_x,
      (float*)out_s, (float*)out_e, npad, chunk0, stages, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
