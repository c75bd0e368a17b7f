// Hand-written Hopper (sm_90a) kernels of the BTILE engine: SpMM and SDDMM
// over dense (8, 128) tiles of a sparse matrix.
//
// Built by spmv_research_tpu_torch/ops/btile_cuda.py (through cuda_lib.py)
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry point launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// The program (ops/btile.py): step s holds up to tg tiles of one row band
// g = step_g[s] (1024 rows) and one column block cb = step_cb[s] (128
// columns), as R = 8 * tg slab rows of 128 floats; its first 8 * step_nt[s]
// rows are live, and slab row r lands in band row tgt[s][r]. Steps are
// sorted band-major; band g's steps are [band_ptr[g], band_ptr[g + 1]).
//
// Both kernels multiply in full float32 (FFMA, no TF32): the TPU kernels
// ran their products at Precision.HIGHEST.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 128;   // columns of a tile (one column block)
constexpr int kBand = 1024;   // rows of a band
constexpr int kRows = 256;    // slab rows of a full step (tg = 32), threads
constexpr int kKS = 64;       // columns of X (and Y) per SpMM block

// SpMM — replaces spmv_research_tpu/ops/btile.py `_btile_spmm_kernel`.
// The TPU kernel kept the band's Y block in VMEM and ran the band's steps
// one after another on one core, placing each step's product
// P = tiles @ X[cb] with a one-hot matmul. Here a band's steps are cut into
// `nchunk` chunks of at most `ch` consecutive steps, and one block of 256
// threads owns one (band, chunk, 64-column slice of X) triple: it zeroes its
// own 1024 x 64 partial band, walks its steps in order, and adds each
// step's P into it (placement is a plain add into row tgt[s][r]). No two
// blocks write one element: no atomics. When a band has more than one
// chunk, btile_combine_kernel then sums its chunks' partials in chunk
// order (a second launch, counted as btile_combine), so the result is
// deterministic. Only the step's live tiles are read; a band with only the
// builder's empty filler step comes out as zeros.
// The product is a register-tiled SGEMM: thread (ty, tx) = (t / 8, t % 8)
// holds P's rows 8ty..8ty+7 at columns 4tx..4tx+3 and 32+4tx..32+4tx+3 (64
// FFMA chains); the step's X slice (128 x 64) sits in shared memory, and
// the tile rows pass through shared memory 16 columns at a time,
// transposed and swizzled (row r of column c at r ^ (c / 4 % 4) * 8), so
// that both the staging stores and the float4 reads are free of bank
// conflicts; the next 16 columns are loaded into registers while the
// current ones are multiplied. Each element of P sums its 128 products in
// column order 0..127.
// Bound: the function needs 2 * K operations per nnz, so its floor is the
// bytes it must move (the slab and the pattern's steps once, X once, Y
// once). The kernel does more: it multiplies every live tile slot, stored
// zeros included (2 * 1024 * K FFMA-operations per live tile), and so runs
// at the card's FFMA rate over slots, not at its memory rate; it issues 4
// shared float4 loads per 64 FFMA. The chunks give the card enough blocks
// (a band alone is too little work for the SMs).
constexpr int kKC = 16;  // tile columns per staged pass

__device__ __forceinline__ int swz(int r, int c) {
  return r ^ (((c >> 2) & 3) << 3);
}

__global__ void __launch_bounds__(kRows, 2)
    btile_spmm_kernel(const float* __restrict__ tiles,
                      const int32_t* __restrict__ tgt,
                      const int32_t* __restrict__ step_cb,
                      const int32_t* __restrict__ step_nt,
                      const int32_t* __restrict__ band_ptr,
                      const float* __restrict__ xp, float* __restrict__ out,
                      int nchunk, int ch, int rows_per_step, int kp) {
  __shared__ __align__(16) float xs[kTileC][kKS];  // 32 KB
  __shared__ __align__(16) float ts[kKC][kRows];   // 16 KB
  const int t = threadIdx.x;
  const int ty = t >> 3, tx = t & 7;
  const int g = blockIdx.x / nchunk;
  const int j = blockIdx.x % nchunk;
  const int s0 = band_ptr[g] + j * ch;
  const int s1 = min(s0 + ch, band_ptr[g + 1]);
  if (s0 >= s1) return;  // past the band's last chunk: not combined
  const int k0 = blockIdx.y * kKS;
  float* yb = out + (int64_t)blockIdx.x * kBand * kp + k0;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = t; i < kBand * kKS / 4; i += kRows)
    *reinterpret_cast<float4*>(yb + (int64_t)(i / (kKS / 4)) * kp +
                               4 * (i % (kKS / 4))) = zero4;
  // staging: thread t moves the float4 (row (t / 4) + 64q, columns
  // 4 (t % 4) .. + 3) of each pass, q = 0..3
  const int lr = t >> 2, lc = 4 * (t & 3);
  for (int s = s0; s < s1; ++s) {
    const int R = step_nt[s] * 8;
    if (R == 0) continue;  // the filler step of an empty band
    const int64_t cb = step_cb[s];
    const float* src = tiles + (int64_t)s * rows_per_step * kTileC;
    float4 pre[4];
    auto load_pass = [&](int jc) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lr + 64 * q;
        pre[q] = r < R ? *reinterpret_cast<const float4*>(
                             src + (int64_t)r * kTileC + jc + lc)
                       : zero4;
      }
    };
    load_pass(0);
    __syncthreads();  // the last step's reads of xs are done
    for (int i = t; i < kTileC * kKS / 4; i += kRows) {
      const int r = i / (kKS / 4), c = 4 * (i % (kKS / 4));
      *reinterpret_cast<float4*>(&xs[r][c]) = *reinterpret_cast<const float4*>(
          xp + (cb * kTileC + r) * kp + k0 + c);
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.0f;
    for (int jc = 0; jc < kTileC; jc += kKC) {
      __syncthreads();  // the last pass's reads of ts are done
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = lr + 64 * q;
        ts[lc + 0][swz(r, lc + 0)] = pre[q].x;
        ts[lc + 1][swz(r, lc + 1)] = pre[q].y;
        ts[lc + 2][swz(r, lc + 2)] = pre[q].z;
        ts[lc + 3][swz(r, lc + 3)] = pre[q].w;
      }
      __syncthreads();
      if (jc + kKC < kTileC) load_pass(jc + kKC);
      if (8 * ty < R) {
#pragma unroll
        for (int c = 0; c < kKC; ++c) {
          const float* tc = &ts[c][swz(8 * ty, c)];
          const float4 a0 = *reinterpret_cast<const float4*>(tc);
          const float4 a1 = *reinterpret_cast<const float4*>(tc + 4);
          const float4 x0 =
              *reinterpret_cast<const float4*>(&xs[jc + c][4 * tx]);
          const float4 x1 =
              *reinterpret_cast<const float4*>(&xs[jc + c][32 + 4 * tx]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(a[i], x[k], acc[i][k]);
        }
      }
    }
    if (8 * ty < R) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* yr =
            yb + (int64_t)tgt[(int64_t)s * rows_per_step + 8 * ty + i] * kp;
        float4* y0 = reinterpret_cast<float4*>(yr + 4 * tx);
        float4* y1 = reinterpret_cast<float4*>(yr + 32 + 4 * tx);
        float4 v0 = *y0, v1 = *y1;
        v0.x += acc[i][0]; v0.y += acc[i][1]; v0.z += acc[i][2]; v0.w += acc[i][3];
        v1.x += acc[i][4]; v1.y += acc[i][5]; v1.z += acc[i][6]; v1.w += acc[i][7];
        *y0 = v0;
        *y1 = v1;
      }
    }
  }
}

// Y[g] = the sum of band g's chunk partials, in chunk order (only the
// chunks that hold steps: ceil(steps of g / ch)).
__global__ void btile_combine_kernel(const float* __restrict__ part,
                                     const int32_t* __restrict__ band_ptr,
                                     float* __restrict__ y, int ngroups,
                                     int nchunk, int ch, int kp) {
  const int64_t band_elems = (int64_t)kBand * kp;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ngroups * band_elems) return;
  const int g = (int)(i / band_elems);
  const int64_t e = i % band_elems;
  const int n = (band_ptr[g + 1] - band_ptr[g] + ch - 1) / ch;
  const float* p = part + (int64_t)g * nchunk * band_elems + e;
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc = acc + p[j * band_elems];
  y[i] = acc;
}

// SDDMM — replaces spmv_research_tpu/ops/btile.py `_btile_sddmm_kernel`.
// One block per step (steps are independent), one warp per slab row r:
// the warp holds A's row g * 1024 + tgt[s][r] in registers (lane l holds
// elements l, l + 32, ...; read directly, where the TPU kernel gathered the
// band's rows with a one-hot matmul), finds the row's pattern bits 32
// columns at a time with a ballot, and for each set column c takes the dot
// product with B's row cb * 128 + c: per-lane FFMA over the lane's
// elements, then a butterfly of shuffles, so every slot's sum runs in one
// fixed order. Masked slots and rows past the step's live tiles are written
// as 0 without a product. KW = ceil(K / 32) registers per lane.
// Bound: the bytes it must move (the slab written once, the pattern read
// once, A and B once); the pattern's dots are 2 * K operations per nnz.
template <int KW>
__global__ void __launch_bounds__(256)
    btile_sddmm_kernel(const int8_t* __restrict__ patt,
                       const int32_t* __restrict__ tgt,
                       const int32_t* __restrict__ step_g,
                       const int32_t* __restrict__ step_cb,
                       const int32_t* __restrict__ step_nt,
                       const float* __restrict__ ap,
                       const float* __restrict__ bp, float* __restrict__ out,
                       int rows_per_step, int K) {
  const int64_t s = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int R = step_nt[s] * 8;
  const int64_t base = s * rows_per_step;
  const float* bb = bp + (int64_t)step_cb[s] * kTileC * K;
  for (int r = warp; r < rows_per_step; r += 8) {
    float* orow = out + (base + r) * kTileC;
    if (r >= R) {
#pragma unroll
      for (int j = 0; j < kTileC / 32; ++j) orow[32 * j + lane] = 0.0f;
      continue;
    }
    const float* arow =
        ap + ((int64_t)step_g[s] * kBand + tgt[base + r]) * K;
    float a[KW];
#pragma unroll
    for (int i = 0; i < KW; ++i)
      a[i] = 32 * i + lane < K ? arow[32 * i + lane] : 0.0f;
    const int8_t* prow = patt + (base + r) * kTileC;
#pragma unroll
    for (int j = 0; j < kTileC / 32; ++j) {
      unsigned m = __ballot_sync(0xffffffffu, prow[32 * j + lane] != 0);
      float mine = 0.0f;
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const float* brow = bb + (int64_t)(32 * j + b) * K;
        float p = 0.0f;
#pragma unroll
        for (int i = 0; i < KW; ++i)
          if (32 * i + lane < K) p = fmaf(a[i], brow[32 * i + lane], p);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == b) mine = p;
      }
      orow[32 * j + lane] = mine;
    }
  }
}

template <int KW>
void launch_sddmm(int64_t nsteps, cudaStream_t st, const int8_t* patt,
                  const int32_t* tgt, const int32_t* step_g,
                  const int32_t* step_cb, const int32_t* step_nt,
                  const float* ap, const float* bp, float* out,
                  int rows_per_step, int K) {
  btile_sddmm_kernel<KW><<<(unsigned)nsteps, 256, 0, st>>>(
      patt, tgt, step_g, step_cb, step_nt, ap, bp, out, rows_per_step, K);
}

}  // namespace

extern "C" {

const char* btile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// With nchunk = 1, out is y (ngroups * 1024, kp), kp a multiple of 64; with
// nchunk > 1 chunks of ch steps per band, out holds the chunk partials
// (ngroups * nchunk * 1024, kp) for btile_combine. xp: (ncb * 128, kp).
int btile_spmm(const void* tiles, const void* tgt, const void* step_cb,
               const void* step_nt, const void* band_ptr, const void* xp,
               void* out, int ngroups, int nchunk, int ch, int rows_per_step,
               int kp, void* stream) {
  if (rows_per_step > kRows || kp % kKS || nchunk < 1 || ch < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(ngroups * nchunk), (unsigned)(kp / kKS));
  btile_spmm_kernel<<<grid, kRows, 0, (cudaStream_t)stream>>>(
      (const float*)tiles, (const int32_t*)tgt, (const int32_t*)step_cb,
      (const int32_t*)step_nt, (const int32_t*)band_ptr, (const float*)xp,
      (float*)out, nchunk, ch, rows_per_step, kp);
  return (int)cudaGetLastError();
}

// y (ngroups * 1024, kp) from btile_spmm's chunk partials.
int btile_combine(const void* part, const void* band_ptr, void* y,
                  int ngroups, int nchunk, int ch, int kp, void* stream) {
  const int64_t n = (int64_t)ngroups * kBand * kp;
  btile_combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const float*)part, (const int32_t*)band_ptr, (float*)y, ngroups,
      nchunk, ch, kp);
  return (int)cudaGetLastError();
}

// out: (nsteps * rows_per_step, 128); ap: (ngroups * 1024, K), bp:
// (ncb * 128, K), 1 <= K <= 256.
int btile_sddmm(const void* patt, const void* tgt, const void* step_g,
                const void* step_cb, const void* step_nt, const void* ap,
                const void* bp, void* out, int64_t nsteps, int rows_per_step,
                int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto launch) {
    launch(nsteps, st, (const int8_t*)patt, (const int32_t*)tgt,
           (const int32_t*)step_g, (const int32_t*)step_cb,
           (const int32_t*)step_nt, (const float*)ap, (const float*)bp,
           (float*)out, rows_per_step, K);
  };
  switch ((K + 31) / 32) {
    case 1: args(launch_sddmm<1>); break;
    case 2: args(launch_sddmm<2>); break;
    case 3: args(launch_sddmm<3>); break;
    case 4: args(launch_sddmm<4>); break;
    case 5: args(launch_sddmm<5>); break;
    case 6: args(launch_sddmm<6>); break;
    case 7: args(launch_sddmm<7>); break;
    case 8: args(launch_sddmm<8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
