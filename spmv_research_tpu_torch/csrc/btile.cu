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
constexpr int kRows = 256;    // slab rows of a full step (tg = 32)

// SpMM — replaces spmv_research_tpu/ops/btile.py `_btile_spmm_kernel`.
// The TPU kernel kept the band's Y block in VMEM and ran the band's steps
// one after another on one core, placing each step's product
// P = tiles @ X[cb] with a one-hot matmul. Here one block of 1024 threads
// owns one (band, chunk of steps, 32-column slice of X) triple, the slice
// index fastest, so the slices of one chunk run together and share the
// slab rows in L2:
//   * its band accumulator, 1024 x 32 fp32 (128 KB), lives in dynamic
//     shared memory: zeroed there, written once at the end, to Y when the
//     band has one chunk, else to the chunk's partial;
//   * each step's X[cb] slice (128 x 32, 16 KB) arrives by cp.async into a
//     double buffer, so the next step's slice loads while this step runs;
//   * one warp per live slab row (rows warp, warp + 32, ...), lane l
//     holding the row's columns 4l..4l+3 (one 16-byte load): four ballots
//     find its nonzero slots, each lane writes its nonzeros, in column
//     order, to the warp's list in shared memory as (value, column) pairs
//     at its rank (the nonzeros of the lanes before it), and then every
//     lane j runs down the list, four entries at a time, adding
//     value * X[cb][column][j] into its sum (FFMA, column order); the sum
//     goes into band[tgt[s][r]][j]. A step's live rows are distinct band
//     rows, so no atomics; a barrier separates steps. The warp's rows of
//     the next step are loaded into registers while it works on this
//     step's, so they are in flight across the barrier;
//   * padding rows past the step's 8 * step_nt[s] live rows are not read,
//     and the builder's filler step of an empty band (step_nt = 0) leaves
//     the band's zeros.
// Stored zeros are skipped, where the first kernel multiplied every slot
// (on gupta3 92% of them are zeros). So the result differs from the plain
// version's only in the order of its fp32 sums, and where X holds inf or
// NaN (a skipped 0 * inf is no NaN). Sums run in column order within a
// row, steps in order within a chunk, and btile_combine_kernel adds a cut
// band's chunks in order: the result is deterministic.
// Bound: the bytes the function must move (the live slab once, the
// steps' metadata, X and Y once; 2 * K operations per nnz). The kernel
// stays well above it: each nnz costs two shared loads (its list entry,
// broadcast, and X) and an FFMA per slice, and each slab row a list
// built again for every slice; on gupta3 walking the lists takes about
// half the time and the rest goes to building them, loading the rows and
// the step barriers (PERF.md). The list replaced a shuffle per nonzero
// found bit by bit, which ran gupta3 at about twice the time: dense rows
// (13,608 slab rows of 128 nonzeros) made long serial chains.
constexpr int kSlice = 32;            // X (and Y) columns per block
constexpr int kSpmmThreads = 1024;    // 32 warps
constexpr int kWarps = kSpmmThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // a full step's rows a warp
// the band accumulator, two X slices, and a warp's list of 128 entries
constexpr int kSpmmSmem =
    4 * (kBand * kSlice + 2 * kTileC * kSlice) + 8 * kWarps * kTileC;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__global__ void __launch_bounds__(kSpmmThreads, 1)
    btile_spmm_kernel(const float* __restrict__ tiles,
                      const int32_t* __restrict__ tgt,
                      const int32_t* __restrict__ step_cb,
                      const int32_t* __restrict__ step_nt,
                      const int32_t* __restrict__ band_ptr,
                      const float* __restrict__ xp, float* __restrict__ y,
                      float* __restrict__ part, int nchunk, int ch,
                      int rows_per_step, int kp) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;                     // [kBand][kSlice]
  float* xs = smem + kBand * kSlice;      // [2][kTileC][kSlice]
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  // the warp's list: (value, offset of its X row in a slice buffer)
  float2* list = reinterpret_cast<float2*>(xs + 2 * kTileC * kSlice) +
                 warp * kTileC;
  const int slices = kp / kSlice;
  const int k0 = (blockIdx.x % slices) * kSlice;
  const int g = blockIdx.x / slices / nchunk;
  const int j = blockIdx.x / slices % nchunk;
  const int b0 = band_ptr[g], b1 = band_ptr[g + 1];
  const int s0 = b0 + j * ch;
  const int s1 = min(s0 + ch, b1);
  if (s0 >= s1) return;  // past the band's last chunk: not combined
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = t; i < kBand * kSlice / 4; i += kSpmmThreads)
    reinterpret_cast<float4*>(band)[i] = zero4;
  // thread t copies 16 bytes of each X slice: row t / 8, columns 4 (t % 8)
  const int xr = t >> 3, xc = 4 * (t & 7);
  auto load_x = [&](int s, int buf) {
    cp_async16(xs + (buf * kTileC + xr) * kSlice + xc,
               xp + ((int64_t)step_cb[s] * kTileC + xr) * kp + k0 + xc);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the warp's rows of a step (row warp + 32 i in v[i]) and, in lane i,
  // the band row of its row i
  float4 v[kRowsPerWarp];
  int trow = 0;
  auto load_rows = [&](int s, int R) {
    const int64_t base = (int64_t)s * rows_per_step;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      v[i] = r < R ? reinterpret_cast<const float4*>(
                         tiles + (base + r) * kTileC)[lane]
                   : zero4;
    }
    const int r = warp + kWarps * lane;
    if (lane < kRowsPerWarp && r < R) trow = tgt[base + r];
  };
  load_x(s0, 0);
  int R = step_nt[s0] * 8;
  load_rows(s0, R);
  const unsigned full = 0xffffffffu;
  const unsigned before = (1u << lane) - 1u;  // the lanes before this one
  for (int s = s0, buf = 0; s < s1; ++s, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // X[s] landed; the last step's band adds are done
    const int Rn = s + 1 < s1 ? step_nt[s + 1] * 8 : 0;
    if (s + 1 < s1) load_x(s + 1, buf ^ 1);
    const float* xb = xs + buf * kTileC * kSlice + lane;
    const int trow_s = trow;
    const int64_t base_n = (int64_t)(s + 1) * rows_per_step;
    if (lane < kRowsPerWarp && warp + kWarps * lane < Rn)
      trow = tgt[base_n + warp + kWarps * lane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;  // warp-uniform
      if (r < R) {
        const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
        int rank = 0, n = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned nz = __ballot_sync(full, e[q] != 0.0f);
          rank += __popc(nz & before);
          n += __popc(nz);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (e[q] != 0.0f)
            list[rank++] = make_float2(
                e[q], __int_as_float((4 * lane + q) * kSlice));
        __syncwarp();
        float acc = 0.0f;
        int k = 0;
        for (; k + 4 <= n; k += 4) {
          float2 p[4];
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) p[u] = list[k + u];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = xb[__float_as_int(p[u].y)];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc = fmaf(p[u].x, x[u], acc);
        }
        for (; k < n; ++k) {
          const float2 p = list[k];
          acc = fmaf(p.x, xb[__float_as_int(p.y)], acc);
        }
        __syncwarp();  // the list is read before the next row writes it
        band[__shfl_sync(full, trow_s, i) * kSlice + lane] += acc;
      }
      // the next step's row i, in flight while this step goes on
      v[i] = r < Rn ? reinterpret_cast<const float4*>(
                          tiles + (base_n + r) * kTileC)[lane]
                    : zero4;
    }
    R = Rn;
  }
  __syncthreads();
  float* dst = (b1 - b0 <= ch)
                   ? y + (int64_t)g * kBand * kp + k0
                   : part + (int64_t)(g * nchunk + j) * kBand * kp + k0;
  for (int i = t; i < kBand * kSlice / 4; i += kSpmmThreads)
    *reinterpret_cast<float4*>(dst + (int64_t)(i / (kSlice / 4)) * kp +
                               4 * (i % (kSlice / 4))) =
        reinterpret_cast<const float4*>(band)[i];
}

// Y[g] = the sum of band g's chunk partials, in chunk order, for the bands
// cut into chunks (ceil(steps of g / ch) > 1); a band of one chunk was
// written to Y by btile_spmm_kernel.
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
  if (n == 1) return;
  const float* p = part + (int64_t)g * nchunk * band_elems + e;
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) acc = acc + p[j * band_elems];
  y[i] = acc;
}

// SDDMM — replaces spmv_research_tpu/ops/btile.py `_btile_sddmm_kernel`.
// The TPU kernel multiplied each step's gathered A rows by B[cb]ᵀ on the
// matrix unit and masked the product. Multiplying every slot of the live
// tiles would cost about 15 products a nonzero on gupta3, more than the
// byte bound, so here each nonzero is one dot product of a few lanes. One
// block of 512 threads a step (steps are independent):
//   * B's column block, 128 × K fp32 (64 KB at K = 128), is copied into
//     shared memory once a step with cp.async (16 bytes a copy where K is a
//     multiple of 4, else 4), row c at stride SK = K rounded up to 8, plus
//     4: an odd number of 16-byte words, so that 8 lanes reading 8
//     consecutive float4s of one B row hit 8 different bank groups. It is
//     the block's only barrier;
//   * then each warp owns the live slab rows warp, warp + 16, ... and
//     works on its own: its rows' band rows (tgt) in one load, and each
//     row's A row (g * 1024 + tgt[s][r]; read directly, where the TPU
//     kernel gathered the band's rows with a one-hot matmul) and pattern
//     word loaded into registers one row ahead;
//   * a row's set columns: lane l holds pattern bytes 4l..4l+3, four
//     ballots and a popc give its rank, and the columns go, in order, to
//     the warp's list in shared memory;
//   * each set column is one slot's K-long dot product, taken by a group
//     of G lanes (G = 8 from K = 29; fewer where K has fewer float4s), 32
//     / G columns a pass: lane p of the group holds the float4s q = p,
//     p + G, ... of the A row in registers, reads the same float4s of the
//     column's B row from shared memory (one group's 8 lanes, 8 bank
//     groups), FFMA into four partial sums (k mod 4) added as (x + y) +
//     (z + w), then a fixed butterfly of shuffles over the group, so every
//     slot's sum runs in one fixed order. Its lane 0 writes the sum into
//     the warp's C row in shared memory (zeroed beforehand: masked slots
//     stay 0);
//   * the warp writes the C row to the slab, one float4 a lane, and zeroes
//     it again; the rows past the step's 8 * step_nt[s] live rows are
//     written as zeros first, with no product.
// No TF32: FFMA in full fp32, as the TPU kernel ran at Precision.HIGHEST.
// The sums run in another order than the plain version's (torch.bmm), so
// the two agree to fp32 add-order slack.
// Bound: the bytes it must move (the slab written once, the pattern read
// once, A and B once); the dots are 2 * K operations per nnz. Each
// multiply-add reads 4 bytes of B from shared memory: on gupta3 at K = 128
// that is 4.7 GB, about 0.16 ms at 128 bytes a clock an SM, the dots'
// floor beside the slab's writes. A block-wide design (chunks of 32 rows,
// A staged in shared memory, barriers between listing, dots and writes)
// ran those three one after another and was slower (PERF.md).
constexpr int kSdThreads = 512;
constexpr int kSdWarps = kSdThreads / 32;

// shared row stride of the B block (floats)
__host__ __device__ inline int sddmm_stride(int K) {
  return (K + 7) / 8 * 8 + 4;
}

// a block's dynamic shared memory: the B block, and each warp's C row and
// list of up to 128 columns (ops/btile_cuda.py sddmm_smem mirrors it):
// 77,824 B at K = 128, so 2 blocks an SM of 228 KB; 143,360 B at K = 256,
// so 1
__host__ __device__ inline int sddmm_smem(int K) {
  return (int)(sizeof(float) * (kTileC * sddmm_stride(K) +
                                kSdWarps * kTileC) +
               kSdWarps * kTileC);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// float4 q of a row of K floats (zeros past K); vec: K a multiple of 4 and
// the row 16-byte aligned
__device__ __forceinline__ float4 load4(const float* row, int q, int K,
                                        bool vec) {
  if (vec) return reinterpret_cast<const float4*>(row)[q];
  float e[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) e[u] = 4 * q + u < K ? row[4 * q + u] : 0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <int G, int QL>  // QL float4s of the A row a lane (q < ceil(K/4))
__global__ void __launch_bounds__(kSdThreads, QL <= 4 ? 2 : 1)
    btile_sddmm_kernel(const int8_t* __restrict__ patt,
                       const int32_t* __restrict__ tgt,
                       const int32_t* __restrict__ step_g,
                       const int32_t* __restrict__ step_cb,
                       const int32_t* __restrict__ step_nt,
                       const float* __restrict__ ap,
                       const float* __restrict__ bp, float* __restrict__ out,
                       int rows_per_step, int K, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int sk = sddmm_stride(K);
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  float* const bs = smem;                                  // [128][sk]
  float* const crow = bs + kTileC * sk + warp * kTileC;    // the C row
  uint8_t* const list = reinterpret_cast<uint8_t*>(
                            bs + kTileC * sk + kSdWarps * kTileC) +
                        warp * kTileC;                     // its columns
  const int64_t s = blockIdx.x;
  const int R = step_nt[s] * 8;
  const int64_t base = s * rows_per_step;
  float4* const out4 = reinterpret_cast<float4*>(out + base * kTileC);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = R * (kTileC / 4) + t; i < rows_per_step * (kTileC / 4);
       i += kSdThreads)
    out4[i] = zero4;
  if (R == 0) return;
  const float* const bb = bp + (int64_t)step_cb[s] * kTileC * K;
  const int kq = (K + 3) / 4;
  if (vec) {
    for (int i = t; i < kTileC * kq; i += kSdThreads) {
      const int r = i / kq, c = 4 * (i - r * kq);
      cp_async16(bs + r * sk + c, bb + (int64_t)r * K + c);
    }
  } else {
    for (int i = t; i < kTileC * 4 * kq; i += kSdThreads) {
      const int r = i / (4 * kq), c = i - r * 4 * kq;
      if (c < K)
        cp_async4(bs + r * sk + c, bb + (int64_t)r * K + c);
      else
        bs[r * sk + c] = 0.0f;  // the last float4's tail
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  reinterpret_cast<float4*>(crow)[lane] = zero4;
  // the warp's rows warp + 16 i, i < nrows: band row i in lane i
  const int nrows = R > warp ? (R - warp + kSdWarps - 1) / kSdWarps : 0;
  const int tg = lane < nrows ? tgt[base + warp + kSdWarps * lane] : 0;
  const float* const a0 = ap + (int64_t)step_g[s] * kBand * K;
  const int p = lane % G;
  const unsigned full = 0xffffffffu;
  const unsigned before = (1u << lane) - 1u;
  float4 an[QL];  // the next row's A float4s and pattern word
  uint32_t pwn = 0;
  auto fetch = [&](int i) {
    const float* arow = a0 + (int64_t)__shfl_sync(full, tg, i) * K;
#pragma unroll
    for (int j = 0; j < QL; ++j)
      an[j] = p + G * j < kq ? load4(arow, p + G * j, K, vec) : zero4;
    pwn = reinterpret_cast<const uint32_t*>(
        patt + (base + warp + kSdWarps * i) * kTileC)[lane];
  };
  if (nrows) fetch(0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // B landed
  for (int i = 0; i < nrows; ++i) {
    float4 a[QL];
#pragma unroll
    for (int j = 0; j < QL; ++j) a[j] = an[j];
    const uint32_t pw = pwn;
    if (i + 1 < nrows) fetch(i + 1);
    int rank = 0, n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned nz = __ballot_sync(full, (pw >> 8 * q) & 0xffu);
      rank += __popc(nz & before);
      n += __popc(nz);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((pw >> 8 * q) & 0xffu) list[rank++] = (uint8_t)(4 * lane + q);
    __syncwarp();
    for (int e0 = 0; e0 < n; e0 += 32 / G) {
      const int e = e0 + lane / G;
      float4 acc = zero4;
      int c = 0;
      if (e < n) {
        c = list[e];
        const float4* b4 = reinterpret_cast<const float4*>(bs + c * sk);
#pragma unroll
        for (int j = 0; j < QL; ++j) {
          if (p + G * j >= kq) break;
          const float4 y = b4[p + G * j];
          acc.x = fmaf(a[j].x, y.x, acc.x);
          acc.y = fmaf(a[j].y, y.y, acc.y);
          acc.z = fmaf(a[j].z, y.z, acc.z);
          acc.w = fmaf(a[j].w, y.w, acc.w);
        }
      }
      float sum = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        sum += __shfl_xor_sync(full, sum, off);
      if (e < n && p == 0) crow[c] = sum;
    }
    __syncwarp();  // the row's sums are in; its list is read
    out4[(warp + kSdWarps * i) * (kTileC / 4) + lane] =
        reinterpret_cast<const float4*>(crow)[lane];
    reinterpret_cast<float4*>(crow)[lane] = zero4;
    __syncwarp();
  }
}

constexpr int kSddmmMaxK = 256;
// one instantiation per (G, QL): G lanes an entry, as many as K has float4s
// up to 8; QL, the float4s a lane holds, rounded up to a power of two
const void* const sddmm_kernels[] = {
    (const void*)btile_sddmm_kernel<1, 1>,
    (const void*)btile_sddmm_kernel<2, 1>,
    (const void*)btile_sddmm_kernel<2, 2>,
    (const void*)btile_sddmm_kernel<4, 1>,
    (const void*)btile_sddmm_kernel<4, 2>,
    (const void*)btile_sddmm_kernel<8, 1>,
    (const void*)btile_sddmm_kernel<8, 2>,
    (const void*)btile_sddmm_kernel<8, 4>,
    (const void*)btile_sddmm_kernel<8, 8>};

const void* sddmm_kernel(int K) {
  const int kq = (K + 3) / 4;
  if (kq >= 8) {
    const int ql = (kq + 7) / 8;
    return sddmm_kernels[ql <= 1 ? 5 : ql <= 2 ? 6 : ql <= 4 ? 7 : 8];
  }
  if (kq >= 4) return sddmm_kernels[kq <= 4 ? 3 : 4];
  if (kq >= 2) return sddmm_kernels[kq <= 2 ? 1 : 2];
  return sddmm_kernels[0];
}

// Allow the SDDMM kernels their dynamic shared memory, once per device.
cudaError_t allow_sddmm_smem() {
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev])) return err;
  for (const void* k : sddmm_kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sddmm_smem(kSddmmMaxK));
    if (err != cudaSuccess) return err;
  }
  if (dev < 64) allowed[dev] = true;
  return err;
}

}  // namespace

extern "C" {

const char* btile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y (ngroups * 1024, kp), kp a multiple of 32; with nchunk > 1 chunks of
// ch steps per band, the bands of more than one chunk go through part
// (ngroups * nchunk * 1024, kp) for btile_combine. xp: (ncb * 128, kp),
// 16-byte aligned. The kernel's 192 KB of dynamic shared memory is allowed
// once per device before its first launch.
int btile_spmm(const void* tiles, const void* tgt, const void* step_cb,
               const void* step_nt, const void* band_ptr, const void* xp,
               void* y, void* part, int ngroups, int nchunk, int ch,
               int rows_per_step, int kp, void* stream) {
  if (rows_per_step > kRows || rows_per_step % 8 || kp <= 0 ||
      kp % kSlice || nchunk < 1 || ch < 1 || ngroups < 1)
    return (int)cudaErrorInvalidValue;
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !allowed[dev]) {
    err = cudaFuncSetAttribute(btile_spmm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSpmmSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = true;
  }
  btile_spmm_kernel<<<(unsigned)(ngroups * nchunk * (kp / kSlice)),
                      kSpmmThreads, kSpmmSmem, (cudaStream_t)stream>>>(
      (const float*)tiles, (const int32_t*)tgt, (const int32_t*)step_cb,
      (const int32_t*)step_nt, (const int32_t*)band_ptr, (const float*)xp,
      (float*)y, (float*)part, nchunk, ch, rows_per_step, kp);
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
// (ncb * 128, K), 1 <= K <= 256; patt 4-byte aligned. The kernel's dynamic
// shared memory (sddmm_smem(K): 77,824 B at K = 128, 143,360 at K = 256) is allowed once per
// device before its first launch.
int btile_sddmm(const void* patt, const void* tgt, const void* step_g,
                const void* step_cb, const void* step_nt, const void* ap,
                const void* bp, void* out, int64_t nsteps, int rows_per_step,
                int K, void* stream) {
  if (K < 1 || K > kSddmmMaxK || rows_per_step > kRows ||
      rows_per_step % 8 || (uintptr_t)patt % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_sddmm_smem();
  if (err != cudaSuccess) return (int)err;
  const bool vec = K % 4 == 0 && (uintptr_t)ap % 16 == 0 &&
                   (uintptr_t)bp % 16 == 0;
  void* args[] = {&patt, &tgt, &step_g, &step_cb, &step_nt, &ap, &bp,
                  &out, &rows_per_step, &K, (void*)&vec};
  err = cudaLaunchKernel(sddmm_kernel(K), dim3((unsigned)nsteps),
                         dim3(kSdThreads), args, sddmm_smem(K),
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
