// Hand-written Hopper (sm_90a) kernels of the CLOSG SpMV engine: the front
// ends (plain, value-LUT, fused windows), the in-vreg layer, the segmented
// scan, and the three y extractions (windowed, candidate-plane, CLOSGX);
// and the r3 steps of the exact-CLOS engine (B8: the r3 layer × values or
// with the out-valid mask, and the forward fill).
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
// A 1024-slot block holds whole 8-row tiles for every L <= 128, so one
// thread block stages its words and values in shared memory and resolves
// the three dependent picks there.

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

// What follows the in-vreg layer in the same launch (kPost).
constexpr int kPostNone = 0;   // K2, and the r3 layer of K3, B5, B15, B8 fill
constexpr int kPostVals = 1;   // B8 scan: × vals at the output slot
constexpr int kPostValid = 2;  // B8 valid: 0 unless bit 17 of the r3 word

// K2 `clos_invreg` — replaces spmv_research_tpu/ops/clos_pallas.py
// `_invreg_kernel` (the r2 layer; also the r3 layer of K3).
// Bound: device memory, 12 bytes per slot (read word and value, write out);
// the three picks hit shared memory. One block per 1024 slots.
//
// B8's r3 layers — replace clos_pallas.py `_r3_scan_kernel` (the layer, then
// × vals; kPostVals) and `_r3_valid_kernel` (the layer, then the out-valid
// mask of the compact network; kPostValid). The product is __fmul_rn so
// that nvcc cannot contract it into an FMA with the scan's add: the plain
// version rounds it on its own. Bound: device memory, 16 (vals) or 12
// bytes per slot.
template <int kPost>
__global__ void invreg_kernel(const float* __restrict__ v,
                              const uint32_t* __restrict__ word,
                              const float* __restrict__ vals,
                              float* __restrict__ out, int lshift) {
  __shared__ uint32_t w_sh[kBlockSlots];
  __shared__ float v_sh[kBlockSlots];
  const int64_t off = (int64_t)blockIdx.x * kBlockSlots;
  const int t = threadIdx.x;
  w_sh[t] = word[off + t];
  v_sh[t] = v[off + t];
  __syncthreads();
  const float r = invreg_pick(w_sh, v_sh, t, lshift);
  if (kPost == kPostVals)
    out[off + t] = __fmul_rn(r, vals[off + t]);
  else if (kPost == kPostValid)
    out[off + t] = ((w_sh[t] >> 17) & 1u) ? r : 0.0f;
  else
    out[off + t] = r;
}

// K1 `closg_front` — replaces spmv_research_tpu/ops/clos_gather.py
// `_gmul_r1_dma_kernel`: product x2d[rowidx[s], λ] * vals_cs[s, l], then
// the r1 layer. Bound: device memory, 12 bytes per slot plus the x reads,
// which come from L2 (x is 4 bytes per column; the scircuit twin's is
// 684 KB). The TPU kernel copied each sublane's 128-wide x window into VMEM
// first; here each thread reads its own x element directly (columns past n
// read as 0, the zero padding of the x plane), so any x size is served:
// this is also the non-LUT mode of `_gmul_r1_kernel` (x past 4 MB).
//
// B4 (kLut) — replaces the value-LUT mode of clos_gather.py
// `_gmul_r1_kernel`: the value is entry (w >> 24) & 0x7F of the 128-entry
// dictionary (row 0 of the (8,128) dictionary plane), staged in shared
// memory; the value plane is not read at all (8 bytes per slot).
template <bool kLut>
__global__ void front_kernel(const int32_t* __restrict__ rowidx,
                             const uint32_t* __restrict__ word,
                             const float* __restrict__ vals,
                             const float* __restrict__ x, int64_t n_x,
                             float* __restrict__ out) {
  __shared__ uint32_t w_sh[kBlockSlots];
  __shared__ float v_sh[kBlockSlots];
  __shared__ float dict_sh[kLanes];
  const int64_t off = (int64_t)blockIdx.x * kBlockSlots;
  const int t = threadIdx.x;
  if (kLut && t < kLanes) dict_sh[t] = vals[t];
  const uint32_t wd = word[off + t];
  w_sh[t] = wd;
  const int64_t col = (int64_t)rowidx[(off + t) / kLanes] * kLanes +
                      ((wd >> 17) & 0x7F);
  const float xv = col < n_x ? x[col] : 0.0f;
  if (kLut) __syncthreads();
  v_sh[t] = xv * (kLut ? dict_sh[(wd >> 24) & 0x7F] : vals[off + t]);
  __syncthreads();
  out[off + t] = invreg_pick(w_sh, v_sh, t, 7);
}

// B7 `closg_front_win` — replaces spmv_research_tpu/ops/clos_gather.py
// `_gmul_r1_win_kernel` (fused windows). The TPU kernel sliced one (8,128)
// window per 8-sublane group from a VMEM-resident compacted x plane and
// resolved each slot by a rotation select. Here each thread resolves its
// own x row, xr = gbase[s/8] + ((s%8 + rot) & 7) with rot = (w >> 24) & 7,
// the x block is nbids[xr] (or xr itself when every block is non-empty:
// nbids == nullptr), and rows past the n_nb compacted rows read 0 (the TPU
// kernel's 8-row overrun pad). Bound: device memory, as K1.
__global__ void front_win_kernel(const int32_t* __restrict__ gbase,
                                 const int32_t* __restrict__ nbids,
                                 int64_t n_nb,
                                 const uint32_t* __restrict__ word,
                                 const float* __restrict__ vals,
                                 const float* __restrict__ x, int64_t n_x,
                                 float* __restrict__ out) {
  __shared__ uint32_t w_sh[kBlockSlots];
  __shared__ float v_sh[kBlockSlots];
  const int64_t off = (int64_t)blockIdx.x * kBlockSlots;
  const int t = threadIdx.x;
  const uint32_t wd = word[off + t];
  w_sh[t] = wd;
  const int64_t s = (off + t) / kLanes;
  const int64_t xr = (int64_t)gbase[s / kSub] +
                     (((s % kSub) + ((wd >> 24) & 0x7)) & (kSub - 1));
  float xv = 0.0f;
  if (nbids == nullptr || xr < n_nb) {
    const int64_t blk = nbids == nullptr ? xr : (int64_t)nbids[xr];
    const int64_t col = blk * kLanes + ((wd >> 17) & 0x7F);
    if (col < n_x) xv = x[col];
  }
  v_sh[t] = xv * vals[off + t];
  __syncthreads();
  out[off + t] = invreg_pick(w_sh, v_sh, t, 7);
}

// One Hillis–Steele stage of the segmented scan — part of K3 (replacing
// spmv_research_tpu/ops/clos_pallas.py `_r3_scan_yext_kernel`), of B5
// (`_r3_scan_kernel_noval`) and of B15 (clos_xl.py
// `_r3_scan_yext_dyn_kernel`):
//   dst[p] = src[p] + (guard_k[p] ? src[p - 2^k] : 0)
// with guard_k bit 17+k of the r3 word (k < 15) or bit k-15 of scan_hi.
// The slots are runs of `chunk` (a power of two: one program, or one of
// CLOSGX's stacked chunks), and the shift wraps within its run like the
// JAX package's roll; a set guard never wraps, so no value crosses a
// chunk. Each stage reads the previous stage's whole array, so stages
// ping-pong two buffers, one launch each. Bound: device memory, 12 bytes
// per slot per stage.
//
// kSelect: one stage of B8's forward fill — replaces the fill stages of
// clos_pallas.py `_r3_fill_kernel` (the widen network's r3 word carries the
// take bits):
//   dst[p] = take_k[p] ? src[p - 2^k] : src[p]
// over one CLOS program (chunk = N), wrapping like the JAX package's roll.
// The select is exact. Bound: device memory, 12 bytes per slot per stage.
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
// `_extract_y_kernel` (the W = 0 back end's extraction). One thread per y
// element (j, l): cid = bits [7,14) and lane = bits [0,7) of ysel[j,l],
// y = scr[ycand[cid*m_rows + j], lane]. The candidates are read in place:
// the TPU path first copied the C candidate planes out with an XLA gather
// and then looped over C in the kernel. Empty rows read slot nnz, which
// the scan leaves exactly 0. Bound: ysel and y (8 bytes per element) plus
// one scattered 4-byte read each.
__global__ void cand_yext_kernel(const float* __restrict__ scr,
                                 const int32_t* __restrict__ ycand,
                                 const uint32_t* __restrict__ ysel,
                                 int64_t m_rows, float* __restrict__ y) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m_rows * kLanes) return;
  const uint32_t sel = ysel[e];
  const int64_t row =
      ycand[(int64_t)((sel >> 7) & 0x7F) * m_rows + e / kLanes];
  y[e] = scr[row * kLanes + (sel & 0x7F)];
}

}  // namespace

extern "C" {

const char* closg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n_slots: a multiple of 1024; lanes: a power of two <= 128.
int closg_invreg(const void* v, const void* word, void* out, int64_t n_slots,
                 int lanes, void* stream) {
  int lshift = 0;
  while ((1 << lshift) < lanes) ++lshift;
  invreg_kernel<kPostNone><<<(unsigned)(n_slots / kBlockSlots), kBlockSlots,
                             0, (cudaStream_t)stream>>>(
      (const float*)v, (const uint32_t*)word, nullptr, (float*)out, lshift);
  return (int)cudaGetLastError();
}

// B8's r3 layer on 128-lane rows: post 1 multiplies by vals, post 2 applies
// the out-valid bit (vals unused, may be null).
int clos_r3(const void* v, const void* word, const void* vals, void* out,
            int64_t n_slots, int post, void* stream) {
  const unsigned blocks = (unsigned)(n_slots / kBlockSlots);
  const cudaStream_t st = (cudaStream_t)stream;
  if (post == kPostVals)
    invreg_kernel<kPostVals><<<blocks, kBlockSlots, 0, st>>>(
        (const float*)v, (const uint32_t*)word, (const float*)vals,
        (float*)out, 7);
  else if (post == kPostValid)
    invreg_kernel<kPostValid><<<blocks, kBlockSlots, 0, st>>>(
        (const float*)v, (const uint32_t*)word, nullptr, (float*)out, 7);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// n_slots: a multiple of 1024 (rows of 128 lanes). lut != 0: vals is the
// (8,128) dictionary plane.
int closg_front(const void* rowidx, const void* perm_r1, const void* vals,
                const void* x, int64_t n_x, void* out, int64_t n_slots,
                int lut, void* stream) {
  const unsigned blocks = (unsigned)(n_slots / kBlockSlots);
  if (lut)
    front_kernel<true><<<blocks, kBlockSlots, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rowidx, (const uint32_t*)perm_r1, (const float*)vals,
        (const float*)x, n_x, (float*)out);
  else
    front_kernel<false><<<blocks, kBlockSlots, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rowidx, (const uint32_t*)perm_r1, (const float*)vals,
        (const float*)x, n_x, (float*)out);
  return (int)cudaGetLastError();
}

// nbids may be null (every x block is non-empty: no compaction).
int closg_front_win(const void* gbase, const void* nbids, int64_t n_nb,
                    const void* perm_r1, const void* vals, const void* x,
                    int64_t n_x, void* out, int64_t n_slots, void* stream) {
  front_win_kernel<<<(unsigned)(n_slots / kBlockSlots), kBlockSlots, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)gbase, (const int32_t*)nbids, n_nb,
      (const uint32_t*)perm_r1, (const float*)vals, (const float*)x, n_x,
      (float*)out);
  return (int)cudaGetLastError();
}

// chunk: a power of two dividing n_slots; scan_hi may be null when k < 15.
int closg_scan_step(const void* src, void* dst, const void* perm_r3,
                    const void* scan_hi, int k, int64_t n_slots,
                    int64_t chunk, void* stream) {
  const int threads = 256;
  scan_step_kernel<false><<<(unsigned)((n_slots + threads - 1) / threads),
                            threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, (const uint32_t*)perm_r3,
      (const uint32_t*)scan_hi, k, n_slots, chunk);
  return (int)cudaGetLastError();
}

// B8's fill stage: as closg_scan_step, selecting instead of adding (take
// bits in widen_r3's spare bits; fill_hi may be null when k < 15).
int clos_fill_step(const void* src, void* dst, const void* widen_r3,
                   const void* fill_hi, int k, int64_t n_slots,
                   int64_t chunk, void* stream) {
  const int threads = 256;
  scan_step_kernel<true><<<(unsigned)((n_slots + threads - 1) / threads),
                           threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (float*)dst, (const uint32_t*)widen_r3,
      (const uint32_t*)fill_hi, k, n_slots, chunk);
  return (int)cudaGetLastError();
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

int closg_cand_yext(const void* scr, const void* ycand, const void* ysel,
                    int64_t m_rows, void* y, void* stream) {
  const int threads = 256;
  const int64_t n = m_rows * kLanes;
  if (n == 0) return 0;
  cand_yext_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)scr, (const int32_t*)ycand, (const uint32_t*)ysel,
      m_rows, (float*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
