// Ceil-shape max pooling forward over NHWC, f32 and bf16.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/maxpool.py:56 (_fwd_kernel,
// reached by maxpool_fused, :123).  Same function: output
// (N, oh, ow, C) with the ceil geometry the host computes (the JAX
// package's formula, cxxnet_tpu/layers/conv.py:40-62); taps that fall
// outside the input count as -inf, so partial edge windows reduce over
// their in-range taps only.
//
// Bound on the H100: bytes.  Each output reads k*k inputs but does one
// compare per tap, so the work is ~9 compares per 2-4 bytes moved,
// far below the card's operations-per-byte balance.  The least traffic
// is one read of x and one write of y: 1.10 GB over GoogLeNet's 13 b128
// bf16 pools, 0.328 ms at 3.35 TB/s.
//
// Both paths take the max in f32 (exact for bf16, whose values all
// convert exactly), per channel, over the in-range taps in (dy, dx)
// order with the rule "v > m or v is NaN", so a NaN propagates like
// torch.maximum; the result equals the plain PyTorch version bit for
// bit (a max selects one of its inputs, and the one rounding back to
// bf16 is exact).
//
// The main path (maxpool_fwd_vec_kernel, C entries maxpool_fwd_f32 and
// maxpool_fwd_bf16) is a gather over 16-byte channel vectors, for C a
// multiple of the vector (8 bf16 or 4 f32 channels), x and y 16-byte
// aligned, fewer than 2^31 elements in each, and the band of one output
// row's windows, one slice wide, within shared memory (the wrapper's rule,
// ops/maxpool.takes_vector_fwd; all 13 GoogLeNet pools):
// * block (b, rows, slice) owns `rows` consecutive output rows (all of
//   an image where the band allows) and one channel slice of SLICE
//   vectors (128 bytes, channel_vec.cuh); its threads own the rows'
//   (oy, ox, vector) triples: no per-element 64-bit division, and every
//   index is 32-bit;
// * the block first copies its band, the input rows its windows cover
//   ((rows - 1) s + kh at most, clipped to the input), into shared
//   memory with 16-byte cp.async copies, then each thread reads its
//   kh*kw taps from there: one 16-byte read a tap and one 16-byte store
//   an output, where the scalar kernel read k*k 2-byte values through L1
//   for every element.  `rows` is the most that keep the band within
//   48 KB (at least four blocks an SM), so a stride-1 pool reads each
//   input row (rows + 2) / rows times instead of three;
// * taps outside the input are never read: the band holds only the
//   input's rows, and a column outside it is skipped.
//
// The edge path (maxpool_fwd_kernel, C entries maxpool_fwd_f32_edge and
// maxpool_fwd_bf16_edge), for every other shape or alignment: one
// thread per output element, channel index fastest, its position
// recovered by 64-bit divisions, the taps read through L1/L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "channel_vec.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // exact: v is one of the bf16 inputs
}

// ------------------------------------------------------------ edge path
template <typename T>
__global__ void maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   int n, int h, int w, int c, int oh, int ow,
                                   int kh, int kw, int s, int py, int px) {
  const int64_t total = (int64_t)n * oh * ow * c;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(idx % c);
    int64_t r = idx / c;
    const int ox = (int)(r % ow);
    r /= ow;
    const int oy = (int)(r % oh);
    const int b = (int)(r / oh);
    const int y0 = oy * s - py;
    const int x0 = ox * s - px;
    float m = -INFINITY;
    for (int dy = 0; dy < kh; ++dy) {
      const int iy = y0 + dy;
      if (iy < 0 || iy >= h) continue;
      const T* row = x + (((int64_t)b * h + iy) * w) * c + ch;
      for (int dx = 0; dx < kw; ++dx) {
        const int ix = x0 + dx;
        if (ix < 0 || ix >= w) continue;
        const float v = to_f32(row[(int64_t)ix * c]);
        if (v > m || isnan(v)) m = v;
      }
    }
    store(y + idx, m);
  }
}

template <typename T>
int launch_edge(const T* x, T* y, int n, int h, int w, int c, int oh, int ow,
                int kh, int kw, int s, int py, int px, cudaStream_t stream) {
  const int64_t total = (int64_t)n * oh * ow * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  maxpool_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, y, n, h, w, c, oh, ow, kh, kw, s, py, px);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ main path
template <typename T>
__global__ void __launch_bounds__(256)
maxpool_fwd_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                       int h, int w, int cv, int oh, int ow, int kh, int kw,
                       int s, int py, int px, int rows) {
  constexpr int V = Lanes<T>::V;
  extern __shared__ uint4 band[];  // the covered input rows, the slice's
  const int groups = (oh + rows - 1) / rows;  // blocks of rows an image
  const int b = blockIdx.x / groups;
  const int oy0 = (blockIdx.x - b * groups) * rows;
  const int oy1 = min(oh, oy0 + rows);        // the block's rows: [oy0, oy1)
  const int c0 = blockIdx.y * SLICE;          // the slice's first vector
  const int cs = min(SLICE, cv - c0);         // and its width
  const int iy_lo = max(0, oy0 * s - py);
  const int iy_hi = min(h - 1, (oy1 - 1) * s - py + kh - 1);
  const int n = (iy_hi - iy_lo + 1) * w * cs;  // <= 0: no row in range
  const uint4* src = x + (b * h + iy_lo) * w * cv + c0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / cs;  // (iy - iy_lo) * w + ix
    cp_async16(band + i, src + pos * cv + (i - pos * cs));
  }
  cp_async_wait();
  __syncthreads();
  const int row_vecs = ow * cs;
  for (int j = threadIdx.x; j < (oy1 - oy0) * row_vecs; j += blockDim.x) {
    const int r = j / row_vecs, rem = j - r * row_vecs;
    const int ox = rem / cs, v = rem - ox * cs;
    const int y0 = (oy0 + r) * s - py, x0 = ox * s - px;
    float m[V];
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = -INFINITY;
    for (int iy = y0; iy < y0 + kh; ++iy) {
      if (iy < iy_lo || iy > iy_hi) continue;
      const uint4* taps = band + (iy - iy_lo) * w * cs + v;
      for (int ix = x0; ix < x0 + kw; ++ix) {
        if (ix < 0 || ix >= w) continue;
        float f[V];
        unpack(taps[ix * cs], f);
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (f[i] > m[i] || isnan(f[i])) m[i] = f[i];
      }
    }
    y[((b * oh + oy0 + r) * ow + ox) * cv + c0 + v] = pack(m);
  }
}

// the input rows the windows of `rows` consecutive output rows cover
int band_rows(int h, int kh, int s, int rows) {
  return std::min(h, (rows - 1) * s + kh);
}

// the main path's C-side check of the wrapper's rule: the band of one
// output row's windows, one channel slice wide, within shared memory
template <typename T>
bool takes_vector(const void* x, const void* y, int n, int h, int w, int c,
                  int oh, int ow, int kh) {
  const int64_t lim = (int64_t)1 << 31;
  const int cs = std::min(c / Lanes<T>::V, SLICE);
  return c % Lanes<T>::V == 0 && aligned16(x) && aligned16(y) &&
         (int64_t)n * h * w * c < lim && (int64_t)n * oh * ow * c < lim &&
         (int64_t)band_rows(h, kh, 1, 1) * w * cs * 16 <= SMEM_LIMIT;
}

template <typename T>
int launch_vec(const void* x, void* y, int n, int h, int w, int c, int oh,
               int ow, int kh, int kw, int s, int py, int px,
               cudaStream_t stream) {
  if (!takes_vector<T>(x, y, n, h, w, c, oh, ow, kh))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * oh * ow * c == 0) return 0;
  static bool sized = false;
  const cudaError_t err = allow_smem(maxpool_fwd_vec_kernel<T>, sized);
  if (err != cudaSuccess) return (int)err;
  const int cv = c / Lanes<T>::V;
  const int64_t row_bytes = (int64_t)w * std::min(cv, SLICE) * 16;
  const int rows = rows_per_block(
      oh, row_bytes, [&](int r) { return band_rows(h, kh, s, r); });
  const dim3 grid((unsigned)(n * ((oh + rows - 1) / rows)),
                  (unsigned)slices(cv));
  maxpool_fwd_vec_kernel<T>
      <<<grid, 256, (size_t)(band_rows(h, kh, s, rows) * row_bytes),
         stream>>>((const uint4*)x, (uint4*)y, h, w, cv, oh, ow, kh, kw, s,
                   py, px, rows);
  return (int)cudaGetLastError();
}

}  // namespace

#define MAXPOOL_FWD_ARGS                                                  \
  const void *x, void *y, int n, int h, int w, int c, int oh, int ow,     \
      int kh, int kw, int s, int py, int px, void *stream
#define MAXPOOL_FWD_PASS \
  x, y, n, h, w, c, oh, ow, kh, kw, s, py, px, (cudaStream_t)stream

// the main path: C a multiple of 4 (f32) or 8 (bf16) channels, x and y
// 16-byte aligned, each under 2^31 elements, the band within shared
// memory, else cudaErrorInvalidValue (the wrapper sends those to the
// edge entries)
extern "C" int maxpool_fwd_f32(MAXPOOL_FWD_ARGS) {
  return launch_vec<float>(MAXPOOL_FWD_PASS);
}

extern "C" int maxpool_fwd_bf16(MAXPOOL_FWD_ARGS) {
  return launch_vec<__nv_bfloat16>(MAXPOOL_FWD_PASS);
}

// the edge path: any C, alignment and size
extern "C" int maxpool_fwd_f32_edge(MAXPOOL_FWD_ARGS) {
  return launch_edge((const float*)x, (float*)y, n, h, w, c, oh, ow, kh, kw,
                     s, py, px, (cudaStream_t)stream);
}

extern "C" int maxpool_fwd_bf16_edge(MAXPOOL_FWD_ARGS) {
  return launch_edge((const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, h, w, c,
                     oh, ow, kh, kw, s, py, px, (cudaStream_t)stream);
}
