// Max pooling backward for a same-size stride-1 pool (k x k, pad
// (k-1)/2, output the input's size) over NHWC, f32 and bf16 in and out,
// f32 accumulation.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/maxpool.py:149
// (_bwd_s1_kernel, reached by maxpool_bwd_s1, :175), the one-pass
// backward of GoogLeNet's nine inception pools.  Same function as the
// general backward (maxpool_bwd.cu): every input equal to a covering
// window's max receives that window's gradient.
//
// Bound on the H100: bytes.  k*k compares and adds per element against
// one read of x and the (y, g) pairs; the least traffic is one read of
// x, y and g and one write of dx: 0.954 GB over GoogLeNet's nine b128
// bf16 pools, 0.285 ms at 3.35 TB/s.
//
// Both paths take the same sum: with stride 1 the windows covering
// input (i, j) are the outputs (i + dy - p, j + dx - p) for dy, dx in
// [0, k); the Pallas kernel reads y and g padded with +inf and 0 at
// those k*k shifts, in (dy, dx) order, which is over OUTPUT offsets,
// the reverse of the general kernel's window offsets.  Both paths follow
// that order exactly, in f32 with __fadd_rn, skipping the padded reads
// (they add 0), then round once, so the result equals the plain PyTorch
// version bit for bit.  A NaN input equals no window's max and gets no
// gradient.  No atomics.
//
// The main path (maxpool_bwd_s1_vec_kernel, C entries maxpool_bwd_s1_f32
// and maxpool_bwd_s1_bf16) is a gather over 16-byte channel vectors, for
// C a multiple of the vector (8 bf16 or 4 f32 channels), x, y, g and dx
// 16-byte aligned, fewer than 2^31 elements, and the band of one input
// row's windows, y and g, one slice wide, within shared memory (the
// wrapper's rule, ops/maxpool.takes_vector_s1; all nine GoogLeNet
// pools):
// * block (b, rows, slice) owns `rows` consecutive input rows (all of
//   an image where the band allows) and one channel slice of SLICE
//   vectors (128 bytes, channel_vec.cuh); its threads own the rows'
//   (iy, ix, vector) triples, every index 32-bit;
// * the block first copies its band, the y and g rows of the windows
//   that cover its input rows (oy = iy0 - p .. iy1 - 1 - p + k - 1,
//   clipped), into shared memory with 16-byte cp.async copies; each
//   thread reads its x vector once from device memory and its k*k (y, g)
//   vectors from the band, g only where a lane of y matches.  `rows` is
//   the most that keep the band within 48 KB (at least four blocks an
//   SM), so each y and g row is read (rows + k - 1) / rows times, where
//   one row a block would read it k times.
//
// The edge path (maxpool_bwd_s1_kernel, C entries maxpool_bwd_s1_f32_edge
// and maxpool_bwd_s1_bf16_edge), for every other shape or alignment: one
// thread per element, its position recovered by 64-bit divisions, y and
// g read through L1/L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------ edge path
template <typename T>
__global__ void maxpool_bwd_s1_kernel(const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      const T* __restrict__ g,
                                      T* __restrict__ dx, int n, int h, int w,
                                      int c, int k, int p) {
  const int64_t total = (int64_t)n * h * w * c;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int ch = (int)(idx % c);
    int64_t r = idx / c;
    const int ix = (int)(r % w);
    r /= w;
    const int iy = (int)(r % h);
    const int b = (int)(r / h);
    const float xv = to_f32(x[idx]);
    const int64_t plane = (int64_t)b * h;
    float acc = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      const int oy = iy + dy - p;
      if (oy < 0 || oy >= h) continue;
      for (int dxo = 0; dxo < k; ++dxo) {
        const int ox = ix + dxo - p;
        if (ox < 0 || ox >= w) continue;
        const int64_t o = ((plane + oy) * w + ox) * c + ch;
        if (xv == to_f32(y[o])) acc = __fadd_rn(acc, to_f32(g[o]));
      }
    }
    store(dx + idx, acc);
  }
}

template <typename T>
int launch_edge(const T* x, const T* y, const T* g, T* dx, int n, int h,
                int w, int c, int k, int p, cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  maxpool_bwd_s1_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, y, g, dx, n, h, w, c, k, p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ main path
template <typename T>
__global__ void __launch_bounds__(256)
maxpool_bwd_s1_vec_kernel(const uint4* __restrict__ x,
                          const uint4* __restrict__ y,
                          const uint4* __restrict__ g,
                          uint4* __restrict__ dx, int h, int w, int cv, int k,
                          int p, int rows) {
  constexpr int V = Lanes<T>::V;
  extern __shared__ uint4 band[];  // y rows, then g rows, the slice's
  const int groups = (h + rows - 1) / rows;  // blocks of rows an image
  const int b = blockIdx.x / groups;
  const int iy0 = (blockIdx.x - b * groups) * rows;
  const int iy1 = min(h, iy0 + rows);        // the block's rows: [iy0, iy1)
  const int c0 = blockIdx.y * SLICE;         // the slice's first vector
  const int cs = min(SLICE, cv - c0);        // and its width
  const int oy_lo = max(0, iy0 - p), oy_hi = min(h - 1, iy1 - 1 - p + k - 1);
  const int n = (oy_hi - oy_lo + 1) * w * cs;
  uint4* const ys = band;
  uint4* const gs = band + n;
  const int src = (b * h + oy_lo) * w * cv + c0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / cs;  // (oy - oy_lo) * w + ox
    const int o = src + pos * cv + (i - pos * cs);
    cp_async16(ys + i, y + o);
    cp_async16(gs + i, g + o);
  }
  cp_async_wait();
  __syncthreads();
  const int row_vecs = w * cs;
  for (int j = threadIdx.x; j < (iy1 - iy0) * row_vecs; j += blockDim.x) {
    const int r = j / row_vecs, rem = j - r * row_vecs;
    const int ix = rem / cs, v = rem - ix * cs;
    const int iy = iy0 + r;
    const int at = ((b * h + iy) * w + ix) * cv + c0 + v;
    float xf[V], acc[V];
    unpack(x[at], xf);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int oy = iy - p; oy < iy - p + k; ++oy) {
      if (oy < oy_lo || oy > oy_hi) continue;
      const int base = (oy - oy_lo) * w * cs + v;
      for (int ox = ix - p; ox < ix - p + k; ++ox) {
        if (ox < 0 || ox >= w) continue;
        float yf[V];
        unpack(ys[base + ox * cs], yf);
        bool hit[V], any = false;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          hit[i] = xf[i] == yf[i];
          any |= hit[i];
        }
        if (!any) continue;
        float gf[V];
        unpack(gs[base + ox * cs], gf);
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (hit[i]) acc[i] = __fadd_rn(acc[i], gf[i]);
      }
    }
    dx[at] = pack(acc);
  }
}

// the y (or g) rows of the windows that cover `rows` consecutive input
// rows
int band_rows(int h, int k, int rows) { return std::min(h, rows + k - 1); }

// the main path's C-side check of the wrapper's rule: the band of one
// input row's windows, y and g, one channel slice wide, within shared
// memory
template <typename T>
bool takes_vector(const void* x, const void* y, const void* g,
                  const void* dx, int n, int h, int w, int c, int k) {
  const int cs = std::min(c / Lanes<T>::V, SLICE);
  return c % Lanes<T>::V == 0 && aligned16(x) && aligned16(y) &&
         aligned16(g) && aligned16(dx) &&
         (int64_t)n * h * w * c < ((int64_t)1 << 31) &&
         (int64_t)2 * band_rows(h, k, 1) * w * cs * 16 <= SMEM_LIMIT;
}

template <typename T>
int launch_vec(const void* x, const void* y, const void* g, void* dx, int n,
               int h, int w, int c, int k, int p, cudaStream_t stream) {
  if (!takes_vector<T>(x, y, g, dx, n, h, w, c, k))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w * c == 0) return 0;
  static bool sized = false;
  const cudaError_t err = allow_smem(maxpool_bwd_s1_vec_kernel<T>, sized);
  if (err != cudaSuccess) return (int)err;
  const int cv = c / Lanes<T>::V;
  const int64_t row_bytes = (int64_t)2 * w * std::min(cv, SLICE) * 16;
  const int rows = rows_per_block(
      h, row_bytes, [&](int r) { return band_rows(h, k, r); });
  const dim3 grid((unsigned)(n * ((h + rows - 1) / rows)),
                  (unsigned)slices(cv));
  maxpool_bwd_s1_vec_kernel<T>
      <<<grid, 256, (size_t)(band_rows(h, k, rows) * row_bytes), stream>>>(
          (const uint4*)x, (const uint4*)y, (const uint4*)g, (uint4*)dx, h,
          w, cv, k, p, rows);
  return (int)cudaGetLastError();
}

}  // namespace

#define MAXPOOL_BWD_S1_ARGS                                              \
  const void *x, const void *y, const void *g, void *dx, int n, int h,   \
      int w, int c, int k, int p, void *stream
#define MAXPOOL_BWD_S1_PASS x, y, g, dx, n, h, w, c, k, p, (cudaStream_t)stream

// the main path: C a multiple of 4 (f32) or 8 (bf16) channels, x, y, g,
// dx 16-byte aligned, under 2^31 elements, the band within shared
// memory, else cudaErrorInvalidValue (the wrapper sends those to the
// edge entries)
extern "C" int maxpool_bwd_s1_f32(MAXPOOL_BWD_S1_ARGS) {
  return launch_vec<float>(MAXPOOL_BWD_S1_PASS);
}

extern "C" int maxpool_bwd_s1_bf16(MAXPOOL_BWD_S1_ARGS) {
  return launch_vec<__nv_bfloat16>(MAXPOOL_BWD_S1_PASS);
}

// the edge path: any C, alignment and size
extern "C" int maxpool_bwd_s1_f32_edge(MAXPOOL_BWD_S1_ARGS) {
  return launch_edge((const float*)x, (const float*)y, (const float*)g,
                     (float*)dx, n, h, w, c, k, p, (cudaStream_t)stream);
}

extern "C" int maxpool_bwd_s1_bf16_edge(MAXPOOL_BWD_S1_ARGS) {
  return launch_edge((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                     (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, n, h, w,
                     c, k, p, (cudaStream_t)stream);
}
