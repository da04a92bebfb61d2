// Max pooling backward (the reference's unpool rule) over NHWC, any
// stride, f32 and bf16 in and out, f32 accumulation.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/maxpool.py:71 (_bwd_kernel,
// reached by _mp_bwd, :137, the backward of maxpool_fused):
//   dx[p] = sum over the windows w that cover p of g[w] * [x[p] == y[w]]
// so every tied maximum of a window receives that window's gradient.
// The window geometry is the host's (ops/maxpool.geometry): left pads
// (py, px) and the ceil output size (oh, ow).
//
// Bound on the H100: bytes.  Per input element at most ceil(k/s)^2
// compares and adds against one read of x, a read of the covering (y, g)
// pairs and one write of dx; the least traffic is one read of x, y and g
// and one write of dx: 1.24 GB at GoogLeNet's four b128 k3 s2 pools,
// 0.371 ms at 3.35 TB/s.
//
// The main path (maxpool_bwd_vec_kernel, C entries maxpool_bwd_f32 and
// maxpool_bwd_bf16) is a gather over 16-byte channel vectors, for C a
// multiple of the vector (8 bf16 or 4 f32 channels), every base pointer
// 16-byte aligned, fewer than 2^31 elements in x and in y, and a band
// of window rows that fits in shared memory (the wrapper's rule,
// ops/maxpool.takes_vector; all four GoogLeNet pools):
// * one thread per vector of one input position: x, each covering
//   window's y, and its g where a lane matches, are 16-byte loads, dx
//   one 16-byte store, so the loads and stores run at the width Hopper
//   moves memory at;
// * block (b * h + iy) owns one input row, its threads the row's
//   (ix, vector) pairs: no per-element division, and every index is
//   32-bit.  The covering windows are a closed form: oy from
//   max(0, ceil((iy + py - kh + 1) / s)) to min(oh - 1, (iy + py) / s),
//   the same for the block, and likewise ox per thread;
// * oy and ox run downwards, so the window offsets dy = iy + py - oy s
//   and dx rise: the (dy, dx) order in which the Pallas kernel and the
//   plain PyTorch version add, so the f32 sums, and the one rounding to
//   the output dtype, are theirs bit for bit;
// * y and g are read by up to ceil(k/s)^2 inputs each: the block first
//   stages its band (the at most (kh - 1) / s + 1 window rows that cover
//   its input row) of y and g in shared memory with coalesced 16-byte
//   loads and gathers from there.  The band must fit in a block's
//   shared memory (every GoogLeNet pool's does, f32 too: at most 107,520
//   bytes); a wider one takes the edge path.  The staged band beat a gather through
//   L1/L2 at the four b128 pools (PERF.md), so only the band is kept.
// No atomics; taps outside the input do not exist for an input element,
// so the -inf padding needs no code; a NaN input never equals its
// window's max and gets no gradient.
//
// The edge path (maxpool_bwd_kernel, C entries maxpool_bwd_f32_edge and
// maxpool_bwd_bf16_edge), for every other shape or alignment: one thread
// per element, its position recovered by 64-bit divisions, the same
// (dy, dx) order and the same sums.

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
__global__ void maxpool_bwd_kernel(const T* __restrict__ x,
                                   const T* __restrict__ y,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx, int n, int h, int w,
                                   int c, int oh, int ow, int kh, int kw,
                                   int s, int py, int px) {
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
    // position in the padded plane; window (oy, ox) at offset (dy, dx)
    // covers it when oy * s + dy == ppy and ox * s + dx == ppx
    const int ppy = iy + py;
    const int ppx = ix + px;
    const int64_t plane = (int64_t)b * oh;
    float acc = 0.0f;
    for (int dy = 0; dy < kh; ++dy) {
      const int ty = ppy - dy;
      if (ty < 0 || ty % s != 0) continue;
      const int oy = ty / s;
      if (oy >= oh) continue;
      for (int dxo = 0; dxo < kw; ++dxo) {
        const int tx = ppx - dxo;
        if (tx < 0 || tx % s != 0) continue;
        const int ox = tx / s;
        if (ox >= ow) continue;
        const int64_t o = ((plane + oy) * ow + ox) * c + ch;
        if (xv == to_f32(y[o])) acc = __fadd_rn(acc, to_f32(g[o]));
      }
    }
    store(dx + idx, acc);
  }
}

// ------------------------------------------------------------ main path
// windows covering padded coordinate pp: from lo to hi (empty if lo > hi)
__device__ __forceinline__ void covering(int pp, int k, int s, int out,
                                         int& lo, int& hi) {
  hi = min(out - 1, pp / s);
  lo = pp - k + 1 <= 0 ? 0 : (pp - k + s) / s;
}

// the block first stages the y and g rows of its band (every window row
// that covers its input row) in shared memory and gathers from there
template <typename T>
__global__ void __launch_bounds__(256)
maxpool_bwd_vec_kernel(const uint4* __restrict__ x,
                       const uint4* __restrict__ y,
                       const uint4* __restrict__ g, uint4* __restrict__ dx,
                       int h, int w, int cv, int oh, int ow, int kh, int kw,
                       int s, int py, int px) {
  constexpr int V = Lanes<T>::V;
  extern __shared__ uint4 band[];  // y rows, then g rows
  const int row = blockIdx.x;      // b * h + iy
  const int b = row / h, iy = row - b * h;
  int oy_lo, oy_hi;
  covering(iy + py, kh, s, oh, oy_lo, oy_hi);
  const int row_vecs = w * cv, out_row = ow * cv;
  const int n = (oy_hi - oy_lo + 1) * out_row;
  const uint4* ys = band;
  const uint4* gs = band + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    band[i] = y[(b * oh + oy_lo) * out_row + i];
    band[n + i] = g[(b * oh + oy_lo) * out_row + i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < row_vecs; j += blockDim.x) {
    const int ix = j / cv, cvi = j - ix * cv;
    int ox_lo, ox_hi;
    covering(ix + px, kw, s, ow, ox_lo, ox_hi);
    float xf[V], acc[V];
    unpack(x[row * row_vecs + j], xf);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int oy = oy_hi; oy >= oy_lo; --oy) {
      const int base = (oy - oy_lo) * out_row + cvi;
      for (int ox = ox_hi; ox >= ox_lo; --ox) {
        float yf[V];
        unpack(ys[base + ox * cv], yf);
        bool hit[V], any = false;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          hit[i] = xf[i] == yf[i];
          any |= hit[i];
        }
        if (!any) continue;
        float gf[V];
        unpack(gs[base + ox * cv], gf);
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (hit[i]) acc[i] = __fadd_rn(acc[i], gf[i]);
      }
    }
    dx[row * row_vecs + j] = pack(acc);
  }
}

template <typename T>
int launch_edge(const T* x, const T* y, const T* g, T* dx, int n, int h,
                int w, int c, int oh, int ow, int kh, int kw, int s, int py,
                int px, cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  maxpool_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, y, g, dx, n, h, w, c, oh, ow, kh, kw, s, py, px);
  return (int)cudaGetLastError();
}

// the band of y and g rows a block stages: the most window rows that
// cover one input row, times two
int64_t band_bytes(int oh, int ow, int cv, int kh, int s) {
  return (int64_t)2 * std::min(oh, (kh - 1) / s + 1) * ow * cv * 16;
}

// the main path's C-side check of the wrapper's rule
template <typename T>
bool takes_vector(const void* x, const void* y, const void* g,
                  const void* dx, int n, int h, int w, int c, int oh, int ow,
                  int kh, int s) {
  const int64_t lim = (int64_t)1 << 31;
  return c % Lanes<T>::V == 0 && aligned16(x) && aligned16(y) &&
         aligned16(g) && aligned16(dx) && (int64_t)n * h * w * c < lim &&
         (int64_t)n * oh * ow * c < lim &&
         band_bytes(oh, ow, c / Lanes<T>::V, kh, s) <= SMEM_LIMIT;
}

template <typename T>
int launch_vec(const void* x, const void* y, const void* g, void* dx, int n,
               int h, int w, int c, int oh, int ow, int kh, int kw, int s,
               int py, int px, cudaStream_t stream) {
  if (!takes_vector<T>(x, y, g, dx, n, h, w, c, oh, ow, kh, s))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w * c == 0) return 0;
  const int cv = c / Lanes<T>::V;
  static bool sized = false;
  const cudaError_t err = allow_smem(maxpool_bwd_vec_kernel<T>, sized);
  if (err != cudaSuccess) return (int)err;
  // one block of 256 threads a row
  maxpool_bwd_vec_kernel<T><<<(unsigned)(n * h), 256,
                              (size_t)band_bytes(oh, ow, cv, kh, s),
                              stream>>>(
      (const uint4*)x, (const uint4*)y, (const uint4*)g, (uint4*)dx, h, w,
      cv, oh, ow, kh, kw, s, py, px);
  return (int)cudaGetLastError();
}

}  // namespace

#define MAXPOOL_BWD_ARGS                                                  \
  const void *x, const void *y, const void *g, void *dx, int n, int h,   \
      int w, int c, int oh, int ow, int kh, int kw, int s, int py, int px, \
      void *stream
#define MAXPOOL_BWD_PASS \
  x, y, g, dx, n, h, w, c, oh, ow, kh, kw, s, py, px, (cudaStream_t)stream

// the main path: C a multiple of 4 (f32) or 8 (bf16) channels, x, y, g,
// dx 16-byte aligned, x and y under 2^31 elements, the band within
// shared memory, else cudaErrorInvalidValue (the wrapper sends those to
// the edge entries)
extern "C" int maxpool_bwd_f32(MAXPOOL_BWD_ARGS) {
  return launch_vec<float>(MAXPOOL_BWD_PASS);
}

extern "C" int maxpool_bwd_bf16(MAXPOOL_BWD_ARGS) {
  return launch_vec<__nv_bfloat16>(MAXPOOL_BWD_PASS);
}

// the edge path: any C, alignment and size
extern "C" int maxpool_bwd_f32_edge(MAXPOOL_BWD_ARGS) {
  return launch_edge((const float*)x, (const float*)y, (const float*)g,
                     (float*)dx, n, h, w, c, oh, ow, kh, kw, s, py, px,
                     (cudaStream_t)stream);
}

extern "C" int maxpool_bwd_bf16_edge(MAXPOOL_BWD_ARGS) {
  return launch_edge((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                     (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, n, h, w,
                     c, oh, ow, kh, kw, s, py, px, (cudaStream_t)stream);
}
