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
// Bound on the H100: bytes.  Per input element the kernel does at most
// ceil(k/s)^2 compares and adds against one read of x, a read of the
// covering (y, g) pairs and one write of dx; the least traffic is one
// read of x, y and g and one write of dx.
//
// Design: a gather, one thread per INPUT element, channel index fastest
// (coalesced loads of x, y, g and stores of dx).  Each thread visits the
// windows that cover its element in (dy, dx) window-offset order, which
// is the order the Pallas kernel adds its expanded contributions in, and
// accumulates in f32; the one rounding to the output dtype comes last.
// No atomics, so the result is deterministic and equals the plain
// PyTorch version bit for bit in f32.  Taps outside the input do not
// exist for an input element, so the -inf padding needs no code; a NaN
// input never equals its window's max and gets no gradient.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

template <typename T>
int launch(const T* x, const T* y, const T* g, T* dx, int n, int h, int w,
           int c, int oh, int ow, int kh, int kw, int s, int py, int px,
           cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  maxpool_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, y, g, dx, n, h, w, c, oh, ow, kh, kw, s, py, px);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int maxpool_bwd_f32(const void* x, const void* y, const void* g,
                               void* dx, int n, int h, int w, int c, int oh,
                               int ow, int kh, int kw, int s, int py, int px,
                               void* stream) {
  return launch((const float*)x, (const float*)y, (const float*)g,
                (float*)dx, n, h, w, c, oh, ow, kh, kw, s, py, px,
                (cudaStream_t)stream);
}

extern "C" int maxpool_bwd_bf16(const void* x, const void* y, const void* g,
                                void* dx, int n, int h, int w, int c, int oh,
                                int ow, int kh, int kw, int s, int py, int px,
                                void* stream) {
  return launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, n, h, w, c, oh,
                ow, kh, kw, s, py, px, (cudaStream_t)stream);
}
