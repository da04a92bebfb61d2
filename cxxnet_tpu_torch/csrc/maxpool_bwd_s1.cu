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
// x, y and g and one write of dx.
//
// Design: one thread per element, channel index fastest.  With stride 1
// the windows covering input (i, j) are the outputs (i + dy - p,
// j + dx - p) for dy, dx in [0, k): the Pallas kernel reads y and g
// padded with +inf and 0 at those k*k shifts, in (dy, dx) order, which
// is over OUTPUT offsets, the reverse of the general kernel's window
// offsets.  This kernel follows that order exactly and skips the padded
// reads (they add 0), so the f32 sum equals the plain PyTorch version
// bit for bit.  No atomics.

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
int launch(const T* x, const T* y, const T* g, T* dx, int n, int h, int w,
           int c, int k, int p, cudaStream_t stream) {
  const int64_t total = (int64_t)n * h * w * c;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  maxpool_bwd_s1_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, y, g, dx, n, h, w, c, k, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int maxpool_bwd_s1_f32(const void* x, const void* y,
                                  const void* g, void* dx, int n, int h,
                                  int w, int c, int k, int p, void* stream) {
  return launch((const float*)x, (const float*)y, (const float*)g,
                (float*)dx, n, h, w, c, k, p, (cudaStream_t)stream);
}

extern "C" int maxpool_bwd_s1_bf16(const void* x, const void* y,
                                   const void* g, void* dx, int n, int h,
                                   int w, int c, int k, int p, void* stream) {
  return launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                (const __nv_bfloat16*)g, (__nv_bfloat16*)dx, n, h, w, c, k,
                p, (cudaStream_t)stream);
}
