// Cross-channel local response normalization backward over (M, C) rows,
// f32 and bf16 in, f32 math, input gradient in the input's dtype.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/lrn.py:70 (_bwd_kernel,
// reached by _lrn_bwd, :134, the backward of lrn).  With
// a = alpha / nsize, the window [c + lo, c + hi] of the forward
// (lo = -(nsize/2), hi = nsize - 1 - nsize/2) and zeros past the edges:
//   norm[c] = knorm + a * sum_{d=lo..hi} x[c+d]^2          (recomputed)
//   t[c]    = g[c] * x[c] * norm[c]^(-beta-1)
//   dx[c]   = g[c] * norm[c]^-beta
//             - (2 a beta) * x[c] * sum_{d=-hi..-lo} t[c+d]
// The second sum runs over the REVERSED window, which for an even
// nsize is asymmetric the other way.
//
// Bound on the H100: bytes.  Per element ~2 nsize + 10 flops and two
// powf against 6-12 bytes moved; the least traffic is one read of x and
// g and one write of dx.
//
// Design: one block per tile of rows, as lrn_fwd.cu.  The tile's x and
// g are staged once in shared memory as f32 (coalesced, channel
// fastest); a first pass writes t for the whole tile into a third
// shared array, and after a barrier a second pass reads each element's
// reversed window of t from shared memory.  The norm is recomputed in
// the second pass rather than kept, as the Pallas kernel recomputes it
// instead of saving it in the forward.  Sums and products use the
// rounded intrinsics (__fmul_rn/__fadd_rn/__fsub_rn) in the plain
// version's order, so the compiler cannot contract them into FMAs; only
// powf may differ from the host's pow by an ulp or two.

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

constexpr int kThreads = 256;
constexpr int kTileElems = 4096;  // 3 x 16 KB of f32 staging per block

// knorm + a * (window sum of squares), summed in offset order
__device__ __forceinline__ float norm_at(const float* row, int ch, int c,
                                         int lo, int hi, float a,
                                         float knorm) {
  float acc = 0.0f;
  bool first = true;
  for (int d = lo; d <= hi; ++d) {
    const int cc = ch + d;
    const float v = (cc >= 0 && cc < c) ? row[cc] : 0.0f;
    const float sq = __fmul_rn(v, v);
    acc = first ? sq : __fadd_rn(acc, sq);
    first = false;
  }
  return __fadd_rn(knorm, __fmul_rn(a, acc));
}

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ g, T* __restrict__ dx,
                               int64_t m, int c, int rows_per_block, int lo,
                               int hi, float a, float knorm, float neg_beta,
                               float coef) {
  extern __shared__ float smem[];  // 3 * rows_per_block * c
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t rows = m - row0;
  if (rows > rows_per_block) rows = rows_per_block;
  const int n = (int)rows * c;
  const int stride = rows_per_block * c;
  float* xs = smem;
  float* gs = smem + stride;
  float* ts = smem + 2 * stride;
  const T* xb = x + row0 * c;
  const T* gb = g + row0 * c;
  T* db = dx + row0 * c;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    xs[i] = to_f32(xb[i]);
    gs[i] = to_f32(gb[i]);
  }
  __syncthreads();
  const float neg_beta_m1 = neg_beta - 1.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const float nm = norm_at(xs + (i - ch), ch, c, lo, hi, a, knorm);
    ts[i] = __fmul_rn(__fmul_rn(gs[i], xs[i]), powf(nm, neg_beta_m1));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const int base = i - ch;
    const float nm = norm_at(xs + base, ch, c, lo, hi, a, knorm);
    float back = 0.0f;
    bool first = true;
    for (int d = -hi; d <= -lo; ++d) {
      const int cc = ch + d;
      const float v = (cc >= 0 && cc < c) ? ts[base + cc] : 0.0f;
      back = first ? v : __fadd_rn(back, v);
      first = false;
    }
    const float lhs = __fmul_rn(gs[i], powf(nm, neg_beta));
    const float rhs = __fmul_rn(__fmul_rn(coef, xs[i]), back);
    store(db + i, __fsub_rn(lhs, rhs));
  }
}

template <typename T>
int launch(const T* x, const T* g, T* dx, int64_t m, int c, int nsize,
           float alpha_over_n, float beta, float knorm, float coef,
           cudaStream_t stream) {
  if (m == 0 || c == 0) return 0;
  int rows_per_block = kTileElems / c;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = (size_t)3 * rows_per_block * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lrn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  const int lo = -(nsize / 2);
  const int hi = nsize - 1 - nsize / 2;
  lrn_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, g, dx, m, c, rows_per_block, lo, hi, alpha_over_n, knorm, -beta,
      coef);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lrn_bwd_f32(const void* x, const void* g, void* dx,
                           long long m, int c, int nsize, float alpha_over_n,
                           float beta, float knorm, float coef,
                           void* stream) {
  return launch((const float*)x, (const float*)g, (float*)dx, (int64_t)m, c,
                nsize, alpha_over_n, beta, knorm, coef,
                (cudaStream_t)stream);
}

extern "C" int lrn_bwd_bf16(const void* x, const void* g, void* dx,
                            long long m, int c, int nsize, float alpha_over_n,
                            float beta, float knorm, float coef,
                            void* stream) {
  return launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
                (__nv_bfloat16*)dx, (int64_t)m, c, nsize, alpha_over_n, beta,
                knorm, coef, (cudaStream_t)stream);
}
