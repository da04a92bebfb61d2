// Cross-channel local response normalization backward over (M, C) rows
// (an NHWC tensor's positions by its channels), f32 and bf16 in, f32
// math, input gradient in the input's dtype.
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
// nsize is asymmetric the other way.  The norm is recomputed rather
// than saved, as the Pallas kernel does: saving it would add its bytes
// to every step.
//
// Bound on the H100: bytes.  Per element ~2 nsize + 10 flops and one
// power against 6-12 bytes moved; the least traffic is one read of x
// and g and one write of dx: 617 MB over GoogLeNet's two b128 bf16
// launches, 0.184 ms at 3.35 TB/s.  What kept the first kernel (now
// the edge path) at 10x that bound was instruction issue (2-byte
// accesses, two divisions by C, the norm and a powf twice an element)
// and its 48 KB of shared memory a block (three f32 tiles).
//
// Sums and products use the rounded intrinsics
// (__fmul_rn/__fadd_rn/__fsub_rn) in the plain version's order, so the
// compiler cannot contract them into FMAs; only the power differs from
// PyTorch's pow, by a few ulp.
//
// The main path (lrn_bwd_vec_kernel, C entries lrn_bwd_f32 and
// lrn_bwd_bf16), for C a multiple of the 16-byte vector (4 f32 or 8
// bf16 channels) of at most 256 vectors, x, g and dx 16-byte aligned,
// under 2^31 elements, and nsize <= 9 (the wrapper's rule,
// ops/lrn.takes_vector; both GoogLeNet launches):
// * one thread per vector of a position, a block of whole positions, as
//   lrn_fwd.cu: one 16-byte load of x and one of g, one 16-byte store
//   of dx a thread, index arithmetic once a vector;
// * the squares' halo through shared memory (lrn_vec.cuh), then the
//   norm once an element, p = norm^-beta by one log2 and one exp2
//   (lrn_vec.cuh, within 6 ulp of pow) and norm^(-beta-1) as p times
//   norm's reciprocal: one power an element, no powf (but where the
//   norm is outside [2^-124, 2^124] or beta outside (0, 1]);
// * t's halo, which the reversed window needs, through shared memory
//   again after a second barrier: 16 KB a block at most (four arrays of
//   256 x nsize/2 floats), where the first kernel staged 48 KB;
// * many small blocks keep one block's loads in flight while another
//   computes.
//
// The edge path (lrn_bwd_kernel, C entries lrn_bwd_f32_edge and
// lrn_bwd_bf16_edge), for any C, alignment, size and nsize: one block
// per tile of rows, x, g and t staged in shared memory as f32, one
// thread per element, the norm and powf twice an element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "channel_vec.cuh"
#include "lrn_vec.cuh"

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
int launch_edge(const T* x, const T* g, T* dx, int64_t m, int c, int nsize,
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

// ------------------------------------------------------------ main path
template <typename T, int N>
__global__ void __launch_bounds__(lrn::BLOCK_VECTORS)
lrn_bwd_vec_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                   uint4* __restrict__ dx, int m, int cv, float a,
                   float knorm, float neg_beta, float coef) {
  constexpr int V = Lanes<T>::V;
  using W = lrn::Window<N>;
  constexpr int H = W::H;
  constexpr int S = H ? lrn::BLOCK_VECTORS : 1;
  __shared__ lrn::Halo<H> sq_lo[S], sq_hi[S], t_lo[S], t_hi[S];
  const int vec = threadIdx.x;  // the vector within its position
  const int pos = blockIdx.x * blockDim.y + threadIdx.y;
  const int slot = threadIdx.y * cv + vec;
  const bool live = pos < m;  // a dead thread still meets the barriers
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float xf[V], gf[V];
  unpack(live ? x[pos * cv + vec] : zero, xf);
  unpack(live ? g[pos * cv + vec] : zero, gf);
  float s[V + 2 * H];  // squares, then t: H below the vector, V own, H above
#pragma unroll
  for (int i = 0; i < V; ++i) s[H + i] = __fmul_rn(xf[i], xf[i]);
  if constexpr (H > 0)
    lrn::exchange<V, H>(s, sq_lo, sq_hi, slot, vec > 0, vec < cv - 1);
  const bool route = lrn::route_takes(neg_beta);
  // what dx needs past the second barrier: g p and coef x (two arrays
  // live across it, not x, g and p)
  float gp[V], cx[V], t[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float norm = lrn::window_norm<V, N>(s, i, a, knorm);
    float p, q;  // norm^-beta, norm^(-beta-1)
    if (route && lrn::in_route(norm)) {
      p = lrn::exp2_pow(norm, neg_beta);
      q = __fmul_rn(p, lrn::recip(norm));
    } else {
      p = powf(norm, neg_beta);
      q = powf(norm, neg_beta - 1.0f);
    }
    gp[i] = __fmul_rn(gf[i], p);
    cx[i] = __fmul_rn(coef, xf[i]);
    t[i] = __fmul_rn(__fmul_rn(gf[i], xf[i]), q);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s[H + i] = t[i];
  if constexpr (H > 0)
    lrn::exchange<V, H>(s, t_lo, t_hi, slot, vec > 0, vec < cv - 1);
  if (!live) return;
  float out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float back = s[H + i - W::HI];  // the reversed window, -hi .. -lo
#pragma unroll
    for (int d = -W::HI + 1; d <= -W::LO; ++d)
      back = __fadd_rn(back, s[H + i + d]);
    out[i] = __fsub_rn(gp[i], __fmul_rn(cx[i], back));
  }
  dx[pos * cv + vec] = pack(out);
}

template <typename T>
int launch_vec(const void* x, const void* g, void* dx, int64_t m, int c,
               int nsize, float alpha_over_n, float beta, float knorm,
               float coef, cudaStream_t stream) {
  if (!lrn::takes_vector<T>(m, c, nsize, {x, g, dx}))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || c == 0) return 0;
  const int cv = c / Lanes<T>::V;
  const dim3 block = lrn::block_of(cv);
  const unsigned grid = (unsigned)((m + block.y - 1) / block.y);
  return lrn::with_nsize(nsize, [&](auto n) {
    lrn_bwd_vec_kernel<T, decltype(n)::value><<<grid, block, 0, stream>>>(
        (const uint4*)x, (const uint4*)g, (uint4*)dx, (int)m, cv,
        alpha_over_n, knorm, -beta, coef);
    return (int)cudaGetLastError();
  });
}

}  // namespace

#define LRN_BWD_ARGS                                                    \
  const void *x, const void *g, void *dx, long long m, int c, int nsize, \
      float alpha_over_n, float beta, float knorm, float coef,          \
      void *stream
#define LRN_BWD_PASS                                                    \
  (int64_t)m, c, nsize, alpha_over_n, beta, knorm, coef,                \
      (cudaStream_t)stream

// the main path: C a multiple of 4 (f32) or 8 (bf16) channels, at most
// 256 vectors, nsize <= 9, x, g and dx 16-byte aligned and under 2^31
// elements, else cudaErrorInvalidValue (the wrapper sends those to the
// edge entries)
extern "C" int lrn_bwd_f32(LRN_BWD_ARGS) {
  return launch_vec<float>(x, g, dx, LRN_BWD_PASS);
}

extern "C" int lrn_bwd_bf16(LRN_BWD_ARGS) {
  return launch_vec<__nv_bfloat16>(x, g, dx, LRN_BWD_PASS);
}

// the edge path: any C, alignment, size and nsize
extern "C" int lrn_bwd_f32_edge(LRN_BWD_ARGS) {
  return launch_edge((const float*)x, (const float*)g, (float*)dx,
                     LRN_BWD_PASS);
}

extern "C" int lrn_bwd_bf16_edge(LRN_BWD_ARGS) {
  return launch_edge((const __nv_bfloat16*)x, (const __nv_bfloat16*)g,
                     (__nv_bfloat16*)dx, LRN_BWD_PASS);
}
