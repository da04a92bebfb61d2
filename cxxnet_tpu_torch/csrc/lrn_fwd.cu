// Cross-channel local response normalization forward over (M, C) rows
// (an NHWC tensor's positions by its channels), f32 and bf16 in, f32
// math, output in the input's dtype.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/lrn.py:62 (_fwd_kernel,
// reached by lrn, :119):
//   y[r, c] = x[r, c] * (knorm + a * sum_{d=lo..hi} x[r, c+d]^2)^-beta
// with a = alpha / nsize, lo = -(nsize/2), hi = nsize - 1 - nsize/2 (an
// asymmetric window for even nsize) and zeros past the channel edges.
//
// Bound on the H100: bytes.  Per element the kernel does ~nsize+3
// flops and one power against 4-8 bytes moved; the least traffic is one
// read of x and one write of y: 411 MB over GoogLeNet's two b128 bf16
// launches, 0.123 ms at 3.35 TB/s.  What kept the first kernel (now the
// edge path) at 6x that bound was instruction issue: 2-byte loads and
// stores, a division by C, the window's nsize squares and a powf for
// every element, and a block's loads and arithmetic in turns.
//
// The sums use explicitly rounded multiplies and adds
// (__fmul_rn/__fadd_rn) in the plain version's offset order, so the
// compiler's FMA contraction cannot move them; only the power differs
// from PyTorch's pow, by a few ulp.
//
// The main path (lrn_fwd_vec_kernel, C entries lrn_fwd_f32 and
// lrn_fwd_bf16), for C a multiple of the 16-byte vector (4 f32 or 8
// bf16 channels) of at most 256 vectors, x and y 16-byte aligned, under
// 2^31 elements, and nsize <= 9 (the wrapper's rule,
// ops/lrn.takes_vector; both GoogLeNet launches):
// * one thread per vector of a position, a block of whole positions
//   (threadIdx.x the vector, threadIdx.y the position): one 16-byte
//   load and one 16-byte store a thread, index arithmetic once a vector;
// * each thread squares its own lanes once and publishes the first and
//   last nsize/2 squares in shared memory (lrn_vec.cuh, 8 KB a block at
//   most), and after one barrier reads its halo from its neighbours'
//   (each input is read from device memory once);
// * the window sum over compile-time offsets (one instantiation per
//   nsize), then norm^-beta by one log2 and one exp2 (lrn_vec.cuh), no
//   powf, within 6 ulp of pow;
// * many small blocks (up to eight an SM) keep one block's loads in
//   flight while another computes.
//
// The edge path (lrn_fwd_kernel, C entries lrn_fwd_f32_edge and
// lrn_fwd_bf16_edge), for any C, alignment, size and nsize: one block
// per tile of rows staged in shared memory as f32, one thread per
// element walking its window there, powf.

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
constexpr int kTileElems = 4096;  // 16 KB of f32 staging per block

template <typename T>
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t m, int c, int rows_per_block, int lo,
                               int hi, float a, float knorm, float neg_beta) {
  extern __shared__ float tile[];  // rows_per_block * c
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t rows = m - row0;
  if (rows > rows_per_block) rows = rows_per_block;
  const int n = (int)rows * c;
  const T* xb = x + row0 * c;
  T* yb = y + row0 * c;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = to_f32(xb[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const float* row = tile + (i - ch);
    float acc = 0.0f;
    bool first = true;
    for (int d = lo; d <= hi; ++d) {
      const int cc = ch + d;
      const float v = (cc >= 0 && cc < c) ? row[cc] : 0.0f;
      const float sq = __fmul_rn(v, v);
      acc = first ? sq : __fadd_rn(acc, sq);
      first = false;
    }
    const float norm = __fadd_rn(knorm, __fmul_rn(a, acc));
    store(yb + i, __fmul_rn(row[ch], powf(norm, neg_beta)));
  }
}

template <typename T>
int launch_edge(const T* x, T* y, int64_t m, int c, int nsize,
                float alpha_over_n, float beta, float knorm,
                cudaStream_t stream) {
  if (m == 0 || c == 0) return 0;
  int rows_per_block = kTileElems / c;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = (size_t)rows_per_block * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lrn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  const int lo = -(nsize / 2);
  const int hi = nsize - 1 - nsize / 2;
  lrn_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, m, c, rows_per_block, lo, hi, alpha_over_n, knorm, -beta);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ main path
template <typename T, int N>
__global__ void __launch_bounds__(lrn::BLOCK_VECTORS)
lrn_fwd_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                   int m, int cv, float a, float knorm, float neg_beta) {
  constexpr int V = Lanes<T>::V;
  constexpr int H = lrn::Window<N>::H;
  __shared__ lrn::Halo<H> lo[H ? lrn::BLOCK_VECTORS : 1];
  __shared__ lrn::Halo<H> hi[H ? lrn::BLOCK_VECTORS : 1];
  const int vec = threadIdx.x;  // the vector within its position
  const int pos = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = pos < m;  // a dead thread still meets the barrier
  float f[V];
  unpack(live ? x[pos * cv + vec] : make_uint4(0, 0, 0, 0), f);
  float s[V + 2 * H];  // the squares: H below the vector, V own, H above
#pragma unroll
  for (int i = 0; i < V; ++i) s[H + i] = __fmul_rn(f[i], f[i]);
  if constexpr (H > 0)
    lrn::exchange<V, H>(s, lo, hi, threadIdx.y * cv + vec, vec > 0,
                        vec < cv - 1);
  if (!live) return;
  const bool route = lrn::route_takes(neg_beta);
  float out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float norm = lrn::window_norm<V, N>(s, i, a, knorm);
    const float p = route && lrn::in_route(norm)
                        ? lrn::exp2_pow(norm, neg_beta)
                        : powf(norm, neg_beta);
    out[i] = __fmul_rn(f[i], p);
  }
  y[pos * cv + vec] = pack(out);
}

template <typename T>
int launch_vec(const void* x, void* y, int64_t m, int c, int nsize,
               float alpha_over_n, float beta, float knorm,
               cudaStream_t stream) {
  if (!lrn::takes_vector<T>(m, c, nsize, {x, y}))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || c == 0) return 0;
  const int cv = c / Lanes<T>::V;
  const dim3 block = lrn::block_of(cv);
  const unsigned grid = (unsigned)((m + block.y - 1) / block.y);
  return lrn::with_nsize(nsize, [&](auto n) {
    lrn_fwd_vec_kernel<T, decltype(n)::value><<<grid, block, 0, stream>>>(
        (const uint4*)x, (uint4*)y, (int)m, cv, alpha_over_n, knorm, -beta);
    return (int)cudaGetLastError();
  });
}

}  // namespace

#define LRN_FWD_ARGS                                                    \
  const void *x, void *y, long long m, int c, int nsize,                \
      float alpha_over_n, float beta, float knorm, void *stream
#define LRN_FWD_PASS \
  (int64_t)m, c, nsize, alpha_over_n, beta, knorm, (cudaStream_t)stream

// the main path: C a multiple of 4 (f32) or 8 (bf16) channels, at most
// 256 vectors, nsize <= 9, x and y 16-byte aligned and under 2^31
// elements, else cudaErrorInvalidValue (the wrapper sends those to the
// edge entries)
extern "C" int lrn_fwd_f32(LRN_FWD_ARGS) {
  return launch_vec<float>(x, y, LRN_FWD_PASS);
}

extern "C" int lrn_fwd_bf16(LRN_FWD_ARGS) {
  return launch_vec<__nv_bfloat16>(x, y, LRN_FWD_PASS);
}

// the edge path: any C, alignment, size and nsize
extern "C" int lrn_fwd_f32_edge(LRN_FWD_ARGS) {
  return launch_edge((const float*)x, (float*)y, LRN_FWD_PASS);
}

extern "C" int lrn_fwd_bf16_edge(LRN_FWD_ARGS) {
  return launch_edge((const __nv_bfloat16*)x, (__nv_bfloat16*)y,
                     LRN_FWD_PASS);
}
