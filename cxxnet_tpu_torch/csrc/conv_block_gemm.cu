// Fused sibling-1x1 conv block: Y = relu?(X * W + bias), f32 and bf16.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/conv_block.py:41
// (_gemm_bias_kernel, reached by fused_block_gemm :54 and
// conv1x1_block :100).  X is (M, K) row-major (the NHWC activation with
// its pixels flattened; a strided 1x1 conv subsamples on the host
// first), W is (K, O) row-major (the group's 1x1 HWIO kernels
// concatenated on O), bias is (O,) or absent, Y is (M, O) in X's dtype.
// Accumulation is f32; the bias is added and the optional relu applied
// in the epilogue, so the product tile is written to device memory once.
//
// Bound on the H100: at GoogLeNet's b128 shapes (M = 6272..100352,
// K = 192..832, O = 176..624) the bf16 product does 2*K ~ 400-1700 flops
// per output against ~2*(K+O)/O bytes, which puts the largest-K groups
// near the bf16 tensor-core balance and the others on the memory side;
// in f32 (CUDA-core FMAs, no TF32) every shape is bound by operations.
//
// Design (simple and right first; wgmma and TMA come later), with the
// tiles of gemm_tiles.cuh:
// * bf16: 64x64 output tile per 128-thread block, four warps of 32x32,
//   each issuing mma.sync.m16n8k16 (bf16 in, f32 accumulate) over
//   32-deep K slices staged in shared memory.  X is staged row-major
//   (k contiguous) and W transposed to n-major (k contiguous) so that
//   every A and B fragment register is one aligned 32-bit shared load.
// * f32: the same 64x64 tile with 256 threads, each accumulating a 4x4
//   sub-tile with FMAs over 16-deep K slices.
// * Ragged M, O and K (176, 296, 624 are not multiples of 64) are
//   handled by zero-filling out-of-range tile elements on load and
//   masking the epilogue's stores.

#include "gemm_tiles.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void epilogue(T* y, const T* bias, int m, int o,
                                         int r, int col, float v, int relu) {
  if (r < m && col < o) {
    if (bias != nullptr) v += to_f32(bias[col]);
    if (relu && v < 0.0f) v = 0.0f;  // NaN passes, as in torch.relu
    store(y + (int64_t)r * o + col, v);
  }
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, int m, int k, int o,
                 int relu) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];  // [col][k]
  const int tid = threadIdx.x;
  const MmaLane lane;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 128) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[r][kk] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += 128) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[nn][kk] = (gk < k && gn < o) ? w[(int64_t)gk * o + gn] : zero;
    }
    __syncthreads();
    mma_tile(As, Bs, acc, lane);
    __syncthreads();
  }
  for_each_mma_acc(acc, m0, n0, lane, [&](int r, int col, float v) {
    epilogue(y, bias, m, o, r, col, v, relu);
  });
}

// ----------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int m,
                int k, int o, int relu) {
  __shared__ float As[FBK][BM + 4];  // [k][row]
  __shared__ float Bs[FBK][BN + 4];  // [k][col]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += FBK) {
    for (int i = tid; i < BM * FBK; i += 256) {
      const int r = i / FBK, kk = i % FBK;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : 0.0f;
    }
    for (int i = tid; i < FBK * BN; i += 256) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < k && gn < o) ? w[(int64_t)gk * o + gn] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  for_each_fma_acc(acc, m0, n0, tx, ty, [&](int r, int col, float v) {
    epilogue(y, bias, m, o, r, col, v, relu);
  });
}

}  // namespace

extern "C" int conv_block_gemm_bf16(const void* x, const void* w,
                                    const void* bias, void* y, int m, int k,
                                    int o, int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  gemm_bf16_kernel<<<grid_for(m, o), 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, m, k, o, relu);
  return (int)cudaGetLastError();
}

extern "C" int conv_block_gemm_f32(const void* x, const void* w,
                                   const void* bias, void* y, int m, int k,
                                   int o, int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  gemm_f32_kernel<<<grid_for(m, o), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y, m, k,
      o, relu);
  return (int)cudaGetLastError();
}
