// int8 GEMM with the per-channel rescale in its epilogue:
//   Y = relu?((X * q^T, f32 accumulation) * scale + bias), cast to X's dtype.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/int8_gemm.py:32
// (_int8_kernel, reached by int8_gemm_rescale :50).  X is (M, K) row-major
// in f32 or bf16 (a fullc input, or a 1x1 conv's NHWC activation with its
// pixels flattened; a strided 1x1 conv subsamples on the host first), q is
// (O, K) row-major int8 codes (the fullc layout; a 1x1 conv's HWIO codes
// are transposed to it once per load), scale is (O,) f32, bias is (O,) f32
// or absent, Y is (M, O) in X's dtype.  The codes are read as int8, one
// byte each, and converted in registers on their way into shared memory:
// exactly, since |code| <= 127 fits bf16's 8-bit mantissa.  X is not int8,
// so the int8 tensor cores do not apply: quantizing X would compute
// another function.
//
// Bound on the H100: bytes.  At the quantized GoogLeNet b128 forward's 11
// launches (M = 128..401408, K = 64..1024, O = 32..1000) the bf16 product
// does 2*K flops per output against about 2*(K + O)/O bytes per output;
// the layers move ~384 MB in all, 0.115 ms at 3.35 TB/s, against ~20
// GFLOP, 0.02 ms on the bf16 tensor cores.
//
// Design (simple and right first), on the tiles of gemm_tiles.cuh:
// * bf16: a 64x64 output tile per 128-thread block, four warps of 32x32
//   issuing mma.sync.m16n8k16 (bf16 in, f32 accumulate) over 32-deep K
//   slices in shared memory.  X rows and q rows are both k-contiguous, so
//   both stage without a transpose; when K is a multiple of 8 each thread
//   moves 8 elements at a time (16 bytes of X, 8 bytes of codes).
// * f32: the same tile with 256 threads, a 4x4 sub-tile of FMAs each over
//   16-deep K slices (no TF32).
// * The epilogue multiplies by the scale and adds the f32 bias as two
//   rounded operations (no FMA contraction, as the plain version computes
//   them), applies relu, and rounds once to X's dtype.
// * Ragged M, K and O are zero-filled on load and masked on store.
// Left for later: wgmma with TMA-fed shared tiles, a multi-stage ring so
// loads overlap the products, and a persistent grid over the output tiles.

#include "gemm_tiles.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void epilogue(T* y, const float* scale,
                                         const float* bias, int m, int o,
                                         int r, int col, float v, int relu) {
  if (r < m && col < o) {
    v = __fmul_rn(v, scale[col]);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    if (relu && v < 0.0f) v = 0.0f;  // NaN passes, as in torch.relu
    store(y + (int64_t)r * o + col, v);
  }
}

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return (float)(int8_t)((word >> (8 * j)) & 0xffu);
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
int8_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int m, int k, int o,
                      int relu, int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];  // [col][k]
  const int tid = threadIdx.x;
  const MmaLane lane;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    if (vec) {  // K % 8 == 0: a chunk of 8 is wholly in range or out
      for (int c = tid; c < BM * BK / 8; c += 128) {
        const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + kk;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < m && gk < k)
          v = *reinterpret_cast<const uint4*>(x + (int64_t)gm * k + gk);
        *reinterpret_cast<uint4*>(&As[r][kk]) = v;
      }
      for (int c = tid; c < BN * BK / 8; c += 128) {
        const int nn = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gn = n0 + nn, gk = k0 + kk;
        uint2 u = make_uint2(0u, 0u);
        if (gn < o && gk < k)
          u = *reinterpret_cast<const uint2*>(q + (int64_t)gn * k + gk);
        uint32_t h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = j < 2 ? u.x : u.y;
          const int b = (2 * j) & 3;
          __nv_bfloat162 p = __floats2bfloat162_rn(code_at(word, b),
                                                   code_at(word, b + 1));
          h[j] = *reinterpret_cast<uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(&Bs[nn][kk]) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
    } else {
      for (int i = tid; i < BM * BK; i += 128) {
        const int r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        As[r][kk] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : zero;
      }
      for (int i = tid; i < BN * BK; i += 128) {
        const int nn = i / BK, kk = i % BK;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[nn][kk] = (gn < o && gk < k)
                         ? __float2bfloat16((float)q[(int64_t)gn * k + gk])
                         : zero;
      }
    }
    __syncthreads();
    mma_tile(As, Bs, acc, lane);
    __syncthreads();
  }
  for_each_mma_acc(acc, m0, n0, lane, [&](int r, int col, float v) {
    epilogue(y, scale, bias, m, o, r, col, v, relu);
  });
}

// ----------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
int8_gemm_f32_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int m, int k, int o, int relu) {
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
    for (int i = tid; i < BN * FBK; i += 256) {
      const int nn = i / FBK, kk = i % FBK;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < o && gk < k) ? (float)q[(int64_t)gn * k + gk] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  for_each_fma_acc(acc, m0, n0, tx, ty, [&](int r, int col, float v) {
    epilogue(y, scale, bias, m, o, r, col, v, relu);
  });
}

}  // namespace

extern "C" int int8_gemm_bf16(const void* x, const void* q,
                              const void* scale, const void* bias, void* y,
                              int m, int k, int o, int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  const int vec = k % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)q % 8 == 0;
  int8_gemm_bf16_kernel<<<grid_for(m, o), 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)y, m, k, o, relu, vec);
  return (int)cudaGetLastError();
}

extern "C" int int8_gemm_f32(const void* x, const void* q, const void* scale,
                             const void* bias, void* y, int m, int k, int o,
                             int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  int8_gemm_f32_kernel<<<grid_for(m, o), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale,
      (const float*)bias, (float*)y, m, k, o, relu);
  return (int)cudaGetLastError();
}
