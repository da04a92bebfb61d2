// Tiles and loads shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile sizes, 8-element vector loads of f32 or bf16
// rows converted to f32, stores in the output dtype, and the two ways a
// tile of rows is staged in shared memory.  The build keys each kernel
// library by its source AND the local headers it includes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int SP = 68;        // pitch of a 64-wide shared tile of p or ds
constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [row0, row0 + R) of a (T, D) slab (row stride st) as f32,
// transposed into dst[d * R + r], zeros past t_end
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src,
                                            long long st, int row0,
                                            int t_end) {
  for (int c = threadIdx.x; c < R * (D / 8); c += kThreads) {
    const int r = c % R, d0 = (c / R) * 8;
    float v[8];
    if (row0 + r < t_end) {
      load8(src + (long long)(row0 + r) * st + d0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(d0 + j) * R + r] = v[j];
  }
}

// the same rows row-major: dst[r * D + d]
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int row0, int t_end) {
  for (int c = threadIdx.x; c < R * (D / 8); c += kThreads) {
    const int r = c / (D / 8), d0 = (c % (D / 8)) * 8;
    float v[8];
    if (row0 + r < t_end) {
      load8(src + (long long)(row0 + r) * st + d0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * D + d0 + j] = v[j];
  }
}

}  // namespace
