// 16-byte channel vectors over NHWC tensors, shared by the max-pool
// kernels' main paths (maxpool_fwd.cu, maxpool_bwd.cu,
// maxpool_bwd_s1.cu): a uint4 holds 8 bf16 or 4 f32 channels of one
// position, read and written whole, and computed on as f32 lanes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// a block's shared memory on the H100, which holds a main path's band
// of window rows
constexpr int SMEM_LIMIT = 232448;

template <typename T>
struct Lanes {
  static constexpr int V = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
// one rounding to the dtype (exact where every lane is a bf16 value)
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return u;
}

// a 16-byte copy from device memory into shared memory that bypasses
// the registers and L1 (cp.async.cg); cp_async_wait() waits for every
// copy this thread issued, and a __syncthreads() after it for the block's
__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// a block stages one channel slice of its rows: at most SLICE vectors
// (128 bytes) of each position, so that its copies and its stores move
// whole 128-byte lines and its band stays narrow
constexpr int SLICE = 8;
inline int slices(int cv) { return (cv + SLICE - 1) / SLICE; }

// the rows of the output a block owns: the most that keep its band,
// band_rows(rows) rows of row_bytes each, within BAND_TARGET (so that at
// least four blocks fit on an SM; at least one row), then spread evenly
// over the blocks of an image
constexpr int64_t BAND_TARGET = 49152;
template <typename BandRows>
int rows_per_block(int out_rows, int64_t row_bytes, BandRows band_rows) {
  int r = 1;
  while (r < out_rows && band_rows(r + 1) * row_bytes <= BAND_TARGET) ++r;
  const int blocks = (out_rows + r - 1) / r;
  return (out_rows + blocks - 1) / blocks;
}

// raise a kernel's dynamic shared memory limit to SMEM_LIMIT, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  done = err == cudaSuccess;
  return err;
}
