// Tiles shared by the GEMM kernels with an epilogue (conv_block_gemm.cu,
// int8_gemm.cu): a 64x64 output tile per block, in bf16 as four warps of
// 32x32 issuing mma.sync.m16n8k16 (bf16 in, f32 accumulate) over 32-deep
// K slices, in f32 as 256 threads each holding a 4x4 sub-tile of FMAs
// over 16-deep K slices.  The kernels stage their operands into the
// shared tiles below (zeros past M, O and K) and each writes its own
// epilogue through the for_each_* loops.  The build keys each kernel
// library by its source AND the local headers it includes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, PAD = 8;  // bf16 tile
constexpr int FBK = 16;                            // f32 K slice

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tile [row][k] and B tile [col][k] (k contiguous), so that every A and
// B fragment register is one aligned 32-bit shared load
typedef __nv_bfloat16 TileRow[BK + PAD];

// the 128-thread block's lane roles: warp (wm, wn) owns the 32x32 patch
// at (wm * 32, wn * 32); g / t are the mma groupID / thread-in-group
struct MmaLane {
  int g, t, wm, wn;
  __device__ __forceinline__ MmaLane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wm = warp >> 1;
    wn = warp & 1;
  }
};

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// one BK-deep slice of the staged tiles into the warp's accumulators
__device__ __forceinline__ void mma_tile(const TileRow* As, const TileRow* Bs,
                                         float (&acc)[2][4][4],
                                         const MmaLane& l) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rb = l.wm * 32 + mi * 16;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[rb + l.g][ks + 2 * l.t]);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[rb + l.g + 8][ks + 2 * l.t]);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[rb + l.g][ks + 2 * l.t + 8]);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[rb + l.g + 8][ks + 2 * l.t + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cb = l.wn * 32 + ni * 8;
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cb + l.g][ks + 2 * l.t]);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cb + l.g][ks + 2 * l.t + 8]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni]);
  }
}

// f(row, col, value) for each accumulator of the warp's patch
template <typename F>
__device__ __forceinline__ void for_each_mma_acc(const float (&acc)[2][4][4],
                                                 int m0, int n0,
                                                 const MmaLane& l, F f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + l.wm * 32 + mi * 16 + l.g;
      const int col = n0 + l.wn * 32 + ni * 8 + 2 * l.t;
      f(r, col, acc[mi][ni][0]);
      f(r, col + 1, acc[mi][ni][1]);
      f(r + 8, col, acc[mi][ni][2]);
      f(r + 8, col + 1, acc[mi][ni][3]);
    }
}

// f32: A tile [k][row], B tile [k][col]; thread (tx, ty) = (tid % 16,
// tid / 16) owns rows ty + 16 i and cols tx + 16 j
__device__ __forceinline__ void fma_tile(const float (*As)[BM + 4],
                                         const float (*Bs)[BN + 4],
                                         float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < FBK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename F>
__device__ __forceinline__ void for_each_fma_acc(const float (&acc)[4][4],
                                                 int m0, int n0, int tx,
                                                 int ty, F f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f(m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

dim3 grid_for(int m, int o) {
  return dim3((unsigned)((o + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
}

// gridDim.y is at most 65535: M up to 65535 * 64 rows in one launch
bool grid_ok(int m) { return (m + BM - 1) / BM <= 65535; }

}  // namespace
