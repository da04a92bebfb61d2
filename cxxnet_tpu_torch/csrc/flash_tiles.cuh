// Tiles, loads and tensor-core fragments shared by the flash-attention
// kernels (flash_fwd.cu, flash_bwd.cu).  The build keys each kernel
// library by its source AND the local headers it includes.
//
// * f32 (the scalar kernels): the tile sizes, 8-element vector loads of
//   f32 rows, and the two ways a tile of rows is staged in shared memory
//   as f32.
// * bf16 (the tensor-core kernels): 64-row tiles of bf16 rows copied to
//   shared memory by 16-byte cp.async (rows past the end zero-filled),
//   at a pitch of D + 8 elements so that the 8 row addresses of one
//   ldmatrix fall in 8 different 16-byte bank groups; ldmatrix (plain and
//   .trans) into mma.sync.m16n8k16 bf16 fragments; the mma itself with
//   f32 accumulation.  Fragment layouts (PTX ISA, m16n8k16, g = lane / 4,
//   t = lane % 4): A regs {row g, row g+8} x {cols 2t, 2t+1 | 2t+8, 2t+9};
//   B regs {k 2t, 2t+1 | 2t+8, 2t+9} at col g; C/D {row g | row g+8} x
//   cols {2t, 2t+1}.  Two C tiles side by side (n = 16) are therefore one
//   A fragment once packed to bf16: P and dS go from the score
//   accumulators straight into the next product without shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int SP = 68;        // pitch of a 64-wide shared tile of p or ds
constexpr int kThreads = 256; // the scalar kernels' block
constexpr int kMmaThreads = 128;  // the tensor-core kernels' block: 4 warps
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// rows [row0, row0 + R) of a (T, D) slab (row stride st) as f32,
// transposed into dst[d * R + r], zeros past t_end
template <int D, int R>
__device__ __forceinline__ void load_tile_t(float* dst, const float* src,
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
template <int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
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

// ----------------------------------------------------------------------
// bf16 tensor-core tiles

// elements per shared row of a bf16 tile: D plus 16 bytes of pad
template <int D>
__host__ __device__ constexpr int pitch() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !in (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared, or a zero when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + 64) of a (T, D) bf16 slab (row stride st elements)
// into dst[r * pitch + d], zeros past t_end; 16-byte copies, so st and
// the slab's base must be 16-byte aligned (the wrapper checks)
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long st, int row0,
                                                int t_end) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CH; c += kMmaThreads) {
    const int r = c / CH, ch = c % CH;
    const bool in = row0 + r < t_end;
    cp_async16(dst + r * pitch<D>() + ch * 8,
               in ? src + (long long)(row0 + r) * st + ch * 8 : src, in);
  }
}

// 64 f32 of one (b, h) row of lse or dl from position row0, zeros past
// t_end (threads 0..63 copy one value each)
__device__ __forceinline__ void load_row_async(float* dst, const float* src,
                                               int row0, int t_end) {
  const int i = threadIdx.x;
  if (i < 64) {
    const bool in = row0 + i < t_end;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16-row x 16-column slice of f32 accumulators held
// as two n8 tiles c0 (columns 0..7) and c1 (8..15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a
// row-major shared tile of pitch P.
template <int P>
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const bf16* tile,
                                           int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}

// B fragments for X . Y^T with Y stored row-major [n][k]: rows (n)
// [n0, n0 + 16), columns (k) [k0, k0 + 16).  b[0], b[1] are the n8 tile
// at n0, b[2], b[3] the one at n0 + 8.
template <int P>
__device__ __forceinline__ void ldmatrix_b(uint32_t (&b)[4], const bf16* tile,
                                           int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments for X . Y with Y stored row-major [k][n]: rows (k)
// [k0, k0 + 16), columns (n) [n0, n0 + 16), transposed on the way.
// b[0], b[1] are the n8 tile at n0, b[2], b[3] the one at n0 + 8.
template <int P>
__device__ __forceinline__ void ldmatrix_bt(uint32_t (&b)[4], const bf16* tile,
                                            int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                           n0 + (lane >> 4) * 8);
}

}  // namespace
