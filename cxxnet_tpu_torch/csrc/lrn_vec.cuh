// The LRN kernels' main path (lrn_fwd.cu, lrn_bwd.cu): one thread per
// 16-byte channel vector of a position (channel_vec.cuh), the window's
// halo from the neighbouring vectors of the same position through
// shared memory, and norm^e by one log2 and one exp2.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "channel_vec.cuh"

namespace lrn {

// a block holds whole positions, at most BLOCK_VECTORS vectors of them
// (C up to 2048 bf16 or 1024 f32 channels)
constexpr int BLOCK_VECTORS = 256;
// the largest window the main path is instantiated for: a halo of
// nsize / 2 <= 4 channels a side, within one neighbouring vector
constexpr int MAX_NSIZE = 9;

// the window [c + LO, c + HI] of nsize N, asymmetric for an even N
template <int N>
struct Window {
  static constexpr int H = N / 2;  // halo: channels a side at most
  static constexpr int LO = -H;
  static constexpr int HI = N - 1 - H;
};

// the H lanes a thread publishes at one end of its vector; aligned so
// that a warp's stores and loads move whole 8- or 16-byte words (no
// bank conflicts; H = 3 has an odd stride of words)
template <int H>
struct alignas(H == 2 ? 8 : H == 4 ? 16 : 4) Halo {
  float v[H > 0 ? H : 1];
};

// norm^e by one log2 and one exp2 (MUFU lg2 and ex2), where the general
// powf costs dozens of instructions.  exp2(e * __log2f(norm)) alone is
// 20+ ulp off for norms far from 1 (__log2f is good to 2 ulp of its
// result, which e then scales), so the route keeps log2's integer part
// exact: norm = m 2^k with m in [1, 2) from its bits, e k split exactly
// (fmaf) into an integer i and a remainder, and
//   norm^e = 2^i * exp2(remainder + e log2(m)),   |exponent| < 1.5,
// where lg2.approx errs by at most 2^-22 absolutely over m in [1, 2)
// and ex2.approx by 2 ulp: within 6 ulp of pow at those worst errors
// (tests/test_torch_lrn.py bounds the route on the CPU).  The integer
// parts go through float adds of 1.5 * 2^23 and integer adds to the
// exponent bits, not through the slower conversion instructions.
//
// It serves 0 < |e| <= 1 (route_takes, once a launch) and norms in
// [2^-124, 2^124] (in_route: |i| <= 124, so 2^i * exp2(...) stays a
// normal number); every other norm (0, -0, inf, NaN, below 0, or out of
// that range) takes powf, so that inf and NaN fall where the plain
// version's pow puts them.  Norms with knorm = 1 (GoogLeNet's, AlexNet's)
// never do.
__device__ __forceinline__ bool route_takes(float e) {
  return e != 0.0f && fabsf(e) <= 1.0f;
}
__device__ __forceinline__ bool in_route(float norm) {
  return norm >= 0x1p-124f && norm <= 0x1p124f;
}
__device__ __forceinline__ float exp2_pow(float norm, float e) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23: adds round to int
  const int bits = __float_as_int(norm);
  // k = the biased exponent - 127, exactly: 2^23 + biased - (2^23 + 127)
  const float k = __fsub_rn(__int_as_float(0x4b000000 | (bits >> 23)),
                            8388735.0f);
  const float m = __int_as_float((bits & 0x007fffff) | 0x3f800000);
  float lg, ex;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(m));
  const float ek = __fmul_rn(e, k);
  const float ek_lo = fmaf(e, k, -ek);  // e k - ek, exactly
  const float r = __fadd_rn(ek, kRound);  // i + 1.5 * 2^23
  const float rest = __fadd_rn(__fsub_rn(ek, __fsub_rn(r, kRound)),
                               fmaf(e, lg, ek_lo));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(ex) : "f"(rest));
  const int i = __float_as_int(r) - __float_as_int(kRound);
  return __int_as_float(__float_as_int(ex) + i * (1 << 23));
}
// 1 / norm by MUFU rcp (1 ulp), for a norm in_route
__device__ __forceinline__ float recip(float norm) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(norm));
  return r;
}

// knorm + a * sum_{d=LO..HI} s[i+d] for lane i, the squares added in
// offset order with rounded intrinsics, as the plain version adds them;
// s holds H values below the vector, its V own, H above
template <int V, int N>
__device__ __forceinline__ float window_norm(
    const float (&s)[V + 2 * Window<N>::H], int i, float a, float knorm) {
  using W = Window<N>;
  float acc = s[W::H + i + W::LO];
#pragma unroll
  for (int d = W::LO + 1; d <= W::HI; ++d)
    acc = __fadd_rn(acc, s[W::H + i + d]);
  return __fadd_rn(knorm, __fmul_rn(a, acc));
}

// the halo of e (H values below the vector, its V own, H above): each
// thread publishes its first and last H values at its slot, and after a
// barrier takes the last H of the vector below and the first H of the
// one above, zeros past the position's first and last vector (the plain
// version's zero padding; adding a zero changes no sum)
template <int V, int H>
__device__ __forceinline__ void exchange(float (&e)[V + 2 * H],
                                         Halo<H>* lo, Halo<H>* hi, int slot,
                                         bool below, bool above) {
  Halo<H> a, b;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    a.v[j] = e[H + j];
    b.v[j] = e[V + j];
  }
  lo[slot] = a;
  hi[slot] = b;
  __syncthreads();
  Halo<H> l = {}, r = {};
  if (below) l = hi[slot - 1];
  if (above) r = lo[slot + 1];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    e[j] = l.v[j];
    e[V + H + j] = r.v[j];
  }
}

// the main path's C-side check of the wrapper's rule (ops/lrn.py
// takes_vector): C a multiple of the vector, at most BLOCK_VECTORS
// vectors, nsize within MAX_NSIZE, the operands 16-byte aligned and
// under 2^31 elements
template <typename T>
bool takes_vector(int64_t m, int c, int nsize,
                  std::initializer_list<const void*> operands) {
  constexpr int V = Lanes<T>::V;
  bool ok = c % V == 0 && c / V <= BLOCK_VECTORS && nsize >= 1 &&
            nsize <= MAX_NSIZE && m * c < ((int64_t)1 << 31);
  for (const void* p : operands) ok = ok && aligned16(p);
  return ok;
}

// the block: the vectors of BLOCK_VECTORS / cv whole positions
inline dim3 block_of(int cv) { return dim3(cv, BLOCK_VECTORS / cv); }

// f(std::integral_constant<int, nsize>) for nsize in 1..MAX_NSIZE
template <typename F>
int with_nsize(int nsize, F f) {
  switch (nsize) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    case 9: return f(std::integral_constant<int, 9>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace lrn
