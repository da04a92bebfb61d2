// Flash-attention backward over (B, T, H, D) tensors, f32 and bf16 in,
// f32 sums, dQ/dK/dV in the input dtype.  One C entry launches the two
// kernels: dQ, then dK and dV.
//
// Replaces the Pallas kernels cxxnet_tpu/ops/flash.py:126 (_dq_kernel)
// and :171 (_dkv_kernel), launched by _flash_bwd_raw (:294).  From q, k,
// v, dO, the forward's per-row lse and dl = delta - dlse (delta_i =
// sum_d dO_id O_id, computed outside the kernels; dlse is the LSE
// cotangent of flash_mha_lse, 0 for flash_mha):
//   p_ij  = exp(s_ij - lse_i), 0 where key j is masked
//   ds_ij = p_ij * (dO_i . v_j - dl_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_i ds_ij q_i,     dv_j = sum_i p_ij dO_i
// In bf16 the three gradient products take p and ds rounded to bf16
// (the tensor cores' operand type, as the library backward does; the
// Pallas kernels keep them f32); in f32 nothing is rounded.
//
// Bound on the H100: operations.  A causal layer at (8, 2048, 8, 64)
// needs at least five products of B*H*T*T*D/2 multiply-adds each (s and
// dO.v to rebuild p and ds, then dq, dk and dv): 85.9 GFLOP, against
// about 0.1 GB moved, 0.087 ms at the 989 TFLOP/s bf16 tensor-core rate.
// These kernels run seven such products (the dK/dV kernel rebuilds s and
// dO.v again rather than share them through device memory: dS would be
// 268 MB a launch at that shape, or f32 atomics).
//
// No atomics: every output element is summed by one thread in a fixed
// order, so the result is deterministic (the TPU kernels get the same by
// running their reduction axis sequentially).
//
// bf16: the tensor cores (flash_dq_mma_kernel, flash_dkv_mma_kernel),
// mma.sync m16n8k16 bf16 -> f32, 128 threads, 4 warps, shared rows
// padded to D + 8 elements for conflict-free ldmatrix, tiles streamed by
// 16-byte cp.async into a double buffer (tile j + 1 in flight while tile
// j computes), masks applied only to tiles that cross the diagonal or a
// ragged edge, and the accumulator of one product packed to bf16 in
// registers as the A operand of the next (flash_tiles.cuh).
// * dQ: a block owns 64 query rows of one (b, h), a warp 16; Q and dO
//   stay in registers as A fragments; per live 64-key tile, in halves of
//   32 keys: S = Q K^T and dP = dO V^T (K, V by ldmatrix), P and dS in
//   registers, dQ += dS K (K by ldmatrix.trans).  Query tiles launch
//   longest-first.
// * dK/dV: a block owns 64 keys, a warp 16; K and V stay in registers as
//   A fragments; per live 64-row query tile (Q, dO, lse and dl through
//   the double buffer), in halves of 32 rows: S^T = K Q^T and dP^T =
//   V dO^T, P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q (dO
//   and Q by ldmatrix.trans); scale applied to dK once at the end.
//
// f32: the scalar kernels (flash_dq_kernel, flash_dkv_kernel), f32 FMAs
// on the CUDA cores, so that f32 keeps f32 products (no TF32).
// * dQ: one block per 64 query rows of one (b, h), looping over the
//   live 64-key tiles (future tiles skipped, as _live does).  Per tile
//   each of 256 threads computes a 4x4 patch of s and of dO.v from
//   float4 reads of q, dO, k, v staged transposed ([d][row]); ds goes
//   to shared memory as [key][row]; then each thread accumulates a
//   4 x D/16 patch of dq from float4 reads of ds and row-major k.
// * dK/dV: one block per 64 keys, looping over the live 64-row query
//   tiles; the same two patches transposed ([key][row]), p and ds kept
//   as [row][key], then 4 x D/16 patches of dk and dv from row-major q
//   and dO.
//
// Rows past T and keys past Tk load as zeros and are masked, so any T
// is served.  Element strides come from the wrapper (the fused qkv
// slices are read in place).

#include <math.h>

#include "flash_tiles.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B*H, Tq)
  const float* dl;   // (B*H, Tq): delta - dlse
  void* dq;          // (B, Tq, H, D) contiguous
  void* dk;          // (B, Tk, H, D) contiguous
  void* dv;
  int H, Tq, Tk;
  long long qs[3], ks[3], vs[3], os[3];  // (b, t, h) element strides
  int q_off, k_off, causal;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  return qi < a.Tq && kj < a.Tk &&
         (!a.causal || (long long)a.q_off + qi >= (long long)a.k_off + kj);
}

// two 4x4 patches at once: x . y over d for x rows xr*4+i, y rows yr*4+j
// (s from q, k) and u . w (dO . v), all staged [d][row] with 64 rows
template <int D>
__device__ __forceinline__ void two_patches(const float* xT, const float* yT,
                                            const float* uT, const float* wT,
                                            int xr, int yr, float (&s)[4][4],
                                            float (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(xT + d * 64 + xr * 4);
    const float4 b = *reinterpret_cast<const float4*>(yT + d * 64 + yr * 4);
    const float4 c = *reinterpret_cast<const float4*>(uT + d * 64 + xr * 4);
    const float4 e = *reinterpret_cast<const float4*>(wT + d * 64 + yr * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
    const float cv[4] = {c.x, c.y, c.z, c.w}, ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        p[i][j] = fmaf(cv[i], ev[j], p[i][j]);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int C = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][BQ]
  float* doT = qT + D * BQ;     // [D][BQ]
  float* kT = doT + D * BQ;     // [D][BK]
  float* vT = kT + D * BK;      // [D][BK]
  float* ks = vT + D * BK;      // [BK][D]
  float* dsT = ks + BK * D;     // [BK][SP]
  float* lse_s = dsT + BK * SP; // [BQ]
  float* dl_s = lse_s + BQ;     // [BQ]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = (const float*)a.q + b * a.qs[0] + h * a.qs[2];
  const float* kb = (const float*)a.k + b * a.ks[0] + h * a.ks[2];
  const float* vb = (const float*)a.v + b * a.vs[0] + h * a.vs[2];
  const float* ob = (const float*)a.dout + b * a.os[0] + h * a.os[2];

  load_tile_t<D, BQ>(qT, qb, a.qs[1], q0, a.Tq);
  load_tile_t<D, BQ>(doT, ob, a.os[1], q0, a.Tq);
  if (tid < BQ) {
    const bool in = q0 + tid < a.Tq;
    lse_s[tid] = in ? a.lse[(long long)bh * a.Tq + q0 + tid] : 0.0f;
    dl_s[tid] = in ? a.dl[(long long)bh * a.Tq + q0 + tid] : 0.0f;
  }
  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;

  const long long q_last = (long long)a.q_off + min(q0 + BQ, a.Tq) - 1;
  const int nk = (a.Tk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    if (a.causal && q_last < (long long)a.k_off + k0) break;
    __syncthreads();
    load_tile_t<D, BK>(kT, kb, a.ks[1], k0, a.Tk);
    load_tile_t<D, BK>(vT, vb, a.vs[1], k0, a.Tk);
    load_tile<D, BK>(ks, kb, a.ks[1], k0, a.Tk);
    __syncthreads();

    float s[4][4], dp[4][4];  // rows ty*4+i, keys tx*4+j
    two_patches<D>(qT, kT, doT, vT, ty, tx, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float p = visible(a, q0 + r, k0 + tx * 4 + j)
                            ? expf(__fmul_rn(s[i][j], a.scale) - lse_s[r])
                            : 0.0f;
        out[i] = p * (dp[i][j] - dl_s[r]);
      }
      *reinterpret_cast<float4*>(dsT + (tx * 4 + j) * SP + ty * 4) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d4 = *reinterpret_cast<const float4*>(dsT + kk * SP + ty * 4);
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
      float kv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = ks[kk * D + tx * C + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(dv4[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= a.Tq) continue;
    float* row = (float*)a.dq + (((long long)b * a.Tq + q0 + r) * a.H + h) * D + tx * C;
#pragma unroll
    for (int j = 0; j < C; ++j) row[j] = acc[i][j] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int C = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;              // [D][BK]
  float* vT = kT + D * BK;       // [D][BK]
  float* qT = vT + D * BK;       // [D][BQ]
  float* doT = qT + D * BQ;      // [D][BQ]
  float* qs = doT + D * BQ;      // [BQ][D]
  float* dos = qs + BQ * D;      // [BQ][D]
  float* p_s = dos + BQ * D;     // [BQ][SP]
  float* ds_s = p_s + BQ * SP;   // [BQ][SP]
  float* lse_s = ds_s + BQ * SP; // [BQ]
  float* dl_s = lse_s + BQ;      // [BQ]

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = (const float*)a.q + b * a.qs[0] + h * a.qs[2];
  const float* kb = (const float*)a.k + b * a.ks[0] + h * a.ks[2];
  const float* vb = (const float*)a.v + b * a.vs[0] + h * a.vs[2];
  const float* ob = (const float*)a.dout + b * a.os[0] + h * a.os[2];

  load_tile_t<D, BK>(kT, kb, a.ks[1], k0, a.Tk);
  load_tile_t<D, BK>(vT, vb, a.vs[1], k0, a.Tk);
  float acc_k[4][C], acc_v[4][C];  // keys ty*4+i, columns tx*C+j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  const int nq = (a.Tq + BQ - 1) / BQ;
  for (int iq = 0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    const long long q_last = (long long)a.q_off + min(q0 + BQ, a.Tq) - 1;
    if (a.causal && q_last < (long long)a.k_off + k0) continue;
    __syncthreads();
    load_tile_t<D, BQ>(qT, qb, a.qs[1], q0, a.Tq);
    load_tile_t<D, BQ>(doT, ob, a.os[1], q0, a.Tq);
    load_tile<D, BQ>(qs, qb, a.qs[1], q0, a.Tq);
    load_tile<D, BQ>(dos, ob, a.os[1], q0, a.Tq);
    if (tid < BQ) {
      const bool in = q0 + tid < a.Tq;
      lse_s[tid] = in ? a.lse[(long long)bh * a.Tq + q0 + tid] : 0.0f;
      dl_s[tid] = in ? a.dl[(long long)bh * a.Tq + q0 + tid] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // keys ty*4+i, rows tx*4+j
    two_patches<D>(kT, qT, vT, doT, ty, tx, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx * 4 + j;
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = visible(a, q0 + r, k0 + ty * 4 + i)
                            ? expf(__fmul_rn(s[i][j], a.scale) - lse_s[r])
                            : 0.0f;
        pv[i] = p;
        dsv[i] = p * (dp[i][j] - dl_s[r]);
      }
      *reinterpret_cast<float4*>(p_s + r * SP + ty * 4) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(ds_s + r * SP + ty * 4) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * SP + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(ds_s + r * SP + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
      float ov[C], qv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        ov[j] = dos[r * D + tx * C + j];
        qv[j] = qs[r * D + tx * C + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dv4[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = ty * 4 + i;
    if (k0 + kj >= a.Tk) continue;
    const long long off = (((long long)b * a.Tk + k0 + kj) * a.H + h) * D +
                          tx * C;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      ((float*)a.dk)[off + j] = acc_k[i][j] * a.scale;
      ((float*)a.dv)[off + j] = acc_v[i][j];
    }
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_mma_kernel(Args a) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16, ND = D / 8, TILE = 64 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* dos = qs + TILE;                         // [64][P]
  bf16* ks = dos + TILE;                         // [2][64][P]
  bf16* vs = ks + 2 * TILE;                      // [2][64][P]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = warp * 16;  // the warp's rows within the tile
  const bf16* qb = (const bf16*)a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* kb = (const bf16*)a.k + b * a.ks[0] + h * a.ks[2];
  const bf16* vb = (const bf16*)a.v + b * a.vs[0] + h * a.vs[2];
  const bf16* ob = (const bf16*)a.dout + b * a.os[0] + h * a.os[2];

  // the live key tiles: all, or under causal those that begin at or
  // before the tile's last query position
  int nk = (a.Tk + 63) / 64;
  if (a.causal) {
    const long long last =
        (long long)a.q_off + min(q0 + 64, a.Tq) - 1 - (long long)a.k_off;
    nk = last < 0 ? 0 : (int)min((long long)nk, last / 64 + 1);
  }

  // lse (times log2(e)) and dl of the thread's rows g and g + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_base + g + r * 8;
    const bool in = qi < a.Tq;
    lse2[r] = in ? a.lse[(long long)bh * a.Tq + qi] * kLog2e : 0.0f;
    dl[r] = in ? a.dl[(long long)bh * a.Tq + qi] : 0.0f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  if (nk > 0) {
    load_tile_async<D>(qs, qb, a.qs[1], q0, a.Tq);
    load_tile_async<D>(dos, ob, a.os[1], q0, a.Tq);
    load_tile_async<D>(ks, kb, a.ks[1], 0, a.Tk);
    load_tile_async<D>(vs, vb, a.vs[1], 0, a.Tk);
  }
  cp_async_commit();

  uint32_t qf[KD][4], of[KD][4];
  const float sl = a.scale * kLog2e;
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * 64;
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    if (it + 1 < nk) {  // the next tile into the other buffer
      load_tile_async<D>(ks + ((it + 1) & 1) * TILE, kb, a.ks[1], k0 + 64,
                         a.Tk);
      load_tile_async<D>(vs + ((it + 1) & 1) * TILE, vb, a.vs[1], k0 + 64,
                         a.Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_a<P>(qf[kk], qs, r_base, kk * 16);
        ldmatrix_a<P>(of[kk], dos, r_base, kk * 16);
      }
    }
    const bool edge = k0 + 64 > a.Tk ||
                      (a.causal && (long long)a.q_off + q0 <
                                       (long long)a.k_off + k0 + 63);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 32;  // this half's first key in the tile
      // S = Q K^T and dP = dO V^T over 32 keys: 4 n8 tiles each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldmatrix_b<P>(bf, kt, n0 + np * 16, kk * 16);
          mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
          mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          ldmatrix_b<P>(bf, vt, n0 + np * 16, kk * 16);
          mma16816(dp[2 * np], of[kk], bf[0], bf[1]);
          mma16816(dp[2 * np + 1], of[kk], bf[2], bf[3]);
        }
      // dS = P (dP - dl), kept in s; P = exp(s scale - lse), 0 if masked
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], sl, -lse2[e >> 1]));
          if (edge && !visible(a, q0 + r_base + g + (e >> 1) * 8,
                               k0 + n0 + j * 8 + 2 * t + (e & 1)))
            p = 0.0f;
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      // dQ += round_bf16(dS) . K, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t af[4];
        acc_to_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
          uint32_t bf[4];
          ldmatrix_bt<P>(bf, kt, n0 + kk * 16, dp2 * 16);
          mma16816(dq[2 * dp2], af, bf[0], bf[1]);
          mma16816(dq[2 * dp2 + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r_base + g + r * 8;
    if (qi >= a.Tq) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(
        (bf16*)a.dq + (((long long)b * a.Tq + qi) * a.H + h) * D + 2 * t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      row[n * 4] = pack_bf16(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_mma_kernel(Args a) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16, ND = D / 8, TILE = 64 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* vs = ks + TILE;                          // [64][P]
  bf16* qs = vs + TILE;                          // [2][64][P]
  bf16* dos = qs + 2 * TILE;                     // [2][64][P]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][64]
  float* dl_s = lse_s + 2 * 64;                             // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * 64;  // under causal the first keys see most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = warp * 16;  // the warp's keys within the tile
  const bf16* qb = (const bf16*)a.q + b * a.qs[0] + h * a.qs[2];
  const bf16* kb = (const bf16*)a.k + b * a.ks[0] + h * a.ks[2];
  const bf16* vb = (const bf16*)a.v + b * a.vs[0] + h * a.vs[2];
  const bf16* ob = (const bf16*)a.dout + b * a.os[0] + h * a.os[2];
  const float* lse_b = a.lse + (long long)bh * a.Tq;
  const float* dl_b = a.dl + (long long)bh * a.Tq;

  // the live query tiles [iq0, nq): under causal, those whose last row
  // sees key k0, i.e. holds a row i >= first
  const int nq = (a.Tq + 63) / 64;
  int iq0 = 0;
  if (a.causal) {
    const long long first = (long long)a.k_off + k0 - a.q_off;
    iq0 = first <= 0 ? 0 : first > a.Tq - 1 ? nq : (int)(first / 64);
  }
  const int n_live = nq - iq0;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  if (n_live > 0) {
    load_tile_async<D>(ks, kb, a.ks[1], k0, a.Tk);
    load_tile_async<D>(vs, vb, a.vs[1], k0, a.Tk);
    load_tile_async<D>(qs, qb, a.qs[1], iq0 * 64, a.Tq);
    load_tile_async<D>(dos, ob, a.os[1], iq0 * 64, a.Tq);
    load_row_async(lse_s, lse_b, iq0 * 64, a.Tq);
    load_row_async(dl_s, dl_b, iq0 * 64, a.Tq);
  }
  cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];
  const float sl = a.scale * kLog2e;
  for (int it = 0; it < n_live; ++it) {
    const int q0 = (iq0 + it) * 64;
    const int buf = it & 1;
    const bf16* qt = qs + buf * TILE;
    const bf16* dot = dos + buf * TILE;
    const float* lt = lse_s + buf * 64;
    const float* dlt = dl_s + buf * 64;
    if (it + 1 < n_live) {  // the next tile into the other buffer
      const int nb = buf ^ 1;
      load_tile_async<D>(qs + nb * TILE, qb, a.qs[1], q0 + 64, a.Tq);
      load_tile_async<D>(dos + nb * TILE, ob, a.os[1], q0 + 64, a.Tq);
      load_row_async(lse_s + nb * 64, lse_b, q0 + 64, a.Tq);
      load_row_async(dl_s + nb * 64, dl_b, q0 + 64, a.Tq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_a<P>(kf[kk], ks, r_base, kk * 16);
        ldmatrix_a<P>(vf[kk], vs, r_base, kk * 16);
      }
    }
    const bool edge = q0 + 64 > a.Tq || k0 + 64 > a.Tk ||
                      (a.causal && (long long)a.q_off + q0 <
                                       (long long)a.k_off + k0 + 63);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * 32;  // this half's first query row in the tile
      // S^T = K Q^T and dP^T = V dO^T over 32 query rows
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldmatrix_b<P>(bf, qt, n0 + np * 16, kk * 16);
          mma16816(st[2 * np], kf[kk], bf[0], bf[1]);
          mma16816(st[2 * np + 1], kf[kk], bf[2], bf[3]);
          ldmatrix_b<P>(bf, dot, n0 + np * 16, kk * 16);
          mma16816(dpt[2 * np], vf[kk], bf[0], bf[1]);
          mma16816(dpt[2 * np + 1], vf[kk], bf[2], bf[3]);
        }
      // P^T in st, dS^T = P^T (dP^T - dl) in dpt; element (key
      // r_base + g + 8 (e / 2), query n0 + 8 j + 2 t + e % 2)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n0 + j * 8 + 2 * t + (e & 1);
          float p = exp2f(fmaf(st[j][e], sl, -lt[ql] * kLog2e));
          if (edge && !visible(a, q0 + ql, k0 + r_base + g + (e >> 1) * 8))
            p = 0.0f;
          dpt[j][e] = p * (dpt[j][e] - dlt[ql]);
          st[j][e] = p;
        }
      // dV += round_bf16(P^T) . dO and dK += round_bf16(dS^T) . Q, 16
      // query rows a step
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[4], as[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
          uint32_t bf[4];
          ldmatrix_bt<P>(bf, dot, n0 + kk * 16, dp2 * 16);
          mma16816(dv[2 * dp2], ap, bf[0], bf[1]);
          mma16816(dv[2 * dp2 + 1], ap, bf[2], bf[3]);
          ldmatrix_bt<P>(bf, qt, n0 + kk * 16, dp2 * 16);
          mma16816(dk[2 * dp2], as, bf[0], bf[1]);
          mma16816(dk[2 * dp2 + 1], as, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r_base + g + r * 8;
    if (kj >= a.Tk) continue;
    const long long off = (((long long)b * a.Tk + kj) * a.H + h) * D + 2 * t;
    uint32_t* krow = reinterpret_cast<uint32_t*>((bf16*)a.dk + off);
    uint32_t* vrow = reinterpret_cast<uint32_t*>((bf16*)a.dv + off);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      krow[n * 4] = pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      vrow[n * 4] = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem_q =
      (size_t)(4 * D * 64 + 64 * D + 64 * SP + 2 * 64) * sizeof(float);
  const size_t smem_kv =
      (size_t)(4 * D * 64 + 2 * 64 * D + 2 * 64 * SP + 2 * 64) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  if (a.Tq > 0) {
    flash_dq_kernel<D>
        <<<dim3((a.Tq + BQ - 1) / BQ, B * a.H), kThreads, smem_q, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Tk > 0) {
    flash_dkv_kernel<D>
        <<<dim3((a.Tk + BK - 1) / BK, B * a.H), kThreads, smem_kv, stream>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const size_t tile = (size_t)64 * pitch<D>() * sizeof(bf16);
  const size_t smem_q = 6 * tile;
  const size_t smem_kv = 6 * tile + 4 * 64 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_dkv_mma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  if (a.Tq > 0) {
    flash_dq_mma_kernel<D>
        <<<dim3(B * a.H, (a.Tq + 63) / 64), kMmaThreads, smem_q, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Tk > 0) {
    flash_dkv_mma_kernel<D>
        <<<dim3(B * a.H, (a.Tk + 63) / 64), kMmaThreads, smem_kv, stream>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}

typedef int (*LaunchFn)(const Args&, int, cudaStream_t);

int dispatch(LaunchFn d16, LaunchFn d32, LaunchFn d64, const void* q,
             const void* k, const void* v, const void* dout, const void* lse,
             const void* dl, void* dq, void* dk, void* dv, int B, int H,
             int Tq, int Tk, int D, const long long* strides, int q_off,
             int k_off, int causal, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  LaunchFn fn = D == 16 ? d16 : D == 32 ? d32 : D == 64 ? d64 : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = (const float*)lse; a.dl = (const float*)dl;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.Tq = Tq; a.Tk = Tk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.q_off = q_off; a.k_off = k_off; a.causal = causal; a.scale = scale;
  return fn(a, B, (cudaStream_t)stream);
}

}  // namespace

// strides: 12 element strides, (b, t, h) of q, k, v and dO in turn
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dl, void* dq, void* dk, void* dv,
                             int B, int H, int Tq, int Tk, int D,
                             const void* strides, int q_off, int k_off,
                             int causal, float scale, void* stream) {
  return dispatch(launch_f32<16>, launch_f32<32>, launch_f32<64>, q, k, v,
                  dout, lse, dl, dq, dk, dv, B, H, Tq, Tk, D,
                  (const long long*)strides, q_off, k_off, causal, scale,
                  stream);
}

extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dl, void* dq, void* dk, void* dv,
                              int B, int H, int Tq, int Tk, int D,
                              const void* strides, int q_off, int k_off,
                              int causal, float scale, void* stream) {
  return dispatch(launch_bf16<16>, launch_bf16<32>, launch_bf16<64>, q, k,
                  v, dout, lse, dl, dq, dk, dv, B, H, Tq, Tk, D,
                  (const long long*)strides, q_off, k_off, causal, scale,
                  stream);
}
