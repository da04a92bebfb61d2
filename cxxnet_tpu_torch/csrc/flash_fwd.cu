// Flash-attention forward over (B, T, H, D) tensors, f32 and bf16 in,
// f32 recurrence, O in the input dtype and the per-row LSE in f32.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/flash.py:71 (_fwd_kernel,
// launched by _flash_fwd_raw, :246, for flash_mha :368 and
// flash_mha_lse :410).  For each query row i of head (b, h):
//   s_ij = (q_i . k_j) * scale        from q and k, products exact in f32
//   causal: key j is visible iff q_off + i >= k_off + j
//   m_i  = running max, l_i = running sum of exp(s_ij - m_i) (f32)
//   acc += round_to_v_dtype(p_ij) * v_j
//   o_i = acc / max(l_i, 1e-30),  lse_i = m_i + log(max(l_i, 1e-30))
// A row with no visible key keeps m = -1e30 and l = 0, so o_i = 0 and
// lse_i = -1e30, as the Pallas kernel leaves it.
//
// Bound on the H100: operations.  A causal launch at (8, 2048, 8, 64)
// does two products of the visible pairs, 2 * 2 * B*H*T*T*D / 2 =
// 34.4 GFLOP, against 67 MB moved; the least time is the flops over the
// 989 TFLOP/s bf16 tensor-core rate (0.035 ms).
//
// bf16: the tensor cores (flash_fwd_mma_kernel).  128 threads, 4 warps;
// a block owns 64 query rows of one (b, h), a warp 16 of them.  Q is
// copied to shared memory once and held in registers as mma A fragments
// (ldmatrix).  K and V come in 64-key tiles through a double buffer of
// 16-byte cp.async: tile j + 1 is in flight while tile j computes.  Per
// tile: S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate; K read
// by ldmatrix as the col-major B operand); the scale and the mask in
// registers, the mask only on tiles that cross the diagonal or the
// ragged edge (masked scores -inf); the online softmax in registers,
// each thread holding two rows, the row max reduced over the lane quad
// with __shfl_xor_sync, l kept per thread and reduced once at the end;
// p = exp2(s * scale * log2(e) - m * log2(e)) with m in natural units,
// so the -1e30 start of m and the -inf of a masked score never meet as
// -inf - -inf; P rounded to bf16 in registers is the A operand of P.V
// as it stands (the m16n8 accumulator layout is the A layout), V read
// by ldmatrix.trans.  Shared rows are padded to D + 8 elements, so
// ldmatrix's 8 row addresses hit 8 bank groups.  Query tiles launch
// longest-first (the causal tail is short).  D = 64: 46 KB of shared
// memory, 2048 blocks at the LM shape.
//
// f32: the scalar kernel (flash_fwd_kernel), f32 FMAs on the CUDA cores,
// so that f32 keeps f32 products (no TF32).  The TPU kernel walks a
// sequential grid axis over key blocks, carrying m, l and acc in VMEM
// scratch from one grid step to the next.  Here one thread block owns a
// tile of 64 query rows of one (b, h) and loops over the 64-key tiles
// itself, so the carry lives in registers (acc) and shared memory (m,
// l).  Key tiles wholly in the future of the tile's last row are skipped
// (the Pallas kernel's _live).  256 threads; each computes a 4x4 patch
// of the 64x64 score tile from float4 reads of q and k staged TRANSPOSED
// in shared memory ([d][row]), so one d step is two 16-byte loads for 16
// FMAs.  The row statistics are one pass of 8 lanes per row over the
// tile (lane l reads key l, l+8, ...: conflict-free with the 68-float row
// pitch), then each thread accumulates a 4 x D/16 patch of acc from
// float4 reads of P (stored [key][row]) and row-major V.  A masked score
// is -inf, so its p is exactly 0 and a fully masked row never moves m off
// -1e30.  Tiles are loaded 8 elements a thread, rows beyond T as zeros.
//
// Both read q, k and v through the element strides the wrapper passes,
// so the q, k and v slices of the fused qkv projection are read in place.

#include <math.h>

#include "flash_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 long long qsb, long long qst, long long qsh, long long ksb,
                 long long kst, long long ksh, long long vsb, long long vst,
                 long long vsh, int q_off, int k_off, int causal,
                 float scale) {
  constexpr int C = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [D][BQ]
  float* kT = qT + D * BQ;     // [D][BK]
  float* vs = kT + D * BK;     // [BK][D]
  float* pT = vs + BK * D;     // [BK][SP]: scores, then P
  float* m_s = pT + BK * SP;   // [BQ] running max
  float* l_s = m_s + BQ;       // [BQ] running sum
  float* c_s = l_s + BQ;       // [BQ] this tile's correction

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  load_tile_t<D, BQ>(qT, qb, qst, q0, Tq);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.0f;

  // last query position of this tile, against key positions k_off + j
  const long long q_last = (long long)q_off + min(q0 + BQ, Tq) - 1;
  const int nk = (Tk + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    if (causal && q_last < (long long)k_off + k0) break;  // all future
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<D, BK>(kT, kb, kst, k0, Tk);
    load_tile<D, BK>(vs, vb, vst, k0, Tk);
    __syncthreads();

    // scores: rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * BQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kT + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx * 4 + j;
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        const bool vis = kj < Tk && (!causal || (long long)q_off + qi >=
                                                    (long long)k_off + kj);
        out[i] = vis ? s[i][j] * scale : -INFINITY;
      }
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * SP + ty * 4) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

    // online softmax: warp w owns rows w*8 .. w*8+7, 4 at a time, 8
    // lanes a row
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r = warp * 8 + pass * 4 + (lane >> 3);
      const int ki = lane & 7;
      float mx = -INFINITY;
#pragma unroll
      for (int st = 0; st < BK / 8; ++st)
        mx = fmaxf(mx, pT[(ki + 8 * st) * SP + r]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int st = 0; st < BK / 8; ++st) {
        float* e = pT + (ki + 8 * st) * SP + r;
        const float p = expf(*e - m_new);  // -inf (masked) -> 0
        sum += p;
        *e = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (ki == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V: rows ty*4+i, columns tx*C+j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pT + kk * SP + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[C];
#pragma unroll
      for (int j = 0; j < C; ++j) vv[j] = vs[kk * D + tx * C + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Tq) continue;
    const float lf = fmaxf(l_s[r], 1e-30f);
    float* orow = o + (((long long)b * Tq + q0 + r) * H + h) * D + tx * C;
#pragma unroll
    for (int j = 0; j < C; ++j) orow[j] = acc[i][j] / lf;
  }
  if (tid < BQ && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int Tk,
                     long long qsb, long long qst, long long qsh,
                     long long ksb, long long kst, long long ksh,
                     long long vsb, long long vst, long long vsh, int q_off,
                     int k_off, int causal, float scale) {
  constexpr int P = pitch<D>();
  constexpr int KD = D / 16;  // 16-deep steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles of the output row
  constexpr int TILE = 64 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]
  bf16* ks = qs + TILE;                          // [2][64][P]
  bf16* vs = ks + 2 * TILE;                      // [2][64][P]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;  // longest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_base = warp * 16;  // the warp's rows within the tile
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  // the live key tiles: all, or under causal those that begin at or
  // before the tile's last query position
  int nk = (Tk + 63) / 64;
  if (causal) {
    const long long last =
        (long long)q_off + min(q0 + 64, Tq) - 1 - (long long)k_off;
    nk = last < 0 ? 0 : (int)min((long long)nk, last / 64 + 1);
  }

  float m[2] = {kNegInf, kNegInf};  // rows g, g + 8 of the warp
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  if (nk > 0) {
    load_tile_async<D>(qs, qb, qst, q0, Tq);
    load_tile_async<D>(ks, kb, kst, 0, Tk);
    load_tile_async<D>(vs, vb, vst, 0, Tk);
  }
  cp_async_commit();

  uint32_t qf[KD][4];
  const float sl = scale * kLog2e;
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * 64;
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    if (it + 1 < nk) {  // the next tile into the other buffer
      load_tile_async<D>(ks + ((it + 1) & 1) * TILE, kb, kst, k0 + 64, Tk);
      load_tile_async<D>(vs + ((it + 1) & 1) * TILE, vb, vst, k0 + 64, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_a<P>(qf[kk], qs, r_base, kk * 16);
    }

    // S = Q K^T: 8 n8 tiles of keys, rows g and g + 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_b<P>(bf, kt, np * 16, kk * 16);
        mma16816(s[2 * np], qf[kk], bf[0], bf[1]);
        mma16816(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // the mask, only where the tile crosses the diagonal or the edge
    const bool edge = k0 + 64 > Tk ||
                      (causal && (long long)q_off + q0 <
                                     (long long)k_off + k0 + 63);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          const int qi = q0 + r_base + g + (e >> 1) * 8;
          const bool vis = kj < Tk && (!causal || (long long)q_off + qi >=
                                                      (long long)k_off + kj);
          if (!vis) s[j][e] = -INFINITY;
        }
    }

    // online softmax; scale > 0, so max(s) * scale = max(s * scale)
    float ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale);  // -inf * scale = -inf
      const float corr = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], sl, -ml[e >> 1]));  // -inf -> 0
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // acc += round_bf16(P) . V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_bt<P>(bf, vt, kk * 16, dp * 16);
        mma16816(acc[2 * dp], a, bf[0], bf[1]);
        mma16816(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lf = fmaxf(lr, 1e-30f);
    const int qi = q0 + r_base + g + r * 8;
    if (qi >= Tq) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + (((long long)b * Tq + qi) * H + h) * D + 2 * t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      orow[n * 4] = pack_bf16(acc[n][2 * r] / lf, acc[n][2 * r + 1] / lf);
    if (t == 0) lse[(long long)bh * Tq + qi] = m[r] + logf(lf);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Tq, int Tk, const long long* qs,
               const long long* ks, const long long* vs, int q_off,
               int k_off, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(D * BQ + D * BK + BK * D + BK * SP + 3 * BQ) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, H, Tq, Tk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0],
      vs[1], vs[2], q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Tq, int Tk, const long long* qs,
                const long long* ks, const long long* vs, int q_off,
                int k_off, int causal, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)5 * 64 * pitch<D>() * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + 63) / 64);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Tq, Tk, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const void*, const void*, const void*, void*, void*,
                        int, int, int, int, const long long*,
                        const long long*, const long long*, int, int, int,
                        float, cudaStream_t);

int dispatch(LaunchFn d16, LaunchFn d32, LaunchFn d64, const void* q,
             const void* k, const void* v, void* o, void* lse, int B, int H,
             int Tq, int Tk, int D, long long qsb, long long qst,
             long long qsh, long long ksb, long long kst, long long ksh,
             long long vsb, long long vst, long long vsh, int q_off,
             int k_off, int causal, float scale, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  const long long qs[3] = {qsb, qst, qsh};
  const long long ks[3] = {ksb, kst, ksh};
  const long long vs[3] = {vsb, vst, vsh};
  LaunchFn fn = D == 16 ? d16 : D == 32 ? d32 : D == 64 ? d64 : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, q_off, k_off, causal,
            scale, (cudaStream_t)stream);
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Tq, int Tk,
                             int D, long long qsb, long long qst,
                             long long qsh, long long ksb, long long kst,
                             long long ksh, long long vsb, long long vst,
                             long long vsh, int q_off, int k_off, int causal,
                             float scale, void* stream) {
  return dispatch(launch_f32<16>, launch_f32<32>, launch_f32<64>, q, k, v, o,
                  lse, B, H, Tq, Tk, D, qsb, qst, qsh, ksb, kst, ksh, vsb,
                  vst, vsh, q_off, k_off, causal, scale, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Tq,
                              int Tk, int D, long long qsb, long long qst,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, long long vsb, long long vst,
                              long long vsh, int q_off, int k_off, int causal,
                              float scale, void* stream) {
  return dispatch(launch_bf16<16>, launch_bf16<32>, launch_bf16<64>, q, k, v,
                  o, lse, B, H, Tq, Tk, D, qsb, qst, qsh, ksb, kst, ksh, vsb,
                  vst, vsh, q_off, k_off, causal, scale, stream);
}
