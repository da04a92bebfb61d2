// Flash-attention forward over (B, T, H, D) tensors, f32 and bf16 in,
// f32 recurrence, O in the input dtype and the per-row LSE in f32.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/flash.py:71 (_fwd_kernel,
// launched by _flash_fwd_raw, :246, for flash_mha :368 and
// flash_mha_lse :410).  For each query row i of head (b, h):
//   s_ij = (q_i . k_j) * scale        from q and k cast to f32
//   causal: key j is visible iff q_off + i >= k_off + j
//   m_i  = running max, l_i = running sum of exp(s_ij - m_i) (f32)
//   acc += round_to_v_dtype(p_ij) * v_j
//   o_i = acc / max(l_i, 1e-30),  lse_i = m_i + log(max(l_i, 1e-30))
// A row with no visible key keeps m = -1e30 and l = 0, so o_i = 0 and
// lse_i = -1e30, as the Pallas kernel leaves it.
//
// Bound on the H100: operations.  A causal launch at (8, 2048, 8, 64)
// does 2 * 2 * B*H*T*T*D / 2 = 34.4 GFLOP against 67 MB moved; the
// least time is the flops over the 989 TFLOP/s bf16 tensor-core rate.
// This kernel does them as f32 FMAs on the CUDA cores (67 TFLOP/s peak),
// so it sits at least 15x above that bound: making it use the tensor
// cores (mma/wgmma on bf16 tiles) is later work.
//
// Design.  The TPU kernel walks a sequential grid axis over key blocks,
// carrying m, l and acc in VMEM scratch from one grid step to the next.
// Here one thread block owns a tile of 64 query rows of one (b, h) and
// loops over the 64-key tiles itself, so the carry lives in registers
// (acc) and shared memory (m, l).  Key tiles wholly in the future of
// the tile's last row are skipped (the Pallas kernel's _live).
// 256 threads; each computes a 4x4 patch of the 64x64 score tile from
// float4 reads of q and k staged TRANSPOSED in shared memory ([d][row]),
// so one d step is two 16-byte loads for 16 FMAs.  The row statistics
// are one pass of 8 lanes per row over the tile (lane l reads key
// l, l+8, ...: conflict-free with the 68-float row pitch), then each
// thread accumulates a 4 x D/16 patch of acc from float4 reads of P
// (stored [key][row]) and row-major V.  A masked score is -inf, so its
// p is exactly 0 and a fully masked row never moves m off -1e30.  Tiles
// are loaded 8 elements a thread (16- or 32-byte vector loads), rows
// beyond T as zeros; the wrapper passes element strides, so the q, k
// and v slices of the fused qkv projection are read in place.
// Scalar f32 math only: no tensor cores, no cp.async, no TMA yet.

#include <math.h>

#include "flash_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// P rounded to v's dtype before P.V
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  load_tile_t<T, D, BQ>(qT, qb, qst, q0, Tq);
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
    load_tile_t<T, D, BK>(kT, kb, kst, k0, Tk);
    load_tile<T, D, BK>(vs, vb, vst, k0, Tk);
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
        *e = round_as(p, v);  // P in v's dtype before P.V
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
    T* orow = o + (((long long)b * Tq + q0 + r) * H + h) * D + tx * C;
#pragma unroll
    for (int j = 0; j < C; ++j) store(orow + j, acc[i][j] / lf);
  }
  if (tid < BQ && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Tq, int Tk, const long long* qs,
           const long long* ks, const long long* vs, int q_off, int k_off,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(D * BQ + D * BK + BK * D + BK * SP + 3 * BQ) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Tq, Tk,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], q_off,
      k_off, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int Tq, int Tk, int D, long long qsb,
             long long qst, long long qsh, long long ksb, long long kst,
             long long ksh, long long vsb, long long vst, long long vsh,
             int q_off, int k_off, int causal, float scale, void* stream) {
  if (B == 0 || H == 0 || Tq == 0) return 0;
  const long long qs[3] = {qsb, qst, qsh};
  const long long ks[3] = {ksb, kst, ksh};
  const long long vs[3] = {vsb, vst, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, q_off,
                           k_off, causal, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, q_off,
                           k_off, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, qs, ks, vs, q_off,
                           k_off, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Tq, int Tk,
                             int D, long long qsb, long long qst,
                             long long qsh, long long ksb, long long kst,
                             long long ksh, long long vsb, long long vst,
                             long long vsh, int q_off, int k_off, int causal,
                             float scale, void* stream) {
  return dispatch<float>(q, k, v, o, lse, B, H, Tq, Tk, D, qsb, qst, qsh, ksb,
                         kst, ksh, vsb, vst, vsh, q_off, k_off, causal, scale,
                         stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int Tq,
                              int Tk, int D, long long qsb, long long qst,
                              long long qsh, long long ksb, long long kst,
                              long long ksh, long long vsb, long long vst,
                              long long vsh, int q_off, int k_off, int causal,
                              float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, B, H, Tq, Tk, D, qsb, qst,
                                 qsh, ksb, kst, ksh, vsb, vst, vsh, q_off,
                                 k_off, causal, scale, stream);
}
