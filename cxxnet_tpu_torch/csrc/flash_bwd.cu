// Flash-attention backward over (B, T, H, D) tensors, f32 and bf16 in,
// f32 math, dQ/dK/dV in the input dtype.  One C entry launches the two
// kernels: dQ, then dK and dV.
//
// Replaces the Pallas kernels cxxnet_tpu/ops/flash.py:126 (_dq_kernel)
// and :171 (_dkv_kernel), launched by _flash_bwd_raw (:294).  From q, k,
// v, dO, the forward's per-row lse and dl = delta - dlse (delta_i =
// sum_d dO_id O_id, computed outside the kernels; dlse is the LSE
// cotangent of flash_mha_lse, 0 for flash_mha):
//   p_ij  = exp(s_ij - lse_i), 0 where key j is masked  (NOT rounded)
//   ds_ij = p_ij * (dO_i . v_j - dl_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = scale * sum_i ds_ij q_i,     dv_j = sum_i p_ij dO_i
//
// Bound on the H100: operations.  A causal layer at (8, 2048, 8, 64)
// needs at least five products of B*H*T*T*D/2 multiply-adds each (s and
// dO.v to rebuild p and ds, then dq, dk and dv): 85.9 GFLOP, against
// about 0.1 GB moved.  These kernels run seven such products (the dK/dV
// kernel rebuilds s and dO.v again rather than share them through
// device memory) as f32 FMAs on the CUDA cores, so they sit well above
// the bf16 tensor-core bound: tensor cores are later work.
//
// Design.  No atomics: every output element is summed by one thread in
// a fixed order, so the result is deterministic (the TPU kernels get
// the same by running their reduction axis sequentially).
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
// Rows past T and keys past Tk load as zeros and are masked, so any T
// is served.  Element strides come from the wrapper (the fused qkv
// slices are read in place).  Scalar f32 math only.

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

template <typename T, int D>
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
  const T* qb = (const T*)a.q + b * a.qs[0] + h * a.qs[2];
  const T* kb = (const T*)a.k + b * a.ks[0] + h * a.ks[2];
  const T* vb = (const T*)a.v + b * a.vs[0] + h * a.vs[2];
  const T* ob = (const T*)a.dout + b * a.os[0] + h * a.os[2];

  load_tile_t<T, D, BQ>(qT, qb, a.qs[1], q0, a.Tq);
  load_tile_t<T, D, BQ>(doT, ob, a.os[1], q0, a.Tq);
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
    load_tile_t<T, D, BK>(kT, kb, a.ks[1], k0, a.Tk);
    load_tile_t<T, D, BK>(vT, vb, a.vs[1], k0, a.Tk);
    load_tile<T, D, BK>(ks, kb, a.ks[1], k0, a.Tk);
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
    T* row = (T*)a.dq + (((long long)b * a.Tq + q0 + r) * a.H + h) * D + tx * C;
#pragma unroll
    for (int j = 0; j < C; ++j) store(row + j, acc[i][j] * a.scale);
  }
}

template <typename T, int D>
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
  const T* qb = (const T*)a.q + b * a.qs[0] + h * a.qs[2];
  const T* kb = (const T*)a.k + b * a.ks[0] + h * a.ks[2];
  const T* vb = (const T*)a.v + b * a.vs[0] + h * a.vs[2];
  const T* ob = (const T*)a.dout + b * a.os[0] + h * a.os[2];

  load_tile_t<T, D, BK>(kT, kb, a.ks[1], k0, a.Tk);
  load_tile_t<T, D, BK>(vT, vb, a.vs[1], k0, a.Tk);
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
    load_tile_t<T, D, BQ>(qT, qb, a.qs[1], q0, a.Tq);
    load_tile_t<T, D, BQ>(doT, ob, a.os[1], q0, a.Tq);
    load_tile<T, D, BQ>(qs, qb, a.qs[1], q0, a.Tq);
    load_tile<T, D, BQ>(dos, ob, a.os[1], q0, a.Tq);
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
      store((T*)a.dk + off + j, acc_k[i][j] * a.scale);
      store((T*)a.dv + off + j, acc_v[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem_q =
      (size_t)(4 * D * 64 + 64 * D + 64 * SP + 2 * 64) * sizeof(float);
  const size_t smem_kv =
      (size_t)(4 * D * 64 + 2 * 64 * D + 2 * 64 * SP + 2 * 64) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_dkv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  if (a.Tq > 0) {
    flash_dq_kernel<T, D>
        <<<dim3((a.Tq + BQ - 1) / BQ, B * a.H), kThreads, smem_q, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Tk > 0) {
    flash_dkv_kernel<T, D>
        <<<dim3((a.Tk + BK - 1) / BK, B * a.H), kThreads, smem_kv, stream>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* dl, void* dq, void* dk, void* dv,
             int B, int H, int Tq, int Tk, int D, const long long* strides,
             int q_off, int k_off, int causal, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
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
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<T, 16>(a, B, st);
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (b, t, h) of q, k, v and dO in turn
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dl, void* dq, void* dk, void* dv,
                             int B, int H, int Tq, int Tk, int D,
                             const void* strides, int q_off, int k_off,
                             int causal, float scale, void* stream) {
  return dispatch<float>(q, k, v, dout, lse, dl, dq, dk, dv, B, H, Tq, Tk, D,
                         (const long long*)strides, q_off, k_off, causal,
                         scale, stream);
}

extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dl, void* dq, void* dk, void* dv,
                              int B, int H, int Tq, int Tk, int D,
                              const void* strides, int q_off, int k_off,
                              int causal, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, dout, lse, dl, dq, dk, dv, B, H, Tq,
                                 Tk, D, (const long long*)strides, q_off,
                                 k_off, causal, scale, stream);
}
