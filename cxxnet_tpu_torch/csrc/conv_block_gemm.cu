// Fused sibling-1x1 conv block: Y = relu?(X * W + bias), f32 and bf16.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/conv_block.py:41
// (_gemm_bias_kernel, reached by fused_block_gemm :54 and
// conv1x1_block :100).  X is (M, K) row-major (the NHWC activation with
// its pixels flattened; a strided 1x1 conv subsamples on the host
// first), W is (K, O) row-major (the group's 1x1 HWIO kernels
// concatenated on O), bias is (O,) or absent, Y is (M, O) in X's dtype.
// Accumulation is f32; the bias is added and the optional relu applied
// in the epilogue, so the product tile is written to device memory once.
//
// Bound on the H100: at GoogLeNet's nine b128 groups (M = 6272..100352,
// K = 192..832, O = 176..624) the bf16 products move ~430 MB (0.129 ms
// at 3.35 TB/s) and do ~74 GFLOP (0.075 ms at 989 TFLOP/s): near the
// balance, so the kernel must stream at full bandwidth AND keep the
// tensor cores well over half busy.  In f32 (CUDA-core FMAs, no TF32)
// every shape is bound by operations.
//
// bf16, the main path (conv_block_wgmma_kernel, C entry
// conv_block_gemm_bf16), for K % 8 == 0, O % 8 == 0 and X, W, Y 16-byte
// aligned (what a TMA tensor map takes):
// * products: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) with A
//   (the X tile) and B (the W tile) both read from shared memory in the
//   128-byte swizzle; W's O-contiguous rows are B's MN-major layout, so
//   nothing is transposed (wgmma_tiles.cuh).  W's rows are read at a
//   multiple of 32 bytes: the wrapper pads them when O % 16 == 8 (TMA
//   read O = 280 and 296 at two thirds of the rate of O = 288).
// * block tile: 128 rows x N columns, two consumer warpgroups of 64 rows
//   each, N = 128, 160, 192, 224 or 256 (a template width; ragged
//   columns are clipped by the store).  pick_bn takes, per shape, the
//   width whose waves of tiles cost least at a share of the tensor-core
//   rate, or on a tie (the bytes bound every width alike) the least
//   padded one: at the nine groups 192 for O 176, 160 for O 280..304,
//   224 for O 448, 128 for O 624, so a row tile has 1 to 5 column tiles
//   (the 64-wide mma.sync tile had 3 to 10) and the products pad O by
//   at most 8 %, not the 33 % of two 192-wide tiles at O 288.
// * loads: a ring of 3-6 stages (as many as shared memory holds) of
//   64-deep K slices in dynamic shared memory, filled by TMA
//   (cp.async.bulk.tensor, completion on full mbarriers) from one
//   producer thread, released by the consumer warps on empty mbarriers;
//   TMA zero-fills past M and K.  Each consumer keeps one slice's
//   products in flight while it waits for the next.
// * persistent blocks: one block of 384 threads per SM (a producer
//   warpgroup holding 40 registers, two consumers at 232) walks the
//   tiles in order, the column tiles of one row tile next to each other,
//   so the blocks running together share X's rows through L2 and X is
//   read from device memory about once; the producer fills the next
//   tile's stages while the consumers run the epilogue.  At M = 6272
//   (inception 5a, 5b) that is 98 and 245 tiles on 132 SMs.
// * epilogue: the bias row staged in shared memory (loaded under the
//   products), bias and relu in f32 (NaN passes), one rounding to bf16,
//   the warpgroup's 64 x N tile written to shared memory in 32-column
//   boxes with the 64-byte swizzle (no bank conflicts) and stored by TMA
//   (cp.async.bulk.tensor, clipped at M and O), which runs on under the
//   next tile's products; the buffer is reused once the stores have
//   read it.
//
// bf16, the edge path (gemm_bf16_kernel, C entry
// conv_block_gemm_bf16_mma), for every other shape or alignment, by the
// wrapper's rule (ops/kernels/conv_block.py): a 64x64 output tile per
// 128-thread block, four warps of 32x32, each issuing mma.sync.m16n8k16
// (bf16 in, f32 accumulate) over 32-deep K slices staged in shared
// memory, X row-major and W transposed to n-major with scalar loads.
//
// f32 (gemm_f32_kernel, the parity runs): the same 64x64 tile with 256
// threads, each accumulating a 4x4 sub-tile with FMAs over 16-deep K
// slices.  Both mma.sync and f32 kernels zero-fill out-of-range tile
// elements on load and mask the epilogue's stores.

#include "gemm_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void epilogue(T* y, const T* bias, int m, int o,
                                         int r, int col, float v, int relu) {
  if (r < m && col < o) {
    if (bias != nullptr) v += to_f32(bias[col]);
    if (relu && v < 0.0f) v = 0.0f;  // NaN passes, as in torch.relu
    store(y + (int64_t)r * o + col, v);
  }
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, int m, int k, int o,
                 int relu) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];  // [col][k]
  const int tid = threadIdx.x;
  const MmaLane lane;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 128) {
      const int r = i / BK, kk = i % BK;
      const int gm = m0 + r, gk = k0 + kk;
      As[r][kk] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : zero;
    }
    for (int i = tid; i < BK * BN; i += 128) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[nn][kk] = (gk < k && gn < o) ? w[(int64_t)gk * o + gn] : zero;
    }
    __syncthreads();
    mma_tile(As, Bs, acc, lane);
    __syncthreads();
  }
  for_each_mma_acc(acc, m0, n0, lane, [&](int r, int col, float v) {
    epilogue(y, bias, m, o, r, col, v, relu);
  });
}

// ----------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int m,
                int k, int o, int relu) {
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
    for (int i = tid; i < FBK * BN; i += 256) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < k && gn < o) ? w[(int64_t)gk * o + gn] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  for_each_fma_acc(acc, m0, n0, tx, ty, [&](int r, int col, float v) {
    epilogue(y, bias, m, o, r, col, v, relu);
  });
}


// ------------------------------------------------- bf16 on wgmma + TMA
constexpr int WBM = 128;                 // rows of a block tile
constexpr int WBK = 64;                  // K slice: one 128-byte row
constexpr int A_BYTES = WBM * WBK * 2;   // the X box of a stage
constexpr int B_BOX = 64 * WBK * 2;      // one 64-column box of W
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory
constexpr int WTHREADS = 384;            // producer + two consumers

template <int BN>
struct WTile {
  static constexpr int NB = (BN + 63) / 64;  // W boxes a stage
  static constexpr int STAGE = A_BYTES + NB * B_BOX;
  // each consumer's 64 x BN output, in 32-column boxes of 64 rows x 64
  // bytes with the 64-byte swizzle (a TMA store's layout, and free of
  // bank conflicts for the accumulators' 4-byte writes)
  static constexpr int EPI = 2 * 64 * BN * 2;
  static constexpr int BIAS = 2 * BN * 4;  // each consumer's f32 bias row
  static constexpr int FIT = (SMEM_LIMIT - 1024 - EPI - BIAS - 96) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM =
      1024 + STAGES * STAGE + EPI + BIAS + 16 * STAGES;
  static_assert(BN % 32 == 0, "the output boxes are 32 columns wide");
  static_assert(STAGES >= 2, "the ring needs two stages");
};

template <int BN>
__global__ void __launch_bounds__(WTHREADS, 1)
conv_block_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                        __grid_constant__ const CUtensorMap tw,
                        __grid_constant__ const CUtensorMap ty,
                        const __nv_bfloat16* __restrict__ bias, int m, int k,
                        int o, int relu) {
  using T = WTile<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* epi = (__nv_bfloat16*)(smem + T::STAGES * T::STAGE);
  float* sbias = (float*)(smem + T::STAGES * T::STAGE + T::EPI);
  uint64_t* full =
      (uint64_t*)(smem + T::STAGES * T::STAGE + T::EPI + T::BIAS);
  uint64_t* empty = full + T::STAGES;

  const int ncol = (o + BN - 1) / BN;
  const int tiles = ncol * ((m + WBM - 1) / WBM);
  const int nk = (k + WBK - 1) / WBK;
  const int role = threadIdx.x / 128;  // 0 producer, 1 and 2 consumers
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 8);  // the consumers' eight warps
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (role == 0) {
    wg::regs_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / ncol * WBM, n0 = tile % ncol * BN;
      // W boxes past O are not loaded: their columns are never stored
      const int nb = min(T::NB, (o - n0 + 63) / 64);
      for (int kt = 0; kt < nk; ++kt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* a = smem + stage * T::STAGE;
        wg::mbar_expect_tx(&full[stage], A_BYTES + nb * B_BOX);
        wg::tma_load_2d(a, &tx, &full[stage], kt * WBK, m0);
        for (int j = 0; j < nb; ++j)
          wg::tma_load_2d(a + A_BYTES + j * B_BOX, &tw, &full[stage],
                          n0 + 64 * j, kt * WBK);
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  wg::regs_inc<232>();
  const int half = role - 1;  // rows 64 half .. 64 half + 63 of a tile
  const int tid = threadIdx.x - 128 * role;
  const int warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* e = epi + half * 64 * BN;
  float* sb = sbias + half * BN;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0, last = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ncol * WBM, n0 = tile % ncol * BN;
    // the tile's bias row: loaded now, its latency under the products,
    // and staged for the epilogue (one load per column per warpgroup,
    // not one per column per thread)
    float b_lo = 0.0f, b_hi = 0.0f;
    if (bias != nullptr) {
      if (tid < BN && n0 + tid < o) b_lo = __bfloat162float(bias[n0 + tid]);
      if (tid + 128 < BN && n0 + tid + 128 < o)
        b_hi = __bfloat162float(bias[n0 + tid + 128]);
    }
    for (int kt = 0; kt < nk; ++kt) {
      wg::mbar_wait(&full[stage], phase);
      __syncwarp();
      const uint8_t* a = smem + stage * T::STAGE + half * 64 * 128;
      const uint8_t* b = smem + stage * T::STAGE + A_BYTES;
      wg::fence_acc(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WBK / 16; ++kk)
        wg::wgmma_bf16<BN>(acc, wg::sw128_desc(a + 32 * kk, 16, 1024),
                           wg::sw128_desc(b + 2048 * kk, B_BOX, 1024),
                           (kt | kk) != 0);
      wg::wgmma_commit();
      wg::fence_acc(acc);
      wg::wgmma_wait<1>();  // the previous slice's products are done
      if (kt > 0 && lane == 0) wg::mbar_arrive(&empty[last]);
      last = stage;
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (lane == 0) wg::mbar_arrive(&empty[last]);

    // epilogue: bias and relu in f32, one rounding to bf16, the tile
    // staged in shared memory and written out by TMA stores, which run
    // on under the next tile's products (the store engine clips the
    // rows past M and the columns past O)
    if (tid < BN) sb[tid] = b_lo;
    if (tid + 128 < BN) sb[tid + 128] = b_hi;
    if (tid == 0) wg::tma_store_wait_read();  // the last tile's stores
    wg::bar_sync(1 + half, 128);  // have left e; the bias row is written
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bb =
            *reinterpret_cast<const float2*>(sb + 8 * j + 2 * (lane % 4));
        acc[4 * j] += bb.x;
        acc[4 * j + 1] += bb.y;
        acc[4 * j + 2] += bb.x;
        acc[4 * j + 3] += bb.y;
      }
    }
    if (relu) {  // NaN passes, as in torch.relu
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (acc[i] < 0.0f) acc[i] = 0.0f;
    }
    const int r0 = warp * 16 + lane / 4;  // and r0 + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      // box j / 4, 16-byte chunk j % 4 of the row, swizzled by row / 2
      __nv_bfloat16* box = e + (j >> 2) * 2048 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(
          box + r0 * 32 + (((j & 3) ^ ((r0 >> 1) & 3)) << 3)) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          box + (r0 + 8) * 32 + (((j & 3) ^ (((r0 + 8) >> 1) & 3)) << 3)) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    wg::fence_proxy_async();
    wg::bar_sync(1 + half, 128);
    if (tid == 0) {
      for (int bx = 0; bx < BN / 32 && n0 + 32 * bx < o; ++bx)
        wg::tma_store_2d(&ty, e + bx * 2048, n0 + 32 * bx, m0 + 64 * half);
      wg::tma_store_commit();
    }
  }
  if (tid == 0) wg::tma_store_wait();
}

// The tile width for a shape: the least of max(bytes at 3.35 TB/s,
// waves of tiles x a tile's products at 70% of an SM's share of 989
// TFLOP/s); on a tie (the bytes bound every width alike) the width that
// pads O least, then the wider.
int pick_bn(int m, int k, int o, int sms) {
  const int widths[5] = {256, 224, 192, 160, 128};
  const double bytes_ms =
      2.0 * ((double)m * k + (double)k * o + (double)m * o) / 3.35e9;
  const double sm_flops_ms = 989e9 * 0.7 / sms;
  int best = 256;
  double best_ms = 0.0;
  long long best_pad = 0;
  for (int bn : widths) {
    const long long ncol = (o + bn - 1) / bn;
    const long long tiles = ncol * ((m + WBM - 1) / WBM);
    const long long waves = (tiles + sms - 1) / sms;
    const double ms =
        fmax(bytes_ms, waves * 2.0 * WBM * bn * (double)k / sm_flops_ms);
    const long long pad = ncol * bn;
    if (bn == 256 || ms < best_ms || (ms == best_ms && pad < best_pad)) {
      best = bn;
      best_ms = ms;
      best_pad = pad;
    }
  }
  return best;
}

template <int BN>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                 const CUtensorMap& ty, const void* bias, int m, int k,
                 int o, int relu, int sms, cudaStream_t stream) {
  using T = WTile<BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_block_wgmma_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const long long tiles =
      (long long)((o + BN - 1) / BN) * ((m + WBM - 1) / WBM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv_block_wgmma_kernel<BN><<<grid, WTHREADS, T::SMEM, stream>>>(
      tx, tw, ty, (const __nv_bfloat16*)bias, m, k, o, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16, the main path: K % 8 == 0, O % 8 == 0 and X, W, Y 16-byte
// aligned, else cudaErrorInvalidValue (the wrapper sends every other
// shape to conv_block_gemm_bf16_mma).  W's rows hold O rounded up to a
// multiple of 16 values, 32 bytes (the wrapper pads them when O % 16 ==
// 8: TMA reads rows that start off a 32-byte boundary at a fraction of
// its rate); the columns past O are never stored.
extern "C" int conv_block_gemm_bf16(const void* x, const void* w,
                                    const void* bias, void* y, int m, int k,
                                    int o, int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (k <= 0 || k % 8 || o % 8 || !wg::aligned16(x) ||
      !wg::aligned16(w) || !wg::aligned16(y))
    return (int)cudaErrorInvalidValue;
  const int ldw = (o + 15) / 16 * 16;
  CUtensorMap tx, tw, ty;
  if (!wg::bf16_box_map(&tx, x, (uint64_t)m, (uint64_t)k, WBM) ||
      !wg::bf16_box_map(&tw, w, (uint64_t)k, (uint64_t)ldw, WBK) ||
      !wg::bf16_box_map(&ty, y, (uint64_t)m, (uint64_t)o, 64, 32))
    return (int)cudaErrorInvalidValue;
  const int sms = wg::sm_count();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pick_bn(m, k, o, sms)) {
    case 128:
      return launch_wgmma<128>(tx, tw, ty, bias, m, k, o, relu, sms, s);
    case 160:
      return launch_wgmma<160>(tx, tw, ty, bias, m, k, o, relu, sms, s);
    case 192:
      return launch_wgmma<192>(tx, tw, ty, bias, m, k, o, relu, sms, s);
    case 224:
      return launch_wgmma<224>(tx, tw, ty, bias, m, k, o, relu, sms, s);
    default:
      return launch_wgmma<256>(tx, tw, ty, bias, m, k, o, relu, sms, s);
  }
}

// bf16, the edge path: any shape and alignment, on mma.sync.
extern "C" int conv_block_gemm_bf16_mma(const void* x, const void* w,
                                        const void* bias, void* y, int m,
                                        int k, int o, int relu,
                                        void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  gemm_bf16_kernel<<<grid_for(m, o), 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, m, k, o, relu);
  return (int)cudaGetLastError();
}

extern "C" int conv_block_gemm_f32(const void* x, const void* w,
                                   const void* bias, void* y, int m, int k,
                                   int o, int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  gemm_f32_kernel<<<grid_for(m, o), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y, m, k,
      o, relu);
  return (int)cudaGetLastError();
}
