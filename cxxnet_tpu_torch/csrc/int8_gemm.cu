// int8 GEMM with the per-channel rescale in its epilogue:
//   Y = relu?((X * q^T, f32 accumulation) * scale + bias), cast to X's dtype.
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/int8_gemm.py:32
// (_int8_kernel, reached by int8_gemm_rescale :50).  X is (M, K) row-major
// in f32 or bf16 (a fullc input, or a 1x1 conv's NHWC activation with its
// pixels flattened; a strided 1x1 conv subsamples on the host first), q is
// (O, K) row-major int8 codes (the fullc layout; a 1x1 conv's HWIO codes
// are transposed to it once per load), scale is (O,) f32, bias is (O,) f32
// or absent, Y is (M, O) in X's dtype.  The codes are read as int8, one
// byte each, and converted in registers on their way into shared memory:
// exactly, since |code| <= 127 fits bf16's 8-bit mantissa.  X is not int8,
// so the int8 tensor cores do not apply: quantizing X would compute
// another function.
//
// Bound on the H100: bytes.  At the quantized GoogLeNet b128 forward's 11
// launches (M = 128..401408, K = 64..1024, O = 32..1000) the bf16 product
// does 2*K flops per output against about 2*(K + O)/O bytes per output;
// the layers move ~384 MB in all, 0.115 ms at 3.35 TB/s, against ~20
// GFLOP, 0.02 ms on the bf16 tensor cores.
//
// bf16, the main path (int8_gemm_wgmma_kernel, C entry int8_gemm_bf16),
// for K % 16 == 0, O % 8 == 0 and X, q, Y 16-byte aligned (the wrapper's
// rule, ops/kernels/int8_gemm.takes_wgmma; every layer of the quantized
// GoogLeNet):
// * products: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate) with A
//   (the X tile) and B (the codes as bf16) both read from shared memory
//   in the 128-byte swizzle (wgmma_tiles.cuh).  q's K-contiguous rows are
//   wgmma's K-major B, read untransposed.
// * loads: X through a ring of 128-row x 64-deep boxes (16 KB a stage, as
//   many stages as shared memory holds beside the B panel, up to 8),
//   filled by TMA from one producer thread that runs ACROSS tiles: at
//   K = 64 a tile is a single slice, so the next tiles' X streams in
//   while the consumers run this tile's epilogue.
// * B: the consumer threads read the codes with 16-byte loads, eight in
//   flight a thread (q is at most 1 MB and stays in L2), convert them to
//   bf16 (exactly, with byte permutes and one f32 add a code, not the
//   conversion unit: codes_to_bf16) and write them into the swizzled
//   K-major layout, then fence the writes into the async proxy
//   (fence.proxy.async) and meet at a barrier before any wgmma reads
//   them.  The block's BN x K panel stays resident for every row tile of
//   its column tile when it fits beside four ring stages: up to K = 1152
//   at BN = 64 and 2432 at BN = 32, so every GoogLeNet layer.  A longer
//   K is cut into chunks of as many slices as fit, each converted anew
//   per tile.
// * block tile: 128 rows (two consumer warpgroups of 64) x BN columns,
//   BN 32 where O <= 32, else 64 (pick_bn, per shape in C).  A tile's
//   cost is its rows' whole X, whatever its width, so the wider tile
//   reads X fewer times, and a narrower one only adds waves of X.
//   64-row tiles, the two consumers splitting the columns, spread 25088
//   rows more evenly over the SMs but ran slower: twice the tiles, each
//   with its epilogue.
// * few tiles: where the output tiles number at most half the SMs (the
//   classifier, (128, 1024, 1000), has 16), the wrapper splits K
//   (ops/kernels/int8_gemm.k_splits): each of the `splits` runs of K
//   slices over a tile is a work item of its own, whose f32 partial sums
//   go to a (splits, M, O) workspace, and a second kernel
//   (int8_gemm_reduce_kernel) adds the parts in split order and applies
//   the epilogue: deterministic, no atomics.  Every other GoogLeNet
//   layer has more tiles than half the SMs and one split.
// * persistent blocks: one block of 384 threads per SM walks the tiles
//   column tile by column tile, so a block converts its panel once (or
//   once per column tile it moves to).  Launched as a programmatic
//   dependent of the kernel before it in the stream (cudaLaunchKernelEx,
//   griddepcontrol.wait): the launch and the barriers' set-up overlap
//   that kernel's tail; every read and write of the operands waits for
//   its completion.
// * epilogue: scale and bias per column staged in shared memory (loaded
//   under the products), then y = relu?(acc * scale + bias) as two
//   rounded operations (__fmul_rn, __fadd_rn: no FMA contraction, as the
//   plain version computes them; NaN passes relu), one rounding to bf16,
//   each warpgroup's 64 x BN tile written to shared memory in
//   32-column boxes with the 64-byte swizzle and stored by TMA (clipped
//   at M and O, so O = 1000's ragged last box needs no mask), under the
//   next tile's products.
//
// bf16, the edge path (int8_gemm_bf16_kernel, C entry
// int8_gemm_bf16_mma), for every other shape or alignment: a 64x64
// output tile per 128-thread block on the tiles of gemm_tiles.cuh, four
// warps of 32x32 issuing mma.sync.m16n8k16 over 32-deep K slices; X rows
// and q rows both k-contiguous, so both stage without a transpose; when
// K is a multiple of 8 each thread moves 8 elements at a time (16 bytes
// of X, 8 bytes of codes).  Ragged M, K and O are zero-filled on load and
// masked on store.
// f32 (int8_gemm_f32_kernel, the parity runs): the same tile with 256
// threads, a 4x4 sub-tile of FMAs each over 16-deep K slices (no TF32).
// Every path multiplies by the scale and adds the f32 bias as two rounded
// operations, applies relu and rounds once to X's dtype.

#include "gemm_tiles.cuh"
#include "wgmma_tiles.cuh"

#include <algorithm>

namespace {

template <typename T>
__device__ __forceinline__ void epilogue(T* y, const float* scale,
                                         const float* bias, int m, int o,
                                         int r, int col, float v, int relu) {
  if (r < m && col < o) {
    v = __fmul_rn(v, scale[col]);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    if (relu && v < 0.0f) v = 0.0f;  // NaN passes, as in torch.relu
    store(y + (int64_t)r * o + col, v);
  }
}

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return (float)(int8_t)((word >> (8 * j)) & 0xffu);
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
int8_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int m, int k, int o,
                      int relu, int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];  // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];  // [col][k]
  const int tid = threadIdx.x;
  const MmaLane lane;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    if (vec) {  // K % 8 == 0: a chunk of 8 is wholly in range or out
      for (int c = tid; c < BM * BK / 8; c += 128) {
        const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + kk;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (gm < m && gk < k)
          v = *reinterpret_cast<const uint4*>(x + (int64_t)gm * k + gk);
        *reinterpret_cast<uint4*>(&As[r][kk]) = v;
      }
      for (int c = tid; c < BN * BK / 8; c += 128) {
        const int nn = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gn = n0 + nn, gk = k0 + kk;
        uint2 u = make_uint2(0u, 0u);
        if (gn < o && gk < k)
          u = *reinterpret_cast<const uint2*>(q + (int64_t)gn * k + gk);
        uint32_t h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t word = j < 2 ? u.x : u.y;
          const int b = (2 * j) & 3;
          __nv_bfloat162 p = __floats2bfloat162_rn(code_at(word, b),
                                                   code_at(word, b + 1));
          h[j] = *reinterpret_cast<uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(&Bs[nn][kk]) =
            make_uint4(h[0], h[1], h[2], h[3]);
      }
    } else {
      for (int i = tid; i < BM * BK; i += 128) {
        const int r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        As[r][kk] = (gm < m && gk < k) ? x[(int64_t)gm * k + gk] : zero;
      }
      for (int i = tid; i < BN * BK; i += 128) {
        const int nn = i / BK, kk = i % BK;
        const int gn = n0 + nn, gk = k0 + kk;
        Bs[nn][kk] = (gn < o && gk < k)
                         ? __float2bfloat16((float)q[(int64_t)gn * k + gk])
                         : zero;
      }
    }
    __syncthreads();
    mma_tile(As, Bs, acc, lane);
    __syncthreads();
  }
  for_each_mma_acc(acc, m0, n0, lane, [&](int r, int col, float v) {
    epilogue(y, scale, bias, m, o, r, col, v, relu);
  });
}

// ----------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
int8_gemm_f32_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int m, int k, int o, int relu) {
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
    for (int i = tid; i < BN * FBK; i += 256) {
      const int nn = i / FBK, kk = i % FBK;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < o && gk < k) ? (float)q[(int64_t)gn * k + gk] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }
  for_each_fma_acc(acc, m0, n0, tx, ty, [&](int r, int col, float v) {
    epilogue(y, scale, bias, m, o, r, col, v, relu);
  });
}


// ------------------------------------------------- bf16 on wgmma + TMA
constexpr int QBM = 128;                  // rows of a block tile
constexpr int QBK = 64;                   // K slice: one 128-byte row
constexpr int QA_BYTES = QBM * QBK * 2;   // the X box of a stage
constexpr int QSMEM = 232448;             // a block's shared memory
constexpr int QTHREADS = 384;             // producer + two consumers
constexpr int QMAX_STAGES = 8;
constexpr int QMIN_STAGES = 4;
constexpr int QMAX_SPLITS = 8;  // parts of K (the wrapper's SPLIT_MAX)

template <int BN>
struct QTile {
  static constexpr int SLICE = BN * QBK * 2;  // one 64-deep slice of B
  // each consumer's 64 x BN output, in 32-column boxes of 64 rows x 64
  // bytes with the 64-byte swizzle (as conv_block_gemm.cu's)
  static constexpr int EPI = 2 * 64 * BN * 2;
  static constexpr int COLS = 2 * 2 * BN * 4;  // each consumer's scale, bias
  static constexpr int FIXED = 1024 + EPI + COLS + 16 * QMAX_STAGES;
  static_assert(BN % 32 == 0, "the output boxes are 32 columns wide");
};

// 4 codes (one word) as 4 bf16 values, exactly, without the conversion
// unit (I2F runs at a quarter of the ALU's rate and bounded the panel's
// fill): each code c, biased to c + 128 by the XOR, becomes the f32
// 2^23 + c + 128 by a byte permute, and 2^23 + 128 less gives c; an
// integer of at most 8 significant bits leaves the f32's low 16 bits 0,
// so its high half IS its bf16, and a byte permute packs two of them
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) -
           8388736.0f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// slices k0 .. k1 - 1 of the B panel of columns n0 .. n0 + BN - 1: the
// codes as bf16 in the K-major 128-byte swizzle (row n at (n / 8) * 1024
// + (n % 8) * 128, its 16-byte chunk c at (c ^ (n % 8)) * 16), zeros past
// O and K; by the 256 consumer threads
template <int BN>
__device__ __forceinline__ void fill_panel(uint8_t* panel,
                                           const int8_t* __restrict__ q,
                                           int k, int o, int n0, int k0,
                                           int k1, int ctid) {
  constexpr int U = 8;  // loads in flight a thread: the panel arrives in
                        // one or two round trips, not one per 4 KB
  const int items = (k1 - k0) * BN * 4;  // 16 codes an item
  for (int base = ctid; base < items; base += 256 * U) {
    uint4 c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 256 * u;
      const int j = i & 3, n = (i >> 2) % BN, sl = (i >> 2) / BN;
      const int gn = n0 + n, gk = (k0 + sl) * QBK + 16 * j;
      c[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < items && gn < o && gk < k)
        c[u] = __ldg(
            reinterpret_cast<const uint4*>(q + (int64_t)gn * k + gk));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 256 * u;
      if (i >= items) break;
      const int j = i & 3, n = (i >> 2) % BN, sl = (i >> 2) / BN;
      uint8_t* row = panel + sl * QTile<BN>::SLICE + (n >> 3) * 1024 +
                     (n & 7) * 128;
      const uint2 h0 = codes_to_bf16(c[u].x), h1 = codes_to_bf16(c[u].y);
      const uint2 h2 = codes_to_bf16(c[u].z), h3 = codes_to_bf16(c[u].w);
      *reinterpret_cast<uint4*>(row + (((2 * j) ^ (n & 7)) << 4)) =
          make_uint4(h0.x, h0.y, h1.x, h1.y);
      *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (n & 7)) << 4)) =
          make_uint4(h2.x, h2.y, h3.x, h3.y);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(QTHREADS, 1)
int8_gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tx,
                       __grid_constant__ const CUtensorMap ty,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ work, int m, int k, int o,
                       int relu, int stages, int pslices, int splits) {
  using T = QTile<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* panel = smem + stages * QA_BYTES;
  __nv_bfloat16* epi = (__nv_bfloat16*)(panel + pslices * T::SLICE);
  float* cols = (float*)((uint8_t*)epi + T::EPI);
  uint64_t* full = (uint64_t*)((uint8_t*)cols + T::COLS);
  uint64_t* empty = full + stages;

  const int nrow = (m + QBM - 1) / QBM;
  const int nk = (k + QBK - 1) / QBK;
  // work item t: row tile t % nrow of unit t / nrow, which is column
  // tile unit / splits over the K slices of split unit % splits
  const int items = nrow * ((o + BN - 1) / BN) * splits;
  const int role = threadIdx.x / 128;  // 0 producer, 1 and 2 consumers
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 8);  // the consumers' eight warps
    }
    wg::fence_barrier_init();
  }
  __syncthreads();
  // launched as a programmatic dependent (launch_wgmma): the set-up above
  // ran under the previous kernel's tail; every read of X, q, scale and
  // bias and every write of Y comes after that kernel's completion
  wg::grid_dependency_wait();

  if (role == 0) {
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int m0 = t % nrow * QBM, sp = t / nrow % splits;
      for (int kt = sp * nk / splits; kt < (sp + 1) * nk / splits; ++kt) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        wg::mbar_expect_tx(&full[stage], QA_BYTES);
        wg::tma_load_2d(smem + stage * QA_BYTES, &tx, &full[stage],
                        kt * QBK, m0);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int half = role - 1;  // rows 64 half .. 64 half + 63 of a tile
  const int tid = threadIdx.x - 128 * role;
  const int ctid = threadIdx.x - 128;  // 0 .. 255 over both consumers
  const int warp = tid / 32, lane = tid % 32;
  __nv_bfloat16* e = epi + half * 64 * BN;
  float* sc = cols + half * 2 * BN;  // the scale row, then the bias row
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0, pending = -1, panel_unit = -1, panel_k0 = -1;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int unit = t / nrow, m0 = t % nrow * QBM;
    const int n0 = unit / splits * BN, sp = unit % splits;
    const int kb = sp * nk / splits, ke = (sp + 1) * nk / splits;
    // the tile's column constants: loaded now, their latency under the
    // products, staged for the epilogue
    float s_col = 0.0f, b_col = 0.0f;
    if (splits == 1 && tid < BN && n0 + tid < o) {
      s_col = scale[n0 + tid];
      if (bias != nullptr) b_col = bias[n0 + tid];
    }
    for (int k0 = kb; k0 < ke; k0 += pslices) {
      const int k1 = min(ke, k0 + pslices);
      if (unit != panel_unit || k0 != panel_k0) {
        // no product may still read the panel: this warpgroup's are
        // done, and the barrier waits for the other's
        wg::wgmma_wait<0>();
        wg::fence_acc(acc);
        if (pending >= 0 && lane == 0) wg::mbar_arrive(&empty[pending]);
        pending = -1;
        wg::bar_sync(3, 256);
        fill_panel<BN>(panel, q, k, o, n0, k0, k1, ctid);
        wg::fence_proxy_async();  // the generic writes, before wgmma
        wg::bar_sync(3, 256);
        panel_unit = unit;
        panel_k0 = k0;
      }
      for (int kt = k0; kt < k1; ++kt) {
        wg::mbar_wait(&full[stage], phase);
        __syncwarp();
        const uint8_t* a = smem + stage * QA_BYTES + half * 64 * 128;
        const uint8_t* b = panel + (kt - k0) * T::SLICE;
        wg::fence_acc(acc);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QBK / 16; ++kk)
          wg::wgmma_bf16_kb<BN>(acc, wg::sw128_desc(a + 32 * kk, 16, 1024),
                                wg::sw128_desc(b + 32 * kk, 16, 1024),
                                kt != kb || kk != 0);
        wg::wgmma_commit();
        wg::fence_acc(acc);
        wg::wgmma_wait<1>();  // the previous slice's products are done
        if (pending >= 0 && lane == 0) wg::mbar_arrive(&empty[pending]);
        pending = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (lane == 0) wg::mbar_arrive(&empty[pending]);
    pending = -1;
    const int r0 = warp * 16 + lane / 4;  // and r0 + 8

    if (splits > 1) {
      // the split's f32 partial sums, to its slab of the workspace; the
      // reduce kernel adds the slabs in split order
      float* slab = work + (int64_t)sp * m * o;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + 64 * half + r0 + 8 * h;
          if (r < m && c < o)
            *reinterpret_cast<float2*>(slab + (int64_t)r * o + c) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      continue;
    }

    // epilogue: scale, bias and relu in f32, one rounding to bf16, the
    // tile staged in shared memory and written out by TMA stores, which
    // run on under the next tile's products
    if (tid < BN) {
      sc[tid] = s_col;
      sc[BN + tid] = b_col;
    }
    if (tid == 0) wg::tma_store_wait_read();  // the last tile's stores
    wg::bar_sync(1 + half, 128);  // have left e; the columns are written
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 sv = *reinterpret_cast<const float2*>(sc + c);
      float v[4] = {__fmul_rn(acc[4 * j], sv.x),
                    __fmul_rn(acc[4 * j + 1], sv.y),
                    __fmul_rn(acc[4 * j + 2], sv.x),
                    __fmul_rn(acc[4 * j + 3], sv.y)};
      if (bias != nullptr) {
        const float2 bv = *reinterpret_cast<const float2*>(sc + BN + c);
        v[0] = __fadd_rn(v[0], bv.x);
        v[1] = __fadd_rn(v[1], bv.y);
        v[2] = __fadd_rn(v[2], bv.x);
        v[3] = __fadd_rn(v[3], bv.y);
      }
      if (relu) {  // NaN passes, as in torch.relu
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (v[i] < 0.0f) v[i] = 0.0f;
      }
      // box j / 4, 16-byte chunk j % 4 of the row, swizzled by row / 2
      __nv_bfloat16* box = e + (j >> 2) * 2048 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(
          box + r0 * 32 + (((j & 3) ^ ((r0 >> 1) & 3)) << 3)) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(
          box + (r0 + 8) * 32 + (((j & 3) ^ (((r0 + 8) >> 1) & 3)) << 3)) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
    wg::fence_proxy_async();
    wg::bar_sync(1 + half, 128);
    if (tid == 0) {
      for (int bx = 0; bx < BN / 32 && n0 + 32 * bx < o; ++bx)
        wg::tma_store_2d(&ty, e + bx * 2048, n0 + 32 * bx, m0 + 64 * half);
      wg::tma_store_commit();
    }
  }
  if (tid == 0) wg::tma_store_wait_read();  // before the block's exit
}

// The split of K's second pass: y = relu?((sum of the splits' partial
// sums, in split order) * scale + bias), four columns a thread (O is a
// multiple of 8), the same two rounded operations as the epilogue, one
// rounding to bf16.  Launched as a programmatic dependent of the GEMM:
// it waits for the GEMM's completion before it reads the workspace.
__global__ void __launch_bounds__(256)
int8_gemm_reduce_kernel(const float* __restrict__ work,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, int m, int o,
                        int splits, int relu) {
  wg::grid_dependency_wait();
  const int64_t n = (int64_t)m * o, quads = n / 4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(4 * i % o);
    // every part's load in flight at once, then the sums in split order
    float4 p[QMAX_SPLITS];
#pragma unroll
    for (int sp = 0; sp < QMAX_SPLITS; ++sp)
      if (sp < splits)
        p[sp] = reinterpret_cast<const float4*>(work + sp * n)[i];
    float4 a = p[0];
#pragma unroll
    for (int sp = 1; sp < QMAX_SPLITS; ++sp) {
      if (sp >= splits) break;
      a.x = __fadd_rn(a.x, p[sp].x);
      a.y = __fadd_rn(a.y, p[sp].y);
      a.z = __fadd_rn(a.z, p[sp].z);
      a.w = __fadd_rn(a.w, p[sp].w);
    }
    float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __fmul_rn(v[j], scale[c + j]);
      if (bias != nullptr) v[j] = __fadd_rn(v[j], bias[c + j]);
      if (relu && v[j] < 0.0f) v[j] = 0.0f;  // NaN passes, as in torch.relu
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    reinterpret_cast<uint2*>(y)[i] =
        make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                   *reinterpret_cast<uint32_t*>(&hi));
  }
}

// The tile width for a shape: 32 where O fits in it, else 64.  Every
// tile streams its 128 rows' whole X, whatever its width, so the wider
// tile reads X fewer times; where the tiles are too few to busy the
// SMs, the wrapper splits K instead (ops/kernels/int8_gemm.k_splits).
int pick_bn(int o) { return o <= 32 ? 32 : 64; }

// a launch as a programmatic dependent of the kernel before it in the
// stream
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), int grid, int threads,
                     int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& ty, const void* q,
                 const void* scale, const void* bias, void* y, void* work,
                 int m, int k, int o, int relu, int splits, int sms,
                 cudaStream_t stream) {
  using T = QTile<BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_wgmma_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, QSMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  // the whole B panel beside at least QMIN_STAGES stages if it fits, the
  // rest of shared memory to the ring; else as many slices as fit
  const int nk = (k + QBK - 1) / QBK;
  const int avail = QSMEM - T::FIXED;
  int stages = QMIN_STAGES, pslices = nk;
  if (nk * T::SLICE + QMIN_STAGES * QA_BYTES <= avail)
    stages = std::min(QMAX_STAGES, (avail - nk * T::SLICE) / QA_BYTES);
  else
    pslices = (avail - QMIN_STAGES * QA_BYTES) / T::SLICE;
  const int smem =
      1024 + stages * QA_BYTES + pslices * T::SLICE + T::EPI + T::COLS +
      16 * stages;
  const long long items =
      (long long)((o + BN - 1) / BN) * ((m + QBM - 1) / QBM) * splits;
  const int grid = (int)(items < sms ? items : sms);
  int err = launch_dependent(
      int8_gemm_wgmma_kernel<BN>, grid, QTHREADS, smem, stream, tx, ty,
      (const int8_t*)q, (const float*)scale, (const float*)bias,
      (float*)work, m, k, o, relu, stages, pslices, splits);
  if (err != 0 || splits == 1) return err;
  const long long quads = (long long)m * o / 4;
  const int blocks = (int)std::min<long long>((quads + 255) / 256, 8 * sms);
  return launch_dependent(int8_gemm_reduce_kernel, blocks, 256, 0, stream,
                          (const float*)work, (const float*)scale,
                          (const float*)bias, (__nv_bfloat16*)y, m, o,
                          splits, relu);
}

}  // namespace

// bf16, the main path: K % 16 == 0, O % 8 == 0, M, K, O > 0 and X, q, Y
// 16-byte aligned, else cudaErrorInvalidValue (the wrapper sends every
// other shape to int8_gemm_bf16_mma).  ``splits`` (1 to the number of
// 64-deep K slices, at most 8) cuts K into that many parts, each summed by its own
// blocks into ``work``, (splits, M, O) f32 and 16-byte aligned, and
// added up in split order by a second kernel; with 1, ``work`` is unused.
extern "C" int int8_gemm_bf16(const void* x, const void* q,
                              const void* scale, const void* bias, void* y,
                              int m, int k, int o, int relu, int splits,
                              void* work, void* stream) {
  if (m <= 0 || k <= 0 || o <= 0 || k % 16 || o % 8 || !wg::aligned16(x) ||
      !wg::aligned16(q) || !wg::aligned16(y) || splits < 1 ||
      splits > QMAX_SPLITS || splits > (k + QBK - 1) / QBK ||
      (splits > 1 && (work == nullptr || !wg::aligned16(work))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty;
  if (!wg::bf16_box_map(&tx, x, (uint64_t)m, (uint64_t)k, QBM) ||
      !wg::bf16_box_map(&ty, y, (uint64_t)m, (uint64_t)o, 64, 32))
    return (int)cudaErrorInvalidValue;
  const int sms = wg::sm_count();
  const cudaStream_t s = (cudaStream_t)stream;
  if (pick_bn(o) == 32)
    return launch_wgmma<32>(tx, ty, q, scale, bias, y, work, m, k, o, relu,
                            splits, sms, s);
  return launch_wgmma<64>(tx, ty, q, scale, bias, y, work, m, k, o, relu,
                          splits, sms, s);
}

// bf16, the edge path: any shape and alignment, on mma.sync.
extern "C" int int8_gemm_bf16_mma(const void* x, const void* q,
                                  const void* scale, const void* bias,
                                  void* y, int m, int k, int o, int relu,
                                  void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  const int vec = k % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)q % 8 == 0;
  int8_gemm_bf16_kernel<<<grid_for(m, o), 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)y, m, k, o, relu, vec);
  return (int)cudaGetLastError();
}

extern "C" int int8_gemm_f32(const void* x, const void* q, const void* scale,
                             const void* bias, void* y, int m, int k, int o,
                             int relu, void* stream) {
  if (m == 0 || o == 0) return 0;
  if (!grid_ok(m)) return (int)cudaErrorInvalidValue;
  int8_gemm_f32_kernel<<<grid_for(m, o), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int8_t*)q, (const float*)scale,
      (const float*)bias, (float*)y, m, k, o, relu);
  return (int)cudaGetLastError();
}
