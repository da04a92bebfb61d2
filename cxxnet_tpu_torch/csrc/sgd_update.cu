// Fused SGD step with momentum and weight decay, over every f32 tensor
// of a step in one launch, in place:
//   g  <- clip(g with NaNs zeroed, -clip, clip)      only when clip != 0
//   m' =  mom * m - lr * (g + wd * w)
//   w' =  w + m'
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/update_step.py:38
// (_sgd_kernel, reached by sgd_update, :53), which replays
// updater.SGDUpdater.apply op for op, once per tensor.
//
// Bound on the H100: bytes.  Five flops per element against 20 bytes
// (read w, g, m; write w, m).  The least traffic is exactly that: for
// GoogLeNet's 116 tensors (6,998,552 values) 140 MB, 0.042 ms.  One
// launch per tensor spent ~10 us of launch overhead on each, so the
// step's update followed the host (1.2-2.8 ms); one launch for all of
// them leaves the bytes.
//
// Design: the host passes a table of tensors by value (a
// __grid_constant__ struct, up to MAX_TENSORS entries of 64 bytes,
// 30,736 bytes in all: CUDA 12.1 and later take 32,764 bytes of kernel
// parameters; GoogLeNet's 116 tensors, ResNet-50's 161 and ResNet-152's
// 467 each fit one table), each entry with
// its pointers, size, its four scalars and the index of its first
// chunk.  The grid walks a flat list of CHUNK-value chunks; a block
// finds the tensor of its chunk by a binary search over the entries'
// first chunks.  A tensor whose size is a multiple of 4 and whose three
// pointers are 16-byte aligned is read and written as float4, any other
// as scalars.  The arithmetic uses the rounded intrinsics in the
// reference's order: nvcc contracts a*b+c into an FMA by default, which
// would round once where the plain version rounds twice, and the result
// would then differ from it in the last bit.  lr and mom are the host's
// float32 schedule values, wd and clip the tensor's own.  A step with
// more tensors than MAX_TENSORS takes one launch per MAX_TENSORS (the
// wrapper splits them).

#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION < 12010
#error "sgd_update.cu passes its tensor table as a kernel parameter of 30 KB, which needs CUDA 12.1 or later"
#endif

namespace {

constexpr int MAX_TENSORS = 480;  // update_step.MAX_TENSORS
constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 8;  // values a block takes at a time

struct Entry {
  float* w;
  const float* g;
  float* m;
  long long n;
  float lr, mom, wd, clip;
  long long chunk0;  // the index of the tensor's first chunk
  int vec;           // 1: float4 loads and stores
  int pad_;
};

struct Table {
  Entry e[MAX_TENSORS];
  int count;
  long long chunks;  // all tensors' chunks
};

__device__ __forceinline__ void sgd_one(float& w, float g, float& m,
                                        const Entry& t) {
  if (t.clip != 0.0f) {
    if (isnan(g)) g = 0.0f;
    g = fminf(fmaxf(g, -t.clip), t.clip);
  }
  const float step = __fmul_rn(t.lr, __fadd_rn(g, __fmul_rn(t.wd, w)));
  const float mv = __fsub_rn(__fmul_rn(t.mom, m), step);
  m = mv;
  w = __fadd_rn(w, mv);
}

__global__ void __launch_bounds__(THREADS)
sgd_update_multi_kernel(__grid_constant__ const Table tab) {
  for (long long c = blockIdx.x; c < tab.chunks; c += gridDim.x) {
    int lo = 0, hi = tab.count - 1;  // the last entry with chunk0 <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.e[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Entry& t = tab.e[lo];
    const long long begin = (c - t.chunk0) * CHUNK;
    const long long end = begin + CHUNK < t.n ? begin + CHUNK : t.n;
    if (t.vec) {  // begin is a multiple of 4, and so is end
      for (long long i = begin / 4 + threadIdx.x; i < end / 4;
           i += THREADS) {
        float4 w = reinterpret_cast<const float4*>(t.w)[i];
        const float4 g = reinterpret_cast<const float4*>(t.g)[i];
        float4 m = reinterpret_cast<const float4*>(t.m)[i];
        sgd_one(w.x, g.x, m.x, t);
        sgd_one(w.y, g.y, m.y, t);
        sgd_one(w.z, g.z, m.z, t);
        sgd_one(w.w, g.w, m.w, t);
        reinterpret_cast<float4*>(t.m)[i] = m;
        reinterpret_cast<float4*>(t.w)[i] = w;
      }
    } else {
      for (long long i = begin + threadIdx.x; i < end; i += THREADS) {
        float w = t.w[i], m = t.m[i];
        sgd_one(w, t.g[i], m, t);
        t.m[i] = m;
        t.w[i] = w;
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

static_assert(sizeof(Entry) == 64 && sizeof(Table) <= 32764,
              "the tensor table must fit the kernel parameter space");

}  // namespace

// One launch over ``count`` tensors (at most MAX_TENSORS): ptrs holds
// the w, then the g, then the m pointers (3 x count), n the tensors'
// sizes, hyper their lr, then mom, wd and clip (4 x count, float32).
extern "C" int sgd_update_multi_f32(int count, const uint64_t* ptrs,
                                    const long long* n, const float* hyper,
                                    void* stream) {
  if (count < 0 || count > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  Table tab;
  tab.count = 0;
  tab.chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    Entry& e = tab.e[tab.count++];
    e.w = (float*)ptrs[i];
    e.g = (const float*)ptrs[count + i];
    e.m = (float*)ptrs[2 * count + i];
    e.n = n[i];
    e.lr = hyper[i];
    e.mom = hyper[count + i];
    e.wd = hyper[2 * count + i];
    e.clip = hyper[3 * count + i];
    e.chunk0 = tab.chunks;
    e.vec = n[i] % 4 == 0 && aligned16(e.w) && aligned16(e.g) &&
            aligned16(e.m);
    e.pad_ = 0;
    tab.chunks += (n[i] + CHUNK - 1) / CHUNK;
  }
  if (tab.count == 0) return 0;
  long long blocks = tab.chunks;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // chunk-stride beyond
  sgd_update_multi_kernel<<<(unsigned)blocks, THREADS, 0,
                            (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
}

// One tensor: the same kernel with a one-entry table.
extern "C" int sgd_update_f32(void* w, const void* g, void* m, long long n,
                              float lr, float mom, float wd, float clip,
                              void* stream) {
  const uint64_t ptrs[3] = {(uint64_t)w, (uint64_t)g, (uint64_t)m};
  const float hyper[4] = {lr, mom, wd, clip};
  return sgd_update_multi_f32(1, ptrs, &n, hyper, stream);
}
