// Fused SGD step with momentum and weight decay over one f32 tensor,
// in place:
//   g  <- clip(g with NaNs zeroed, -clip, clip)      only when clip != 0
//   m' =  mom * m - lr * (g + wd * w)
//   w' =  w + m'
//
// Replaces the Pallas kernel cxxnet_tpu/ops/kernels/update_step.py:38
// (_sgd_kernel, reached by sgd_update, :53), which replays
// updater.SGDUpdater.apply op for op.
//
// Bound on the H100: bytes.  Five flops per element against 20 bytes
// (read w, g, m; write w, m).  The least traffic is exactly that.
//
// Design: a grid-stride elementwise loop, one read-modify-write of w
// and m per element (the trainer then drops the operands it prepared
// from the old weights).  The arithmetic uses the rounded intrinsics in
// the reference's order: nvcc contracts a*b+c into an FMA by default,
// which would round once where the plain version rounds twice, and the
// result would then differ from it in the last bit.  lr and mom are the
// host's float32 schedule values, wd and clip the tensor's own.  One
// launch per tensor, as the JAX package does; a multi-tensor launch is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sgd_update_kernel(float* __restrict__ w,
                                  const float* __restrict__ g,
                                  float* __restrict__ m, int64_t n, float lr,
                                  float mom, float wd, float clip) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float gv = g[i];
    if (clip != 0.0f) {
      if (isnan(gv)) gv = 0.0f;
      gv = fminf(fmaxf(gv, -clip), clip);
    }
    const float wv = w[i];
    const float step = __fmul_rn(lr, __fadd_rn(gv, __fmul_rn(wd, wv)));
    const float mv = __fsub_rn(__fmul_rn(mom, m[i]), step);
    m[i] = mv;
    w[i] = __fadd_rn(wv, mv);
  }
}

}  // namespace

extern "C" int sgd_update_f32(void* w, const void* g, void* m, long long n,
                              float lr, float mom, float wd, float clip,
                              void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond
  sgd_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)w, (const float*)g, (float*)m, (int64_t)n, lr, mom, wd, clip);
  return (int)cudaGetLastError();
}
