// How fast the card issues mma.sync.m16n8k8 with tf32 operands (the
// instruction K1, csrc/token_max_sim.cu, and the fp32 attention run in
// 3xTF32): every warp of `blocks` x `warps` issues `iters` rounds of ACC
// products into ACC independent accumulators, with nothing else in the loop.
// Not part of the kernel library: cli/kernel_sweep.py builds it alone
// (ops/_ext.py::build_alone) and times one launch with CUDA events.
#include <cuda_runtime.h>

#include "tf32.cuh"

namespace {

template <int ACC>
__global__ void mma_tf32_rate_kernel(float* out, int iters) {
  const float x = 1e-3f * (threadIdx.x + 1);
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(x * (i + 1));
  const uint32_t b0 = __float_as_uint(-x), b1 = __float_as_uint(x * 0.5f);
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < ACC; ++k) sprc::mma_1688_tf32(c[k], a, b0, b1);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < ACC; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: blocks x warps x 32 floats; acc: 4 or 8 accumulators a warp
extern "C" int sprc_probe_mma_tf32(void* out, int blocks, int warps, int iters, int acc,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (acc == 4)
    mma_tf32_rate_kernel<4><<<blocks, warps * 32, 0, s>>>(o, iters);
  else if (acc == 8)
    mma_tf32_rate_kernel<8><<<blocks, warps * 32, 0, s>>>(o, iters);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
