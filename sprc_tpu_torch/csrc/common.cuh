// Shared helpers for the Hopper kernels of sprc_tpu_torch.
//
// Every kernel file exposes plain C entry points (extern "C") that take raw
// device pointers, sizes and a cudaStream_t, launch on that stream, do not
// synchronise, and return cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sprc {

// dtype codes shared with sprc_tpu_torch/ops/_ext.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// activation codes shared with sprc_tpu_torch/ops/_ext.py
constexpr int kActNone = 0;
constexpr int kActQuickGelu = 1;  // x * sigmoid(1.702 x), CLIP ViT
constexpr int kActGelu = 2;       // exact erf GELU, BERT / Q-Former

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the activation as a compile-time choice: a loop built on it holds one
// activation's code (with a run-time code the compiler may evaluate all of
// them for every element and select)
template <int ACT>
__device__ __forceinline__ float apply_act_static(float v) {
  if constexpr (ACT == kActQuickGelu) return v / (1.0f + expf(-1.702f * v));
  else if constexpr (ACT == kActGelu) return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
  else return v;
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActQuickGelu) return apply_act_static<kActQuickGelu>(v);
  if (act == kActGelu) return apply_act_static<kActGelu>(v);
  return v;
}

// symmetric int8 code of an already scaled value: clip(rint(v), -127, 127),
// round half to even (jnp.round, torch.round)
__device__ __forceinline__ int8_t quantize_s8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

// 16-byte asynchronous copy into shared memory; pred false fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace sprc
