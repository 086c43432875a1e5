// LayerNorm in fp32 with an optional residual added first:
//
//   y = ((v - mean) * rsqrt(var + eps)) * w + b,   v = x (+ r),  in fp32
//
// Shared building block of the ViT block chain (the pre-LN norms of
// sprc_tpu/ops/pallas_block.py::_full_kernel, `_ln_f32(x32).astype(bf16)`)
// and of the Q-Former layer chain (the post-LN `LN(out + x)` of
// sprc_tpu/ops/pallas_qformer.py::_qf_layer_kernel). x, r and y are in the
// model dtype; w and b are fp32.
//
// With y8 set, the fp32 result is not rounded to the model dtype but
// quantised with a static scale, y8 = clip(rint(ln * inv), -127, 127): the
// `_q8(h1, 1 / a_qkv)` and `_q8(u, 1 / a_fc1)` of
// sprc_tpu/ops/pallas_block.py::_full_kernel_i8, which feed the int8 qkv and
// fc1 products. The int8 row is a quarter of the fp32 one, and the only
// copy of the normalised activation that reaches device memory.
//
// One block of 256 threads per row; the row (W <= 4096) is held in shared
// memory in fp32 so that the variance is the two-pass mean of (v - mean)^2,
// as the JAX kernels compute it. The op is bound by memory traffic: it reads
// the row once (twice with a residual) and writes it once.
#include "common.cuh"

namespace {

constexpr int MAXW = 4096;

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = sprc::warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (threadIdx.x < blockDim.x / 32) ? red[threadIdx.x] : 0.0f;
  if (warp == 0) t = sprc::warp_sum(t);
  if (threadIdx.x == 0) red[0] = t;
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(256) layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ bvec, T* __restrict__ y, int8_t* __restrict__ y8, float inv,
    int W, float eps) {
  __shared__ float row[MAXW];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * W;
  float s = 0.0f;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    float v = sprc::to_f32(x[base + i]);
    if (r) v += sprc::to_f32(r[base + i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / W;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    float d = row[i] - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) / W + eps);
  if (y8) {  // every step rounded on its own, as the plain PyTorch version does
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      float v = __fadd_rn(__fmul_rn(__fmul_rn(row[i] - mean, rstd), w[i]), bvec[i]);
      y8[base + i] = sprc::quantize_s8(__fmul_rn(v, inv));
    }
    return;
  }
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    y[base + i] = sprc::from_f32<T>((row[i] - mean) * rstd * w[i] + bvec[i]);
}

template <typename T>
int launch(const void* x, const void* r, const void* w, const void* b, void* y, void* y8,
           float inv, int rows, int W, float eps, cudaStream_t s) {
  layernorm_kernel<T><<<rows, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<int8_t*>(y8), inv, W, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sprc_layernorm(const void* x, const void* r, const void* w, const void* b,
                              void* y, int rows, int W, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16)
    return launch<__nv_bfloat16>(x, r, w, b, y, nullptr, 0.0f, rows, W, eps, s);
  return launch<float>(x, r, w, b, y, nullptr, 0.0f, rows, W, eps, s);
}

// the int8-output mode: y8 [rows, W] codes with the static scale 1 / inv
extern "C" int sprc_layernorm_q8(const void* x, const void* r, const void* w, const void* b,
                                 void* y8, int rows, int W, float eps, float inv, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16)
    return launch<__nv_bfloat16>(x, r, w, b, nullptr, y8, inv, rows, W, eps, s);
  return launch<float>(x, r, w, b, nullptr, y8, inv, rows, W, eps, s);
}
