// Activation quantisers for the int8 dense ops (csrc/gemm_i8.cu).
//
// - quantize_static: y8 = clip(rint(x * inv), -127, 127) with one calibrated
//   scale (inv = 1 / a). Replaces `_q8(ctx, 1 / a_proj)` of
//   sprc_tpu/ops/pallas_block.py::_full_kernel_i8, the quantisation of the
//   attention context before the output projection.
// - quantize_rows: per row, sc = max(amax|x|, 1e-8) * (1 / 127) and
//   y8 = clip(rint(x / sc), -127, 127); writes the codes and sc[row].
//   Replaces the activation half of
//   sprc_tpu/ops/pallas_qformer.py::_mm_i8 (per-row dynamic scales). It
//   divides where the TPU kernel divides: x * (1 / sc) rounds to other codes
//   at half steps.
//
// Both are bound by memory traffic (x read once or twice, one byte written
// per element). quantize_static is elementwise; quantize_rows gives one
// block of 256 threads to a row (W <= 4096 in the model) and reads the row
// a second time from L2 for the codes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) quantize_static_kernel(
    const T* __restrict__ x, int8_t* __restrict__ y, long long n, float inv) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    y[i] = sprc::quantize_s8(__fmul_rn(sprc::to_f32(x[i]), inv));
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ y, float* __restrict__ scales, int W) {
  __shared__ float red[8];
  const size_t base = (size_t)blockIdx.x * W;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    amax = fmaxf(amax, fabsf(sprc::to_f32(x[base + i])));
  amax = sprc::warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
  const float sc = __fmul_rn(fmaxf(amax, 1e-8f), static_cast<float>(1.0 / 127.0));
  if (threadIdx.x == 0) scales[blockIdx.x] = sc;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    y[base + i] = sprc::quantize_s8(__fdiv_rn(sprc::to_f32(x[base + i]), sc));
}

}  // namespace

extern "C" int sprc_quantize_static(const void* x, void* y, long long n, float inv, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  long long want = (n + 255) / 256;
  int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  if (dtype == sprc::kBF16)
    quantize_static_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(y), n, inv);
  else
    quantize_static_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(y), n, inv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sprc_quantize_rows(const void* x, void* y, void* scales, int rows, int W,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (dtype == sprc::kBF16)
    quantize_rows_kernel<__nv_bfloat16><<<rows, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(y),
        static_cast<float*>(scales), W);
  else
    quantize_rows_kernel<float><<<rows, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(y), static_cast<float*>(scales), W);
  return static_cast<int>(cudaGetLastError());
}
