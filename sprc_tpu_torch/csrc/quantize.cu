// Activation quantisers for the int8 dense ops (csrc/gemm_i8.cu).
//
// - quantize_static: y8 = clip(rint(x * inv), -127, 127) with one calibrated
//   scale (inv = 1 / a). Replaces `_q8(ctx, 1 / a_proj)` of
//   sprc_tpu/ops/pallas_block.py::_full_kernel_i8 (`_q8`, :417), the
//   quantisation of the attention context before the output projection.
// - quantize_rows: per row, sc = max(amax|x|, 1e-8) * (1 / 127) and
//   y8 = clip(rint(x / sc), -127, 127); writes the codes and sc[row].
//   Replaces the activation half of
//   sprc_tpu/ops/pallas_qformer.py::_mm_i8 (:55, per-row dynamic scales). It
//   divides where the TPU kernel divides (IEEE division, __fdiv_rn):
//   x * (1 / sc) rounds to other codes at half steps.
//
// What bounds both: device memory. x is read once and one byte a value is
// written (and a scale a row), with a few operations a value, so the least
// time is the bytes over 3.35 TB/s: ViT-L's ctx, 16448 x 1024 bf16, 50.5 MB,
// 0.0151 ms; the Q-Former's image rows, 16448 x 1024 fp32, 84.3 MB, 0.0252 ms.
//
// The designs keep enough bytes in flight and read each value once.
// - quantize_static is a pure stream: each thread issues UNROLL independent
//   16-byte loads (8 bf16 or 4 fp32 values) before it converts any, and
//   writes 8 or 4 bytes of codes per load; the grid is four blocks of 256 an
//   SM, all resident at once (at most 64 registers a thread), each thread
//   striding over the whole tensor, the last step masked.
// - quantize_rows gives one warp to a row, four rows a block. The row is
//   read once with 16-byte loads into fp32 registers (VEC values a load;
//   24 a lane at 768 fp32, 32 at 1024, 44 at 1408, 96 at 3072), its |max| is
//   taken with warp shuffles (no shared memory, no block barrier), and the
//   codes are written from the same registers, lane 0 writing the scale.
//   The main path's widths (768, 1024, 1408, 3072) are template parameters,
//   so the loops unroll and the mask folds away; one generic instantiation
//   takes every other W <= 4096, its last load masked per lane.
// Either kernel takes data that is not 16-byte aligned, or a length (a row
// width) that is not a whole number of 16-byte loads, one element a load
// (the rule of csrc/layernorm.cu).
//
// Arithmetic, bit for bit the plain versions' (ops/quant.py) and the JAX
// kernels': the product x * inv rounded once (__fmul_rn), the scale
// max(amax, 1e-8) * f32(1 / 127) rounded once, the quotient x / sc rounded
// once, and sprc::quantize_s8 (rint, half to even; clip). The |max| is exact
// in any order.
#include "common.cuh"
#include "hopper.cuh"  // sm_count

namespace {

constexpr int STATIC_THREADS = 256;
constexpr int STATIC_UNROLL = 4;         // 16-byte loads a thread has in flight
constexpr int STATIC_BLOCKS_PER_SM = 4;  // 1024 threads, 64 KB of loads in flight an SM
constexpr int ROWS_WARPS = 4;     // rows (warps) a block
constexpr int MAXW = 4096;        // the widest row quantize_rows takes

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// VEC consecutive values, as they lie in memory: one 16-byte load, or VEC loads of one
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <int VEC, typename T>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* __restrict__ p) {
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&raw);
  } else {
    Pack<T, VEC> r;
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.e[i] = p[i];
    return r;
  }
}

// VEC codes to y: one 8- or 4-byte store (four codes a 32-bit word), or VEC of one
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ y, const int8_t (&c)[VEC]) {
  if constexpr (VEC % 4 == 0) {
    uint32_t words[VEC / 4];
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(c[4 * k + e])) << (8 * e);
      words[k] = word;
    }
    if constexpr (VEC == 8)
      *reinterpret_cast<uint2*>(y) = make_uint2(words[0], words[1]);
    else
      *reinterpret_cast<uint32_t*>(y) = words[0];
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = c[e];
  }
}

// ----------------------------------------------------------- quantize_static

// nv loads of VEC values; thread t takes loads t, t + T, ... (T threads in
// the grid), UNROLL of them at once
template <typename T, int VEC>
__global__ void __launch_bounds__(STATIC_THREADS, STATIC_BLOCKS_PER_SM) quantize_static_kernel(
    const T* __restrict__ x, int8_t* __restrict__ y, long long nv, float inv) {
  const long long stride = (long long)gridDim.x * STATIC_THREADS;
  for (long long v0 = (long long)blockIdx.x * STATIC_THREADS + threadIdx.x; v0 < nv;
       v0 += STATIC_UNROLL * stride) {
    Pack<T, VEC> raw[STATIC_UNROLL];  // held as loaded: four registers a 16-byte load
#pragma unroll
    for (int u = 0; u < STATIC_UNROLL; ++u)  // every load issued before any is used
      if (v0 + u * stride < nv) raw[u] = load_pack<VEC>(x + (v0 + u * stride) * VEC);
#pragma unroll
    for (int u = 0; u < STATIC_UNROLL; ++u) {
      const long long i = v0 + u * stride;
      if (i < nv) {
        int8_t c[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          c[e] = sprc::quantize_s8(__fmul_rn(sprc::to_f32(raw[u].e[e]), inv));
        store_codes<VEC>(y + i * VEC, c);
      }
    }
  }
}

template <typename T, int VEC>
void run_static(const void* x, void* y, long long n, float inv, cudaStream_t s) {
  const long long nv = n / VEC;
  const long long want = (nv + (long long)STATIC_THREADS * STATIC_UNROLL - 1) /
                         ((long long)STATIC_THREADS * STATIC_UNROLL);
  const long long full = (long long)sprc::sm_count() * STATIC_BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < full || full < 1 ? want : full);
  quantize_static_kernel<T, VEC><<<blocks, STATIC_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(y), nv, inv);
}

template <typename T>
int launch_static(const void* x, void* y, long long n, float inv, cudaStream_t s) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (n % V == 0 && aligned16(x) && aligned16(y))
    run_static<T, V>(x, y, n, inv, s);
  else
    run_static<T, 1>(x, y, n, inv, s);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- quantize_rows

// WT > 0: the row width is WT (the main path's widths); WT == 0: the generic
// instantiation, width W <= MAXW at run time. VEC: values a lane loads at
// once (16 bytes, or 1).
template <typename T, int WT, int VEC>
__global__ void __launch_bounds__(ROWS_WARPS * 32) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ y, float* __restrict__ scales, int rows,
    int W) {
  constexpr int STEP = 32 * VEC;                                // values a warp covers per load
  constexpr int CH = ((WT > 0 ? WT : MAXW) + STEP - 1) / STEP;  // loads a lane
  const int n = WT > 0 ? WT : W;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp: no shuffle is left waiting
  const size_t base = (size_t)row * n;

  float v[CH][VEC];
  float amax = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * STEP + lane * VEC;
    if (i < n) {  // n % VEC == 0: a load lies wholly inside the row or wholly past it
      const Pack<T, VEC> raw = load_pack<VEC>(x + base + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[c][e] = sprc::to_f32(raw.e[e]);
        amax = fmaxf(amax, fabsf(v[c][e]));
      }
    }
  }
  amax = sprc::warp_max(amax);
  const float sc = __fmul_rn(fmaxf(amax, 1e-8f), static_cast<float>(1.0 / 127.0));
  if (lane == 0) scales[row] = sc;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * STEP + lane * VEC;
    if (i < n) {
      int8_t codes[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) codes[e] = sprc::quantize_s8(__fdiv_rn(v[c][e], sc));
      store_codes<VEC>(y + base + i, codes);
    }
  }
}

template <typename T, int WT, int VEC>
void run_rows(const void* x, void* y, void* scales, int rows, int W, cudaStream_t s) {
  quantize_rows_kernel<T, WT, VEC><<<(rows + ROWS_WARPS - 1) / ROWS_WARPS, ROWS_WARPS * 32, 0,
                                     s>>>(static_cast<const T*>(x), static_cast<int8_t*>(y),
                                          static_cast<float*>(scales), rows, W);
}

// the instantiation for (W, alignment): a main-path width with 16-byte loads,
// else the generic one with 16-byte loads, else one value a load
template <typename T>
int launch_rows(const void* x, void* y, void* scales, int rows, int W, cudaStream_t s) {
  if (rows < 0 || W < 1 || W > MAXW) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  const bool vec = W % V == 0 && aligned16(x) && aligned16(y);
  if (vec && W == 768)
    run_rows<T, 768, V>(x, y, scales, rows, W, s);
  else if (vec && W == 1024)
    run_rows<T, 1024, V>(x, y, scales, rows, W, s);
  else if (vec && W == 1408)
    run_rows<T, 1408, V>(x, y, scales, rows, W, s);
  else if (vec && W == 3072)
    run_rows<T, 3072, V>(x, y, scales, rows, W, s);
  else if (vec)
    run_rows<T, 0, V>(x, y, scales, rows, W, s);
  else
    run_rows<T, 0, 1>(x, y, scales, rows, W, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sprc_quantize_static(const void* x, void* y, long long n, float inv, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16) return launch_static<__nv_bfloat16>(x, y, n, inv, s);
  return launch_static<float>(x, y, n, inv, s);
}

extern "C" int sprc_quantize_rows(const void* x, void* y, void* scales, int rows, int W,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16) return launch_rows<__nv_bfloat16>(x, y, scales, rows, W, s);
  return launch_rows<float>(x, y, scales, rows, W, s);
}
