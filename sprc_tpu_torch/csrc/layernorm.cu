// LayerNorm in fp32 with an optional residual added first:
//
//   y = ((v - mean) * rsqrt(var + eps)) * w + b,   v = x (+ r),  in fp32
//
// Shared building block of the ViT block chain (the pre-LN norms of
// sprc_tpu/ops/pallas_block.py::_full_kernel, `_ln_f32(x32).astype(bf16)`)
// and of the Q-Former layer chain (the post-LN `LN(out + x)` of
// sprc_tpu/ops/pallas_qformer.py::_qf_layer_kernel); it replaces `_ln_f32`
// of both files. x, r and y are in the model dtype; w and b are fp32.
//
// With y8 set, the fp32 result is not rounded to the model dtype but
// quantised with a static scale, y8 = clip(rint(ln * inv), -127, 127): the
// `_q8(h1, 1 / a_qkv)` and `_q8(u, 1 / a_fc1)` of
// sprc_tpu/ops/pallas_block.py::_full_kernel_i8, which feed the int8 qkv and
// fc1 products. The int8 row is a quarter of the fp32 one, and the only
// copy of the normalised activation that reaches device memory.
//
// What bounds it: device memory. A row is read once (twice with a residual)
// and written once, and the arithmetic is a few operations per element, so
// the least time is the bytes over 3.35 TB/s (ViT-L's 16448 x 1024 bf16
// rows: 67.4 MB, 0.020 ms).
//
// The design keeps the memory system busy and everything else out of the
// way: one warp per row, four rows a block, the row held in fp32 registers
// (VEC values per 16-byte load: 8 bf16 or 4 fp32; 32 values a lane at W =
// 1024 bf16, 44 at 1408, 24 at 768 fp32), read once with 16-byte vector
// loads, reduced with warp shuffles only (no shared memory, no block
// barrier), and written with one 16-byte (int8: 8- or 4-byte) store per
// load. The widths of the main path (768, 1024, 1408) are template
// parameters, so the loops unroll and the tail mask folds away where a
// width is a whole number of warp steps; one generic instantiation in the
// same kernel takes every other W <= 4096 (the tail chunk of 1408 bf16 --
// 176 loads of 16 bytes over 32 lanes -- and the ragged widths are masked
// per load; a width that is not a whole number of 16-byte loads, or data
// that is not 16-byte aligned, takes the same kernel with one element a
// load).
//
// Arithmetic, as the JAX functions compute it: the mean, then the two-pass
// variance, the mean of (v - mean)^2; y = ((v - mean) * rstd) * w + b with
// every step rounded on its own (the plain PyTorch version's roundings), and
// the int8 code of that fp32 value. Only the order of the row sums differs
// from the plain version: each lane sums its own elements in order, then
// the 32 lane sums meet in a butterfly of shuffles (xor 16, 8, 4, 2, 1);
// ops/schedules.py::layer_norm_emulated walks the same order.
#include "common.cuh"

namespace {

constexpr int LN_WARPS = 4;  // rows (warps) a block
constexpr int MAXW = 4096;

// VEC consecutive elements of a row from p, as fp32
template <int VEC, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = sprc::to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = sprc::to_f32(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_param(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// WT > 0: the row width is WT (the instantiations of the main path's
// widths); WT == 0: the generic instantiation, width W <= MAXW at run time.
// VEC: elements a lane loads at once (16 bytes, or 1).
template <typename T, int WT, int VEC, bool Q8>
__global__ void __launch_bounds__(LN_WARPS * 32) layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ w,
    const float* __restrict__ bvec, T* __restrict__ y, int8_t* __restrict__ y8, float inv,
    int rows, int W, float eps) {
  constexpr int STEP = 32 * VEC;                       // elements a warp covers per load
  constexpr int CH = ((WT > 0 ? WT : MAXW) + STEP - 1) / STEP;  // loads a lane
  const int n = WT > 0 ? WT : W;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp: no shuffle is left waiting
  const size_t base = (size_t)row * n;

  float v[CH][VEC];
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * STEP + lane * VEC;
    if (i < n) {  // n % VEC == 0: a load lies wholly inside the row or wholly past it
      load_row<VEC>(x + base + i, v[c]);
      if (r) {
        float t[VEC];
        load_row<VEC>(r + base + i, t);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[c][e] = __fadd_rn(v[c][e], t[e]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = __fadd_rn(s, v[c][e]);
    }
  }
  const float mean = sprc::warp_sum(s) / n;
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c * STEP + lane * VEC < n) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = __fsub_rn(v[c][e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(sprc::warp_sum(sq) / n, eps));

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = c * STEP + lane * VEC;
    if (i >= n) continue;
    float wv[VEC], bv[VEC], out[VEC];
    load_param<VEC>(w + i, wv);
    load_param<VEC>(bvec + i, bv);
#pragma unroll
    for (int e = 0; e < VEC; ++e)  // every step rounded on its own, as the plain version does
      out[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mean), rstd), wv[e]), bv[e]);
    if constexpr (Q8) {
      if constexpr (VEC % 4 == 0) {  // four codes a 32-bit word
        uint32_t words[VEC / 4];
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        sprc::quantize_s8(__fmul_rn(out[4 * k + e], inv)))) << (8 * e);
          words[k] = word;
        }
        if constexpr (VEC == 8)
          *reinterpret_cast<uint2*>(y8 + base + i) = make_uint2(words[0], words[1]);
        else
          *reinterpret_cast<uint32_t*>(y8 + base + i) = words[0];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) y8[base + i + e] = sprc::quantize_s8(__fmul_rn(out[e], inv));
      }
    } else if constexpr (VEC * sizeof(T) == 16 && sizeof(T) == 2) {  // 8 bf16: 4 pairs
      uint32_t words[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 pair = __floats2bfloat162_rn(out[2 * k], out[2 * k + 1]);
        words[k] = *reinterpret_cast<uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(y + base + i) = make_uint4(words[0], words[1], words[2], words[3]);
    } else if constexpr (VEC * sizeof(T) == 16) {  // 4 fp32
      *reinterpret_cast<float4*>(y + base + i) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[base + i + e] = sprc::from_f32<T>(out[e]);
    }
  }
}

template <typename T, int WT, int VEC, bool Q8>
void run(const void* x, const void* r, const void* w, const void* b, void* y, void* y8,
         float inv, int rows, int W, float eps, cudaStream_t s) {
  layernorm_kernel<T, WT, VEC, Q8><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), static_cast<int8_t*>(y8), inv, rows, W,
      eps);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the instantiation for (W, alignment): a main-path width with 16-byte
// loads, else the generic one with 16-byte loads, else one element a load
template <typename T, bool Q8>
int launch(const void* x, const void* r, const void* w, const void* b, void* y, void* y8,
           float inv, int rows, int W, float eps, cudaStream_t s) {
  if (rows < 1 || W < 1 || W > MAXW) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool vec = W % V == 0 && aligned16(x) && (!r || aligned16(r)) && aligned16(w) &&
                   aligned16(b) && aligned16(Q8 ? y8 : y);
  if (vec && W == 768)
    run<T, 768, V, Q8>(x, r, w, b, y, y8, inv, rows, W, eps, s);
  else if (vec && W == 1024)
    run<T, 1024, V, Q8>(x, r, w, b, y, y8, inv, rows, W, eps, s);
  else if (vec && W == 1408)
    run<T, 1408, V, Q8>(x, r, w, b, y, y8, inv, rows, W, eps, s);
  else if (vec)
    run<T, 0, V, Q8>(x, r, w, b, y, y8, inv, rows, W, eps, s);
  else
    run<T, 0, 1, Q8>(x, r, w, b, y, y8, inv, rows, W, eps, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sprc_layernorm(const void* x, const void* r, const void* w, const void* b,
                              void* y, int rows, int W, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16)
    return launch<__nv_bfloat16, false>(x, r, w, b, y, nullptr, 0.0f, rows, W, eps, s);
  return launch<float, false>(x, r, w, b, y, nullptr, 0.0f, rows, W, eps, s);
}

// the int8-output mode: y8 [rows, W] codes with the static scale 1 / inv
extern "C" int sprc_layernorm_q8(const void* x, const void* r, const void* w, const void* b,
                                 void* y8, int rows, int W, float eps, float inv, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16)
    return launch<__nv_bfloat16, true>(x, r, w, b, nullptr, y8, inv, rows, W, eps, s);
  return launch<float, true>(x, r, w, b, nullptr, y8, inv, rows, W, eps, s);
}
