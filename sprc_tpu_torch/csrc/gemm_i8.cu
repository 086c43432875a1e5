// Int8 dense layer on the tensor cores: Y = epi(s32(A8 . W8^T)).
//
// Replaces the s8 x s8 -> s32 products of three TPU kernels:
// - the four dense ops of sprc_tpu/ops/pallas_block.py::_full_kernel_i8
//   (fused_vit_block_i8: static per-tensor activation scales);
// - the ten dense ops of sprc_tpu/ops/pallas_qformer.py::_qf_layer_kernel_i8
//   (_mm_i8: per-row dynamic activation scales);
// - scripts/ablate_int8.py::mode_pallas, the tiled s8 matmul with an s32
//   accumulator (the raw output mode here).
//
// Layouts: A8 [M, K] int8 row-major, W8 [N, K] int8 row-major (torch Linear
// [out, in]; each output column's K values are contiguous, which is the
// `col` operand of mma.sync m16n8k32), Y [M, N]. The product accumulates in
// s32 and is exact. Epilogue, per element, in fp32 after float(acc) and with
// every step rounded on its own (no fused multiply-add, so that the plain
// PyTorch version computes the same bits):
//
//   raw:    Y = acc                                   (s32)
//   else:   v = acc (* row_scale[m]) * (col_scale[n] * col_alpha) (+ bias[n]);
//           v = act(v)
//   f32:    Y = v (+ R)
//   bf16:   Y = bf16(v), or bf16(R + bf16(v)) with a residual
//   int8:   Y = clip(rint(v * out_inv), -127, 127)    (the next op's codes)
//
// col_alpha is the static activation scale of the ViT block's dense ops: the
// TPU kernel rescales by the vector `w_scale * a_x`, and the product of the
// two fp32 values is formed here per element, to the same bits, so that no
// launch is spent on making that vector. The Q-Former's ops pass 1.
//
// Rows past M and columns past N are masked (M = 257 B in the ViT). The
// wrapper checks K % 16 == 0, N % 2 == 0 and 16-byte aligned operands.
//
// Design: 8 warps, block tile (64 MT) x 128 with MT = 2 or 1 (the smaller
// tile when the larger would leave SMs without a block: the Q-Former's dense
// ops have M = 2048), warp tile (16 MT) x 64, K step 64 bytes, a three-stage
// cp.async ring of 16-byte copies into shared memory with an 80-byte row
// pitch (fragment reads are 32-bit and bank-conflict free). Each k32 step
// runs 8 MT mma.sync.m16n8k32.s8 per warp. At ViT-L shapes the op is
// bound by the tensor cores (2 M N K operations against 1,979 TOP/s), not
// by memory; wgmma and TMA, which reach the card's full rate, are later
// work.
#include "common.cuh"

using sprc::cp_async16;
using sprc::cp_async_commit;
using sprc::cp_async_wait;

namespace {

constexpr int BN = 128, BK = 64, LDS = BK + 16, STAGES = 3, THREADS = 256;

// output modes shared with sprc_tpu_torch/ops/_ext.py
constexpr int kOutS32 = 0, kOutF32 = 1, kOutBF16 = 2;  // 3: int8 codes

struct Epilogue {
  const float* row_scale;  // [M] or null
  const float* col_scale;  // [N] (null in raw mode)
  const float* bias;       // [N] or null
  const void* res;         // [M, N] in the output type, or null
  void* y;
  int out, act;
  float out_inv, col_alpha;
};

template <int BM>
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* A, const int8_t* W,
                                           int m0, int n0, int k0, int M, int N, int K) {
  int8_t* As = stage;
  int8_t* Bs = stage + BM * LDS;
  for (int idx = threadIdx.x; idx < BM * 4; idx += THREADS) {  // 4 chunks of 16 per row
    int r = idx / 4, c = (idx % 4) * 16;
    bool p = m0 + r < M && k0 + c < K;
    cp_async16(As + r * LDS + c, p ? A + (size_t)(m0 + r) * K + k0 + c : A, p);
  }
  for (int idx = threadIdx.x; idx < BN * 4; idx += THREADS) {
    int r = idx / 4, c = (idx % 4) * 16;
    bool p = n0 + r < N && k0 + c < K;
    cp_async16(Bs + r * LDS + c, p ? W + (size_t)(n0 + r) * K + k0 + c : W, p);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring columns (col even, col + 1 < N) of one row
__device__ __forceinline__ void store_pair(const Epilogue& e, int row, int col, int N,
                                           int c0, int c1) {
  const size_t at = (size_t)row * N + col;
  if (e.out == kOutS32) {
    *reinterpret_cast<int2*>(static_cast<int*>(e.y) + at) = make_int2(c0, c1);
    return;
  }
  float v0 = __int2float_rn(c0), v1 = __int2float_rn(c1);
  if (e.row_scale) {
    const float rs = e.row_scale[row];
    v0 = __fmul_rn(v0, rs);
    v1 = __fmul_rn(v1, rs);
  }
  v0 = __fmul_rn(v0, __fmul_rn(e.col_scale[col], e.col_alpha));
  v1 = __fmul_rn(v1, __fmul_rn(e.col_scale[col + 1], e.col_alpha));
  if (e.bias) {
    v0 = __fadd_rn(v0, e.bias[col]);
    v1 = __fadd_rn(v1, e.bias[col + 1]);
  }
  v0 = sprc::apply_act(v0, e.act);
  v1 = sprc::apply_act(v1, e.act);
  if (e.out == kOutF32) {
    if (e.res) {
      const float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(e.res) + at);
      v0 = __fadd_rn(r.x, v0);
      v1 = __fadd_rn(r.y, v1);
    }
    *reinterpret_cast<float2*>(static_cast<float*>(e.y) + at) = make_float2(v0, v1);
  } else if (e.out == kOutBF16) {
    __nv_bfloat16 b0 = __float2bfloat16(v0), b1 = __float2bfloat16(v1);
    if (e.res) {
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
          static_cast<const __nv_bfloat16*>(e.res) + at);
      b0 = __float2bfloat16(__fadd_rn(__bfloat162float(r.x), __bfloat162float(b0)));
      b1 = __float2bfloat16(__fadd_rn(__bfloat162float(r.y), __bfloat162float(b1)));
    }
    __nv_bfloat162 o;
    o.x = b0;
    o.y = b1;
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.y) + at) = o;
  } else {
    char2 o;
    o.x = sprc::quantize_s8(__fmul_rn(v0, e.out_inv));
    o.y = sprc::quantize_s8(__fmul_rn(v1, e.out_inv));
    *reinterpret_cast<char2*>(static_cast<int8_t*>(e.y) + at) = o;
  }
}

// MT: 16-row mma tiles per warp; the block tile is (64 MT) x 128
template <int MT>
__global__ void __launch_bounds__(THREADS) gemm_i8_kernel(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W, Epilogue e, int M, int N,
    int K) {
  constexpr int BM = 64 * MT;
  constexpr int STAGE_BYTES = (BM + BN) * LDS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 2;  // 4 warps down, 16 MT rows each
  const int warp_n = warp % 2;  // 2 warps across, 64 columns each
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  int acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<BM>(smem + s * STAGE_BYTES, A, W, m0, n0, s * BK, M, N, K);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread, and tile kt-1 is consumed
    const int pf = kt + STAGES - 1;
    if (pf < KT)
      load_stage<BM>(smem + (pf % STAGES) * STAGE_BYTES, A, W, m0, n0, pf * BK, M, N, K);
    cp_async_commit();
    const int8_t* As = smem + (kt % STAGES) * STAGE_BYTES;
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // m16n8k32 fragments: A rows g and g + 8, k bytes 4t..4t+3 and 16 + the
      // same; B column g, the same k bytes
      uint32_t a[MT][4], b[8][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (warp_m * MT * 16 + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* p = Bs + (warp_n * 64 + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout: c0, c1 at (row g, columns 2t, 2t + 1); c2, c3 at row g + 8.
  // One row at a time, its eight column pairs in turn. The compiler keeps the
  // h loop rolled and indexes acc through 256 bytes of local memory for the
  // 128-row tile. A fully unrolled epilogue (rows g and g + 8 interleaved, acc
  // in registers throughout) was tried on an H100 in the same run: faster on
  // the raw 4096^3 product, slower on the tower's qkv, proj and fc1 products
  // (M = 16448), which are what the served path runs. So this order stays.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp_m * MT * 16 + i * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + warp_n * 64 + j * 8 + t * 2;
        if (col < N) store_pair(e, row, col, N, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int MT>
cudaError_t launch(const int8_t* a, const int8_t* w, const Epilogue& e, int M, int N, int K,
                   cudaStream_t s) {
  constexpr int BM = 64 * MT;
  constexpr int SMEM = STAGES * (BM + BN) * LDS;
  cudaError_t err = cudaFuncSetAttribute(gemm_i8_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<MT><<<grid, THREADS, SMEM, s>>>(a, w, e, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sprc_gemm_i8(const void* a, const void* w, const void* row_scale,
                            const void* col_scale, const void* bias, const void* res, void* y,
                            int M, int N, int K, int out, int act, float out_inv,
                            float col_alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue e{static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
             static_cast<const float*>(bias), res, y, out, act, out_inv, col_alpha};
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  // the 128-row tile when it still gives two blocks per SM (132 SMs), else 64 rows
  const long long blocks128 = (long long)((M + 127) / 128) * ((N + BN - 1) / BN);
  cudaError_t err = blocks128 >= 264 ? launch<2>(a8, w8, e, M, N, K, s)
                                     : launch<1>(a8, w8, e, M, N, K, s);
  return static_cast<int>(err);
}
