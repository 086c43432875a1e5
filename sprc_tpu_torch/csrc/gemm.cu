// Dense layer with a fused epilogue: Y = epi(X . W^T + b).
//
// Shared building block of the ViT block chain (replaces the four dense ops
// inside sprc_tpu/ops/pallas_block.py::_full_kernel) and of the Q-Former
// layer chain (the ten dense ops inside
// sprc_tpu/ops/pallas_qformer.py::_qf_layer_kernel).
//
// Layouts: X [M, K] row-major, W [N, K] row-major (torch Linear [out, in]),
// b [N] fp32 or null, R [M, N] (residual, model dtype) or null, Y [M, N].
// Epilogue, all in fp32: v = acc + b; v = act(v); then either Y = v or, with
// a residual, one of two modes: Y = R + round(v) in the model dtype (the JAX
// block kernels' `x + out.astype(x.dtype)`), or, with res_f32, Y = round(v + R)
// with the sum in fp32 and one rounding (the `acc + b2 + f32(x)` of
// sprc_tpu/ops/pallas_mlp.py::_mlp_kernel). In fp32 the two modes are the same
// sum. Rows and columns past M and N are masked
// (M = 257 B in the ViT; 32 B or 64 B in the Q-Former); K must be a
// multiple of 8 (bf16) or 4 (fp32), which the wrapper checks.
//
// Two paths:
// - bf16: tensor cores through WMMA (mma.sync, 16x16x16, fp32 accumulate).
//   128x128 block tile, 8 warps of 32x64, K step 32, a three-stage cp.async
//   ring of 16-byte copies into padded shared memory so that the next tiles
//   load while the current one multiplies. At ViT-L shapes (M = 257 B,
//   K = 1024..4096) the op is bound by tensor-core issue; wgmma and TMA,
//   which reach the card's full rate, are later work.
// - fp32: true fp32 FMA on the CUDA cores (no TF32), so that the Q-Former
//   matches the JAX fp32 Q-Former. 128x128 tile (8x8 outputs per thread), or
//   64x64 (4x4) when the problem is too small to fill the card with the
//   larger tile; K step 8, float4 shared-memory reads, two shared buffers
//   with the next tile staged through registers. Bound by the fp32 FMA rate.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ----------------------------------------------------------------- bf16

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8, STAGES = 3, THREADS = 256;
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr size_t SMEM_BF16 = STAGES * STAGE_ELEMS * sizeof(__nv_bfloat16);

using sprc::cp_async16;
using sprc::cp_async_commit;
using sprc::cp_async_wait;

__device__ __forceinline__ void load_stage(__nv_bfloat16* stage, const __nv_bfloat16* X,
                                           const __nv_bfloat16* W, int m0, int n0, int k0,
                                           int M, int N, int K) {
  __nv_bfloat16* As = stage;
  __nv_bfloat16* Bs = stage + BM * LDS;
#pragma unroll
  for (int it = 0; it < 2; ++it) {  // 128 rows x 32 columns = 512 chunks of 8 per operand
    int idx = threadIdx.x + it * THREADS;
    int r = idx / 4, c = (idx % 4) * 8;
    bool pa = m0 + r < M && k0 + c < K;
    bool pb = n0 + r < N && k0 + c < K;
    cp_async16(As + r * LDS + c, pa ? X + (size_t)(m0 + r) * K + k0 + c : X, pa);
    cp_async16(Bs + r * LDS + c, pb ? W + (size_t)(n0 + r) * K + k0 + c : W, pb);
  }
}

__device__ __forceinline__ void epilogue_store_bf16(
    float v, int row, int col, int N, const float* bias,
    const __nv_bfloat16* res, __nv_bfloat16* Y, int act, int res_f32) {
  if (bias) v += bias[col];
  v = sprc::apply_act(v, act);
  if (res) {
    float r = __bfloat162float(res[(size_t)row * N + col]);
    v = res_f32 ? v + r : r + __bfloat162float(__float2bfloat16(v));
  }
  Y[(size_t)row * N + col] = __float2bfloat16(v);
}

__global__ void __launch_bounds__(THREADS) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ Y, int M, int N, int K, int act, int res_f32) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_m = warp / 2;  // 4 warps down, 32 rows each
  const int warp_n = warp % 2;  // 2 warps across, 64 columns each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(smem + s * STAGE_ELEMS, X, W, m0, n0, s * BK, M, N, K);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread, and tile kt-1 is consumed
    const int pf = kt + STAGES - 1;
    if (pf < KT) load_stage(smem + (pf % STAGES) * STAGE_ELEMS, X, W, m0, n0, pf * BK, M, N, K);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (warp_m * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + (warp_n * 64 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it to stage the epilogue

  float* cs = reinterpret_cast<float*>(smem_raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int r = lane / 2, c = (lane % 2) * 8;
      int row = m0 + warp_m * 32 + i * 16 + r;
      int colb = n0 + warp_n * 64 + j * 16 + c;
      if (row < M) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          int col = colb + t;
          if (col < N) epilogue_store_bf16(cs[r * 16 + c + t], row, col, N, bias, res, Y, act,
                                               res_f32);
        }
      }
      __syncwarp();
    }
  }
}

// ----------------------------------------------------------------- fp32

constexpr int FK = 8;

__device__ __forceinline__ float4 load4(const float* base, int row, int rows, int k, int K) {
  if (row < rows && k < K) return *reinterpret_cast<const float4*>(base + (size_t)row * K + k);
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// TILE x TILE outputs per block (TILE 128: 8x8 per thread; TILE 64: 4x4, for
// problems too small to give the 128 tile enough blocks)
template <int TILE>
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ X, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ res,
    float* __restrict__ Y, int M, int N, int K, int act) {
  constexpr int R = TILE / 16;   // outputs per thread along each axis
  constexpr int LD = TILE + 4;
  __shared__ __align__(16) float As[2][FK][LD];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[2][FK][LD];  // transposed: Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const bool loader = tid < TILE * 2;  // TILE rows x 8 columns, one float4 per loader
  const int lr = tid / 2, lc = (tid % 2) * 4;
  const int KT = (K + FK - 1) / FK;
  float acc[R][R] = {};

  float4 ra = make_float4(0.0f, 0.0f, 0.0f, 0.0f), rb = ra;
  if (loader) {
    ra = load4(X, m0 + lr, M, lc, K);
    rb = load4(W, n0 + lr, N, lc, K);
    As[0][lc + 0][lr] = ra.x; As[0][lc + 1][lr] = ra.y; As[0][lc + 2][lr] = ra.z; As[0][lc + 3][lr] = ra.w;
    Bs[0][lc + 0][lr] = rb.x; Bs[0][lc + 1][lr] = rb.y; Bs[0][lc + 2][lr] = rb.z; Bs[0][lc + 3][lr] = rb.w;
  }
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt % 2;
    const bool more = loader && kt + 1 < KT;
    if (more) {
      ra = load4(X, m0 + lr, M, (kt + 1) * FK + lc, K);
      rb = load4(W, n0 + lr, N, (kt + 1) * FK + lc, K);
    }
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[R], b[R];
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        *reinterpret_cast<float4*>(a + 4 * q) =
            *reinterpret_cast<const float4*>(&As[cur][k][64 * q + ty * 4]);
        *reinterpret_cast<float4*>(b + 4 * q) =
            *reinterpret_cast<const float4*>(&Bs[cur][k][64 * q + tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      const int nxt = cur ^ 1;
      As[nxt][lc + 0][lr] = ra.x; As[nxt][lc + 1][lr] = ra.y; As[nxt][lc + 2][lr] = ra.z; As[nxt][lc + 3][lr] = ra.w;
      Bs[nxt][lc + 0][lr] = rb.x; Bs[nxt][lc + 1][lr] = rb.y; Bs[nxt][lc + 2][lr] = rb.z; Bs[nxt][lc + 3][lr] = rb.w;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = m0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = n0 + 64 * (j / 4) + tx * 4 + j % 4;
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[col];
      v = sprc::apply_act(v, act);
      if (res) v += res[(size_t)row * N + col];
      Y[(size_t)row * N + col] = v;
    }
  }
}

}  // namespace

extern "C" int sprc_gemm(const void* x, const void* w, const void* bias, const void* res,
                         void* y, int M, int N, int K, int dtype, int act, int res_f32,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<<<grid, THREADS, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(y), M, N, K, act, res_f32);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(bias);
    const float* rf = static_cast<const float*>(res);
    float* yf = static_cast<float*>(y);
    // the 128 tile when it still gives two blocks per SM (132 SMs), else 64
    if ((long long)((M + 127) / 128) * ((N + 127) / 128) >= 264) {
      dim3 grid((N + 127) / 128, (M + 127) / 128);
      gemm_f32_kernel<128><<<grid, 256, 0, s>>>(xf, wf, bf, rf, yf, M, N, K, act);
    } else {
      dim3 grid((N + 63) / 64, (M + 63) / 64);
      gemm_f32_kernel<64><<<grid, 256, 0, s>>>(xf, wf, bf, rf, yf, M, N, K, act);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
