// Multi-head attention with an optional additive column bias; the head dim D
// is a compile-time parameter, built for 64 (CLIP ViT-L, the Q-Former) and 88
// (EVA ViT-g).
//
//   ctx[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h] * scale + bias[b, j]) v[b,j,h]
//
// Shared building block of the ViT block chain (replaces the attention of
// sprc_tpu/ops/pallas_block.py::_attend inside _full_kernel and _kernel), of
// the Q-Former layer chain (sprc_tpu/ops/pallas_qformer.py::_attend_bias, both
// the self-attention with its 0 / -10000 column bias and the cross-attention
// of the Q query rows into the 257 image rows, Sq != Sk), and, called on its
// own, the port of sprc_tpu/ops/pallas_attention.py::flash_attention.
//
// q, k and v are read in place through row and batch strides, so the packed
// [B, S, 3W] qkv output of the ViT's dense op needs no split or transpose,
// and a BSHD tensor is read as its [B, S, H*D] view.
// The output is [B, Sq, H*D] (row stride o_rs, batch stride o_bs).
//
// Both paths stream K and V through shared memory in chunks of 64 rows and
// keep an online (max-subtracted) softmax in fp32; rows past Sk are masked.
// A max-subtracted softmax equals jax.nn.softmax, including a fully masked
// row, which it spreads evenly as the unfused JAX path does. The
// probabilities are rounded to the model dtype unnormalised and the division
// by their fp32 sum comes after P V (the order of _attend and of the
// flash_attention variants v9 to v11; _attn_kernel of v3 normalises first: in
// bf16 the two lie within one bf16 step of each other, in fp32 they agree to
// rounding).
//
// - bf16 (the ViT, S = 257): tensor cores through WMMA. A block owns 64
//   query rows of one (item, head), 16 per warp. The head is padded in shared
//   memory to DP = D rounded up to 16 (88 -> 96) with zero lanes: zero q/k
//   lanes add nothing to a score, and the extra output lanes are not stored.
//   Device memory is never read past a head's D columns (the next head's data
//   lies there); D * 2 bytes is a multiple of 16 for both head dims, so the
//   16-byte loads of a head's row stay aligned. Per chunk, S = Q K^T goes
//   through mma.sync into a per-warp fp32 tile in shared memory; two lanes
//   per row rescale the running output and write P in bf16; O += P V runs on
//   the tensor cores again, with O held in shared memory in fp32 (WMMA
//   fragments do not expose their row layout, so the per-row rescale works
//   on the stored tile). At S = 257 the op is small (4 S^2 D flops per
//   head) and bound by the softmax pass and shared-memory traffic between
//   the two products, not by device memory. Shared memory: 70 KB at D = 64,
//   90 KB at D = 88 (dynamic, opted in; the limit is 227 KB).
// - fp32 (the Q-Former, and fp32 towers): true fp32 on the CUDA cores. A
//   block owns 16 query rows; each warp keeps four rows, one lane per key for
//   the scores and ceil(D / 32) output dims per lane for P.V. Bound by the
//   fp32 FMA rate. Shared memory: 36 KB at D = 64, 52 KB at D = 88 (dynamic).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int KC = 64;  // key rows per chunk

// ----------------------------------------------------------------- fp32

constexpr int ROWS = 16;  // query rows per block
constexpr int RPW = ROWS / 4;

template <int D>
struct F32Layout {
  static constexpr int NO = (D + 31) / 32;  // output dims per lane
  static constexpr int LDK = D + 1;         // odd pitch: lanes read distinct banks
  static constexpr int LDV = NO * 32;       // V padded with zero lanes to 32 NO
  static constexpr size_t SMEM = (ROWS * D + KC * LDK + KC * LDV) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(128) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, int Sq, int Sk,
    long long q_rs, long long q_bs, long long k_rs, long long k_bs,
    long long v_rs, long long v_bs, long long o_rs, long long o_bs, float scale) {
  using L = F32Layout<D>;
  constexpr int NO = L::NO, LDK = L::LDK, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // [ROWS][D]
  float* Ks = Qs + ROWS * D;                       // [KC][LDK]
  float* Vs = Ks + KC * LDK;                       // [KC][LDV]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * q_bs + h * D;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;
  const float* bb = bias ? bias + (long long)b * Sk : nullptr;

  for (int e = tid; e < ROWS * D; e += 128) {
    int r = e / D, d = e % D;
    Qs[r * D + d] = (r0 + r < Sq) ? qb[(r0 + r) * q_rs + d] : 0.0f;
  }

  float m[RPW], l[RPW], o[RPW][NO];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.0f;
  }

  for (int c0 = 0; c0 < Sk; c0 += KC) {
    __syncthreads();  // previous chunk fully consumed (and Qs written, first time)
    for (int e = tid; e < KC * LDV; e += 128) {
      int r = e / LDV, d = e % LDV;
      bool ok = c0 + r < Sk && d < D;
      if (d < D) Ks[r * LDK + d] = ok ? kb[(c0 + r) * k_rs + d] : 0.0f;
      Vs[r * LDV + d] = ok ? vb[(c0 + r) * v_rs + d] : 0.0f;
    }
    __syncthreads();
    const int j0 = c0 + lane, j1 = c0 + lane + 32;
    const float add0 = (j0 < Sk) ? (bb ? bb[j0] : 0.0f) : -INFINITY;
    const float add1 = (j1 < Sk) ? (bb ? bb[j1] : 0.0f) : -INFINITY;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qd = Qs[r * D + d];
        s0 = fmaf(qd, Ks[lane * LDK + d], s0);
        s1 = fmaf(qd, Ks[(lane + 32) * LDK + d], s1);
      }
      s0 = s0 * scale + add0;
      s1 = s1 * scale + add1;
      float m_new = fmaxf(m[i], sprc::warp_max(fmaxf(s0, s1)));
      float corr = expf(m[i] - m_new);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l[i] = l[i] * corr + sprc::warp_sum(p0 + p1);
      float a[NO];
#pragma unroll
      for (int n = 0; n < NO; ++n) a[n] = o[i][n] * corr;
#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        float pj = __shfl_sync(0xffffffffu, p0, jj);
#pragma unroll
        for (int n = 0; n < NO; ++n) a[n] = fmaf(pj, Vs[jj * LDV + lane + 32 * n], a[n]);
      }
#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        float pj = __shfl_sync(0xffffffffu, p1, jj);
#pragma unroll
        for (int n = 0; n < NO; ++n) a[n] = fmaf(pj, Vs[(jj + 32) * LDV + lane + 32 * n], a[n]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] = a[n];
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = r0 + warp * RPW + i;
    if (row < Sq) {
      float* ob = out + b * o_bs + row * o_rs + h * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (lane + 32 * n < D) ob[lane + 32 * n] = o[i][n] / l[i];
    }
  }
}

// ----------------------------------------------------------------- bf16

constexpr int BQ = 64;  // query rows per block (4 warps x 16)

template <int D>
struct BF16Layout {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma tile
  static constexpr int LDH = DP + 8;             // Q / K / V tile row pitch (bf16 elements)
  static constexpr int LDS = KC + 4;             // score tile row pitch (floats)
  static constexpr int LDO = DP + 4;             // output tile row pitch (floats)
  static constexpr int LDP = KC + 8;             // P tile row pitch (bf16 elements)
  static constexpr int TILE_H = BQ * LDH;        // Q / K / V tile, bf16 elements
  static constexpr int WARP_S = 16 * LDS;        // per-warp score tile, floats
  static constexpr int WARP_O = 16 * LDO;        // per-warp output tile, floats
  static constexpr int WARP_P = 16 * LDP;        // per-warp P tile, bf16 elements
  static constexpr size_t SMEM = 3 * TILE_H * sizeof(__nv_bfloat16) +
                                 4 * ((WARP_S + WARP_O) * sizeof(float) +
                                      WARP_P * sizeof(__nv_bfloat16));
};

// rows [row0, row0 + 64) of one head (D bf16 = D / 8 chunks of 16 bytes each)
// into a padded tile; rows past `rows` and the lanes D..DP-1 are zero
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int rows) {
  using L = BF16Layout<D>;
  constexpr int CH = L::DP / 8;
  for (int e = threadIdx.x; e < BQ * CH; e += blockDim.x) {
    int r = e / CH, c = (e % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows && c < D) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * L::LDH + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, long long q_rs, long long q_bs,
    long long k_rs, long long k_bs, long long v_rs, long long v_bs, long long o_rs,
    long long o_bs, float scale) {
  static_assert(D % 8 == 0, "a head's row is read in 16-byte chunks");
  using L = BF16Layout<D>;
  constexpr int DP = L::DP, LDH = L::LDH, LDS = L::LDS, LDO = L::LDO, LDP = L::LDP;
  constexpr int HALF = DP / 2;  // output columns per lane of a row's pair
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L::TILE_H;
  __nv_bfloat16* Vs = Ks + L::TILE_H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* fbase = reinterpret_cast<float*>(Vs + L::TILE_H);
  float* Sf = fbase + warp * (L::WARP_S + L::WARP_O);  // scores
  float* Of = Sf + L::WARP_S;                          // output acc
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(fbase + 4 * (L::WARP_S + L::WARP_O)) +
                      warp * L::WARP_P;

  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kb = k + b * k_bs + h * D;
  const __nv_bfloat16* vb = v + b * v_bs + h * D;
  const float* bb = bias ? bias + (long long)b * Sk : nullptr;
  load_tile<D>(Qs, q + b * q_bs + h * D, q_rs, r0, Sq);
  for (int e = lane; e < L::WARP_O; e += 32) Of[e] = 0.0f;

  // softmax bookkeeping: two lanes per row, 32 score columns and HALF output
  // columns each
  const int row = lane / 2, cb = (lane % 2) * 32, ob0 = (lane % 2) * HALF;
  float m = -INFINITY, l = 0.0f;

  for (int c0 = 0; c0 < Sk; c0 += KC) {
    __syncthreads();  // previous chunk consumed by every warp
    load_tile<D>(Ks, kb, k_rs, c0, Sk);
    load_tile<D>(Vs, vb, v_rs, c0, Sk);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < KC / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(bt, Ks + j * 16 * LDH + kk, LDH);
        wmma::mma_sync(s, a, bt, s);
      }
      wmma::store_matrix_sync(Sf + j * 16, s, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      int j = c0 + cb + c;
      float add = (j < Sk) ? (bb ? bb[j] : 0.0f) : -INFINITY;
      sv[c] = Sf[row * LDS + cb + c] * scale + add;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float p = expf(sv[c] - m_new);
      sum += p;
      Ps[row * LDP + cb + c] = __float2bfloat16(p);
    }
#pragma unroll
    for (int c = 0; c < HALF; ++c) Of[row * LDO + ob0 + c] *= corr;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Of + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + kk, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * LDH + j * 16, LDH);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(Of + j * 16, o, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int orow = r0 + warp * 16 + row;
  if (orow < Sq) {
    __nv_bfloat16* ob = out + b * o_bs + orow * o_rs + h * D;
    const float inv = 1.0f / l;
#pragma unroll
    for (int c = 0; c < HALF; ++c)
      if (ob0 + c < D) ob[ob0 + c] = __float2bfloat16(Of[row * LDO + ob0 + c] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int H, int Sq, int Sk, long long q_rs, long long q_bs,
                   long long k_rs, long long k_bs, long long v_rs, long long v_bs,
                   long long o_rs, long long o_bs, float scale, int dtype, cudaStream_t s) {
  if (dtype == sprc::kBF16) {
    using T = __nv_bfloat16;
    constexpr int SMEM = (int)BF16Layout<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    attention_bf16_kernel<D><<<grid, 128, SMEM, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(out), Sq, Sk,
        q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs, o_bs, scale);
  } else {
    constexpr int SMEM = (int)F32Layout<D>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + ROWS - 1) / ROWS, H, B);
    attention_f32_kernel<D><<<grid, 128, SMEM, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<float*>(out), Sq, Sk,
        q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs, o_bs, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// head_dim: one of the built head dims (64, 88; the wrapper's HEAD_DIMS);
// any other returns cudaErrorInvalidValue
extern "C" int sprc_attention(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int B, int H, int head_dim, int Sq, int Sk,
                              long long q_rs, long long q_bs, long long k_rs, long long k_bs,
                              long long v_rs, long long v_bs, long long o_rs, long long o_bs,
                              float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64)
    err = launch<64>(q, k, v, bias, out, B, H, Sq, Sk, q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs,
                     o_bs, scale, dtype, s);
  else if (head_dim == 88)
    err = launch<88>(q, k, v, bias, out, B, H, Sq, Sk, q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs,
                     o_bs, scale, dtype, s);
  return static_cast<int>(err);
}
