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
// [out, in]), Y [M, N]. The product accumulates in s32 and is exact. Epilogue,
// per element, in fp32 after float(acc) and with every step rounded on its own
// (no fused multiply-add, so that the plain PyTorch version computes the same
// bits):
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
// launch is spent on making that vector. The Q-Former's ops pass 1. A missing
// row scale is a multiplication by 1 and a missing bias an addition of -0,
// both exact, so one code path gives the bits of every variant.
//
// The wrapper checks K % 16 == 0 (16-byte rows, which TMA needs), N % 2 == 0
// and 16-byte aligned operands; ops/schedules.py::gemm_i8_plan chooses the
// tile width. Rows past M and columns past N are masked (M = 257 B in the
// ViT).
//
// Design (the shape of the bf16 kernel of gemm.cu): at ViT-L's and EVA's
// shapes the products are bound by the tensor cores (2 M N K operations at
// 1,979 TOP/s against about 600 operations per byte of device memory), so
// everything keeps s8 wgmma fed. One persistent block per SM walks over
// 128 x TILE_N output tiles (TILE_N 256 or 128), the column tiles of a row
// band in turn. A producer thread issues TMA loads of A8 [128 x 128] and W8
// [TILE_N x 128] boxes (128 bytes a row, the 128-byte swizzle) into a ring of
// stages guarded by full / empty mbarriers; what lies past M, N or K arrives
// as zeros. Two consumer warpgroups of 64 rows each run
// wgmma.mma_async m64n{TILE_N}k32 s32.s8.s8 straight from the stages (both
// operands K-major, the only form s8 wgmma takes), four products a stage,
// and release a stage one step late. setmaxnreg moves registers from the
// producer's warpgroup to the consumers. The epilogue runs in registers on the
// accumulator layout (row = 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane %
// 4) + {0, 1}); the output mode and the activation are template parameters,
// and the residual's presence is chosen outside the unrolled loop (a run-time
// code inside it cost more than the products in the bf16 kernel). bf16 and
// int8 outputs go through a staging tile of 64-row boxes of 128 bytes with
// the 128-byte swizzle (conflict-free fragment stores) and leave by TMA
// stores that drain under the next tile; with a residual, a store thread
// first loads R's tile by TMA where the output will lie. s32 and fp32 outputs
// (a 128 x 256 tile of them is 128 KB, which does not fit beside the stages)
// and rows without a 16-byte pitch (N % 8 bf16, N % 16 int8) are stored
// straight from the registers: 8-byte pairs, whole 32-byte sectors a row.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// output modes shared with sprc_tpu_torch/ops/_ext.py
constexpr int kOutS32 = 0, kOutF32 = 1, kOutBF16 = 2, kOutS8 = 3;

constexpr int BM = 128, BK = 128;               // BK: int8 values a stage row, one swizzle atom
constexpr int CONSUMERS = 2;                    // warpgroups, 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer's warpgroup
constexpr int A_BYTES = BM * BK;                // one A8 box: 16 KB
constexpr int BOX_BYTES = 64 * 128;             // one staged output box: 64 rows x 128 bytes

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 3 : 5;  // 144 KB or 160 KB of stages
  static constexpr int OUT_BYTES = BM * BN * 2;     // the staging tile, sized for bf16
  // + 1024: the stages start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + 1024;
};

template <int OUT>
__host__ __device__ constexpr int out_bytes() {
  return OUT == kOutS8 ? 1 : OUT == kOutBF16 ? 2 : 4;
}

struct Epilogue {
  const float* row_scale;  // [M] or null
  const float* col_scale;  // [N] (null in raw mode)
  const float* bias;       // [N] or null
  const void* res;         // [M, N] in the output type, or null
  void* y;
  float out_inv, col_alpha;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&acc)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 256) sprc::wgmma_m64n256k32_s8(acc, a, b, scale_d);
  else sprc::wgmma_m64n128k32_s8(acc, a, b, scale_d);
}

// acc (* row scale) times (col scale * col_alpha): the order of the TPU kernel
// and of the plain version
__device__ __forceinline__ float rescale(float v, float cs, float alpha) {
  return __fmul_rn(v, __fmul_rn(cs, alpha));
}

// byte offset of output element (row of the warpgroup's 64, col of the tile)
// in the warpgroup's part of the staging tile: boxes of 64 rows x 128 bytes,
// the 16-byte chunks of a row permuted by the 128-byte swizzle (chunk ^ row %
// 8), which is the layout a TMA store with SWIZZLE_128B reads
template <int ELT>
__device__ __forceinline__ int staged_at(int row, int col) {
  const int b = col * ELT;
  return (b / 128) * BOX_BYTES + row * 128 + ((((b % 128) / 16) ^ (row % 8)) * 16) + b % 16;
}

template <int BN, int OUT, int ACT>
__global__ void __launch_bounds__(THREADS, 1) gemm_i8_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_r,
    Epilogue e, int M, int N, int K, int tiles_n, int tiles, int y_tma) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  constexpr int ELT = out_bytes<OUT>();
  constexpr int BOX_COLS = 128 / ELT;  // output columns of one staged box
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES], ready_bar, staged_bar;
  unsigned char* stages = smem_raw + ((1024 - (sprc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staged = stages + STAGES * T::STAGE_BYTES;  // 1024-aligned too

  const int wg = threadIdx.x / 128;
  const int KT = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sprc::mbar_init(&full_bar[s], 1);               // the producer's arrival (+ the bytes)
      sprc::mbar_init(&empty_bar[s], CONSUMERS * 4);  // one lane of every consumer warp
    }
    sprc::mbar_init(&ready_bar, 1);               // the store thread (+ the residual's bytes)
    sprc::mbar_init(&staged_bar, CONSUMERS * 4);  // one lane of every consumer warp
    sprc::mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // ---- producer: the two roles never meet again
    sprc::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;  // k-steps issued so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          sprc::mbar_wait(&empty_bar[s], ((it / STAGES) & 1) ^ 1);  // passes on the first round
          sprc::mbar_arrive_expect_tx(&full_bar[s], T::STAGE_BYTES);
          unsigned char* st = stages + s * T::STAGE_BYTES;
          sprc::tma_load_2d(st, &map_a, &full_bar[s], kt * BK, m0);
          sprc::tma_load_2d(st + A_BYTES, &map_w, &full_bar[s], kt * BK, n0);
        }
      }
    } else if (threadIdx.x == CONSUMERS * 128 + 32 && y_tma) {
      // the store thread owns the staging tile between the consumers' turns:
      // it readies it for a tile (with a residual, by loading the tile of R
      // into it, box for box where the output will lie), waits until the
      // consumers have staged the output, and sends it out
      int n = 0;  // tiles done
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        // every box of the tile that holds an element of Y: fn(staged box, column, row)
        auto for_boxes = [&](auto&& fn) {
          for (int w2 = 0; w2 < CONSUMERS; ++w2)
            for (int bx = 0; bx < BN / BOX_COLS; ++bx)
              if (m0 + w2 * 64 < M && n0 + bx * BOX_COLS < N)
                fn(staged + w2 * (T::OUT_BYTES / CONSUMERS) + bx * BOX_BYTES, n0 + bx * BOX_COLS,
                   m0 + w2 * 64);
        };
        if (e.res) {
          int boxes = 0;
          for_boxes([&](unsigned char*, int, int) { ++boxes; });
          sprc::mbar_arrive_expect_tx(&ready_bar, boxes * BOX_BYTES);
          for_boxes([&](unsigned char* box, int c, int r) {
            sprc::tma_load_2d(box, &map_r, &ready_bar, c, r);
          });
        } else {
          sprc::mbar_arrive(&ready_bar);
        }
        sprc::mbar_wait(&staged_bar, n & 1);
        for_boxes([&](unsigned char* box, int c, int r) { sprc::tma_store_2d(&map_y, box, c, r); });
        sprc::tma_store_commit();
        sprc::tma_store_wait_read();  // the staging tile may be written again
      }
      sprc::tma_store_wait_all();
    }
  } else {  // ---- consumers
    sprc::setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    unsigned char* mine = staged + wg * (T::OUT_BYTES / CONSUMERS);
    int acc[BN / 2];
    int it = 0, n = 0;  // k-steps and tiles done so far, over all of this block's tiles
    const int rw = warp * 16 + g;  // row within the warpgroup's 64 (rw % 8 == g)

    // The sums of one tile through the epilogue. TMA: the pairs go to the
    // staging tile (a pair never straddles N: N and col are even); else they
    // are stored straight to Y. RES false: no residual.
    auto epilogue = [&]<bool RES, bool TMA>(int m0, int n0) {
      const int row0 = m0 + wg * 64 + rw;
      float rs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rs[h] = (OUT != kOutS32 && e.row_scale && row0 + 8 * h < M) ? e.row_scale[row0 + 8 * h]
                                                                    : 1.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float cs0 = 0.0f, cs1 = 0.0f, b0 = -0.0f, b1 = -0.0f;
        if (OUT != kOutS32 && col < N) {
          cs0 = e.col_scale[col], cs1 = e.col_scale[col + 1];
          if (e.bias) b0 = e.bias[col], b1 = e.bias[col + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          const bool inside = row < M && col < N;
          const size_t at = (size_t)row * N + col;
          const int c0 = acc[4 * j + 2 * h], c1 = acc[4 * j + 2 * h + 1];
          if constexpr (OUT == kOutS32) {
            if (inside) *reinterpret_cast<int2*>(static_cast<int*>(e.y) + at) = make_int2(c0, c1);
            continue;
          }
          float v0 = rescale(__fmul_rn(__int2float_rn(c0), rs[h]), cs0, e.col_alpha);
          float v1 = rescale(__fmul_rn(__int2float_rn(c1), rs[h]), cs1, e.col_alpha);
          v0 = sprc::apply_act_static<ACT>(__fadd_rn(v0, b0));
          v1 = sprc::apply_act_static<ACT>(__fadd_rn(v1, b1));
          if constexpr (OUT == kOutF32) {
            if (!inside) continue;
            if (RES) {
              const float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(e.res) + at);
              v0 = __fadd_rn(r.x, v0);
              v1 = __fadd_rn(r.y, v1);
            }
            *reinterpret_cast<float2*>(static_cast<float*>(e.y) + at) = make_float2(v0, v1);
          } else if constexpr (OUT == kOutBF16) {
            __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            __nv_bfloat162* slot =
                reinterpret_cast<__nv_bfloat162*>(mine + staged_at<2>(rw + 8 * h, 8 * j + 2 * t));
            if (RES && (TMA || inside)) {
              // TMA: the store thread loaded R's tile where the output goes
              const float2 r = __bfloat1622float2(
                  TMA ? *slot
                      : *reinterpret_cast<const __nv_bfloat162*>(
                            static_cast<const __nv_bfloat16*>(e.res) + at));
              o = __floats2bfloat162_rn(__fadd_rn(r.x, __low2float(o)),
                                        __fadd_rn(r.y, __high2float(o)));
            }
            if (TMA) *slot = o;
            else if (inside) *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(e.y) + at) = o;
          } else {
            char2 o;
            o.x = sprc::quantize_s8(__fmul_rn(v0, e.out_inv));
            o.y = sprc::quantize_s8(__fmul_rn(v1, e.out_inv));
            if (TMA) *reinterpret_cast<char2*>(mine + staged_at<1>(rw + 8 * h, 8 * j + 2 * t)) = o;
            else if (inside) *reinterpret_cast<char2*>(static_cast<int8_t*>(e.y) + at) = o;
          }
        }
      }
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        sprc::mbar_wait(&full_bar[s], (it / STAGES) & 1);
        const uint32_t st = sprc::smem_u32(stages + s * T::STAGE_BYTES);
        const uint64_t da = sprc::wgmma_desc_sw128(st + wg * (64 * BK));
        const uint64_t db = sprc::wgmma_desc_sw128(st + A_BYTES);
        sprc::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)  // the tile's first product overwrites the sums
          wgmma_tile<BN>(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
        sprc::wgmma_commit();
        sprc::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0 && lane == 0) sprc::mbar_arrive(&empty_bar[(it - 1) % STAGES]);
      }
      sprc::wgmma_wait<0>();
      if (lane == 0) sprc::mbar_arrive(&empty_bar[(it - 1) % STAGES]);

      // one specialisation per case, chosen outside the unrolled loop
      if (y_tma) {
        sprc::mbar_wait(&ready_bar, n & 1);  // the staging tile is free (and holds R's tile)
        if (e.res) epilogue.template operator()<true, true>(m0, n0);
        else epilogue.template operator()<false, true>(m0, n0);
        sprc::fence_async_shared();  // these writes, to the TMA unit
        __syncwarp();
        if (lane == 0) sprc::mbar_arrive(&staged_bar);
        ++n;
      } else if (e.res) {
        epilogue.template operator()<true, false>(m0, n0);
      } else {
        epilogue.template operator()<false, false>(m0, n0);
      }
    }
  }
}

template <int BN, int OUT, int ACT>
cudaError_t launch(const void* a, const void* w, const Epilogue& e, int M, int N, int K,
                   cudaStream_t s) {
  constexpr CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // Y (and R) through TMA where a row has a 16-byte pitch and R is 16-byte
  // aligned; the maps the kernel does not use are A's, never read
  const bool aligned = !e.res || reinterpret_cast<uintptr_t>(e.res) % 16 == 0;
  const int y_tma = aligned && ((OUT == kOutBF16 && N % 8 == 0) || (OUT == kOutS8 && N % 16 == 0));
  const CUtensorMapDataType ty = OUT == kOutBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : U8;
  CUtensorMap map_a, map_w, map_y, map_r;
  if (!sprc::make_map(&map_a, a, M, K, U8, 1, BM) || !sprc::make_map(&map_w, w, N, K, U8, 1, BN) ||
      sprc::sm_count() <= 0)
    return cudaErrorInvalidValue;
  map_y = map_r = map_a;
  if (y_tma && (!sprc::make_map(&map_y, e.y, M, N, ty, out_bytes<OUT>(), 64) ||
                (e.res && !sprc::make_map(&map_r, e.res, M, N, ty, out_bytes<OUT>(), 64))))
    return cudaErrorInvalidValue;
  cudaError_t err = sprc::allow_smem<&gemm_i8_kernel<BN, OUT, ACT>>(Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tiles_n;
  const int grid = tiles < sprc::sm_count() ? tiles : sprc::sm_count();
  gemm_i8_kernel<BN, OUT, ACT><<<grid, THREADS, Tile<BN>::SMEM, s>>>(
      map_a, map_w, map_y, map_r, e, M, N, K, tiles_n, tiles, y_tma);
  return cudaGetLastError();
}

// the specialisations that gemm_i8_plan can choose: the wide tile only
// without an activation and for the raw, bf16 and int8 outputs
template <int BN, int OUT>
cudaError_t launch_act(const void* a, const void* w, const Epilogue& e, int M, int N, int K,
                       int act, cudaStream_t s) {
  if constexpr (BN == 256 && OUT == kOutF32) {
    return cudaErrorInvalidValue;
  } else if constexpr (BN == 256 || OUT == kOutS32) {
    if (act != sprc::kActNone) return cudaErrorInvalidValue;
    return launch<BN, OUT, sprc::kActNone>(a, w, e, M, N, K, s);
  } else {
    if (act == sprc::kActNone) return launch<BN, OUT, sprc::kActNone>(a, w, e, M, N, K, s);
    if (act == sprc::kActGelu) return launch<BN, OUT, sprc::kActGelu>(a, w, e, M, N, K, s);
    if (act == sprc::kActQuickGelu)
      return launch<BN, OUT, sprc::kActQuickGelu>(a, w, e, M, N, K, s);
    return cudaErrorInvalidValue;
  }
}

template <int BN>
cudaError_t launch_out(const void* a, const void* w, const Epilogue& e, int M, int N, int K,
                       int out, int act, cudaStream_t s) {
  switch (out) {
    case kOutS32: return launch_act<BN, kOutS32>(a, w, e, M, N, K, act, s);
    case kOutF32: return launch_act<BN, kOutF32>(a, w, e, M, N, K, act, s);
    case kOutBF16: return launch_act<BN, kOutBF16>(a, w, e, M, N, K, act, s);
    case kOutS8: return launch_act<BN, kOutS8>(a, w, e, M, N, K, act, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// tile_n: the output tile width, 256 or 128 (the wrapper's gemm_i8_plan
// chooses it); a combination that is not built is refused
extern "C" int sprc_gemm_i8(const void* a, const void* w, const void* row_scale,
                            const void* col_scale, const void* bias, const void* res, void* y,
                            int M, int N, int K, int out, int act, float out_inv,
                            float col_alpha, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Epilogue e{static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
             static_cast<const float*>(bias), res, y, out_inv, col_alpha};
  cudaError_t err = cudaErrorInvalidValue;
  if (tile_n == 256) err = launch_out<256>(a, w, e, M, N, K, out, act, s);
  else if (tile_n == 128) err = launch_out<128>(a, w, e, M, N, K, out, act, s);
  return static_cast<int>(err);
}
