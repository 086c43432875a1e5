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
// - bf16 (the ViT towers; M = 257 B, K and N in the thousands): bound by the
//   tensor cores (about 295 operations per byte of device memory on this
//   card), so everything is built around keeping wgmma fed. One persistent
//   block per SM walks over 128 x TILE_N output tiles (TILE_N 256 or 128: the
//   wrapper chooses and passes it), the column tiles of a row band in turn,
//   so the blocks in flight share a few bands of X and all of W in L2.
//   One producer thread issues TMA loads of X [128 x 64] and W [TILE_N x 64]
//   boxes (128-byte swizzle) into a ring of shared-memory stages guarded by
//   full / empty mbarriers, and runs ahead into the next tile while the
//   consumers finish this one; TMA fills rows past M or N and columns past K
//   with zeros, so ragged edges need no predicates. Two consumer warpgroups
//   of 64 rows each run wgmma.mma_async m64n{TILE_N}k16 straight from the
//   stages, both operands through descriptors (X and W are both K-major, the
//   form wgmma takes without a transpose), fp32 sums in registers. A stage is
//   released one step late, after wgmma.wait_group 1 shows that its products
//   are done, so a product is always in flight. setmaxnreg moves registers
//   from the producer's warpgroup to the consumers.
//   The epilogue runs in registers on the documented accumulator layout (row
//   = 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) + {0, 1}): bias,
//   activation (a template parameter: with a run-time code the compiler
//   evaluated every activation for every element, which cost more than the
//   products), residual, one rounding. The bf16 pairs go to a staging tile of
//   the block's own (64-column boxes with the 128-byte swizzle, so the 8 rows
//   x 4 pairs a warp writes at once fall on 32 banks). A store thread in the
//   producer's warpgroup sends the staged tile out through TMA stores, which
//   clip at M and N and drain while the next tile multiplies; before that it
//   loads the residual's tile into the same boxes, so a consumer thread finds
//   its pair of R where it will put its pair of Y (read as fragments from
//   device memory, R doubled the time of a product with a residual). Where
//   N % 8 != 0 (no 16-byte row pitch, so no
//   tensor map over Y) the pairs are stored straight from the registers.
//   The tensor maps are made on the host (hopper.cuh::make_map, which keeps
//   the last ones made and encodes only new ones) and passed by value.
// - fp32 (the Q-Former's ten dense ops; M = 1024 to 16448, N = 768 or 3072):
//   true fp32 FMA on the CUDA cores (no TF32), so that the Q-Former matches the
//   JAX fp32 Q-Former; bound by the FMA rate (67 TFLOP/s). 256 threads as a
//   16 x 16 grid, each with TM x TN outputs (8 x 8 or 4 x 6: block tiles 128 x
//   128 or 64 x 96; the wrapper's gemm_f32_plan chooses the one that fills the
//   132 SMs in the fewest waves). Both operands are
//   K-major, and both are read as they lie: a four-stage cp.async ring of
//   16-byte copies brings [tile x 32] slices of X and W into shared memory
//   with a 36-float row pitch, so a thread reads its rows as float4 along K
//   without conflicts (8 consecutive rows fall on 8 different groups of 4
//   banks) and each float it reads feeds TM or TN FMAs. A thread owns rows ty
//   + 16 i and columns tx + 16 j; a warp is 4 x 8 threads, so a float4 read
//   of W touches 8 rows and one of X 4. Each sum runs along K in order, as
//   before. Epilogue: bias, activation (a template parameter), residual.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ----------------------------------------------------------------- bf16

constexpr int BM = 128, BK = 64;
constexpr int CONSUMERS = 2;                    // warpgroups, 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer's warpgroup
constexpr int A_BYTES = BM * BK * 2;            // one X box: 16 KB
constexpr int BOX_BYTES = 64 * 64 * 2;          // one staged output box: 64 rows x 64 columns

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 3 : 5;   // 144 KB or 160 KB of stages
  static constexpr int OUT_BYTES = BM * BN * 2;      // the staged bf16 tile: 64 KB or 32 KB
  // + 1024: the stages start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = STAGES * STAGE_BYTES + OUT_BYTES + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 256) sprc::wgmma_m64n256k16(acc, a, b, scale_d);
  else sprc::wgmma_m64n128k16(acc, a, b, scale_d);
}

// The activation of the bf16 epilogue. Its result is rounded to bf16 (8 bits),
// and it runs while the tensor cores wait, so QuickGELU takes the fast
// exponential and division (relative error about 1e-6, against a bf16 step of
// 4e-3); the exact GELU keeps erff.
template <int ACT>
__device__ __forceinline__ float act_bf16(float v) {
  if constexpr (ACT == sprc::kActQuickGelu) return __fdividef(v, 1.0f + __expf(-1.702f * v));
  else return sprc::apply_act_static<ACT>(v);
}

template <int BN, int ACT>
__global__ void __launch_bounds__(THREADS, 1) gemm_bf16_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_y, const __grid_constant__ CUtensorMap map_r,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ Y, int M, int N, int K, int tiles_n, int tiles, int res_f32,
    int y_tma) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
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
          sprc::tma_load_2d(st, &map_x, &full_bar[s], kt * BK, m0);
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
        // every 64 x 64 box of the tile that holds an element of Y: fn(staged box, column, row)
        auto for_boxes = [&](auto&& fn) {
          for (int w2 = 0; w2 < CONSUMERS; ++w2)
            for (int bx = 0; bx < BN / 64; ++bx)
              if (m0 + w2 * 64 < M && n0 + bx * 64 < N)
                fn(staged + (w2 * (BN / 64) + bx) * BOX_BYTES, n0 + bx * 64, m0 + w2 * 64);
        };
        if (res) {
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
    const bool pairs = (N % 2) == 0;  // then (row N + col) is even: 4-byte accesses are aligned
    unsigned char* mine = staged + wg * (T::OUT_BYTES / CONSUMERS);  // BN / 64 boxes of 64 rows
    float acc[BN / 2];
    int it = 0, n = 0;  // k-steps and tiles done so far, over all of this block's tiles
    const int rw = warp * 16 + g;  // row within the warpgroup's 64 (rw % 8 == g)

    // The sums of one tile through bias, activation, residual and the rounding.
    // TMA: N % 8 == 0, the pairs go to the staging tile (box j / 8, 16-byte
    // chunk (j % 8) ^ (row % 8) of the row's 128 bytes) and a pair never
    // straddles N; else they are stored straight to Y. RES false: no residual.
    auto epilogue = [&]<bool RES, bool TMA>(float (&sums)[BN / 2], int m0, int n0) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float b0 = 0.0f, b1 = 0.0f;
        if (bias && col < N) {
          if (TMA) {
            const float2 b = *reinterpret_cast<const float2*>(bias + col);
            b0 = b.x, b1 = b.y;
          } else {
            b0 = bias[col];
            if (col + 1 < N) b1 = bias[col + 1];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = act_bf16<ACT>(sums[4 * j + 2 * h] + b0);
          float v1 = act_bf16<ACT>(sums[4 * j + 2 * h + 1] + b1);
          const int row = m0 + wg * 64 + rw + 8 * h;
          const bool inside = row < M && col < N;
          const size_t at = (size_t)row * N + col;
          __nv_bfloat162* slot = reinterpret_cast<__nv_bfloat162*>(
              mine + (j / 8) * BOX_BYTES + (rw + 8 * h) * 128 + (((j % 8) ^ g) * 16) + t * 4);
          if (RES && res && (TMA || inside)) {
            float r0, r1 = 0.0f;
            if (TMA) {  // the store thread loaded R's tile where the output goes
              const float2 r = __bfloat1622float2(*slot);
              r0 = r.x, r1 = r.y;
            } else if (pairs) {
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
              r0 = r.x, r1 = r.y;
            } else {
              r0 = __bfloat162float(res[at]);
              if (col + 1 < N) r1 = __bfloat162float(res[at + 1]);
            }
            if (res_f32) {
              v0 += r0, v1 += r1;
            } else {
              v0 = r0 + __bfloat162float(__float2bfloat16(v0));
              v1 = r1 + __bfloat162float(__float2bfloat16(v1));
            }
          }
          const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
          if (TMA) {
            *slot = out;
          } else if (inside) {
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(Y + at) = out;
            } else {
              Y[at] = out.x;
              if (col + 1 < N) Y[at + 1] = out.y;
            }
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
        const uint64_t da = sprc::wgmma_desc_sw128(st + wg * (64 * BK * 2));
        const uint64_t db = sprc::wgmma_desc_sw128(st + A_BYTES);
        sprc::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)  // the tile's first product overwrites the sums
          wgmma_tile<BN>(acc, da + 2 * k, db + 2 * k, (kt | k) != 0);
        sprc::wgmma_commit();
        sprc::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0 && lane == 0) sprc::mbar_arrive(&empty_bar[(it - 1) % STAGES]);
      }
      sprc::wgmma_wait<0>();
      if (lane == 0) sprc::mbar_arrive(&empty_bar[(it - 1) % STAGES]);

      // one specialisation per case, chosen outside the unrolled loop: the loop
      // runs once a tile on two warps a scheduler, so every instruction in it
      // is paid in full
      if (y_tma) {
        sprc::mbar_wait(&ready_bar, n & 1);  // the staging tile is free (and holds R's tile)
        if (res) epilogue.template operator()<true, true>(acc, m0, n0);
        else epilogue.template operator()<false, true>(acc, m0, n0);
        sprc::fence_async_shared();  // these writes, to the TMA unit
        __syncwarp();
        if (lane == 0) sprc::mbar_arrive(&staged_bar);
        ++n;
      } else {
        epilogue.template operator()<true, false>(acc, m0, n0);
      }
    }
  }
}

template <int BN, int ACT>
cudaError_t launch_bf16(const void* x, const void* w, const float* bias, const __nv_bfloat16* res,
                        __nv_bfloat16* y, int M, int N, int K, int res_f32, cudaStream_t s) {
  const int y_tma = N % 8 == 0;  // else Y has no 16-byte row pitch: no tensor map over it
  // Y and R through 64 x 64 boxes; without them (no TMA for Y, no residual) the
  // parameter still has to be a valid map: X's stands in and is never used
  const bool r_tma = y_tma && res;
  constexpr CUtensorMapDataType B16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_x, map_w, map_y, map_r;
  if (!sprc::make_map(&map_x, x, M, K, B16, 2, BM) || !sprc::make_map(&map_w, w, N, K, B16, 2, BN) ||
      sprc::sm_count() <= 0)
    return cudaErrorInvalidValue;
  map_y = map_r = map_x;
  if ((y_tma && !sprc::make_map(&map_y, y, M, N, B16, 2, 64)) ||
      (r_tma && !sprc::make_map(&map_r, res, M, N, B16, 2, 64)))
    return cudaErrorInvalidValue;
  cudaError_t err = sprc::allow_smem<&gemm_bf16_kernel<BN, ACT>>(Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tiles_n;
  const int grid = tiles < sprc::sm_count() ? tiles : sprc::sm_count();
  gemm_bf16_kernel<BN, ACT><<<grid, THREADS, Tile<BN>::SMEM, s>>>(
      map_x, map_w, map_y, map_r, bias, res, y, M, N, K, tiles_n, tiles, res_f32, y_tma);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bf16_act(const void* x, const void* w, const float* bias,
                            const __nv_bfloat16* res, __nv_bfloat16* y, int M, int N, int K,
                            int act, int res_f32, cudaStream_t s) {
  if (act == sprc::kActGelu)
    return launch_bf16<BN, sprc::kActGelu>(x, w, bias, res, y, M, N, K, res_f32, s);
  if (act == sprc::kActQuickGelu)
    return launch_bf16<BN, sprc::kActQuickGelu>(x, w, bias, res, y, M, N, K, res_f32, s);
  if (act == sprc::kActNone)
    return launch_bf16<BN, sprc::kActNone>(x, w, bias, res, y, M, N, K, res_f32, s);
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- fp32

constexpr int FBK = 32;        // depth of one stage: 32 floats, eight 16-byte copies a row
constexpr int FLD = FBK + 4;   // row pitch in floats: row r starts on bank 4 r (mod 32)
constexpr int F_THREADS = 256;

template <int TM, int TN>
struct FTile {
  static constexpr int BM = 16 * TM, BN = 16 * TN;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_FLOATS = (BM + BN) * FLD;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;  // 144 or 90 KB
};

// one stage: rows [r0, r0 + ROWS) of a [rows, K] matrix, columns [k0, k0 + 32),
// as 16-byte copies; what lies past the edges is filled with zeros
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows, int k0,
                                          int K) {
  static_assert(ROWS * (FBK / 4) % F_THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int n = 0; n < ROWS * (FBK / 4) / F_THREADS; ++n) {
    const int idx = threadIdx.x + n * F_THREADS;
    const int r = idx / (FBK / 4), c = (idx % (FBK / 4)) * 4;
    const bool p = r0 + r < rows && k0 + c < K;
    sprc::cp_async16(dst + r * FLD + c, p ? src + (size_t)(r0 + r) * K + k0 + c : src, p);
  }
}

template <int TM, int TN, int ACT>
__global__ void __launch_bounds__(F_THREADS, 1) gemm_f32_kernel(
    const float* __restrict__ X, const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ Y, int M, int N, int K) {
  using T = FTile<TM, TN>;
  extern __shared__ float4 fsmem[];
  float* smem = reinterpret_cast<float*>(fsmem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;  // a warp: 4 x 8
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int KT = (K + FBK - 1) / FBK;
  float acc[TM][TN] = {};

  auto load = [&](int stage, int kt) {
    float* st = smem + stage * T::STAGE_FLOATS;
    load_rows<T::BM>(st, X, m0, M, kt * FBK, K);
    load_rows<T::BN>(st + T::BM * FLD, W, n0, N, kt * FBK, K);
  };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    sprc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    sprc::cp_async_wait<T::STAGES - 2>();  // step kt has landed
    __syncthreads();                       // ... for every thread, and step kt - 1 is consumed
    if (kt + T::STAGES - 1 < KT) load((kt + T::STAGES - 1) % T::STAGES, kt + T::STAGES - 1);
    sprc::cp_async_commit();
    const float* As = smem + (kt % T::STAGES) * T::STAGE_FLOATS;
    const float* Bs = As + T::BM * FLD;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * FLD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * FLD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  sprc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias) v += bias[col];
      v = sprc::apply_act_static<ACT>(v);
      if (res) v += res[(size_t)row * N + col];
      Y[(size_t)row * N + col] = v;
    }
  }
}

template <int TM, int TN, int ACT>
cudaError_t launch_f32(const float* x, const float* w, const float* bias, const float* res,
                       float* y, int M, int N, int K, cudaStream_t s) {
  using T = FTile<TM, TN>;
  cudaError_t err = sprc::allow_smem<&gemm_f32_kernel<TM, TN, ACT>>(T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  gemm_f32_kernel<TM, TN, ACT><<<grid, F_THREADS, T::SMEM, s>>>(x, w, bias, res, y, M, N, K);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_f32_act(const float* x, const float* w, const float* bias, const float* res,
                           float* y, int M, int N, int K, int act, cudaStream_t s) {
  if (act == sprc::kActNone) return launch_f32<TM, TN, sprc::kActNone>(x, w, bias, res, y, M, N, K, s);
  if (act == sprc::kActGelu) return launch_f32<TM, TN, sprc::kActGelu>(x, w, bias, res, y, M, N, K, s);
  if (act == sprc::kActQuickGelu)
    return launch_f32<TM, TN, sprc::kActQuickGelu>(x, w, bias, res, y, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// tile_m x tile_n: the output tile the wrapper's plan chose (gemm_bf16_plan:
// 128 x 256 or 128 x 128; gemm_f32_plan: 128 x 128 or 64 x 96); a tile that
// is not built is refused
extern "C" int sprc_gemm(const void* x, const void* w, const void* bias, const void* res,
                         void* y, int M, int N, int K, int dtype, int act, int res_f32,
                         int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == sprc::kBF16) {
    const float* bf = static_cast<const float*>(bias);
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(res);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    if (tile_m != BM) return static_cast<int>(err);
    if (tile_n == 256) err = launch_bf16_act<256>(x, w, bf, rb, yb, M, N, K, act, res_f32, s);
    else if (tile_n == 128) err = launch_bf16_act<128>(x, w, bf, rb, yb, M, N, K, act, res_f32, s);
  } else if (dtype == sprc::kF32) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(bias);
    const float* rf = static_cast<const float*>(res);
    float* yf = static_cast<float*>(y);
    if (tile_m == 128 && tile_n == 128)
      err = launch_f32_act<8, 8>(xf, wf, bf, rf, yf, M, N, K, act, s);
    else if (tile_m == 64 && tile_n == 96)
      err = launch_f32_act<4, 6>(xf, wf, bf, rf, yf, M, N, K, act, s);
  }
  return static_cast<int>(err);
}
