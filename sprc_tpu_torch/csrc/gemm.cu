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
//   The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
//   looked up in libcuda by name, so the library links against nothing new)
//   and passed by value.
// - fp32: true fp32 FMA on the CUDA cores (no TF32), so that the Q-Former
//   matches the JAX fp32 Q-Former. 128x128 tile (8x8 outputs per thread), or
//   64x64 (4x4) when the problem is too small to fill the card with the
//   larger tile; K step 8, float4 shared-memory reads, two shared buffers
//   with the next tile staged through registers. Bound by the fp32 FMA rate.
#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <dlfcn.h>

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which every process that runs a
// kernel has loaded, not in the runtime library: it is looked up there once,
// by name, so the link step names no library
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return reinterpret_cast<EncodeTiled>(lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr);
  }();
  return fn;
}

// a [rows, cols] row-major bf16 matrix cut into boxes of box_rows x 64 columns
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};  // bytes between rows: a multiple of 16
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  static int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
    return sms;
  }();
  return n;
}

template <int BN, int ACT>
cudaError_t launch_bf16(const void* x, const void* w, const float* bias, const __nv_bfloat16* res,
                        __nv_bfloat16* y, int M, int N, int K, int res_f32, cudaStream_t s) {
  const int y_tma = N % 8 == 0;  // else Y has no 16-byte row pitch: no tensor map over it
  // Y and R through 64 x 64 boxes; without them (no TMA for Y, no residual) the
  // parameter still has to be a valid map: X's stands in and is never used
  const bool r_tma = y_tma && res;
  CUtensorMap map_x, map_w, map_y, map_r;
  if (!make_map(&map_x, x, M, K, BM) || !make_map(&map_w, w, N, K, BN) ||
      !make_map(&map_y, y_tma ? y : x, M, y_tma ? N : K, 64) ||
      !make_map(&map_r, r_tma ? static_cast<const void*>(res) : x, M, r_tma ? N : K, 64) ||
      sm_count() <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<BN, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tiles_n;
  const int grid = tiles < sm_count() ? tiles : sm_count();
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

// tile_n: the bf16 path's output tile width, 128 or 256 (the wrapper's
// gemm_bf16_plan chooses it); the fp32 path ignores it
extern "C" int sprc_gemm(const void* x, const void* w, const void* bias, const void* res,
                         void* y, int M, int N, int K, int dtype, int act, int res_f32,
                         int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sprc::kBF16) {
    const float* bf = static_cast<const float*>(bias);
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(res);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    cudaError_t err = cudaErrorInvalidValue;
    if (tile_n == 256) err = launch_bf16_act<256>(x, w, bf, rb, yb, M, N, K, act, res_f32, s);
    else if (tile_n == 128) err = launch_bf16_act<128>(x, w, bf, rb, yb, M, N, K, act, res_f32, s);
    return static_cast<int>(err);
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
