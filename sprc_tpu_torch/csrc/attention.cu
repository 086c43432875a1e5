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
// Both paths stream K and V through shared memory in chunks (64 rows in
// bf16, 32 in fp32) and keep an online (max-subtracted) softmax in fp32; rows
// past Sk are masked.
// A max-subtracted softmax equals jax.nn.softmax, including a fully masked
// row, which it spreads evenly as the unfused JAX path does. The
// probabilities are rounded to the model dtype unnormalised and the division
// by their fp32 sum comes after P V (the order of _attend and of the
// flash_attention variants v9 to v11; _attn_kernel of v3 normalises first: in
// bf16 the two lie within one bf16 step of each other, in fp32 they agree to
// rounding).
//
// - bf16 (the ViT, S = 257): tensor cores through mma.sync.m16n8k16 PTX, whose
//   fragment layouts are documented, so scores, probabilities and the output
//   accumulator never leave registers: a warp owns 16 query rows, a thread two
//   of them (lane / 4 and + 8) with its row's columns spread over its quad.
//   Row max and row sum are two shuffles inside the quad, the running output
//   is rescaled in registers, and the score fragment of Q K^T, rounded to
//   bf16, is already the A fragment of P V. Shared memory holds only the Q
//   tile and a two-stage ring of K / V chunks (64 keys) filled by cp.async, so
//   the next chunk arrives while this one multiplies; fragments come from it
//   through ldmatrix (rows pitched DP + 8 elements: conflict-free). The op is
//   small (4 S^2 D operations a head) and bound by the softmax's fp32 and
//   exp2 work beside the tensor cores, not by device memory.
//   Tiles for S = 257: a block is 6 warps = 96 query rows, so 257 rows are 3
//   blocks and 17 warp tiles of 16 (272 rows computed, 5.8 % padding); a warp
//   whose rows all lie past Sq only helps to load. Keys: 5 chunks of 64, but
//   inside a chunk only the 8-key score tiles and 16-key P V steps that hold a
//   valid key are computed, so the last chunk (one key) costs one tile and one
//   step: 264 key columns for 257 in Q K^T and 272 in P V. Together 272 x 264
//   and 272 x 272 products for 257 x 257: 8.7 % and 12 % padding (the old
//   64 x 64 tiling computed 320 x 320: 55 %).
//   The head is padded in shared memory to DP = D rounded up to 16 (88 -> 96)
//   with zero lanes for the depth of Q K^T; P V has N = D and needs none.
//   Device memory is never read past a head's D columns (the next head's data
//   lies there); D * 2 bytes is a multiple of 16 for both head dims, so the
//   16-byte copies of a head's row stay aligned.
//   Scores are s = (q . k) * scale + bias in fp32 with both roundings of the
//   plain version, and p = exp2((s - m) * log2 e): the subtraction happens
//   before the change of base, because with the -10000 bias of a masked key
//   a folded scale would round the exponent at a magnitude of 14427 and move
//   a fully masked row's probabilities by 1e-3.
//   Shared memory: 50 KB at D = 64, 72 KB at D = 88 (dynamic, opted in).
// - fp32 (the Q-Former's attention, sprc_tpu/ops/pallas_qformer.py::_attend_bias:
//   its self-attention over 32 or 64 rows and its cross-attention of 32 rows
//   into 257; and the fp32 towers, S = 257). What bounds it: at S = 257 the
//   products (4 S^2 D operations a head; 0.044 ms at EVA's 8-image batch on
//   the fp32 CUDA-core rate), at the Q-Former's calls device memory (each K
//   and V read once). The first design held one 4-byte shared load per FMA
//   and re-read K / V for every 16 query rows through synchronous copies; a
//   register-tiled CUDA-core design (4 rows x 4 keys a lane from float4
//   reads) was still bound by the shared-memory port (PERF.md). This
//   one runs on the tensor cores in 3xTF32, as PyTorch's fp32 SDPA kernel
//   does (its CUTLASS "FastF32" operator):
//   * every fp32 operand x is split into a TF32 big part (cvt.rna) and the
//     TF32 rounding of x - big; a product is small . big + big . small +
//     big . big through mma.sync.m16n8k8 tf32 with fp32 accumulation (about
//     2^-22 of each product is lost: 0.7 to 1.5e-6 of the output's range
//     against fp32 on random inputs, inside the stage bound of 5e-6);
//   * the bf16 path's register-resident layout: a warp owns 16 query rows
//     (a thread rows g and g + 8, g = lane / 4, with its quad); a score tile
//     of 8 keys (keys 8 j + 2t and 8 j + 2t + 1 of the thread) is P's A
//     fragment when the k-step takes those keys in that order and V's rows
//     are read in it: scores, probabilities and the output never leave
//     registers; row max and sum are two shuffles a quad. Q's A fragments
//     are read from shared memory at each chunk and a chunk's P V goes to a
//     fresh accumulator, which keeps two blocks an SM at D = 88;
//   * a block owns all of a head's query rows up to 64 (2 or 4 warps: K and
//     V read once), else 4 to 8 warps spread evenly over the rows (S = 257:
//     6 warps, 96 rows, 3 blocks a head); ops/schedules.py::attention_f32_plan,
//     mirrored by f32_warps below;
//   * K and V stream through a two-stage ring of 32-key chunks filled by
//     16-byte cp.async (rows pitched D + 4: a fragment's 32 lanes read 32
//     banks); score tiles and P V k-steps past the chunk's last valid key
//     are skipped.
//   s = (q . k) * scale + bias with both roundings of the plain version,
//   p = expf(s - m) with the running max m, l = l * corr + rowsum and o = o *
//   corr + pv, each step rounded on its own, where pv is the chunk's
//   unnormalised P V from a fresh accumulator (the tensor cores' fp32 sums,
//   which truncate, chain over one chunk only), the division by the fp32 sum
//   last; ops/schedules.py::attention_f32_emulated walks it, TF32 splits
//   included. Shared memory (dynamic, opted in): 26 KB for a 32 x 32
//   call, 52 KB for 64 x 64, 44 KB for 32 x 257, 83 KB for 257 x 257 at D =
//   88.
#include "common.cuh"

namespace {

constexpr int KC = 64;  // key rows per chunk

// ----------------------------------------------------------------- fp32

constexpr int F_KC = 32;        // keys of one chunk
constexpr int F_MAX_WARPS = 8;  // warps of a block, 16 query rows each

template <int D>
struct F32Layout {
  static constexpr int KS = D / 8;  // depth steps of Q K^T, and output tiles of P V
  static constexpr int LD = D + 4;  // Q, K and V rows: the fragments' 32 lanes in 32 banks
  static constexpr int KV_ELEMS = F_KC * LD;  // one K or V chunk
  // Q [rows][LD], then per stage K [KC][LD], V [KC][LD] and the column terms [KC]
  static size_t smem(int warps, int stages) {
    return sizeof(float) * ((size_t)warps * 16 * LD + (size_t)stages * (2 * KV_ELEMS + F_KC));
  }
};

// rows [row0, row0 + n) of one head (D floats = D / 4 copies of 16 bytes a
// row) into a tile of pitch LD, asynchronously; rows past `rows` arrive as
// zeros
template <int D, int LD>
__device__ __forceinline__ void load_f32_async(float* dst, const float* src, long long rs,
                                               int row0, int n, int rows) {
  constexpr int CH = D / 4;
  for (int e = threadIdx.x; e < n * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool ok = row0 + r < rows;
    sprc::cp_async16(dst + r * LD + c, ok ? src + (row0 + r) * rs + c : src, ok);
  }
}

// x as a TF32 "big" part (round to nearest, ties away: the low 13 bits of
// the mantissa cleared) and the TF32 rounding of what is left; x - big is
// exact in fp32, and big + small is x to about 2^-22 of itself
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 in, fp32 out. Per thread (g =
// lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g +
// 8, t + 4); b0 (k = t, n = g), b1 (k = t + 4, n = g); c0 c1 (g, 2t..), c2
// c3 (g + 8, 2t..)
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment a split once for the products it takes part in
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], big[i], small[i]);
  }
};

// c += a . b in 3xTF32: the small parts' products first, big . big last
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_1688_tf32(c, a.small, bb0, bb1);
  mma_1688_tf32(c, a.big, bs0, bs1);
  mma_1688_tf32(c, a.big, bb0, bb1);
}

// warps of a block for Sq query rows (ops/schedules.py::attention_f32_plan):
// all of a head's rows up to 4 warp tiles of 16, else the fewest blocks of at
// most 8 warps with the warp tiles spread evenly over them
int f32_warps(int Sq) {
  const int tiles = (Sq + 15) / 16;
  if (tiles <= 4) return tiles;
  const int blocks = (tiles + F_MAX_WARPS - 1) / F_MAX_WARPS;
  return (tiles + blocks - 1) / blocks;
}

template <int D>
__global__ void __launch_bounds__(F_MAX_WARPS * 32) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ out, int Sq, int Sk,
    long long q_rs, long long q_bs, long long k_rs, long long k_bs,
    long long v_rs, long long v_bs, long long o_rs, long long o_bs, float scale, int stages) {
  static_assert(D % 8 == 0, "the depth steps and output tiles of mma.m16n8k8");
  using L = F32Layout<D>;
  constexpr int KS = L::KS, LD = L::LD;
  constexpr int NT = F_KC / 8;  // 8-key score tiles a chunk, and k-steps of P V
  const int rows = (blockDim.x / 32) * 16;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);  // [rows][LD]
  float* Ks = Qs + rows * LD;                      // [stages][KC][LD]
  float* Vs = Ks + stages * L::KV_ELEMS;           // [stages][KC][LD]
  float* adds = Vs + stages * L::KV_ELEMS;         // [stages][KC]: bias, or -inf past Sk

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;
  const float* bb = bias ? bias + (long long)b * Sk : nullptr;
  const int chunks = (Sk + F_KC - 1) / F_KC;
  const bool active = r0 + warp * 16 < Sq;  // else every row of this warp lies past Sq

  auto load_chunk = [&](int c) {
    const int st = c % stages, c0 = c * F_KC;
    load_f32_async<D, LD>(Ks + st * L::KV_ELEMS, kb, k_rs, c0, F_KC, Sk);
    load_f32_async<D, LD>(Vs + st * L::KV_ELEMS, vb, v_rs, c0, F_KC, Sk);
    for (int e = threadIdx.x; e < F_KC; e += blockDim.x) {
      const int j = c0 + e;
      adds[st * F_KC + e] = j < Sk ? (bb ? bb[j] : 0.0f) : -INFINITY;
    }
  };

  load_f32_async<D, LD>(Qs, q + b * q_bs + h * D, q_rs, r0, rows, Sq);
  for (int c = 0; c < stages; ++c) {  // one group a stage: Q rides with chunk 0
    if (c < chunks) load_chunk(c);
    sprc::cp_async_commit();
  }

  float o[KS][4];   // output tiles of 8 dims: (g, 8 n + 2t..), (g + 8, 8 n + 2t..)
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows g and g + 8

  for (int c = 0; c < chunks; ++c) {
    // chunk c (and Q) has landed; the stages - 1 chunks after it may be in flight
    if (stages == 3) sprc::cp_async_wait<2>();
    else if (stages == 2) sprc::cp_async_wait<1>();
    else sprc::cp_async_wait<0>();
    __syncthreads();
    const int st = c % stages;
    const int kv = min(F_KC, Sk - c * F_KC);  // valid keys in this chunk
    if (active) {
      const float* Qw = Qs + warp * 16 * LD + g * LD + t;  // A fragments of this warp's rows
      const float* Kc = Ks + st * L::KV_ELEMS;
      const float* Vc = Vs + st * L::KV_ELEMS;
      const float* add = adds + st * F_KC;

      // S = Q K^T on the score tiles that hold a valid key, 3xTF32
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float qf[4] = {Qw[kk * 8], Qw[8 * LD + kk * 8], Qw[kk * 8 + 4],
                             Qw[8 * LD + kk * 8 + 4]};
        const SplitA qa(qf);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 < kv) {
            const float* kr = Kc + (j * 8 + g) * LD + kk * 8 + t;
            mma_3xtf32(s[j], qa, kr[0], kr[4]);
          }
        }
      }

      // online softmax on rows g (values 0, 1) and g + 8 (values 2, 3): keys
      // 8 j + 2t and 8 j + 2t + 1; a row's keys lie on the 4 lanes of a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < kv) {
          const float a0 = add[j * 8 + 2 * t], a1 = add[j * 8 + 2 * t + 1];
          s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), a0);
          s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), a1);
          s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), a0);
          s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), a1);
          mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);  // finite: chunk 0 holds a valid key
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < kv) {  // a key past Sk has s = -inf: p = 0
          s[j][0] = expf(s[j][0] - m[0]);
          s[j][1] = expf(s[j][1] - m[0]);
          s[j][2] = expf(s[j][2] - m[1]);
          s[j][3] = expf(s[j][3] - m[1]);
          sum[0] = __fadd_rn(__fadd_rn(sum[0], s[j][0]), s[j][1]);
          sum[1] = __fadd_rn(__fadd_rn(sum[1], s[j][2]), s[j][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 1));
        sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(0xffffffffu, sum[i], 2));
        l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum[i]);
      }
      // O = O * corr + P V, the chunk's P V in 3xTF32 into a fresh
      // accumulator (the tensor cores' fp32 sums chain over one chunk only)
      // and added rounded to nearest. The score tile j (keys 8 j + 2t, 8 j +
      // 2t + 1 of rows g, g + 8) is P's A fragment when its k-step takes the
      // keys in the order 8 j + 2t (k = t) and 8 j + 2t + 1 (k = t + 4), and
      // V's rows are read in that order
      float pv[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < kv) {
          const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          const SplitA pa(p);
          const float* v0 = Vc + (j * 8 + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < KS; ++n) mma_3xtf32(pv[n], pa, v0[n * 8], v0[LD + n * 8]);
        }
      }
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        o[n][0] = __fadd_rn(__fmul_rn(o[n][0], corr[0]), pv[n][0]);
        o[n][1] = __fadd_rn(__fmul_rn(o[n][1], corr[0]), pv[n][1]);
        o[n][2] = __fadd_rn(__fmul_rn(o[n][2], corr[1]), pv[n][2]);
        o[n][3] = __fadd_rn(__fmul_rn(o[n][3], corr[1]), pv[n][3]);
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (c + stages < chunks) load_chunk(c + stages);
    sprc::cp_async_commit();
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + warp * 16 + g + 8 * i;
      if (row < Sq) {
        float* ob = out + b * o_bs + row * o_rs + h * D + 2 * t;
#pragma unroll
        for (int n = 0; n < KS; ++n)
          *reinterpret_cast<float2*>(ob + n * 8) =
              make_float2(o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
      }
    }
  }
}

// ----------------------------------------------------------------- bf16

constexpr int BF_WARPS = 6;               // warps per block, 16 query rows each
constexpr int BF_THREADS = BF_WARPS * 32;
constexpr int BQ = BF_WARPS * 16;         // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct BF16Layout {
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int LDH = DP + 8;             // tile row pitch (bf16 elements): 16-byte units odd
  static constexpr int Q_ELEMS = BQ * LDH;
  static constexpr int KV_ELEMS = KC * LDH;      // one K or V chunk
  // Q, two stages of K and V, two stages of the per-key additive term
  static constexpr size_t SMEM = (Q_ELEMS + 4 * KV_ELEMS) * sizeof(__nv_bfloat16) +
                                 2 * KC * sizeof(float);
};

// rows [row0, row0 + ROWS) of one head (D bf16 = D / 8 copies of 16 bytes a
// row) into a padded tile, asynchronously; rows past `rows` and the lanes
// D..DP-1 arrive as zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long rs, int row0, int rows) {
  using L = BF16Layout<D>;
  constexpr int CH = L::DP / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += BF_THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = row0 + r < rows && c < D;
    sprc::cp_async16(dst + r * L::LDH + c, ok ? src + (row0 + r) * rs + c : src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 out. Per thread (g =
// lane / 4, t = lane % 4): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
// a3 (g + 8, 2t + 8..); b0 (k = 2t.., n = g), b1 (k = 2t + 8.., n = g);
// c0 c1 (g, 2t..), c2 c3 (g + 8, 2t..)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(BF_THREADS, 2) attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int Sq, int Sk, long long q_rs, long long q_bs,
    long long k_rs, long long k_bs, long long v_rs, long long v_bs, long long o_rs,
    long long o_bs, float scale) {
  static_assert(D % 8 == 0, "a head's row is read in 16-byte chunks");
  using L = BF16Layout<D>;
  constexpr int DP = L::DP, LDH = L::LDH;
  constexpr int KS = DP / 16;       // depth steps of Q K^T
  constexpr int NT = KC / 8;        // 8-key score tiles a chunk
  constexpr int OT = D / 8;         // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L::Q_ELEMS;           // [2][KC][LDH]
  __nv_bfloat16* Vs = Ks + 2 * L::KV_ELEMS;      // [2][KC][LDH]
  float* adds = reinterpret_cast<float*>(Vs + 2 * L::KV_ELEMS);  // [2][KC]: bias, or -inf past Sk

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kb = k + b * k_bs + h * D;
  const __nv_bfloat16* vb = v + b * v_bs + h * D;
  const float* bb = bias ? bias + (long long)b * Sk : nullptr;
  const int chunks = (Sk + KC - 1) / KC;
  const bool active = r0 + warp * 16 < Sq;  // else every row of this warp lies past Sq

  auto load_chunk = [&](int c) {
    const int st = c & 1, c0 = c * KC;
    load_tile_async<D, KC>(Ks + st * L::KV_ELEMS, kb, k_rs, c0, Sk);
    load_tile_async<D, KC>(Vs + st * L::KV_ELEMS, vb, v_rs, c0, Sk);
    if (threadIdx.x < KC) {
      const int j = c0 + threadIdx.x;
      adds[st * KC + threadIdx.x] = j < Sk ? (bb ? bb[j] : 0.0f) : -INFINITY;
    }
  };

  load_tile_async<D, BQ>(Qs, q + b * q_bs + h * D, q_rs, r0, Sq);
  load_chunk(0);
  sprc::cp_async_commit();
  if (chunks > 1) load_chunk(1);
  sprc::cp_async_commit();

  uint32_t qf[KS][4];
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows g and g + 8

  // ldmatrix row addresses: lane supplies row (lane % 8) of matrix (lane / 8)
  const int lm = lane / 8, lr = lane % 8;

  for (int c = 0; c < chunks; ++c) {
    sprc::cp_async_wait<1>();  // chunk c (and Q) has landed; chunk c + 1 may be in flight
    __syncthreads();
    const int st = c & 1;
    const int kv = min(KC, Sk - c * KC);  // valid keys in this chunk
    if (active) {
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lm % 2) * 8 + lr) * LDH + kk * 16 + (lm / 2) * 8);
      }
      const __nv_bfloat16* Kc = Ks + st * L::KV_ELEMS;
      const __nv_bfloat16* Vc = Vs + st * L::KV_ELEMS;
      const float* add = adds + st * KC;

      // S = Q K^T on the score tiles that hold a valid key
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        s[j + 1][0] = s[j + 1][1] = s[j + 1][2] = s[j + 1][3] = 0.0f;
        if (j * 8 < kv) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t kf[4];  // tiles j (k low, k high) and j + 1 (k low, k high)
            ldmatrix_x4(kf, Kc + ((j + lm / 2) * 8 + lr) * LDH + kk * 16 + (lm % 2) * 8);
            mma_16816(s[j], qf[kk], kf[0], kf[1]);
            mma_16816(s[j + 1], qf[kk], kf[2], kf[3]);
          }
        }
      }

      // online softmax on rows g (values 0, 1) and g + 8 (values 2, 3)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j * 8 < kv) {
          const float a0 = add[j * 8 + 2 * t], a1 = add[j * 8 + 2 * t + 1];
          s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), a0);
          s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), a1);
          s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), a0);
          s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), a1);
          mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
      }
      float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);  // finite: chunk 0 holds a valid key
        corr[i] = exp2f((m[i] - m_new) * LOG2E);
        m[i] = m_new;
      }
      uint32_t pf[NT][2];  // P in bf16: [tile][row g, row g + 8]
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
        if (j * 8 < kv) {
          p0 = exp2f((s[j][0] - m[0]) * LOG2E);
          p1 = exp2f((s[j][1] - m[0]) * LOG2E);
          p2 = exp2f((s[j][2] - m[1]) * LOG2E);
          p3 = exp2f((s[j][3] - m[1]) * LOG2E);
          sum[0] += p0 + p1;
          sum[1] += p2 + p3;
        }
        pf[j][0] = pack_bf16(p0, p1);
        pf[j][1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }

      // O += P V on the 16-key steps that hold a valid key
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk * 16 < kv) {
          const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
          for (int j = 0; j < OT; j += 2) {
            uint32_t vf[4];  // output tiles j (keys low, high) and j + 1 (keys low, high)
            ldmatrix_x4_trans(vf, Vc + (kk * 16 + (lm % 2) * 8 + lr) * LDH + (j + lm / 2) * 8);
            mma_16816(o[j], a, vf[0], vf[1]);
            if (j + 1 < OT) mma_16816(o[j + 1], a, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (c + 2 < chunks) load_chunk(c + 2);
    sprc::cp_async_commit();
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + warp * 16 + g + 8 * i;
      if (row < Sq) {
        __nv_bfloat16* ob = out + b * o_bs + row * o_rs + h * D + 2 * t;
        const float inv = 1.0f / l[i];
#pragma unroll
        for (int j = 0; j < OT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ob + j * 8) =
              __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      }
    }
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
    attention_bf16_kernel<D><<<grid, BF_THREADS, SMEM, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(out), Sq, Sk,
        q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs, o_bs, scale);
  } else {
    // warps a block and blocks along the queries: ops/schedules.py::attention_f32_plan
    // (all of a head's rows in one block up to 64 rows; else 4 to 8 warps)
    if (Sq < 1 || Sk < 1) return cudaErrorInvalidValue;
    const int warps = f32_warps(Sq);
    const int chunks = (Sk + F_KC - 1) / F_KC;
    const int stages = chunks > 1 ? 2 : 1;
    const size_t smem = F32Layout<D>::smem(warps, stages);
    cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + warps * 16 - 1) / (warps * 16), H, B);
    attention_f32_kernel<D><<<grid, warps * 32, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<float*>(out), Sq, Sk,
        q_rs, q_bs, k_rs, k_bs, v_rs, v_bs, o_rs, o_bs, scale, stages);
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

// the fp32 path's warps a block for Sq query rows (checked on the card
// against ops/schedules.py::attention_f32_plan)
extern "C" int sprc_attention_f32_warps(int Sq) { return Sq < 1 ? 0 : f32_warps(Sq); }
