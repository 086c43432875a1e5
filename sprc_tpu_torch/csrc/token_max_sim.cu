// Token-max similarity: out[b, n] = max_q <f[b], t[n, q]>, fp32 in and out.
//
// Replaces sprc_tpu/ops/pallas_sim.py::token_max_sim_pallas (_sim_kernel).
// f [B, E] fp32, t [N, Q, E] fp32 (Q <= 32, E <= 512, E % 4 == 0), out [B, N]
// fp32; offsets into t and out are 64-bit, so any gallery the card holds is
// scored (B and N are 32-bit ints of the C entry).
//
// What bounds it: reading the gallery once (N Q E 4 bytes) at serving batch
// sizes. The products are 2 B N Q E operations; on the CUDA cores (fp32
// FFMA) B = 32 would need about 80 % of the card's fp32 rate to keep up with
// its memory, so they run on the tensor cores in 3xTF32 (mma.sync.m16n8k8,
// tf32.cuh). At B = 32 the tensor-core instructions still set the pace
// (PERF.md: 768 an item; without them the same kernel streams at 92 % of the
// bytes bound); at B <= 16 one m16 tile is built and they do not.
//
// The design (ops/schedules.py::token_max_sim_plan is the same plan,
// token_max_sim_emulated walks the same arithmetic):
// - A persistent grid: two blocks an SM where the shared memory allows, else
//   one, all resident. A block owns a query tile of 32 rows (MT = 2 m16
//   tiles; 1 where B <= 16) and the items n = group, group + groups, ... For
//   B > 32 the tiles of one group are neighbouring blocks that run at the
//   same time, so an item leaves device memory once and the other tiles read
//   it from L2.
// - The query tile stays in registers for the whole launch, split once by
//   rounding into its TF32 big and small parts: the depth is cut into
//   k-steps of 8 and warp w owns k-steps 4 w .. 4 w + 3 (E / 32 warps, at
//   most 16; 64 registers a thread at MT = 2). A k-step takes its 8 depths
//   in the order 2t, 2t + 1 (k = t, t + 4), so a thread reads its two
//   gallery values as one float2, and splits them by truncation (three
//   operations; cvt.rna.tf32 is several on sm_90a).
// - Items stream through a ring of `stages` shared-memory slots, one item a
//   slot, filled by 1-d bulk copies (cp.async.bulk, one a token row, into
//   rows pitched E rounded up to 8 mod 16: a warp's float2 reads hit 32
//   banks) that complete on an mbarrier a slot. A slot's rows are Q rounded
//   up to 8; the rows past Q and the pad columns hold whatever was there and
//   never reach a score (the depths past E are zeroed as read).
// - A k-step issues its three products tile by tile (small . big over every
//   (m, n) tile, then big . small, then big . big): back-to-back tensor-core
//   instructions go to different accumulators (chained, the same products
//   ran 20 % slower).
// - The warps' partial sums meet in the item's own slot once every warp has
//   read it (added in warp order), the max over Q is taken in registers,
//   then across the 4 lanes of a quad: the [B, N, Q] product never leaves
//   the SM; then warp 0 refills the slot. The max propagates NaN, as amax
//   does (a NaN anywhere in f[b] or in t[n] gives NaN).
// - An infinity among the inputs makes its 3xTF32 products NaN (its small
//   part is inf - inf), so a block that wrote a NaN score takes its NaN
//   scores again after its last item, as plain fp32 sums from device memory
//   (exact_score): NaN where amax gives it, an infinity kept as the plain
//   version keeps it. Finite inputs never take that path unless a NaN is
//   among them.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int TILE_B = 32;       // query rows of a block: two m16 tiles
constexpr int MAXQ = 32;         // tokens of an item: four n8 tiles
constexpr int MAXE = 512;
constexpr int KPW = 4;           // k-steps of 8 a warp owns
constexpr int MAX_WARPS = MAXE / (8 * KPW);
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may opt in to
constexpr int SMEM_RESERVED = 1024;   // held back by the card for each resident block
constexpr int SMEM_SM = SMEM_LIMIT + SMEM_RESERVED;  // shared memory of an SM
constexpr int BARRIER_BYTES = 64;     // the ring's mbarriers and a flag, ahead of everything
constexpr int RED_BYTES = 4 * 2 * 32 * 16;  // one warp's partial sums: 4 KB

struct Plan {
  int warps, pitch, stages, blocks_per_sm, tiles, groups, grid, smem;
};

// ops/schedules.py::token_max_sim_plan
Plan make_plan(int B, int N, int Q, int E, int sms) {
  Plan p;
  const int ksteps = (E + 7) / 8;
  p.warps = (ksteps + KPW - 1) / KPW;
  p.pitch = E + (8 - E % 16 + 16) % 16;  // 8 mod 16: a fragment's float2 reads hit 32 banks
  // a slot holds an item (rows rounded up to the n8 tiles), then the warps'
  // partial sums of that item
  const int item = (Q + 7) / 8 * 8 * p.pitch * 4, red = p.warps * RED_BYTES;
  const int stage = item > red ? item : red;
  const int fixed = BARRIER_BYTES;
  auto stages_for = [&](int bps) {
    const int n = (SMEM_SM / bps - SMEM_RESERVED - fixed) / stage;
    return n < MAX_STAGES ? n : MAX_STAGES;
  };
  p.blocks_per_sm = p.warps <= 8 && stages_for(2) >= 2 ? 2 : 1;
  p.stages = stages_for(p.blocks_per_sm);
  p.smem = fixed + p.stages * stage;
  p.tiles = (B + TILE_B - 1) / TILE_B;
  const long long slots = (long long)(sms > 0 ? sms : 1) * p.blocks_per_sm / p.tiles;
  p.groups = (int)(slots < 1 ? 1 : slots < N ? slots : N);
  p.grid = p.groups * p.tiles;
  return p;
}

__device__ __forceinline__ float nan_max(float a, float b) { return a > b || a != a ? a : b; }

// max_q <fb, ti[q]> as plain fp32 sums (FFMA in depth order), the four lanes
// of a quad taking tokens tq, tq + 4, ...; every lane of the quad calls it
// and gets the score
__device__ __forceinline__ float exact_score(const float* fb, const float* ti, int Q, int E,
                                             int lane) {
  const float4* x = reinterpret_cast<const float4*>(fb);
  float m = -INFINITY;
  for (int q = lane % 4; q < Q; q += 4) {
    const float4* y = reinterpret_cast<const float4*>(ti + (size_t)q * E);
    float s = 0.0f;
    for (int e = 0; e < E / 4; ++e) {
      const float4 u = x[e], v = y[e];
      s = fmaf(u.x, v.x, s);
      s = fmaf(u.y, v.y, s);
      s = fmaf(u.z, v.z, s);
      s = fmaf(u.w, v.w, s);
    }
    m = nan_max(m, s);
  }
  const unsigned quad = 0xFu << (lane & ~3);
  m = nan_max(m, __shfl_xor_sync(quad, m, 1));
  return nan_max(m, __shfl_xor_sync(quad, m, 2));
}

// MT: the m16 tiles a block's query tile holds, 1 where B <= 16 (a batch of
// one query multiplies one tile, not two), else 2
template <int MT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) token_max_sim_kernel(
    const float* __restrict__ f, const float* __restrict__ t, float* __restrict__ out, int B,
    int N, int Q, int E, int pitch, int stages, int tiles, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);              // [stages]
  int* nan_seen = reinterpret_cast<int*>(smem + MAX_STAGES * 8);    // a score came out NaN
  float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);      // [stages][slot]
  const int rows = (Q + 7) / 8 * 8;  // a slot's rows: the n8 tiles' tokens
  // an item's [rows][pitch], then its partial sums [warps][4][2][32] float4
  const int slot = max(rows * pitch, warps * RED_BYTES / 4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int tile = blockIdx.x % tiles, group = blockIdx.x / tiles;
  const int b0 = tile * TILE_B;
  const int mtiles = min(MT, (B - b0 + 15) / 16);  // m16 tiles that hold a query
  const int ntiles = (Q + 7) / 8;
  const int k0 = warp * KPW;
  const int my_k = min(KPW, (E + 7) / 8 - k0);    // this warp's k-steps, >= 1
  const int ragged = E % 8 ? (E + 7) / 8 - 1 - k0 : -1;  // where E % 8 == 4: the last k-step
  const long long count = group < N ? (long long)(N - 1 - group) / groups + 1 : 0;
  const size_t item = (size_t)Q * E;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) sprc::mbar_init(&full[s], 1);
    *nan_seen = 0;
    sprc::mbar_init_fence();
  }
  __syncthreads();

  // warp 0: item i of this block into slot i % stages, a bulk copy a token row
  auto issue = [&](long long i) {
    const int s = (int)(i % stages);
    const long long n = group + i * groups;
    if (lane == 0) sprc::mbar_arrive_expect_tx(&full[s], (uint32_t)(Q * E * 4));
    __syncwarp();
    if (lane < Q)
      sprc::bulk_load(ring + (size_t)s * slot + lane * pitch, t + (size_t)n * item + (size_t)lane * E,
                      (uint32_t)(E * 4), &full[s]);
  };
  if (warp == 0)
    for (long long i = 0; i < count && i < stages; ++i) issue(i);

  // this warp's k-steps of the query tile, split once: a[j][mt] for rows
  // b0 + 16 mt + (g, g + 8), depths 8 (k0 + j) + 2t, + 1 (k = t, t + 4: a
  // k-step's depths in another order, as the gallery's are read); zero past B and E
  sprc::SplitA a[KPW][MT];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = b0 + mt * 16 + g, c0 = (k0 + j) * 8 + 2 * tq;
      auto at = [&](int r, int c) {
        return j < my_k && r < B && c < E ? f[(size_t)r * E + c] : 0.0f;
      };
      const float v[4] = {at(r0, c0), at(r0 + 8, c0), at(r0, c0 + 1), at(r0 + 8, c0 + 1)};
      a[j][mt] = sprc::SplitA(v);
    }
  }

  for (long long i = 0; i < count; ++i) {
    const int s = (int)(i % stages);
    sprc::mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
    // tokens 8 nt + g of the item, depth 8 (k0 + j) + 2t, + 1 (k = t, t + 4)
    const float* T = ring + (size_t)s * slot + g * pitch + k0 * 8 + 2 * tq;
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      if (j < my_k) {
        float2 raw[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < ntiles)
            raw[nt] = *reinterpret_cast<const float2*>(T + nt * 8 * pitch + j * 8);
        if (j == ragged && 2 * tq >= 4) {  // depths past E: whatever the pad holds, zero
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) raw[nt] = make_float2(0.0f, 0.0f);
        }
        sprc::SplitBTrunc bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) bf[nt] = sprc::SplitBTrunc(raw[nt].x, raw[nt].y);
        // mma_3xtf32's three products, each over every tile before the next:
        // back-to-back tensor-core instructions then go to different
        // accumulators, not one waiting on the other (each tile still adds
        // small . big, big . small, big . big in that order)
#pragma unroll
        for (int prod = 0; prod < 3; ++prod)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              if (nt < ntiles && mt < mtiles) {
                const uint32_t(&av)[4] = prod == 0 ? a[j][mt].small : a[j][mt].big;
                const uint32_t(&bv)[2] = prod == 1 ? bf[nt].small : bf[nt].big;
                sprc::mma_1688_tf32(acc[mt][nt], av, bv[0], bv[1]);
              }
      }
    }
    __syncthreads();  // every warp has read the item in slot s
    // its partial sums into slot s, by (m tile, row half h): rows g + 8 h,
    // tokens 8 nt + 2t, + 1
    float4* red = reinterpret_cast<float4*>(ring + (size_t)s * slot);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          red[((warp * 4 + mt * 2 + h) * 2 + p) * 32 + lane] =
              make_float4(acc[mt][2 * p][2 * h], acc[mt][2 * p][2 * h + 1],
                          acc[mt][2 * p + 1][2 * h], acc[mt][2 * p + 1][2 * h + 1]);
    sprc::fence_async_shared();  // before the slot is refilled by the copy engine
    __syncthreads();
    const long long n = group + i * groups;
    for (int c = warp; c < 4; c += warps) {  // c = 2 mt + h
      if (c / 2 >= mtiles) continue;
      float m = -INFINITY;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float4 sum = red[(c * 2 + p) * 32 + lane];
        for (int w = 1; w < warps; ++w) {
          const float4 v = red[((w * 4 + c) * 2 + p) * 32 + lane];
          sum.x = __fadd_rn(sum.x, v.x);
          sum.y = __fadd_rn(sum.y, v.y);
          sum.z = __fadd_rn(sum.z, v.z);
          sum.w = __fadd_rn(sum.w, v.w);
        }
        const int q0 = 16 * p + 2 * tq, q1 = q0 + 8;  // the tokens of x, y and of z, w
        if (q0 < Q) m = nan_max(m, sum.x);
        if (q0 + 1 < Q) m = nan_max(m, sum.y);
        if (q1 < Q) m = nan_max(m, sum.z);
        if (q1 + 1 < Q) m = nan_max(m, sum.w);
      }
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int b = b0 + c * 8 + g;
      if (tq == 0 && b < B) {
        out[(size_t)b * N + n] = m;
        if (m != m) *nan_seen = 1;
      }
    }
    __syncthreads();  // the partial sums are read: slot s takes the next item
    if (warp == 0 && i + stages < count) issue(i + stages);
  }
  // a NaN score: a NaN or an infinity among its inputs. This block's NaN
  // scores again as plain fp32 sums, a quad a score (past the loop, so that
  // the query tile's registers are free)
  if (!*nan_seen) return;
  for (long long p = threadIdx.x / 4; p < count * TILE_B; p += warps * 8) {
    const int b = b0 + (int)(p % TILE_B);
    const long long n = group + p / TILE_B * groups;
    if (b < B && out[(size_t)b * N + n] != out[(size_t)b * N + n]) {
      const float m = exact_score(f + (size_t)b * E, t + (size_t)n * item, Q, E, lane);
      if (tq == 0) out[(size_t)b * N + n] = m;
    }
  }
}

bool takes(int B, int N, int Q, int E) {
  return B >= 1 && N >= 1 && Q >= 1 && Q <= MAXQ && E >= 4 && E <= MAXE && E % 4 == 0;
}


template <int MT>
cudaError_t launch(const float* f, const float* t, float* out, int B, int N, int Q, int E,
                   const Plan& p, cudaStream_t stream) {
  const cudaError_t err = sprc::allow_smem<token_max_sim_kernel<MT>>(SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  token_max_sim_kernel<MT><<<p.grid, p.warps * 32, p.smem, stream>>>(
      f, t, out, B, N, Q, E, p.pitch, p.stages, p.tiles, p.groups);
  return cudaGetLastError();
}

template <int MT>
cudaError_t resident(const Plan& p, int* blocks) {
  const cudaError_t err = sprc::allow_smem<token_max_sim_kernel<MT>>(SMEM_LIMIT);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, token_max_sim_kernel<MT>,
                                                       p.warps * 32, p.smem);
}

}  // namespace

extern "C" int sprc_token_max_sim(const void* f, const void* t, void* out, int B, int N,
                                  int Q, int E, void* stream) {
  if (!takes(B, N, Q, E)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, N, Q, E, sprc::sm_count());
  const auto* fp = static_cast<const float*>(f);
  const auto* tp = static_cast<const float*>(t);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(B <= 16 ? launch<1>(fp, tp, op, B, N, Q, E, p, s)
                                  : launch<2>(fp, tp, op, B, N, Q, E, p, s));
}

// the plan of a launch on `sms` SMs (sms <= 0: this card's), as 8 ints:
// warps, pitch, stages, blocks_per_sm, tiles, groups, grid, smem bytes; and in
// out[8] the blocks of that size the card keeps resident on an SM
extern "C" int sprc_token_max_sim_plan(int B, int N, int Q, int E, int sms, int* out) {
  if (!takes(B, N, Q, E)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, N, Q, E, sms > 0 ? sms : sprc::sm_count());
  const int vals[8] = {p.warps, p.pitch, p.stages, p.blocks_per_sm,
                       p.tiles, p.groups, p.grid, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return static_cast<int>(B <= 16 ? resident<1>(p, &out[8]) : resident<2>(p, &out[8]));
}
