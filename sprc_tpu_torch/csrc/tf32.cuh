// 3xTF32 products on the tensor cores (mma.sync.m16n8k8, tf32 in, fp32 out):
// every fp32 operand x is split into a TF32 big part and the TF32 rounding of
// what is left, and a product is small . big + big . small + big . big (about
// 2^-22 of each product is lost). Shared by the fp32 attention
// (csrc/attention.cu) and the token-max similarity (csrc/token_max_sim.cu);
// ops/schedules.py::split_tf32 / mma_3xtf32 emulate them.
#pragma once

#include <stdint.h>

namespace sprc {

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

// the A fragment split once for the products it takes part in
struct SplitA {
  uint32_t big[4], small[4];
  SplitA() = default;
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], big[i], small[i]);
  }
};

// x as TF32 parts by truncation: big = x with the low 13 bits of the
// mantissa cleared, small = the same of x - big (exact in fp32); three
// operations where cvt.rna.tf32.f32 is several on sm_90a; big + small is x
// to about 2^-20 of itself (2^-22 above). Both parts of an infinity or a NaN
// give NaN in a product, as split_tf32's do (the small part of an infinity is
// inf - inf): a caller that must keep infinities takes such a result again
// in plain fp32 (csrc/token_max_sim.cu does).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xFFFFE000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big))) & 0xFFFFE000u;
}

// the B fragment (b0, b1) split by truncation
struct SplitBTrunc {
  uint32_t big[2], small[2];
  SplitBTrunc() = default;
  __device__ __forceinline__ SplitBTrunc(float b0, float b1) {
    split_tf32_trunc(b0, big[0], small[0]);
    split_tf32_trunc(b1, big[1], small[1]);
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

}  // namespace sprc
