// Tensor-core helpers shared by the field kernels: mma.sync.m16n8k8 in TF32
// with the 3xTF32 split, and 4-byte cp.async.
//
// 3xTF32: each f32 operand x is split into big = tf32(x) and small =
// tf32(x - big), and big*big + big*small + small*big is accumulated in f32.
// That holds f32 accuracy where one TF32 product (10-bit mantissa) would not
// (tests/test_torch_kernels.py pins it for the weight-gradient sums and for
// the fine forward's layer products).
//
// Fragments of m16n8k8 (gid = lane / 4, t = lane % 4):
//   A 16x8: a0 (gid, t), a1 (gid + 8, t), a2 (gid, t + 4), a3 (gid + 8, t + 4)
//   B 8x8:  b0 (t, gid), b1 (t + 4, gid)
//   C 16x8: c0 (gid, 2t), c1 (gid, 2t + 1), c2 (gid + 8, 2t), c3 (gid + 8, 2t + 1)
// mma.sync needs the whole warp: call these only where the warp is converged.
#pragma once

#include <cuda_runtime.h>

namespace vsrd {

// x = big + small, each a TF32 value (cvt.rna leaves the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// The same split by integer arithmetic, for finite x: cvt.rna.tf32.f32 (round
// to nearest, ties away from zero) is (bits + 0x1000) & ~0x1fff there; the
// conversion instruction also guards infinities and costs about twice as
// many instructions.
__device__ __forceinline__ void split_tf32_finite(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src));
}

// the three products of a 3xTF32 step with B's fragment already split:
// c += a_small b_big + a_big b_small + a_big b_big
__device__ __forceinline__ void mma3_split(float c[4], const unsigned ab[4], const unsigned as[4],
                                           const unsigned bb[2], const unsigned bs[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// the three products of a 3xTF32 step, B's fragment read at column k0 of the
// staged row b
__device__ __forceinline__ void mma3(float c[4], const unsigned ab[4], const unsigned as[4],
                                     const float* b, int k0) {
  unsigned bb[2], bs[2];
  split_tf32(b[k0], bb[0], bs[0]);
  split_tf32(b[k0 + 4], bb[1], bs[1]);
  mma3_split(c, ab, as, bb, bs);
}

}  // namespace vsrd
