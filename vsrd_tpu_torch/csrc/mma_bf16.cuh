// Tensor-core helpers of the field kernels' default precision: one
// mma.sync.m16n8k8 in BF16 with f32 accumulation, and the RNE packing of two
// f32 values into a bf16x2 word.
//
// This is the function the TPU's MXU computes for an f32 dot_general at
// Precision.DEFAULT (the JAX package's pallas_matmul_precision="default"):
// both operands rounded to bf16 (round to nearest, ties to even), their
// products exact in f32 (8 x 8 significant bits), the sum in f32. One TF32
// product (mma_tf32.cuh) would keep 11 bits of each operand: another, more
// accurate function, so it is not the port of this mode.
//
// Fragments of m16n8k8 with .bf16 (gid = lane / 4, t = lane % 4; each A and
// B register holds two elements, the lower k in the low half):
//   A 16x8: a0 (gid, 2t | 2t + 1), a1 (gid + 8, 2t | 2t + 1)
//   B 8x8:  b0 (2t | 2t + 1, gid)
//   C 16x8: c0 (gid, 2t), c1 (gid, 2t + 1), c2 (gid + 8, 2t), c3 (gid + 8, 2t + 1)
// so the k-steps of 8 and the staging rows of the TF32 products stay; only
// the loads change. mma.sync needs the whole warp: call these only where the
// warp is converged.
#pragma once

#include <cuda_runtime.h>

namespace vsrd {

// {bf16(lo) in bits 0-15, bf16(hi) in bits 16-31}, each rounded to nearest
// even (cvt puts its first source in the upper half)
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[2], unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

}  // namespace vsrd
