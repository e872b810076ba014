// Warp-wide layer products of the field's MLP on the tensor cores, shared by
// the forward kernels K1/K4a (fused_forward.cu) and K3/K4b (dir_forward.cu).
//
// A warp computes C [16 x 8 NT] += A [16 x K] B [K x 8 NT] over NT n-tiles of
// 8 columns with mma.sync.m16n8k8 in 3xTF32 (mma_tf32.cuh). A is a layer's
// weights, split once per instance into TF32 big and small words in the
// A-fragment order (convert_block), so that a lane loads a fragment with two
// 16-byte loads and no conversion; B is read from the warp's staging rows in
// shared memory (row k at B + k * STRIDE, with STRIDE = 8 mod 32 so that the
// B-fragment loads are free of bank conflicts) and split by integer
// arithmetic (split_tf32_finite).
#pragma once

#include <cuda_runtime.h>

#include "field_common.cuh"
#include "mma_tf32.cuh"

namespace vsrd {

constexpr int kRawSize = 1620;  // kWeights, rounded up to 4
constexpr int kMisc = 84;       // kRevMisc, rounded up to 4
constexpr int kFwdBlocks = 12;  // A-fragment blocks of the value forward (layers 0-3)
constexpr size_t kMaxSmem = 232448;  // a CTA's shared memory on Hopper

// A-fragment blocks of 256 words (big [32][4], small [32][4]): the forward of
// layer l (A = W_l) at k-step s, blocks 0-11, and the reverse (A = W_l^T) at
// k-step s and, for layer 0, m-tile m (coordinate m), blocks 12-23
__host__ __device__ constexpr int fwd_block(int l, int s) { return l == 0 ? s : 6 + (l - 1) * 2 + s; }
__host__ __device__ constexpr int rev_block(int l, int s, int m) {
  return l == 0 ? 18 + m * 2 + s : 12 + (l - 1) * 2 + s;
}

// Block b's fragment of one lane from the raw weights, split into TF32 big
// and small words.
__device__ __forceinline__ void convert_block(const float* raw, unsigned* frag, int b, int lane) {
  int l, s, m = 0;
  bool rev;
  if (b < 6) {
    l = 0, s = b, rev = false;
  } else if (b < 12) {
    l = 1 + (b - 6) / 2, s = (b - 6) % 2, rev = false;
  } else if (b < 18) {
    l = 1 + (b - 12) / 2, s = (b - 12) % 2, rev = true;
  } else {
    l = 0, m = (b - 18) / 2, s = (b - 18) % 2, rev = true;
  }
  const int row = (l == 0 ? kEnc : kHid) + 1;
  const float* W = raw + layer_offset(l);
  const int gid = lane >> 2, t = lane & 3;
  unsigned big[4], small[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = m * 16 + gid + (q & 1) * 8, k = s * 8 + t + (q >> 1) * 4;
    split_tf32_finite(rev ? W[k * row + r] : W[r * row + k], big[q], small[q]);
  }
  *reinterpret_cast<uint4*>(frag + b * 256 + lane * 4) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(frag + b * 256 + 128 + lane * 4) =
      make_uint4(small[0], small[1], small[2], small[3]);
}

// c[nt] += A B over NT n-tiles of 8 columns, K = 8 * KSTEPS; A's fragments
// from blocks block.., B from the staging rows (row k at B + k * STRIDE)
template <int KSTEPS, int NT, int STRIDE>
__device__ __forceinline__ void warp_product(const unsigned* frag, int block, const float* B,
                                             int lane, float c[NT][4]) {
  const int gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const uint4 big = *reinterpret_cast<const uint4*>(frag + (block + s) * 256 + lane * 4);
    const uint4 small = *reinterpret_cast<const uint4*>(frag + (block + s) * 256 + 128 + lane * 4);
    const unsigned ab[4] = {big.x, big.y, big.z, big.w};
    const unsigned as[4] = {small.x, small.y, small.z, small.w};
    const float* b = B + (s * 8 + t) * STRIDE + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned bb[2], bs[2];
      split_tf32_finite(b[nt * 8], bb[0], bs[0]);
      split_tf32_finite(b[nt * 8 + 4 * STRIDE], bb[1], bs[1]);
      mma3_split(c[nt], ab, as, bb, bs);
    }
  }
}

// c = bias (row o: bias[o]) or 0, over NT n-tiles
template <int NT>
__device__ __forceinline__ void init_acc(float c[NT][4], const float* bias, int lane) {
  const int gid = lane >> 2;
  const float lo = bias ? bias[gid] : 0.f, hi = bias ? bias[gid + 8] : 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = lo, c[nt][2] = c[nt][3] = hi;
}

// C's 16 rows into the staging rows at dst (row r at dst + r * STRIDE)
template <int NT, int STRIDE>
__device__ __forceinline__ void store_acc(float* dst, const float c[NT][4], int lane) {
  const int gid = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(dst + gid * STRIDE + nt * 8 + 2 * t) = make_float2(c[nt][0], c[nt][1]);
    *reinterpret_cast<float2*>(dst + (gid + 8) * STRIDE + nt * 8 + 2 * t) =
        make_float2(c[nt][2], c[nt][3]);
  }
}

}  // namespace vsrd
