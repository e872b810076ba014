// Warp-wide layer products of the field's MLP on the tensor cores, shared by
// K1/K4a (fused_forward.cu), K3/K4b (dir_forward.cu) and K2/K4c
// (fused_backward.cu).
//
// A warp computes C [16 x 8 NT] += A [16 x K] B [K x 8 NT] over NT n-tiles of
// 8 columns with mma.sync.m16n8k8 in 3xTF32 (mma_tf32.cuh). A is a layer's
// weights, split once per instance into TF32 big and small words in the
// A-fragment order (convert_block), so that a lane loads a fragment with two
// 16-byte loads and no conversion; B is read from the warp's staging rows in
// shared memory (row k at B + k * STRIDE, with STRIDE = 8 mod 32 so that the
// B-fragment loads are free of bank conflicts) and split by integer
// arithmetic (split_tf32_finite).
//
// The default precision (BF16; mma_bf16.cuh) is one mma.sync.m16n8k8 in bf16
// per k-step and n-tile, f32 sums: A's fragment is two words per lane, each
// a pair of consecutive k rounded to bf16 once per instance (convert_block
// in its bf16 form, in the same 256-word blocks or, with BLOCK = 64, packed
// blocks of the 64 words it uses), and B's one word, a pair of staging rows
// rounded as it is loaded. With BLOCK = 128 a 3xTF32 block holds A's f32
// values in the fragment order, split as they are loaded: half the shared
// memory, four integer splits more per k-step.
#pragma once

#include <cuda_runtime.h>

#include "field_common.cuh"
#include "mma_bf16.cuh"
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
// and small words (BLOCK = 256) or kept as f32 (BLOCK = 128), or (BF16)
// rounded into its two bf16x2 words at frag + b * BLOCK + lane * 2. raw may
// lie in shared or global memory.
template <bool BF16, int BLOCK = 256>
__device__ __forceinline__ void convert_block(const float* raw, unsigned* frag, int b, int lane) {
  static_assert(BLOCK == 256 || BLOCK == (BF16 ? 64 : 128), "a block's words");
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
  if constexpr (BF16) {
    auto at = [&](int r, int k) { return rev ? W[k * row + r] : W[r * row + k]; };
    const int r = m * 16 + gid, k = s * 8 + 2 * t;
    *reinterpret_cast<uint2*>(frag + b * BLOCK + lane * 2) = make_uint2(
        pack_bf16x2(at(r, k), at(r, k + 1)), pack_bf16x2(at(r + 8, k), at(r + 8, k + 1)));
    return;
  }
  unsigned big[4], small[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = m * 16 + gid + (q & 1) * 8, k = s * 8 + t + (q >> 1) * 4;
    const float x = rev ? W[k * row + r] : W[r * row + k];
    if constexpr (BLOCK == 128)
      big[q] = __float_as_uint(x);
    else
      split_tf32_finite(x, big[q], small[q]);
  }
  if constexpr (BLOCK == 128) {
    *reinterpret_cast<uint4*>(frag + b * 128 + lane * 4) = make_uint4(big[0], big[1], big[2], big[3]);
    return;
  }
  *reinterpret_cast<uint4*>(frag + b * 256 + lane * 4) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(frag + b * 256 + 128 + lane * 4) =
      make_uint4(small[0], small[1], small[2], small[3]);
}

// c[nt] += A B over NT n-tiles of 8 columns, K = 8 * KSTEPS; A's fragments
// from blocks block.. (BLOCK words apart, as convert_block wrote them), B
// from the staging rows (row k at B + k * STRIDE)
template <int KSTEPS, int NT, int STRIDE, bool BF16 = false, int BLOCK = 256>
__device__ __forceinline__ void warp_product(const unsigned* frag, int block, const float* B,
                                             int lane, float c[NT][4]) {
  const int gid = lane >> 2, t = lane & 3;
  if constexpr (BF16) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint2 w = *reinterpret_cast<const uint2*>(frag + (block + s) * BLOCK + lane * 2);
      const unsigned a[2] = {w.x, w.y};
      const float* b = B + (s * 8 + 2 * t) * STRIDE + gid;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(c[nt], a, pack_bf16x2(b[nt * 8], b[nt * 8 + STRIDE]));
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    unsigned ab[4], as[4];
    if constexpr (BLOCK == 128) {
      const uint4 raw = *reinterpret_cast<const uint4*>(frag + (block + s) * 128 + lane * 4);
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32_finite(__uint_as_float(w[q]), ab[q], as[q]);
    } else {
      const uint4 big = *reinterpret_cast<const uint4*>(frag + (block + s) * 256 + lane * 4);
      const uint4 small =
          *reinterpret_cast<const uint4*>(frag + (block + s) * 256 + 128 + lane * 4);
      ab[0] = big.x, ab[1] = big.y, ab[2] = big.z, ab[3] = big.w;
      as[0] = small.x, as[1] = small.y, as[2] = small.z, as[3] = small.w;
    }
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

// The one-tangent form's layer products (field_common.cuh: mlp_dir, for
// instance_dir and instance_backward) on the tensor cores: a warp's C [16 x
// 64] = A [16 x K] B [K x 64] over its own 32 points' value columns (n-tiles
// 0-3) and tangent columns (n-tiles 4-7), A from the instance's fragment
// blocks (BLOCK words apart), B from the warp's staging rows (row k at act
// + k * kDirRowStride; the stride is 8 mod 32, so that the B fragments load
// without bank conflicts). Every lane calls every method, so the warp stays
// converged around each mma. BF16: the default precision, one bf16 mma per
// product; the bias rows (misc) are rounded where they are staged.
constexpr int kDirRowStride = 72;  // staging row: 32 + 32 points + 8

template <bool BF16, int BLOCK = 256>
struct WarpDirProduct {
  const unsigned* frag;
  float* act;
  int lane;
  float c[8][4];

  __device__ __forceinline__ WarpDirProduct(const unsigned* f, float* a, int l)
      : frag(f), act(a), lane(l) {}
  __device__ __forceinline__ float& at(int row) { return act[row * kDirRowStride + lane]; }
  __device__ __forceinline__ float& tan_at(int row) {
    return act[row * kDirRowStride + 32 + lane];
  }
  __device__ __forceinline__ void sync() { __syncwarp(); }
  __device__ __forceinline__ void begin(const float* bias) {
    init_acc<4>(c, bias, lane);
    init_acc<4>(c + 4, nullptr, lane);
  }
  __device__ __forceinline__ void forward(int l, int m) {
    warp_product<2, 8, kDirRowStride, BF16, BLOCK>(
        frag, l == 0 ? fwd_block(0, 2 * m) : fwd_block(l, 0), act, lane, c);
  }
  __device__ __forceinline__ void store() { store_acc<8, kDirRowStride>(act, c, lane); }
};

}  // namespace vsrd
