// K2 / K4c: the backward of K1 / K4a, from the cotangents (du, dw, dg) of
// its outputs to the box parameters and the per-instance MLP weights, for
// one frame (K2) or F stacked frames in one call (K4c).
//
// Replaces the TPU kernel vsrd_tpu/rendering/pallas_field.py::
// _bwd_kernel_manual (:214), launched by the custom_vjp rule
// _fused_bwd_rule (:665, K2) and by _fused_bwd_batched (:757, K4c, grid
// (F, tiles), whose output blocks revisit their frame); the body is
// fused_field.scene_eval_stacked_dir_bwd_t. Since <dg, grad_x u> is the
// derivative of u along dg, each point's field is recomputed with ONE
// tangent along dg and the reverse sweep of that computation runs with
// cotangents (du, dw, 1): first the softmin union (union_backward), then
// each instance's MLP and box (instance_backward, field_common.cuh).
//
// Three kernels, launched back to back on one stream:
//   1. union_cotangent_kernel, grid (point tiles of 256, F): every active
//      instance's d and its derivative td along dg by instance_dir, K3's
//      one-tangent forward, with its layer products on the tensor cores as
//      in dir_forward.cu (each instance's weights copied with cp.async
//      while the previous instance computes, then split once per CTA into
//      the 12 forward A-fragment blocks; per warp one staging block of 16
//      rows of 32 value + 32 tangent columns); then union_backward, one
//      point per thread. d_bar and td_bar go to scratch [F, N, P],
//      instance-major so that stage 2 reads them coalesced;
//   2. instance_backward_kernel, grid (tiles, N, F): a CTA of 4 warps holds
//      ONE instance of one frame and walks kChunksPerCta chunks of kChunk
//      points, one point per thread. Its weights are split once into the
//      24 A-fragment blocks of warp_product.cuh (W_l for the forward, W_l^T
//      for the reverse), read from global memory. Each warp runs its own 32
//      points through instance_backward with every 16-wide layer product on
//      the tensor cores, over a staging block of its own (16 rows of 32
//      value + 32 tangent columns) and, for each reverse step, a second one
//      laid over the residual block that step has just read: the
//      recomputed forward as K3's, the reverse [abar | tabar] = W_l^T [hbar
//      | thbar] (the value and tangent cotangents as the two column blocks
//      of one product; layer 0's W^T one coordinate, one m-tile, at a
//      time), and the weight cotangents dW_l = sum_p hbar a^T + thbar ta^T
//      as m16n8 tiles over the warp's 64 columns (A = [hbar | thbar], B =
//      [a | ta]), 14 tiles whose accumulators stay in the warp's registers
//      for the CTA's whole range. Layer 4 (one output) reverses on the CUDA
//      cores; its dW row is a tile with one real row, which lane gid = 0
//      takes from the lanes by shuffles. The bias column (a = 1, ta = 0) is
//      the sum of hbar over the value columns, added up by each quad from
//      its A fragments. Warps synchronise only themselves (__syncwarp)
//      between the CTA's two barriers, after the weight split and before the
//      epilogue, which sums the warps' tiles and bias sums in warp order and
//      the box cotangents (summed per thread) in thread order into one
//      partial row [dW 1617 | dloc 3 | drot 9 | dhalf 3] (box-only: the last
//      15) of partial [F, N, tiles, row];
//   3. reduce_partials_kernel sums each (frame, instance)'s rows in tile
//      order into out [F, N, row].
// Products in 3xTF32 (mma_tf32.cuh: each operand split into big = tf32(x)
// and small = tf32(x - big), big*big + big*small + small*big accumulated in
// f32, which holds f32 accuracy where one TF32 product would not;
// tests/test_torch_kernels.py pins it for the forward, the reverse and the
// weight-cotangent sums). The default precision (BF16, the JAX body at
// Precision.DEFAULT): ONE bf16 mma.sync per product of the operands rounded
// where the JAX body _group_dir_bwd rounds them: the weights once per CTA
// (packed 64-word fragment blocks), a and ta in the forward, hbar and thbar
// for W_l^T [hbar | thbar], hbar, thbar, a and ta for the weight cotangents,
// the bias column the sum of the rounded hbar; reduce_partials_kernel sums
// in f32 either way. Inactive instances (instance_active) write zero rows.
// No atomics: every sum runs in a fixed order, so the result is bit for bit
// repeatable, and a frame's CTAs read only that frame's inputs.
//
// Per-tile instance-group skipping (the TPU body's two passes with a mask,
// fused_field.scene_eval_stacked_dir_bwd_t, the K1 launch's keep mask
// [F][ceil(N / 8)][ceil(P / mask_tile)], mask_tile a multiple of kChunk):
// stage 1 is pass 1: an instance whose group every tile of the CTA drops
// runs no MLP (its weights are not fetched), and a point whose tile drops
// the group writes kSkipDistance and td = 0, so the union gives it d_bar =
// td_bar = 0 exactly; stage 2 is pass 2, a chunk (inside one mask tile)
// whose tile drops the CTA's instance adds exactly zero and is skipped, and
// a CTA that skips every chunk writes a zero row (the partial rows are
// never zeroed, so every CTA writes its own).
//
// Sizes below are computed from the code and the shapes; the times measured
// on an NVIDIA H100 80GB HBM3 at 700.00 W are in PERF.md.
//
// Scratch, from the grid: d_bar and td_bar 2 F N P floats (102 MB at F=8,
// N=8, P=199,000), partial F N tiles row floats with tiles =
// ceil(ceil(P / 128) / 8) (195 at P=199,000: 81 MB at F=8, N=8, 10 MB at
// F=1). Every element is written before it is read, so none is zeroed.
//
// The bound. Per point and active instance the residual backward takes
// 12,481 multiply-adds of layer products, all on the tensor cores: the
// tangent forward of stage 1 (3,104), the recomputed forward (3,104), the
// reverse W^T [hbar | thbar] (3,104) and the weight cotangents (3,169);
// three products each in 3xTF32 (495 / 3 TFLOP/s), one in bf16 (989
// TFLOP/s). The rest (box, encoding, LayerNorm and GELU with their
// tangents and second-order reverses, the union) runs at the f32 rate
// (chip_smoke.py::kernel_bound counts both). Its bytes (positions,
// directions and cotangents, 28 + 4 N floats' worth per point and frame)
// take 0.03 ms at F=8, P=199,000. Box-only is bound by those bytes.
//
// Occupancy (stage 2, with the residual field): a CTA's shared memory is
// the 24 fragment blocks (6 KB in bf16, 12 KB in 3xTF32), a staging block a
// warp (18 KB), the residual blocks of layers 1-3 (y, tc, Phi(y), istd, p:
// 150 floats a point, 77 KB; keeping Phi spares the reverse 48 erf a
// point), the bias sums and the instance's misc block: 102.9 KB in bf16 and
// 109.0 KB in 3xTF32, so 2 CTAs of 4 warps share an SM (8 warps). The
// registers bind as much: the 14 tiles take 56 a thread, and -Xptxas -v
// reads 255 (bf16, no spill). A warp needs no partner between the CTA's two
// barriers, so the warps of both CTAs overlap freely. Stage 1: 256 threads
// within 128 registers and 56.0 KB, 2 CTAs (16 warps) an SM.
#include <cuda_runtime.h>

#include "field_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "warp_product.cuh"

namespace vsrd {

constexpr int kChunk = 128;                 // points (threads) per stage-2 CTA step
constexpr int kChunksPerCta = 8;            // chunks a stage-2 CTA walks
constexpr int kWarps = kChunk / 32;
constexpr int kUnionThreads = 256;          // stage 1: points per CTA
constexpr int kUnionWarps = kUnionThreads / 32;
constexpr int kMaxInstances = 64;
constexpr int kStageRows = kHid * kDirRowStride;  // one staging block of 16 rows
constexpr int kBwdBlocks = 24;              // forward blocks 0-11, reverse 12-23 (warp_product.cuh)
constexpr int kGradTiles = 14;              // dW's m16n8 tiles: 6 of layer 0, 2 of each other
constexpr int kTileWords = 4 * 32;          // one tile's accumulators over a warp
constexpr int kBias = 4 * kHid + 1;         // the bias columns of layers 0-4
constexpr int kBiasStride = 68;             // a warp's bias sums, kBias rounded up to 4

// A fragment block's words (warp_product.cuh): bf16 packs the 64 it uses,
// 3xTF32 keeps the f32 values (128) and splits them as they are loaded
template <bool BF16>
constexpr int kBlock = BF16 ? 64 : 128;

__host__ __device__ constexpr int layer_in(int l) { return l == 0 ? kEnc : kHid; }
__host__ __device__ constexpr int layer_out(int l) { return l == 4 ? 1 : kHid; }

// Stage 1's shared memory (floats): the forward fragments, the warps'
// staging blocks, the raw weights and the misc block.
struct UnionLayout {
  static constexpr int kStage = kFwdBlocks * 256;
  static constexpr int kRaw = kStage + kUnionWarps * kStageRows;
  static constexpr int kMiscAt = kRaw + kRawSize;
  static constexpr int kSize = kMiscAt + kMisc;
};

// Stage 2's shared memory with the residual field (floats): the fragments,
// the misc block, the box (loc 3 | rot 9 | half 3 | pad), the warps' bias
// sums, the warps' staging blocks, the warps' residual blocks (which the
// epilogue reuses for the warps' tiles and the box cotangents).
constexpr int kResBlock = kRes * 32;  // one layer's residuals over a warp
static_assert(kStageRows <= kResBlock, "a residual block takes a staging block");

template <bool BF16>
struct BackwardLayout {
  static constexpr int kMiscAt = kBwdBlocks * kBlock<BF16>;
  static constexpr int kBox = kMiscAt + kMisc;
  static constexpr int kBiasAt = kBox + 16;
  static constexpr int kStage = kBiasAt + kWarps * kBiasStride;
  static constexpr int kColumns = kStage + kWarps * kStageRows;
  static constexpr int kSize = kColumns + kWarps * kResLayers * kResBlock;
  static_assert(kWarps * kGradTiles * kTileWords + kGeo * kChunk <=
                    kWarps * kResLayers * kResBlock,
                "the epilogue's sums fit in the residual blocks");
};

// instance_backward's product object on the tensor cores: K3's
// (WarpDirProduct, over the warp's staging block) with a second block for a
// reverse step's layer inputs and outputs: the residual block the step has
// just read (the first block for layer 4, which keeps its residuals in
// registers), so that it costs no shared memory of its own. The reverse
// products W_l^T [hbar | thbar] come from the reverse fragment blocks; the
// weight cotangents, per layer (for layer 0 per coordinate), are two m16n8
// tiles over the warp's 64 columns, C [16 x 16] += A [16 x 64] B [64 x 16]
// with A = hbar|thbar (the first block's rows; for layer 4 one row, taken
// from the lanes by shuffles) and B = (a|ta)^T (the second block's rows
// read down their columns), 8 k-steps, the first 4 the value columns. A
// lane's 14 tiles stay in its registers (g). Every lane calls every method,
// so the warp stays converged around each mma.
template <bool BF16>
struct BackwardProduct : WarpDirProduct<BF16, kBlock<BF16>> {
  using Base = WarpDirProduct<BF16, kBlock<BF16>>;
  using Base::act;
  using Base::c;
  using Base::frag;
  using Base::lane;
  float* res;   // this warp's residual blocks [kResLayers][kResBlock]
  float* in;    // the second block
  float* bias;  // this warp's bias-column sums [kBias]
  float g[kGradTiles][4];

  __device__ __forceinline__ BackwardProduct(const unsigned* f, float* stage, float* r, float* b,
                                             int l)
      : Base(f, stage, l), res(r), in(stage), bias(b) {
#pragma unroll
    for (int t = 0; t < kGradTiles; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[t][q] = 0.f;
  }
  __device__ __forceinline__ float& in_at(int row) { return in[row * kDirRowStride + lane]; }
  __device__ __forceinline__ float& in_tan_at(int row) {
    return in[row * kDirRowStride + 32 + lane];
  }
  __device__ __forceinline__ void second(int l) {
    in = l == 4 ? act : res + (l == 0 ? 0 : l - 1) * kResBlock;
  }
  // B stays in the first block: the reverse's outputs go to the second
  __device__ __forceinline__ void hold() {}
  __device__ __forceinline__ void reverse(int l) {
    warp_product<2, 8, kDirRowStride, BF16, kBlock<BF16>>(frag, rev_block(l, 0, 0), act, lane, c);
  }
  __device__ __forceinline__ void reverse0(int m) {
    warp_product<2, 8, kDirRowStride, BF16, kBlock<BF16>>(frag, rev_block(0, 0, m), act, lane, c);
  }
  __device__ __forceinline__ void store_in() { store_acc<8, kDirRowStride>(in, c, lane); }

  // tiles T0 and T0 + 1 of dW; BIAS >= 0: where the layer's bias sums
  // start (once per layer)
  template <int T0, int BIAS>
  __device__ __forceinline__ void grad_tiles() {
    const int gid = lane >> 2, t = lane & 3;
    const float* a0 = act + gid * kDirRowStride;
    const float* a1 = a0 + 8 * kDirRowStride;
    float bsum0 = 0.f, bsum1 = 0.f;  // rows gid and gid + 8 of the bias column
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int k0 = 8 * s;
      if constexpr (BF16) {
        // A: rows gid and gid + 8 at k0 + 2t and k0 + 2t + 1; B: column k0 +
        // 2t and k0 + 2t + 1 of input row 8 j + gid
        const float2 lo = *reinterpret_cast<const float2*>(a0 + k0 + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(a1 + k0 + 2 * t);
        if (s < 4) {
          bsum0 += bf16_round(lo.x) + bf16_round(lo.y);
          bsum1 += bf16_round(hi.x) + bf16_round(hi.y);
        }
        const unsigned a[2] = {pack_bf16x2(lo.x, lo.y), pack_bf16x2(hi.x, hi.y)};
        mma_rows<T0>(a, k0);
      } else {
        // A: (gid, t), (gid + 8, t), (gid, t + 4), (gid + 8, t + 4)
        const float av[4] = {a0[k0 + t], a1[k0 + t], a0[k0 + t + 4], a1[k0 + t + 4]};
        if (s < 4) {
          bsum0 += av[0] + av[2];
          bsum1 += av[1] + av[3];
        }
        mma_rows<T0>(av, k0);
      }
    }
    if constexpr (BIAS >= 0) {
      bsum0 += __shfl_xor_sync(0xffffffffu, bsum0, 1);
      bsum0 += __shfl_xor_sync(0xffffffffu, bsum0, 2);
      bsum1 += __shfl_xor_sync(0xffffffffu, bsum1, 1);
      bsum1 += __shfl_xor_sync(0xffffffffu, bsum1, 2);
      if (t == 0) {
        bias[BIAS + gid] += bsum0;
        bias[BIAS + gid + 8] += bsum1;
      }
    }
  }

  // g[T0 + j] += A's fragment at k0 times B's of input rows 8 j + gid, j =
  // 0, 1: BF16 two bf16x2 words (a), else four f32 values (split here)
  template <int T0>
  __device__ __forceinline__ void mma_rows(const unsigned a[2], int k0) {
    const int gid = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(in + (8 * j + gid) * kDirRowStride + k0 + 2 * t);
      mma_bf16(g[T0 + j], a, pack_bf16x2(b.x, b.y));
    }
  }
  template <int T0>
  __device__ __forceinline__ void mma_rows(const float av[4], int k0) {
    const int gid = lane >> 2, t = lane & 3;
    unsigned ab[4], as[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32_finite(av[q], ab[q], as[q]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* b = in + (8 * j + gid) * kDirRowStride + k0 + t;
      unsigned bb[2], bs[2];
      split_tf32_finite(b[0], bb[0], bs[0]);
      split_tf32_finite(b[4], bb[1], bs[1]);
      mma3_split(g[T0 + j], ab, as, bb, bs);
    }
  }

  __device__ __forceinline__ void grad(int l, int m) {
    switch (l == 0 ? m : 2 + l) {  // the same case in every lane
      case 0: grad_tiles<0, 0>(); break;
      case 1: grad_tiles<2, -1>(); break;
      case 2: grad_tiles<4, -1>(); break;
      case 3: grad_tiles<6, kHid>(); break;
      case 4: grad_tiles<8, 2 * kHid>(); break;
      default: grad_tiles<10, 3 * kHid>(); break;
    }
  }

  // layer 4's tiles 12 and 13: A's one row is [hb | thb] over the warp's
  // points, which lane gid = 0 takes from the lanes by shuffles
  __device__ __forceinline__ void grad4(float hb, float thb) {
    const int gid = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float v = s < 4 ? hb : thb;
      const int k0 = 8 * s, src = 8 * (s & 3);
      if constexpr (BF16) {
        const float x0 = __shfl_sync(0xffffffffu, v, src + 2 * t);
        const float x1 = __shfl_sync(0xffffffffu, v, src + 2 * t + 1);
        const unsigned a[2] = {gid == 0 ? pack_bf16x2(x0, x1) : 0u, 0u};
        mma_rows<12>(a, k0);
      } else {
        const float x0 = __shfl_sync(0xffffffffu, v, src + t);
        const float x4 = __shfl_sync(0xffffffffu, v, src + t + 4);
        const float av[4] = {gid == 0 ? x0 : 0.f, 0.f, gid == 0 ? x4 : 0.f, 0.f};
        mma_rows<12>(av, k0);
      }
    }
    float b = operand<BF16>(hb);  // the bias column: hb summed over the warp's points
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) b += __shfl_xor_sync(0xffffffffu, b, d);
    if (lane == 0) bias[4 * kHid] += b;
  }

  // the lane's tiles into dst [kGradTiles][4][32]
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int t = 0; t < kGradTiles; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[(t * 4 + q) * 32 + lane] = g[t][q];
  }
};

// Where entry e of a warp's tiles (BackwardProduct::put: tile, fragment
// register q, lane) lies in the row [dW 1617 | ...], or -1 for a padding
// row of layer 4's tiles
__device__ __forceinline__ int grad_index(int e) {
  const int tile = e / kTileWords, q = (e / 32) & 3, lane = e & 31;
  const int o = (lane >> 2) + (q >= 2 ? 8 : 0), n = 2 * (lane & 3) + (q & 1);
  const int l = tile < 6 ? 0 : tile < 12 ? 1 + (tile - 6) / 2 : 4;
  const int i = (tile < 6 ? tile : tile < 12 ? (tile - 6) % 2 : tile - 12) * 8 + n;
  return o < layer_out(l) ? layer_offset(l) + o * (layer_in(l) + 1) + i : -1;
}

// Stage 1: d_bar and td_bar of every instance at every point, [F, N, P].
// BF16: the default precision (with the JAX body's rounded 1 / scale).
template <bool RDF, bool BF16>
__global__ void __launch_bounds__(kUnionThreads, RDF ? 2 : 1)
union_cotangent_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ dg,
                       const float* __restrict__ du, const float* __restrict__ dw,
                       const float* __restrict__ loc, const float* __restrict__ rot,
                       const float* __restrict__ half, const float* __restrict__ valid,
                       const float* __restrict__ weights, const float* __restrict__ tau_ptr,
                       float inv_scale, const int* __restrict__ mask, int mask_tile,
                       float* __restrict__ dbar, float* __restrict__ tdbar) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned char active[kMaxInstances];
  const size_t f = blockIdx.y;
  pos += f * P * 3;
  dg += f * P * 3;
  du += f * P;
  dw += f * P * N;
  loc += f * N * 3;
  rot += f * N * 9;
  half += f * N * 3;
  valid += f * N;
  if constexpr (RDF) weights += f * N * kWeights;
  dbar += f * N * P;
  tdbar += f * N * P;
  if (mask != nullptr) mask += f * ((N + kGroup - 1) / kGroup) * ((P + mask_tile - 1) / mask_tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kUnionThreads, p = p0 + tid;
  const bool live = p < P;
  const int pp = live ? p : P - 1;
  // skip mode: the groups this CTA evaluates and those this point's tile keeps
  const unsigned cta_keep =
      kept_groups(mask, N, P, mask_tile, p0, min(p0 + kUnionThreads, P) - 1);
  const unsigned point_keep = kept_groups(mask, N, P, mask_tile, pp, pp);
  const float tau = *tau_ptr;
  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;
  for (int i = tid; i < N; i += kUnionThreads) active[i] = instance_active(valid[i], any_valid);
  __syncthreads();
  // a thread past the end runs the last point, unwritten
  const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
  const float v[3] = {dg[3 * pp], dg[3 * pp + 1], dg[3 * pp + 2]};

  if constexpr (RDF) {
    unsigned* frag = reinterpret_cast<unsigned*>(smem);
    float* stage = smem + UnionLayout::kStage + warp * kStageRows;
    float* raw = smem + UnionLayout::kRaw;
    float* misc = smem + UnionLayout::kMiscAt;
    // the instances whose field this CTA evaluates: active, in a kept group
    auto computed = [&](int i) { return active[i] && group_kept(cta_keep, i); };
    auto next_computed = [&](int i) {
      for (++i; i < N && !computed(i); ++i) {
      }
      return i;
    };
    auto prefetch = [&](int i) {
      const float* src = weights + (size_t)i * kWeights;
      for (int e = tid; e < kWeights; e += kUnionThreads) cp_async4(raw + e, src + e);
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    const int first = next_computed(-1);
    if (first < N) prefetch(first);
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;  // uniform over the CTA
      float d = kSkipDistance, td = 0.f;
      if (group_kept(cta_keep, i)) {  // uniform over the CTA
        const int next = next_computed(i);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();  // raw holds instance i; every warp is done with the last one's fragments
        for (int b = warp; b < kFwdBlocks; b += kUnionWarps) convert_block<BF16>(raw, frag, b, lane);
        for (int e = tid; e < kRevMisc; e += kUnionThreads) misc[e] = operand<BF16>(raw[misc_index(e)]);
        __syncthreads();  // fragments ready, raw free
        if (next < N) prefetch(next);
        WarpDirProduct<BF16> prod(frag, stage, lane);
        d = instance_dir<BF16>(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i, misc, inv_scale, prod,
                               td);
      }
      if (!group_kept(point_keep, i)) {  // the skip mode's pass 1: kSkipDistance
        d = kSkipDistance;
        td = 0.f;
      }
      if (live) {
        dbar[(size_t)i * P + p] = d;
        tdbar[(size_t)i * P + p] = td;
      }
    }
  } else {
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;
      float d = kSkipDistance, td = 0.f;
      if (group_kept(point_keep, i)) {
        float tl[3];
        d = box_dir(BoxGrad(x, loc + 3 * i, rot + 9 * i, half + 3 * i), v, rot + 9 * i, tl, td);
      }
      if (live) {
        dbar[(size_t)i * P + p] = d;
        tdbar[(size_t)i * P + p] = td;
      }
    }
  }
  if (!live) return;
  union_backward(N, active, dbar + p, tdbar + p, valid, tau, du[p], dw + (size_t)p * N, P);
}

// Stage 2: one instance of one frame per CTA, grid (tiles, N, F). BF16: the
// default precision.
template <bool RDF, bool BF16>
__global__ void __launch_bounds__(kChunk, 2)
instance_backward_kernel(int P, int N, const float* __restrict__ pos,
                         const float* __restrict__ dg, const float* __restrict__ loc,
                         const float* __restrict__ rot, const float* __restrict__ half,
                         const float* __restrict__ valid, const float* __restrict__ weights,
                         float inv_scale, const int* __restrict__ mask, int mask_tile,
                         const float* __restrict__ dbar, const float* __restrict__ tdbar,
                         float* __restrict__ partial) {
  using L = BackwardLayout<BF16>;
  extern __shared__ __align__(16) float smem[];
  constexpr int row = RDF ? kParams : kGeo;
  const int tile = blockIdx.x, i = blockIdx.y;
  const size_t f = blockIdx.z;
  const size_t fi = f * N + i;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* out_row = partial + (fi * gridDim.x + tile) * row;
  valid += f * N;
  const int num_chunks = (P + kChunk - 1) / kChunk;
  // skip mode's pass 2: a chunk (inside one mask tile) whose tile drops this
  // instance's group has d_bar = td_bar = 0 exactly there, and is skipped
  const int* keep = nullptr;
  if (mask != nullptr) {
    const int tiles_m = (P + mask_tile - 1) / mask_tile;
    keep = mask + (f * ((N + kGroup - 1) / kGroup) + i / kGroup) * tiles_m;
  }
  auto chunk_kept = [&](int chunk) {
    return keep == nullptr || keep[chunk * kChunk / mask_tile] != 0;
  };
  bool any_chunk = false;
  for (int c = 0; c < kChunksPerCta; ++c) {
    const int chunk = tile * kChunksPerCta + c;
    any_chunk |= chunk < num_chunks && chunk_kept(chunk);
  }
  bool any_valid = false;
  for (int k = 0; k < N; ++k) any_valid |= valid[k] > 0.5f;
  if (!instance_active(valid[i], any_valid) || !any_chunk) {  // uniform over the CTA
    for (int e = tid; e < row; e += kChunk) out_row[e] = 0.f;
    return;
  }
  pos += f * P * 3;
  dg += f * P * 3;
  dbar += fi * P;
  tdbar += fi * P;

  float* box = smem + (RDF ? L::kBox : 0);
  float* region = RDF ? smem + L::kColumns : smem + 16;  // residual blocks, then the sums
  if (tid < 3) {
    box[tid] = loc[fi * 3 + tid];
    box[12 + tid] = half[fi * 3 + tid];
  }
  if (tid < 9) box[3 + tid] = rot[fi * 9 + tid];
  if constexpr (RDF) {
    const float* w = weights + fi * kWeights;
    for (int b = warp; b < kBwdBlocks; b += kWarps)
      convert_block<BF16, kBlock<BF16>>(w, reinterpret_cast<unsigned*>(smem), b, lane);
    for (int e = tid; e < kRevMisc; e += kChunk) smem[L::kMiscAt + e] = operand<BF16>(w[misc_index(e)]);
    for (int e = tid; e < kWarps * kBiasStride; e += kChunk) smem[L::kBiasAt + e] = 0.f;
  }
  __syncthreads();

  float geo[kGeo];
  for (int k = 0; k < kGeo; ++k) geo[k] = 0.f;
  auto point = [&](int c, float x[3], float v[3], float& db, float& tdb) {
    const int p = (tile * kChunksPerCta + c) * kChunk + tid;
    const bool live = p < P;
    const int pp = live ? p : P - 1;
    for (int k = 0; k < 3; ++k) {
      x[k] = pos[3 * pp + k];
      v[k] = dg[3 * pp + k];
    }
    // a point past the end carries zero cotangents, so it adds exact zeros
    db = live ? dbar[p] : 0.f;
    tdb = live ? tdbar[p] : 0.f;
  };
  auto walks = [&](int c) {  // uniform over the CTA
    const int chunk = tile * kChunksPerCta + c;
    return chunk < num_chunks && chunk_kept(chunk);
  };
  if constexpr (RDF) {
    float* res = region + warp * kResLayers * kResBlock;
    BackwardProduct<BF16> prod(reinterpret_cast<const unsigned*>(smem),
                               smem + L::kStage + warp * kStageRows, res,
                               smem + L::kBiasAt + warp * kBiasStride, lane);
    const ColumnStore store{res + lane, 32};
    for (int c = 0; c < kChunksPerCta; ++c) {
      if (!walks(c)) continue;
      float x[3], v[3], db, tdb;
      point(c, x, v, db, tdb);
      instance_backward<BF16>(x, v, box, box + 3, box + 12, smem + L::kMiscAt, inv_scale, db,
                              tdb, geo, prod, store);
    }
    __syncthreads();  // every warp is done with its residual blocks
    prod.put(region + warp * kGradTiles * kTileWords);
  } else {
    for (int c = 0; c < kChunksPerCta; ++c) {
      if (!walks(c)) continue;
      float x[3], v[3], db, tdb, lbar[3] = {0.f, 0.f, 0.f}, tlbar[3] = {0.f, 0.f, 0.f};
      point(c, x, v, db, tdb);
      box_backward(x, v, box, box + 3, box + 12, db, tdb, lbar, tlbar, geo);
    }
  }

  // the epilogue: the warps' dW tiles and bias sums in warp order, the box
  // cotangents in thread order
  float* sums = region + (RDF ? kWarps * kGradTiles * kTileWords : 0);
  for (int k = 0; k < kGeo; ++k) sums[k * kChunk + tid] = geo[k];
  __syncthreads();
  if constexpr (RDF) {
    for (int e = tid; e < kGradTiles * kTileWords; e += kChunk) {
      const int at = grad_index(e);
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += region[w * kGradTiles * kTileWords + e];
      if (at >= 0) out_row[at] = s;
    }
    const float* bias = smem + L::kBiasAt;
    for (int e = tid; e < kBias; e += kChunk) {
      const int l = e / kHid, o = e % kHid;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += bias[w * kBiasStride + e];
      out_row[layer_offset(l) + o * (layer_in(l) + 1) + layer_in(l)] = s;
    }
  }
  if (tid < kGeo) {
    float s = 0.f;
    for (int q = 0; q < kChunk; ++q) s += sums[tid * kChunk + q];
    out_row[row - kGeo + tid] = s;
  }
}

// out[f][i][e] = sum over tiles b, in order, of partial[f][i][b][e];
// grid (ceil(row / 256), N, F)
__global__ void reduce_partials_kernel(int tiles, int row, const float* __restrict__ partial,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= row) return;
  const size_t fi = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  partial += fi * tiles * row;
  float s = 0.f;
  for (int b = 0; b < tiles; ++b) s += partial[(size_t)b * row + e];
  out[fi * row + e] = s;
}

inline size_t union_smem(bool rdf) { return rdf ? UnionLayout::kSize * sizeof(float) : 0; }

template <bool RDF, bool BF16>
size_t instance_smem() {
  return (RDF ? BackwardLayout<BF16>::kSize : 16 + kGeo * kChunk) * sizeof(float);
}

template <bool RDF, bool BF16>
cudaError_t backward_attributes() {
  // both stages take the largest shared-memory carveout, so that the SMs
  // need no reconfiguration between them
  cudaError_t err = cudaFuncSetAttribute(union_cotangent_kernel<RDF, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)union_smem(RDF));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(instance_backward_kernel<RDF, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)instance_smem<RDF, BF16>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(union_cotangent_kernel<RDF, BF16>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(instance_backward_kernel<RDF, BF16>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool RDF, bool BF16>
cudaError_t launch_backward(int F, int P, int N, const float* pos, const float* dg,
                            const float* du, const float* dw, const float* loc, const float* rot,
                            const float* half, const float* valid, const float* weights,
                            const float* tau, float inv_scale, const int* mask, int mask_tile,
                            int tiles, float* dbar, float* tdbar, float* partial, float* out,
                            cudaStream_t s) {
  cudaError_t err = backward_attributes<RDF, BF16>();
  if (err != cudaSuccess) return err;
  const dim3 grid1((P + kUnionThreads - 1) / kUnionThreads, F);
  union_cotangent_kernel<RDF, BF16><<<grid1, kUnionThreads, union_smem(RDF), s>>>(
      P, N, pos, dg, du, dw, loc, rot, half, valid, weights, tau, inv_scale, mask, mask_tile,
      dbar, tdbar);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem2 = instance_smem<RDF, BF16>();
  instance_backward_kernel<RDF, BF16><<<dim3(tiles, N, F), kChunk, smem2, s>>>(
      P, N, pos, dg, loc, rot, half, valid, weights, inv_scale, mask, mask_tile, dbar, tdbar,
      partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int row = RDF ? kParams : kGeo;
  reduce_partials_kernel<<<dim3((row + 255) / 256, N, F), 256, 0, s>>>(tiles, row, partial, out);
  return cudaGetLastError();
}

template <bool RDF, bool BF16>
cudaError_t backward_occupancy(int* ctas1, int* ctas2) {
  cudaError_t err = backward_attributes<RDF, BF16>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas1, union_cotangent_kernel<RDF, BF16>,
                                                        kUnionThreads, union_smem(RDF));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas2, instance_backward_kernel<RDF, BF16>, kChunk, instance_smem<RDF, BF16>());
  return err;
}

}  // namespace vsrd

// Each stage's CTA size, dynamic shared memory (bytes) and CTAs per SM:
// info [6] = {threads, smem, ctas} of stage 1, then of stage 2, for the
// residual field (rdf) or box-only and the precision (bf16).
extern "C" int vsrd_fused_backward_info(int rdf, int bf16, int* info) {
  using namespace vsrd;
  info[0] = kUnionThreads;
  info[1] = (int)union_smem(rdf);
  info[3] = kChunk;
  if (!rdf) {
    info[4] = (int)instance_smem<false, false>();
    return (int)backward_occupancy<false, false>(info + 2, info + 5);
  }
  info[4] = (int)(bf16 ? instance_smem<true, true>() : instance_smem<true, false>());
  return (int)(bf16 ? backward_occupancy<true, true>(info + 2, info + 5)
                    : backward_occupancy<true, false>(info + 2, info + 5));
}

// Stage-2 CTAs per (frame, instance) for P points: the partial buffer
// holds F x N x tiles rows.
extern "C" int vsrd_fused_backward_tiles(int P) {
  const int chunks = (P + vsrd::kChunk - 1) / vsrd::kChunk;
  return (chunks + vsrd::kChunksPerCta - 1) / vsrd::kChunksPerCta;
}

// dbar, tdbar: [F, N, P] scratch; partial: [F, N, tiles, row] scratch with
// tiles = vsrd_fused_backward_tiles(P); out: [F, N, row], each row
// [dW 1617 | dloc 3 | drot 9 | dhalf 3] (rdf) or [dloc 3 | drot 9 | dhalf 3].
// None of them needs zeroing. mask: nullptr, or the skip mode's keep mask
// [F][ceil(N / 8)][ceil(P / mask_tile)] of the forward, mask_tile a multiple
// of kChunk. bf16: the default precision (box-only launches have no
// products, so it does not change them).
extern "C" int vsrd_fused_backward(int F, int P, int N, int rdf, int bf16, const float* pos,
                                   const float* dg,
                                   const float* du, const float* dw, const float* loc,
                                   const float* rot, const float* half, const float* valid,
                                   const float* weights, const float* tau, float scale,
                                   const int* mask, int mask_tile, int tiles, float* dbar,
                                   float* tdbar, float* partial, float* out, void* stream) {
  if (N < 1 || N > vsrd::kMaxInstances || F < 1 || P < 1 || tiles != vsrd_fused_backward_tiles(P))
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (mask_tile < vsrd::kChunk || mask_tile % vsrd::kChunk != 0))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !rdf ? vsrd::launch_backward<false, false>(F, P, N, pos, dg, du, dw, loc, rot, half, valid,
                                                 nullptr, tau, 1.f / scale, mask, mask_tile,
                                                 tiles, dbar, tdbar, partial, out, s)
      : bf16 ? vsrd::launch_backward<true, true>(F, P, N, pos, dg, du, dw, loc, rot, half, valid,
                                                 weights, tau, 1.f / scale, mask, mask_tile,
                                                 tiles, dbar, tdbar, partial, out, s)
             : vsrd::launch_backward<true, false>(F, P, N, pos, dg, du, dw, loc, rot, half, valid,
                                                  weights, tau, 1.f / scale, mask, mask_tile,
                                                  tiles, dbar, tdbar, partial, out, s);
  return (int)err;
}
