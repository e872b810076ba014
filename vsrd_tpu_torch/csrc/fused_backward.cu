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
//   1. union_cotangent_kernel, grid (point blocks, F), one point per
//      thread: every active instance's d and its derivative td along dg
//      (instance_forward<1>, weights staged in shared memory in groups of
//      kGroup), then union_backward; d_bar and td_bar go to scratch
//      [F, N, P], instance-major so that stage 2 reads them coalesced;
//   2. instance_backward_kernel, grid (tiles, N, F): a CTA of 4 warps holds
//      ONE instance of one frame (its weights, in rows padded to 16 bytes,
//      and its 15 box values, copied with cp.async) and walks
//      kChunksPerCta chunks of kChunk points, one point per thread: the
//      one-tangent forward again, then the reverse sweep. The weight
//      gradient dW_l = sum_p hbar a^T + thbar ta^T of every layer is, per
//      chunk, an [out x 2 kChunk] x [2 kChunk x in] product (primal and
//      tangent halves stacked along K) on the tensor cores with
//      mma.sync.m16n8k8 in 3xTF32: each operand is split into big =
//      tf32(x) and small = tf32(x - big), and big*big + big*small +
//      small*big is accumulated in f32, which holds f32 accuracy where one
//      TF32 product (10-bit mantissa) would not (tests/
//      test_torch_kernels.py pins both). The m16n8 tiles (6 for layer 0,
//      2 for each other layer; layer 4's single output row padded to 16)
//      are shared out so that every warp does the same work: some tiles
//      are split along K between two warps and added in the epilogue. The
//      accumulators stay in registers for the CTA's whole range. The bias
//      column (a = 1, ta = 0) is the sum of hbar over the primal half,
//      added up in f32 by one warp from its A fragments. The box
//      cotangents are summed per thread, then over the CTA in thread
//      order. Each CTA writes one partial row [dW 1617 | dloc 3 | drot 9 |
//      dhalf 3] (box-only: the last 15) to partial [F, N, tiles, row];
//   3. reduce_partials_kernel sums each (frame, instance)'s rows in tile
//      order into out [F, N, row].
// No atomics: every sum runs in a fixed order, so the result is bit for
// bit repeatable, and a frame's CTAs read only that frame's inputs.
// The default precision (BF16, the JAX body at Precision.DEFAULT): stage 1
// and stage 2's recompute round every product operand to bf16 (the weights
// once, where they are staged), the input cotangents W^T hbar round hbar,
// and the weight-gradient sums are one bf16 mma of the rounded operands
// (MmaSink<true>); reduce_partials_kernel sums in f32 either way.
// Inactive instances (instance_active) write zero rows.
//
// Per-tile instance-group skipping (the TPU body's two passes with a mask,
// fused_field.scene_eval_stacked_dir_bwd_t, the K1 launch's keep mask
// [F][ceil(N / 8)][ceil(P / mask_tile)], mask_tile a multiple of kChunk):
// stage 1 is pass 1, a point whose tile drops a group writes kSkipDistance
// and td = 0 for its instances without evaluating them (a block whose
// points all drop it does not stage its weights), so the union gives them
// d_bar = td_bar = 0 exactly; stage 2 is pass 2, a chunk (inside one mask
// tile) whose tile drops the CTA's instance adds exactly zero and is
// skipped, and a CTA that skips every chunk writes a zero row (the partial
// rows are never zeroed, so every CTA writes its own).
//
// Sizes below are computed from the code and the shapes; the times measured
// on an NVIDIA H100 80GB HBM3 at 700.00 W are in PERF.md.
//
// Scratch, from the grid: d_bar and td_bar 2 F N P floats (102 MB at F=8,
// N=8, P=199,000), partial F N tiles row floats with tiles =
// ceil(ceil(P / 128) / 4) (389 at P=199,000: 163 MB at F=8, N=8, 20 MB at
// F=1). Every element is written before it is read, so none is zeroed.
//
// The bound. Per point and active instance the residual backward does
// 9,312 f32 FMAs outside the tensor cores (the tangent forward of stage 1,
// 3,104; the recomputed forward, 3,104; the reverse matvecs, 3,104) and
// 3,169 multiply-adds of dW on the tensor cores, three products each in
// 3xTF32. At 67 TFLOP/s f32 (2 FLOP an FMA) those take 0.278 ns per
// point-instance; the dW sums, at 2 FLOP a multiply-add over 495 / 3
// TFLOP/s, 0.038 ns. Since every one of those products could run on the
// tensor cores, the function's least time counts all 12,481 multiply-adds
// at the 3xTF32 rate and the rest (box, encoding, LayerNorm, GELU, union)
// at the f32 rate (chip_smoke.py::kernel_bound). Its bytes (positions,
// directions and cotangents, 28 + 4 N floats' worth per point and frame)
// take 0.03 ms at F=8, P=199,000. Box-only is bound by those bytes.
//
// What the design does about what held the PR-2 kernel back (a fixed pool
// of 64-thread CTAs, each walking every instance of its frame):
//   * occupancy: a stage-2 CTA stages one instance's weights (7.2 KB
//     padded) instead of eight (52 KB); with the residuals and the mma
//     staging it takes 94.9 KB of shared memory and 254 registers a thread
//     (-Xptxas -v), so 2 CTAs of 4 warps (8 warps) fit on an SM, against
//     2 CTAs of 2 warps;
//   * the weight-gradient sink: the scalar dot products over shared
//     memory (four loads per two FMAs) became tensor-core products, two
//     barriers per layer and chunk of 128 points;
//   * local memory: the LayerNorm residuals (y, tc, istd, P of layers
//     1-4, 136 floats per point) live in a per-thread column of shared
//     memory (ColumnStore) and the layer loops are unrolled, so no spill
//     remains (a 592-byte stack frame holds the encoding's per-point
//     arrays);
//   * the frame split of a fixed CTA pool: the grid is (tiles, N, F), so
//     the work per CTA is the same at any F and N, and every (frame,
//     instance) pair runs in parallel.
#include <cuda_runtime.h>

#include "field_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace vsrd {

constexpr int kChunk = 128;                  // points (threads) per CTA step
constexpr int kChunksPerCta = 4;             // chunks a stage-2 CTA walks
constexpr int kUnionThreads = 256;           // stage 1: points per block
constexpr int kMaxInstances = 64;
constexpr int kStageStride = 2 * kChunk + 4;  // mma staging row (+4: no bank conflicts)
constexpr int kWarps = kChunk / 32;

__host__ __device__ constexpr int layer_in(int l) { return l == 0 ? kEnc : kHid; }
__host__ __device__ constexpr int layer_out(int l) { return l == 4 ? 1 : kHid; }
constexpr int kSlots = 6;       // accumulator tiles per warp: 2 for layer 0, 1 for each other
constexpr int kBias = 4 * kHid + 1;  // the bias columns of layers 0-4

// The mma staging of layer l: rows a|ta for each input, then hbar|thbar for
// each output, and where it starts in the region. Layer l >= 1 lies over
// the residuals of layers > l, which its reverse step no longer needs;
// layer 0 over all of them.
__host__ __device__ constexpr int stage_rows(int l) { return layer_in(l) + layer_out(l); }
__host__ __device__ constexpr int stage_offset(int l) { return l == 0 ? 0 : l * kRes * kChunk; }
__host__ __device__ constexpr int stage_end(int l) {
  return stage_offset(l) + stage_rows(l) * kStageStride;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kRegion = cmax(cmax(cmax(stage_end(0), stage_end(1)),
                                  cmax(stage_end(2), stage_end(3))),
                             cmax(stage_end(4), 4 * kRes * kChunk));

// where weight e of the hypernetwork's packed output lies in the padded copy
__device__ __forceinline__ int padded_index(int e) {
  constexpr int rows0 = kHid * (kEnc + 1), block = kHid * (kHid + 1);
  if (e < rows0) return Padded::at(0, e / (kEnc + 1), e % (kEnc + 1));
  e -= rows0;
  const int l = 1 + e / block;
  e -= (l - 1) * block;
  return Padded::at(l, e / (kHid + 1), e % (kHid + 1));
}

// Sums each layer's weight gradient over the CTA's points on the tensor
// cores. A layer's product C[o][i] = sum_k A[o][k] B[k][i] has K = 2 kChunk
// (the chunk's points, primal half then tangent half), A = hbar|thbar and
// B = a|ta, in m16n8 tiles of 8 input columns: 6 tiles for layer 0, 2 for
// the others. Every warp does the same work, with no branch on the warp
// around an mma (mma.sync needs the whole warp): in layer 0 warp w runs
// tile w over all of K and tile 4 + w % 2 over half w / 2 of K; in layers
// 1-4, tile w % 2 over half w / 2. The halves are added in the epilogue.
// The bias column (a = 1, ta = 0) is the sum of hbar over the primal half:
// warp 0 adds it up in f32 from its A fragments, into shared memory.
// BF16: the default precision, ONE bf16 product per tile and k-step of the
// rounded operands (mma_bf16.cuh), the bias column the sum of the rounded
// hbar: the JAX body's dmats = obar stacked^T at Precision.DEFAULT.
template <bool BF16>
struct MmaSink {
  float* region;  // shared: the staging
  float* bias;    // shared: [kBias] bias-column sums
  int tid;
  float acc[kSlots][4];

  __device__ MmaSink(float* r, float* b, int t) : region(r), bias(b), tid(t) {
    for (int s = 0; s < kSlots; ++s)
      for (int q = 0; q < 4; ++q) acc[s][q] = 0.f;
  }

  template <int L>
  __device__ __forceinline__ void products(const float* a, const float* ta, const float* hbar,
                                           const float* thbar) {
    constexpr int in = layer_in(L), out = layer_out(L), steps = kChunk / 8;
    float* st = region + stage_offset(L);
    __syncthreads();  // the previous layer's products have read their staging
#pragma unroll
    for (int i = 0; i < in; ++i) {
      st[i * kStageStride + tid] = a[i];
      st[i * kStageStride + kChunk + tid] = ta[i];
    }
#pragma unroll
    for (int o = 0; o < out; ++o) {
      st[(in + o) * kStageStride + tid] = hbar[o];
      st[(in + o) * kStageStride + kChunk + tid] = thbar[o];
    }
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, t = lane & 3;
    const int own = (warp >> 1) * kChunk, other = kChunk - own;  // this warp's half of K
    const float* hb = st + in * kStageStride;
    const bool row0 = gid < out, row1 = gid + 8 < out;
    const float* a0 = hb + (row0 ? gid : 0) * kStageStride + t;
    const float* a1 = hb + (row1 ? gid + 8 : 0) * kStageStride + t;
    float bsum0 = 0.f, bsum1 = 0.f;  // rows gid and gid + 8 of the bias column
    if constexpr (BF16) {
      // A's fragment at k0: rows gid and gid + 8 at k0 + 2t and k0 + 2t + 1, rounded
      auto load = [&](int k0, unsigned a[2], bool add_bias) {
        const float x0 = row0 ? bf16_round(a0[k0 + t]) : 0.f;
        const float x1 = row0 ? bf16_round(a0[k0 + t + 1]) : 0.f;
        const float x2 = row1 ? bf16_round(a1[k0 + t]) : 0.f;
        const float x3 = row1 ? bf16_round(a1[k0 + t + 1]) : 0.f;
        if (add_bias) {
          bsum0 += x0 + x1;
          bsum1 += x2 + x3;
        }
        a[0] = pack_bf16x2(x0, x1);
        a[1] = pack_bf16x2(x2, x3);
      };
      // B's fragment at k0 from the staged row b (at column 2t)
      auto bword = [&](const float* b, int k0) { return pack_bf16x2(b[k0], b[k0 + 1]); };
      if constexpr (L == 0) {
        const float* bfull = st + (warp * 8 + gid) * kStageStride + 2 * t;
        const float* bhalf = st + ((4 + (warp & 1)) * 8 + gid) * kStageStride + 2 * t;
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned a[2];
          load(own + 8 * s, a, true);
          mma_bf16(acc[0], a, bword(bfull, own + 8 * s));
          mma_bf16(acc[1], a, bword(bhalf, own + 8 * s));
        }
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned a[2];
          load(other + 8 * s, a, false);
          mma_bf16(acc[0], a, bword(bfull, other + 8 * s));
        }
      } else {
        const float* b = st + ((warp & 1) * 8 + gid) * kStageStride + 2 * t;
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned a[2];
          load(own + 8 * s, a, true);
          mma_bf16(acc[L + 1], a, bword(b, own + 8 * s));
        }
      }
    } else {
      // A's fragment at k0, split; every lane loads a valid row and selects
      auto load_a = [&](int k0, unsigned ab[4], unsigned as[4], bool add_bias) {
        const float x0 = a0[k0], x1 = a1[k0], x2 = a0[k0 + 4], x3 = a1[k0 + 4];
        const float av[4] = {row0 ? x0 : 0.f, row1 ? x1 : 0.f, row0 ? x2 : 0.f, row1 ? x3 : 0.f};
        if (add_bias) {
          bsum0 += av[0] + av[2];
          bsum1 += av[1] + av[3];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(av[q], ab[q], as[q]);
      };
      if constexpr (L == 0) {
        const float* bfull = st + (warp * 8 + gid) * kStageStride + t;
        const float* bhalf = st + ((4 + (warp & 1)) * 8 + gid) * kStageStride + t;
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned ab[4], as[4];
          load_a(own + 8 * s, ab, as, true);
          mma3(acc[0], ab, as, bfull, own + 8 * s);
          mma3(acc[1], ab, as, bhalf, own + 8 * s);
        }
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned ab[4], as[4];
          load_a(other + 8 * s, ab, as, false);
          mma3(acc[0], ab, as, bfull, other + 8 * s);
        }
      } else {
        const float* b = st + ((warp & 1) * 8 + gid) * kStageStride + t;
#pragma unroll 2
        for (int s = 0; s < steps; ++s) {
          unsigned ab[4], as[4];
          load_a(own + 8 * s, ab, as, true);
          mma3(acc[L + 1], ab, as, b, own + 8 * s);
        }
      }
    }
    // warp 0's own half is the primal one: its quads' sums are the bias column's
    bsum0 += __shfl_xor_sync(0xffffffffu, bsum0, 1);
    bsum0 += __shfl_xor_sync(0xffffffffu, bsum0, 2);
    bsum1 += __shfl_xor_sync(0xffffffffu, bsum1, 1);
    bsum1 += __shfl_xor_sync(0xffffffffu, bsum1, 2);
    if (warp == 0 && t == 0) {
      if (row0) bias[L * kHid + gid] += bsum0;
      if (row1) bias[L * kHid + gid + 8] += bsum1;
    }
  }

  // host-callable in name only: instance_backward is host-compilable
  __host__ __device__ __forceinline__ void layer(int l, int, int, const float* a, const float* ta,
                                                 const float* hbar, const float* thbar) {
#if defined(__CUDA_ARCH__)
    switch (l) {  // the same layer in every thread
      case 0: products<0>(a, ta, hbar, thbar); break;
      case 1: products<1>(a, ta, hbar, thbar); break;
      case 2: products<2>(a, ta, hbar, thbar); break;
      case 3: products<3>(a, ta, hbar, thbar); break;
      default: products<4>(a, ta, hbar, thbar); break;
    }
#endif
  }

  // tile j of layer L (c: this lane's fragment) into the partial row
  __device__ void put(float* row, int L, int j, const float c[4]) const {
    const int in = layer_in(L), out = layer_out(L);
    const int gid = (tid & 31) >> 2, t = tid & 3;
    for (int q = 0; q < 4; ++q) {
      const int m = gid + (q >= 2 ? 8 : 0), n = j * 8 + 2 * t + (q & 1);
      if (m < out) row[layer_offset(L) + m * (in + 1) + n] = c[q];
    }
  }

  // this CTA's dW into its partial row; scratch: 1280 floats of shared
  // memory that nothing else uses now. Every thread calls it.
  __device__ void store(float* row, float* scratch) const {
    const int lane = tid & 31, warp = tid >> 5, pair = warp & 1;
    auto at = [&](int s, int q) { return scratch + ((pair * 5 + s - 1) * 4 + q) * 32 + lane; };
    if (warp >= 2) {  // the second halves of K
      for (int s = 1; s < kSlots; ++s)
        for (int q = 0; q < 4; ++q) *at(s, q) = acc[s][q];
    }
    __syncthreads();
    put(row, 0, warp, acc[0]);
    if (warp < 2) {
      for (int s = 1; s < kSlots; ++s) {
        float c[4];
        for (int q = 0; q < 4; ++q) c[q] = acc[s][q] + *at(s, q);
        if (s == 1)
          put(row, 0, 4 + pair, c);
        else
          put(row, s - 1, pair, c);
      }
    }
    for (int e = tid; e < kBias; e += kChunk) {
      const int L = e / kHid, o = e % kHid;
      row[layer_offset(L) + o * (layer_in(L) + 1) + layer_in(L)] = bias[e];
    }
  }
};

// Stage 1: d_bar and td_bar of every instance at every point, [F, N, P].
// BF16: the default precision (the weights rounded as they are staged).
template <bool RDF, bool BF16>
__global__ void __launch_bounds__(kUnionThreads)
union_cotangent_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ dg,
                       const float* __restrict__ du, const float* __restrict__ dw,
                       const float* __restrict__ loc, const float* __restrict__ rot,
                       const float* __restrict__ half, const float* __restrict__ valid,
                       const float* __restrict__ weights, const float* __restrict__ tau_ptr,
                       float inv_scale, const int* __restrict__ mask, int mask_tile,
                       float* __restrict__ dbar, float* __restrict__ tdbar) {
  extern __shared__ float wts[];
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
  const int tid = threadIdx.x;
  const int p = blockIdx.x * blockDim.x + tid;
  const bool live = p < P;
  const int pp = live ? p : P - 1;
  // skip mode: the groups this point's tile keeps (the same in a warp)
  const unsigned point_keep = kept_groups(mask, N, P, mask_tile, pp, pp);
  const float tau = *tau_ptr;
  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;
  for (int i = tid; i < N; i += blockDim.x) active[i] = instance_active(valid[i], any_valid);
  __syncthreads();
  const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
  const float v[3] = {dg[3 * pp], dg[3 * pp + 1], dg[3 * pp + 2]};

  for (int g0 = 0; g0 < N; g0 += kGroup) {
    const int gn = min(kGroup, N - g0);
    const bool keep = group_kept(point_keep, g0);
    if constexpr (RDF) {
      // the group's weights, unless every point of the block drops it
      if (__syncthreads_or(keep)) {
        for (int e = tid; e < gn * kWeights; e += blockDim.x)
          wts[e] = operand<BF16>(weights[(size_t)g0 * kWeights + e]);
        __syncthreads();
      }
    }
    for (int i = g0; i < g0 + gn; ++i) {
      if (!active[i]) continue;
      if (!keep) {  // the skip mode's pass 1: a dropped group reads kSkipDistance
        if (live) {
          dbar[(size_t)i * P + p] = kSkipDistance;
          tdbar[(size_t)i * P + p] = 0.f;
        }
        continue;
      }
      const float* Ri = rot + 9 * i;
      float tl[1][3];
      for (int c = 0; c < 3; ++c) tl[0][c] = v[0] * Ri[c] + v[1] * Ri[3 + c] + v[2] * Ri[6 + c];
      float td[1];
      const float d = instance_forward<1, BF16>(x, loc + 3 * i, Ri, half + 3 * i,
                                                RDF ? wts + (i - g0) * kWeights : nullptr,
                                                inv_scale, tl, td);
      if (live) {
        dbar[(size_t)i * P + p] = d;
        tdbar[(size_t)i * P + p] = td[0];
      }
    }
  }
  if (!live) return;
  union_backward(N, active, dbar + p, tdbar + p, valid, tau, du[p], dw + (size_t)p * N, P);
}

// Stage 2: one instance of one frame per CTA, grid (tiles, N, F). BF16: the
// default precision (the weights rounded once staged).
template <bool RDF, bool BF16>
__global__ void __launch_bounds__(kChunk, 2)
instance_backward_kernel(int P, int N, const float* __restrict__ pos,
                         const float* __restrict__ dg, const float* __restrict__ loc,
                         const float* __restrict__ rot, const float* __restrict__ half,
                         const float* __restrict__ valid, const float* __restrict__ weights,
                         float inv_scale, const int* __restrict__ mask, int mask_tile,
                         const float* __restrict__ dbar, const float* __restrict__ tdbar,
                         float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  constexpr int row = RDF ? kParams : kGeo;
  const int tile = blockIdx.x, i = blockIdx.y;
  const size_t f = blockIdx.z;
  const size_t fi = f * N + i;
  const int tid = threadIdx.x;
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

  float* wts = smem;                                // RDF: [Padded::kSize]
  float* box = smem + (RDF ? Padded::kSize : 0);    // loc 3 | rot 9 | half 3 | pad
  float* bias = box + kGeo + 1;                     // RDF: [kBias + 15]
  float* region = bias + (RDF ? kBias + 15 : 0);    // residuals and mma staging
  if constexpr (RDF) {
    for (int e = tid; e < kBias; e += kChunk) bias[e] = 0.f;
    const float* src = weights + fi * kWeights;
    for (int e = tid; e < kWeights; e += kChunk) cp_async4(wts + padded_index(e), src + e);
  }
  if (tid < 3) {
    cp_async4(box + tid, loc + fi * 3 + tid);
    cp_async4(box + 12 + tid, half + fi * 3 + tid);
  }
  if (tid < 9) cp_async4(box + 3 + tid, rot + fi * 9 + tid);
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if constexpr (RDF && BF16) {
    for (int e = tid; e < kWeights; e += kChunk)
      wts[padded_index(e)] = bf16_round(wts[padded_index(e)]);
    __syncthreads();
  }

  float geo[kGeo];
  for (int k = 0; k < kGeo; ++k) geo[k] = 0.f;
  MmaSink<BF16> sink(region, bias, tid);
  for (int c = 0; c < kChunksPerCta; ++c) {
    const int chunk = tile * kChunksPerCta + c;
    if (chunk >= num_chunks) break;     // uniform over the CTA
    if (!chunk_kept(chunk)) continue;   // uniform over the CTA
    const int p = chunk * kChunk + tid;
    const bool live = p < P;
    const int pp = live ? p : P - 1;
    const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
    const float v[3] = {dg[3 * pp], dg[3 * pp + 1], dg[3 * pp + 2]};
    // a point past the end carries zero cotangents, so it adds exact zeros
    const float db = live ? dbar[p] : 0.f, tdb = live ? tdbar[p] : 0.f;
    instance_backward<BF16>(x, v, box, box + 3, box + 12, RDF ? wts : nullptr, inv_scale, db, tdb,
                            geo, sink, ColumnStore{region + tid, kChunk});
    if constexpr (RDF) __syncthreads();  // the next residuals overwrite layer 0's staging
  }

  __syncthreads();
  for (int k = 0; k < kGeo; ++k) region[k * kChunk + tid] = geo[k];
  if constexpr (RDF) sink.store(out_row, region + kGeo * kChunk);  // syncs the block
  __syncthreads();
  if (tid < kGeo) {
    float s = 0.f;
    for (int q = 0; q < kChunk; ++q) s += region[tid * kChunk + q];
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

inline size_t union_smem(int N, bool rdf) {
  return rdf ? (size_t)(N < kGroup ? N : kGroup) * kWeights * sizeof(float) : 0;
}

inline size_t instance_smem(bool rdf) {
  return (size_t)((rdf ? Padded::kSize + kBias + 15 + kRegion : 0) + kGeo + 1 +
                  (rdf ? 0 : kGeo * kChunk)) *
         sizeof(float);
}

template <bool RDF, bool BF16>
cudaError_t launch_backward(int F, int P, int N, const float* pos, const float* dg,
                            const float* du, const float* dw, const float* loc, const float* rot,
                            const float* half, const float* valid, const float* weights,
                            const float* tau, float inv_scale, const int* mask, int mask_tile,
                            int tiles, float* dbar, float* tdbar, float* partial, float* out,
                            cudaStream_t s) {
  const size_t smem1 = union_smem(N, RDF), smem2 = instance_smem(RDF);
  // both stages take the largest shared-memory carveout, so that the SMs
  // need no reconfiguration between them
  cudaError_t err = cudaFuncSetAttribute(union_cotangent_kernel<RDF, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(instance_backward_kernel<RDF, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(union_cotangent_kernel<RDF, BF16>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(instance_backward_kernel<RDF, BF16>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid1((P + kUnionThreads - 1) / kUnionThreads, F);
  union_cotangent_kernel<RDF, BF16><<<grid1, kUnionThreads, smem1, s>>>(
      P, N, pos, dg, du, dw, loc, rot, half, valid, weights, tau, inv_scale, mask, mask_tile,
      dbar, tdbar);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  instance_backward_kernel<RDF, BF16><<<dim3(tiles, N, F), kChunk, smem2, s>>>(
      P, N, pos, dg, loc, rot, half, valid, weights, inv_scale, mask, mask_tile, dbar, tdbar,
      partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int row = RDF ? kParams : kGeo;
  reduce_partials_kernel<<<dim3((row + 255) / 256, N, F), 256, 0, s>>>(tiles, row, partial, out);
  return cudaGetLastError();
}

}  // namespace vsrd

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
