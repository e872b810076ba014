// K3 / K4b: the coarse-pass forward of the scene field with the derivative
// of the union along each point's ray direction, for one frame (K3) or F
// stacked frames in one launch (K4b).
//
// Replaces the TPU kernels vsrd_tpu/rendering/pallas_field.py::
// _dir_fwd_kernel as launched by fused_field_dir_forward (K3) and by
// _fused_dir_forward_batched (K4b, grid (F, tiles)); the body is
// fused_field.scene_eval_stacked_dir_t (K = 1 tangent). Outputs u [F, P],
// w [F, P, N] and u_dot [F, P] = <dir, grad_x u>, each frame from its own
// boxes, validity and weights; forward only, the coarse pass is
// gradient-stopped.
//
// What bounds it on an H100. Box-only (the main path's coarse pass, every
// step) ~90 FLOP per point and active instance against 24 bytes read and
// 8 + 4N written per point: bound by its bytes (64 per point at N = 8).
// With the residual field, 3,104 multiply-adds of layer products per point
// and active instance (1,552 for the value, 1,552 for its tangent) and ~1,800
// FLOP of per-point work (box SDF and its tangent, 24 sincos, 4 LayerNorms
// with their tangents and exact GELU, the union); with the products on the
// tensor cores in 3xTF32 they set the bound (chip_smoke.py::kernel_bound),
// in bf16 the per-point work does.
//
// The design (grid (point tiles of T, F), one point per thread, one warp
// owns 32 consecutive points):
//   * per-CTA state in shared memory, read once and coalesced: the frame's
//     boxes (loc 3, rot 9, half 3) and validity, and the tile's positions
//     and directions (each one contiguous block of 12 T bytes); any_valid
//     once per CTA (__syncthreads_or);
//   * instances in turn, the skip of inactive ones uniform over the CTA,
//     so there is no divergence; each instance's d, td and logit go to a
//     [T][N + 1] tile, and the union (dir_union) takes the max first, then
//     one pass of sums: no running rescale;
//   * w: the tile's weights, one contiguous block of w, written once,
//     coalesced;
//   * with the residual field, instance_dir (field_common.cuh) with its
//     layer products on the tensor cores (warp_product.cuh): the value and
//     its tangent along the ray are two column blocks of ONE product per
//     layer, C [16 x 64] = W_l [A_value | A_tangent] over the warp's 32
//     points (8 n-tiles of mma.sync.m16n8k8, 3xTF32, or one bf16 mma each
//     in the default precision, the tangent columns rounded as the values
//     are, as the JAX body stacks them), so each A fragment
//     is loaded once per k-step for both. Layer 4 (one output) stays on the
//     CUDA cores. Each instance's 1,617 weights are copied with cp.async
//     while the previous instance computes, then split once into the 12
//     forward A-fragment blocks. Between the products the per-point work
//     (encoding, LayerNorm with its tangent, GELU with Phi and phi once for
//     both blocks) goes through one per-warp staging block of 16 rows of 64
//     columns (32 value + 32 tangent; rows padded to 72 floats, so that the
//     B fragments load without bank conflicts). Layer 0's tangent rows come
//     from the same sincospif values as its value rows, and its phases
//     divide by the position scale as the twin does (Scaler, a product and
//     an fma: a rounded 1 / scale alone doubled u_dot's error against the
//     float64 twin in a frame with no valid instance). Forward mode keeps
//     no residuals, so shared memory stays small and several CTAs share an
//     SM;
//   * occupancy: with the residual field at most 128 registers a thread
//     (launch bounds), so 16 warps share an SM, and a CTA has 256 threads
//     (N <= 53, else 128): it amortises each instance's weight split and its two barriers
//     over more points, and two CTAs per SM overlap one's barriers with the
//     other's work. On an H100 at N = 8, 128 threads were slower and 384
//     or 512 no faster (PERF.md); box-only 128;
//   * sums in a fixed order and no atomics: bit-for-bit repeatable, and a
//     frame's CTAs read only that frame's inputs, so F = 1 through the
//     batched entry point is the single-frame launch.
// Per-tile instance-group skipping (the TPU kernel's group_skip mode,
// _dir_fwd_kernel with a mask_ref, pallas_field.py:138-145), as in
// fused_forward.cu: an instance whose group every tile of the CTA drops
// runs no MLP and its weights are not fetched; a point whose tile drops
// the group reads kSkipDistance with a zero tangent (box-only, the point
// skips the box too). The N = 1 path of the w write is unchanged.
// Shared memory (DirLayout): 62,112 + 64 N + 3,072 (N + 1) bytes at T = 256
// with the residual field, 3,072 + 64 N + 1,536 (N + 1) box-only at T = 128
// (vsrd_dir_forward_info reports it with the CTAs per SM).
#include <cuda_runtime.h>

#include "field_common.cuh"
#include "warp_product.cuh"

namespace vsrd {

constexpr int kDirThreadsRdf = 256;  // a CTA's threads with the residual field, while they fit
constexpr int kDirStage = kHid * kDirRowStride;
constexpr int kDirFragWords = kFwdBlocks * 256;

// Shared memory of a CTA of T threads (floats): with the residual field the
// fragments, the warps' staging blocks, the raw weights and the misc block;
// then the frame's boxes [16 N] (loc, rot, half, valid), the tile's
// positions and directions [6 T], and the logit, distance and tangent tiles
// [T][N + 1] each.
template <int T>
struct DirLayout {
  static constexpr int kWarps = T / 32;
  static constexpr int kRaw = kDirFragWords + kWarps * kDirStage;
  static constexpr int kFixed = kRaw + kRawSize + kMisc;
  static size_t bytes(bool rdf, int n) {
    return ((rdf ? kFixed : 0) + 16 * (size_t)n + 6 * T + 3 * (size_t)T * (n + 1)) *
           sizeof(float);
  }
};

// Grid (ceil(P / T), F), T threads a CTA; see the note at the top of the file.
// BF16 (with the residual field): the default precision, with the JAX
// body's rounded 1 / scale in the encoding.
template <bool RDF, bool BF16, int T>
__global__ void __launch_bounds__(T, RDF ? 512 / T : 1)
tangent_forward_kernel(int P, int N, const float* __restrict__ pos,
                       const float* __restrict__ dirs, const float* __restrict__ loc,
                       const float* __restrict__ rot, const float* __restrict__ half,
                       const float* __restrict__ valid, const float* __restrict__ weights,
                       const float* __restrict__ tau_ptr, float scale,
                       const int* __restrict__ mask, int mask_tile,
                       float* __restrict__ u, float* __restrict__ w,
                       float* __restrict__ u_dot) {
  using L = DirLayout<T>;
  extern __shared__ __align__(16) float smem[];
  const size_t f = blockIdx.y;
  pos += f * P * 3;
  dirs += f * P * 3;
  loc += f * N * 3;
  rot += f * N * 9;
  half += f * N * 3;
  valid += f * N;
  if constexpr (RDF) weights += f * N * kWeights;
  u += f * P;
  w += f * P * N;
  u_dot += f * P;
  if (mask != nullptr) mask += f * ((N + kGroup - 1) / kGroup) * ((P + mask_tile - 1) / mask_tile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * T, count = min(T, P - p0);
  const float tau = *tau_ptr;
  // skip mode: the groups this CTA evaluates and those this point's tile keeps
  const unsigned cta_keep = kept_groups(mask, N, P, mask_tile, p0, p0 + count - 1);
  const int pq = p0 + min(tid, count - 1);
  const unsigned point_keep = kept_groups(mask, N, P, mask_tile, pq, pq);

  unsigned* frag = reinterpret_cast<unsigned*>(smem);
  float* stage = smem + kDirFragWords + warp * kDirStage;
  float* raw = smem + L::kRaw;
  float* misc = raw + kRawSize;
  float* sloc = smem + (RDF ? L::kFixed : 0);
  float* srot = sloc + 3 * N;
  float* shalf = srot + 9 * N;
  float* svalid = shalf + 3 * N;
  float* sx = svalid + N;
  float* sv = sx + 3 * T;
  const int lrow = N + 1;
  float* lt = sv + 3 * T + tid * lrow;  // this point's row of each tile
  float* dt = lt + T * lrow;
  float* tdt = dt + T * lrow;

  for (int e = tid; e < 3 * N; e += T) {
    sloc[e] = loc[e];
    shalf[e] = half[e];
  }
  for (int e = tid; e < 9 * N; e += T) srot[e] = rot[e];
  if (tid < N) svalid[tid] = valid[tid];
  for (int e = tid; e < 3 * count; e += T) {
    sx[e] = pos[(size_t)p0 * 3 + e];
    sv[e] = dirs[(size_t)p0 * 3 + e];
  }
  const bool any_valid = __syncthreads_or(tid < N && valid[tid] > 0.5f);
  // a thread past the ragged edge runs the tile's last point, unwritten
  const int q = 3 * min(tid, count - 1);
  const float x[3] = {sx[q], sx[q + 1], sx[q + 2]}, v[3] = {sv[q], sv[q + 1], sv[q + 2]};

  if constexpr (RDF) {
    const Scaler exact(scale);
    const float rounded = 1.f / scale;
    // the instances whose field this CTA evaluates: active, in a kept group
    auto computed = [&](int i) {
      return instance_active(svalid[i], any_valid) && group_kept(cta_keep, i);
    };
    auto next_computed = [&](int i) {
      for (++i; i < N && !computed(i); ++i) {
      }
      return i;
    };
    auto prefetch = [&](int i) {
      const float* src = weights + (size_t)i * kWeights;
      for (int e = tid; e < kWeights; e += T) cp_async4(raw + e, src + e);
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    const int first = next_computed(-1);
    if (first < N) prefetch(first);
    for (int i = 0; i < N; ++i) {
      if (!instance_active(svalid[i], any_valid)) continue;  // uniform over the CTA
      float d = kSkipDistance, td = 0.f;
      if (group_kept(cta_keep, i)) {  // uniform over the CTA
        const int next = next_computed(i);
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();  // raw holds instance i; every warp is done with the last one's fragments
        for (int b = warp; b < kFwdBlocks; b += L::kWarps) convert_block<BF16>(raw, frag, b, lane);
        for (int e = tid; e < kRevMisc; e += T) misc[e] = operand<BF16>(raw[misc_index(e)]);
        __syncthreads();  // fragments ready, raw free
        if (next < N) prefetch(next);
        WarpDirProduct<BF16> prod(frag, stage, lane);
        if constexpr (BF16)
          d = instance_dir<true>(x, v, sloc + 3 * i, srot + 9 * i, shalf + 3 * i, misc, rounded,
                                 prod, td);
        else
          d = instance_dir<false>(x, v, sloc + 3 * i, srot + 9 * i, shalf + 3 * i, misc, exact,
                                  prod, td);
      }
      if (!group_kept(point_keep, i)) {  // this point's tile drops the group
        d = kSkipDistance;
        td = 0.f;
      }
      lt[i] = union_logit(d, svalid[i], tau);
      dt[i] = d;
      tdt[i] = td;
    }
  } else {
    // unrolled, so that independent instances' chains interleave
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      if (!instance_active(svalid[i], any_valid)) continue;
      float d = kSkipDistance, td = 0.f;
      if (group_kept(point_keep, i)) {
        float tl[3];
        d = box_dir(BoxGrad(x, sloc + 3 * i, srot + 9 * i, shalf + 3 * i), v, srot + 9 * i, tl,
                    td);
      }
      lt[i] = union_logit(d, svalid[i], tau);
      dt[i] = d;
      tdt[i] = td;
    }
  }

  float ud;
  const float uu = dir_union(N, svalid, any_valid, lt, dt, tdt, tau, ud);
  if (tid < count) {
    u[p0 + tid] = uu;
    u_dot[p0 + tid] = ud;
  }
  __syncthreads();
  // the tile's rows of w are one contiguous block
  const float* wtile = sv + 3 * T;
  float* wt = w + (size_t)p0 * N;
  // e / N as a multiply-high by ceil(2^32 / N), exact while e N < 2^32 (here
  // e N < T N^2 <= 2^20); for N = 1 that factor, 2^32, does not fit, and r = e
  const unsigned magic = 0xffffffffu / N + 1;
  for (int e = tid; e < count * N; e += T) {
    const int r = N == 1 ? e : __umulhi((unsigned)e, magic);
    wt[e] = wtile[r * lrow + e - r * N];
  }
}

template <bool RDF, int T, bool BF16 = false>
cudaError_t dir_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(tangent_forward_kernel<RDF, BF16, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tangent_forward_kernel<RDF, BF16, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The CTA size of a launch: with the residual field kDirThreadsRdf threads
// when their shared memory fits (N <= 53 at 256), else 128; box-only 128.
inline int dir_threads(bool rdf, int N) {
  return rdf && DirLayout<kDirThreadsRdf>::bytes(true, N) <= kMaxSmem ? kDirThreadsRdf : 128;
}

template <bool RDF, int T, bool BF16 = false>
cudaError_t launch_dir_forward(int F, int P, int N, const float* pos, const float* dirs,
                               const float* loc, const float* rot, const float* half,
                               const float* valid, const float* weights, const float* tau,
                               float scale, const int* mask, int mask_tile, float* u, float* w,
                               float* u_dot, cudaStream_t stream) {
  const size_t smem = DirLayout<T>::bytes(RDF, N);
  const cudaError_t err = dir_attributes<RDF, T, BF16>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + T - 1) / T, F);
  tangent_forward_kernel<RDF, BF16, T><<<grid, T, smem, stream>>>(
      P, N, pos, dirs, loc, rot, half, valid, weights, tau, scale, mask, mask_tile, u, w, u_dot);
  return cudaGetLastError();
}

}  // namespace vsrd

// The kernel's CTA size, dynamic shared memory (bytes) and CTAs per SM, for
// N instances, with the residual field (rdf) or box-only.
extern "C" int vsrd_dir_forward_info(int N, int rdf, int* threads, int* smem_bytes,
                                     int* ctas_per_sm) {
  using namespace vsrd;
  constexpr int TR = kDirThreadsRdf;
  *threads = dir_threads(rdf, N);
  cudaError_t err;
  if (*threads == TR) {
    *smem_bytes = (int)DirLayout<TR>::bytes(true, N);
    err = dir_attributes<true, TR>(*smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, tangent_forward_kernel<true, false, TR>, TR, *smem_bytes);
  } else {
    *smem_bytes = (int)DirLayout<128>::bytes(rdf, N);
    err = rdf ? dir_attributes<true, 128>(*smem_bytes) : dir_attributes<false, 128>(*smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm,
          rdf ? tangent_forward_kernel<true, false, 128>
              : tangent_forward_kernel<false, false, 128>,
          128, *smem_bytes);
  }
  return (int)err;
}

// mask: nullptr, or the skip mode's keep mask [F][ceil(N / 8)][ceil(P / mask_tile)];
// bf16: the default precision (box-only launches have no products, so it
// does not change them)
extern "C" int vsrd_dir_forward(int F, int P, int N, int rdf, int bf16, const float* pos,
                                const float* dirs, const float* loc, const float* rot,
                                const float* half, const float* valid, const float* weights,
                                const float* tau, float scale, const int* mask, int mask_tile,
                                float* u, float* w, float* u_dot, void* stream) {
  using namespace vsrd;
  if (mask != nullptr && mask_tile < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (!rdf)
    return launch_dir_forward<false, 128>(F, P, N, pos, dirs, loc, rot, half, valid, nullptr,
                                          tau, scale, mask, mask_tile, u, w, u_dot, s);
  const bool wide = dir_threads(true, N) == kDirThreadsRdf;
  if (bf16)
    return wide ? launch_dir_forward<true, kDirThreadsRdf, true>(
                      F, P, N, pos, dirs, loc, rot, half, valid, weights, tau, scale, mask,
                      mask_tile, u, w, u_dot, s)
                : launch_dir_forward<true, 128, true>(F, P, N, pos, dirs, loc, rot, half, valid,
                                                      weights, tau, scale, mask, mask_tile, u, w,
                                                      u_dot, s);
  return wide
             ? launch_dir_forward<true, kDirThreadsRdf>(F, P, N, pos, dirs, loc, rot, half, valid,
                                                        weights, tau, scale, mask, mask_tile, u,
                                                        w, u_dot, s)
             : launch_dir_forward<true, 128>(F, P, N, pos, dirs, loc, rot, half, valid, weights,
                                             tau, scale, mask, mask_tile, u, w, u_dot, s);
}
