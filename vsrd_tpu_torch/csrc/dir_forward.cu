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
// tensor cores in 3xTF32 they set the bound (chip_smoke.py::kernel_bound).
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
//     points (8 n-tiles of mma.sync.m16n8k8, 3xTF32), so each A fragment
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
// Shared memory (DirLayout): 62,112 + 64 N + 3,072 (N + 1) bytes at T = 256
// with the residual field, 3,072 + 64 N + 1,536 (N + 1) box-only at T = 128
// (vsrd_dir_forward_info reports it with the CTAs per SM).
#include <cuda_runtime.h>

#include "field_common.cuh"
#include "warp_product.cuh"

namespace vsrd {

constexpr int kDirThreadsRdf = 256;  // a CTA's threads with the residual field, while they fit
constexpr int kDirRowStride = 72;    // staging row: 32 + 32 points + 8
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

// The layer products of instance_dir (field_common.cuh) on the tensor cores:
// a warp's C [16 x 64] = A [16 x K] B [K x 64] over its own 32 points' value
// columns (n-tiles 0-3) and tangent columns (n-tiles 4-7), A from the
// instance's fragment blocks, B from the warp's staging rows (row k at act +
// k * kDirRowStride). Every lane calls every method, so the warp stays
// converged around each mma.
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
    warp_product<2, 8, kDirRowStride>(frag, l == 0 ? fwd_block(0, 2 * m) : fwd_block(l, 0), act,
                                      lane, c);
  }
  __device__ __forceinline__ void store() { store_acc<8, kDirRowStride>(act, c, lane); }
};

// Grid (ceil(P / T), F), T threads a CTA; see the note at the top of the file.
template <bool RDF, int T>
__global__ void __launch_bounds__(T, RDF ? 512 / T : 1)
tangent_forward_kernel(int P, int N, const float* __restrict__ pos,
                       const float* __restrict__ dirs, const float* __restrict__ loc,
                       const float* __restrict__ rot, const float* __restrict__ half,
                       const float* __restrict__ valid, const float* __restrict__ weights,
                       const float* __restrict__ tau_ptr, float scale,
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * T, count = min(T, P - p0);
  const float tau = *tau_ptr;

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
    const Scaler inv(scale);
    auto next_active = [&](int i) {
      for (++i; i < N && !instance_active(svalid[i], any_valid); ++i) {
      }
      return i;
    };
    auto prefetch = [&](int i) {
      const float* src = weights + (size_t)i * kWeights;
      for (int e = tid; e < kWeights; e += T) cp_async4(raw + e, src + e);
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    const int first = next_active(-1);
    if (first < N) prefetch(first);
    for (int i = first; i < N;) {
      const int next = next_active(i);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // raw holds instance i; every warp is done with the last one's fragments
      for (int b = warp; b < kFwdBlocks; b += L::kWarps) convert_block(raw, frag, b, lane);
      for (int e = tid; e < kRevMisc; e += T) misc[e] = raw[misc_index(e)];
      __syncthreads();  // fragments ready, raw free
      if (next < N) prefetch(next);
      WarpDirProduct prod(frag, stage, lane);
      float td;
      const float d =
          instance_dir(x, v, sloc + 3 * i, srot + 9 * i, shalf + 3 * i, misc, inv, prod, td);
      lt[i] = union_logit(d, svalid[i], tau);
      dt[i] = d;
      tdt[i] = td;
      i = next;
    }
  } else {
    // unrolled, so that independent instances' chains interleave
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      if (!instance_active(svalid[i], any_valid)) continue;
      float tl[3], td;
      const float d =
          box_dir(BoxGrad(x, sloc + 3 * i, srot + 9 * i, shalf + 3 * i), v, srot + 9 * i, tl, td);
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

template <bool RDF, int T>
cudaError_t dir_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(tangent_forward_kernel<RDF, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tangent_forward_kernel<RDF, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The CTA size of a launch: with the residual field kDirThreadsRdf threads
// when their shared memory fits (N <= 53 at 256), else 128; box-only 128.
inline int dir_threads(bool rdf, int N) {
  return rdf && DirLayout<kDirThreadsRdf>::bytes(true, N) <= kMaxSmem ? kDirThreadsRdf : 128;
}

template <bool RDF, int T>
cudaError_t launch_dir_forward(int F, int P, int N, const float* pos, const float* dirs,
                               const float* loc, const float* rot, const float* half,
                               const float* valid, const float* weights, const float* tau,
                               float scale, float* u, float* w, float* u_dot,
                               cudaStream_t stream) {
  const size_t smem = DirLayout<T>::bytes(RDF, N);
  const cudaError_t err = dir_attributes<RDF, T>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + T - 1) / T, F);
  tangent_forward_kernel<RDF, T><<<grid, T, smem, stream>>>(
      P, N, pos, dirs, loc, rot, half, valid, weights, tau, scale, u, w, u_dot);
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
          ctas_per_sm, tangent_forward_kernel<true, TR>, TR, *smem_bytes);
  } else {
    *smem_bytes = (int)DirLayout<128>::bytes(rdf, N);
    err = rdf ? dir_attributes<true, 128>(*smem_bytes) : dir_attributes<false, 128>(*smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, rdf ? tangent_forward_kernel<true, 128> : tangent_forward_kernel<false, 128>,
          128, *smem_bytes);
  }
  return (int)err;
}

extern "C" int vsrd_dir_forward(int F, int P, int N, int rdf, const float* pos,
                                const float* dirs, const float* loc, const float* rot,
                                const float* half, const float* valid, const float* weights,
                                const float* tau, float scale, float* u, float* w, float* u_dot,
                                void* stream) {
  using namespace vsrd;
  auto s = static_cast<cudaStream_t>(stream);
  if (!rdf)
    return launch_dir_forward<false, 128>(F, P, N, pos, dirs, loc, rot, half, valid, nullptr,
                                          tau, scale, u, w, u_dot, s);
  return dir_threads(true, N) == kDirThreadsRdf
             ? launch_dir_forward<true, kDirThreadsRdf>(F, P, N, pos, dirs, loc, rot, half, valid,
                                                        weights, tau, scale, u, w, u_dot, s)
             : launch_dir_forward<true, 128>(F, P, N, pos, dirs, loc, rot, half, valid, weights,
                                             tau, scale, u, w, u_dot, s);
}
