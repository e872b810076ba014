// K1 / K4a: the fine-pass forward of the scene field with its spatial
// gradient, for one frame (K1) or F stacked frames in one launch (K4a).
//
// Replaces the TPU kernels vsrd_tpu/rendering/pallas_field.py::_fwd_kernel
// as launched by _fused_forward (K1, grid (tiles,)) and by
// _fused_forward_batched (K4a, grid (F, tiles)). Outputs u [F, P], w [F, P,
// N] and grad_x u [F, P, 3] = sum_i w_i (1 + (u - d_i) / tau) grad_x d_i,
// each frame from its own boxes, validity and weights (F = 1 for K1).
//
// The form is the JAX kernel's with rev_grad (pallas_rev_grad; body
// fused_field._scene_eval_stacked_rev): grad_x d_i comes from the value
// forward and ONE reverse sweep seeded with 1, with respect to the position
// only (field_common.cuh: instance_rev, the sweep the host tests drive with
// scalar products). The JAX body gathers every distance first and seeds the
// reverse with the union's weights; here each instance's sweep is seeded
// with 1 and the union weighs the gradients online, which gives the same
// sum. The JAX package's other form, three forward tangents, exists for its
// strict mode, since the MXU's default precision is not f32; the 3xTF32
// products here hold f32 accuracy, so it has no counterpart.
//
// What bounds it on an H100. Per point and active instance the residual
// field needs 3,104 multiply-adds of layer products (1,552 for the value,
// 1,552 for the reverse) and ~1,900 FLOP of per-point work (box SDF and its
// gradient, 24 sincos, 4 LayerNorms with exact GELU and their first-order
// reverses, the union), against 12 bytes read and 16 + 4N written per
// point. With the products on the tensor cores in 3xTF32 (2 FLOP a
// multiply-add at 495 / 3 TFLOP/s) and the rest at 67 TFLOP/s f32, the
// products set the bound (0.038 against 0.028 ns per point-instance;
// chip_smoke.py::kernel_bound); bytes are far below either. Box-only it is
// bound by its bytes.
//
// The design (grid (point tiles of T, F) with T = 384 threads a CTA while
// their shared memory fits, N <= 10, else 128; one point per thread, one
// warp owns 32 consecutive points):
//   * instances in turn, the skip of inactive ones uniform over the CTA
//     (validity is per frame), so there is no divergence;
//   * weights: each instance's 1,617 are copied with cp.async into a raw
//     buffer while the previous instance computes, then split once per
//     instance into TF32 big and small parts in the m16n8k8 A-fragment
//     order (layers 0-3 as W for the forward, W^T for the reverse: 24
//     blocks of 256 words), so a warp loads a fragment with two 16-byte
//     loads and no conversion;
//   * layer products on the tensor cores: mma.sync.m16n8k8 TF32 in 3xTF32
//     (mma_tf32.cuh), C [16 x 32] = A [16 x K] B [K x 32] per warp over its
//     own points (4 n-tiles): the value forward W_l a for layers 0-3 and the
//     reverse W_l^T hbar for layers 3..0 (layer 0's W^T in three m-tiles,
//     one per coordinate). Layer 4 (one output) stays on the CUDA cores.
//     Every warp runs the same mma sequence; a warp's mma operands are its
//     own points' columns, so a warp synchronises only itself (__syncwarp).
//     B is split by integer arithmetic (split_tf32_finite), half the
//     instructions of cvt.rna;
//   * per-point work on the CUDA cores between the products, through one
//     per-warp staging block of 16 rows of 32 points in shared memory (rows
//     padded to 40 floats, so that the B fragments load without bank
//     conflicts): each thread writes and reads its own column. Layer 0's 48
//     encoding channels go through it one coordinate (16 channels, two
//     k-steps) at a time, and its reverse comes back the same way, with B
//     (hbar) held in registers so that each coordinate's cotangents can go
//     over the rows;
//   * the forward's residuals of layers 1-3 (y, istd and Phi(y), 99 floats
//     per point) stay in a per-thread column of shared memory (RevStore);
//     layer 4's stay in registers, since its reverse follows at once.
//     Keeping Phi(y) spares the reverse an erff per element, the costliest
//     per-point step;
//   * the encoding by sincospif (the phase pi 2^k sym with sym 2^k exact),
//     every other k by angle doubling, and the reverse's again from the
//     k = 0 and 4 values (enc_dim; the JAX package's fast encoding does the
//     same);
//   * occupancy: the per-point work runs one dependent chain per thread, so
//     it needs many warps. At N = 8 a 384-thread CTA takes 228,000 bytes of
//     shared memory and at most 170 registers a thread, so 12 warps share
//     an SM; one CTA of 12 warps holds one copy of the weights where three
//     of 4 warps would hold three. Earlier layouts on an H100 (PERF.md): 8
//     warps with every encoding row staged ran at a third of this speed,
//     3 CTAs of 128 threads recomputing Phi(y) at three quarters;
//   * w: the tile's logits stay in shared memory [points x (N + 1)], are
//     normalised once the union's max is known, and the tile, one
//     contiguous block of w, is written once, coalesced;
//   * sums in a fixed order and no atomics: bit-for-bit repeatable, and a
//     frame's CTAs read only that frame's inputs, so F = 1 through the
//     batched entry point is the single-frame launch.
// Shared memory (RevLayout): 214,176 + 1,536 (N + 1) bytes at T = 384 with
// the residual field, 92,320 + 512 (N + 1) at T = 128, 512 (N + 1)
// box-only (vsrd_rev_forward_info reports it with the CTAs per SM).
#include <cuda_runtime.h>

#include "field_common.cuh"
#include "warp_product.cuh"

namespace vsrd {

constexpr int kRowStride = 40;                 // staging row: 32 points + 8
constexpr int kWarpStage = kHid * kRowStride;
constexpr int kFragBlocks = 24;                // A fragments of one instance
constexpr int kFragWords = kFragBlocks * 256;  // per block: big [32][4], small [32][4]

// Shared memory of a CTA of T threads (floats): the fragments, the warps'
// staging blocks, the residual columns, the raw weights and the misc block,
// then the logits tile [T][N + 1].
template <int T>
struct RevLayout {
  static constexpr int kWarps = T / 32;
  static constexpr int kRes = kFragWords + kWarps * kWarpStage;
  static constexpr int kRaw = kRes + kRevResLayers * kRevRes * T;
  static constexpr int kFixed = kRaw + kRawSize + kMisc;
  static size_t bytes(bool rdf, int n) {
    return ((rdf ? kFixed : 0) + (size_t)T * (n + 1)) * sizeof(float);
  }
};

// The layer products of instance_rev (field_common.cuh) on the tensor
// cores: a warp's C [16 x 32] = A [16 x K] B [K x 32] over its own 32
// points (4 n-tiles of 8), A from the instance's fragment blocks, B from
// the warp's staging rows (row k at act + k * kRowStride). Every lane
// calls every method, so the warp stays converged around each mma.
struct WarpProduct {
  const unsigned* frag;
  float* act;
  int lane;
  float c[4][4];
  unsigned bb[2][4][2], bs[2][4][2];  // layer 0's B (hbar), split once

  __device__ __forceinline__ WarpProduct(const unsigned* f, float* a, int l)
      : frag(f), act(a), lane(l) {}
  __device__ __forceinline__ float& at(int row) { return act[row * kRowStride + lane]; }
  __device__ __forceinline__ void sync() { __syncwarp(); }
  __device__ __forceinline__ void begin(const float* bias) { init_acc<4>(c, bias, lane); }
  __device__ __forceinline__ void forward(int l, int m) {
    warp_product<2, 4, kRowStride>(frag, l == 0 ? fwd_block(0, 2 * m) : fwd_block(l, 0), act,
                                   lane, c);
  }
  __device__ __forceinline__ void reverse(int l) {
    warp_product<2, 4, kRowStride>(frag, rev_block(l, 0, 0), act, lane, c);
  }
  __device__ __forceinline__ void hold() {
    const int gid = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32_finite(act[(s * 8 + t + 4 * h) * kRowStride + nt * 8 + gid], bb[s][nt][h],
                            bs[s][nt][h]);
  }
  __device__ __forceinline__ void reverse0(int m) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = rev_block(0, s, m);
      const uint4 big = *reinterpret_cast<const uint4*>(frag + b * 256 + lane * 4);
      const uint4 small = *reinterpret_cast<const uint4*>(frag + b * 256 + 128 + lane * 4);
      const unsigned ab[4] = {big.x, big.y, big.z, big.w};
      const unsigned as[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma3_split(c[nt], ab, as, bb[s][nt], bs[s][nt]);
    }
  }
  __device__ __forceinline__ void store() { store_acc<4, kRowStride>(act, c, lane); }
};

// Grid (ceil(P / T), F), T threads a CTA; see the note at the top of the file.
template <bool RDF, int T>
__global__ void __launch_bounds__(T, 384 / T)
rev_forward_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ loc,
                   const float* __restrict__ rot, const float* __restrict__ half,
                   const float* __restrict__ valid, const float* __restrict__ weights,
                   const float* __restrict__ tau_ptr, float inv_scale, float* __restrict__ u,
                   float* __restrict__ w, float* __restrict__ grad) {
  using L = RevLayout<T>;
  extern __shared__ __align__(16) float smem[];
  const size_t f = blockIdx.y;
  pos += f * P * 3;
  loc += f * N * 3;
  rot += f * N * 9;
  half += f * N * 3;
  valid += f * N;
  if constexpr (RDF) weights += f * N * kWeights;
  u += f * P;
  w += f * P * N;
  grad += f * P * 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * T, p = p0 + tid;
  const bool live = p < P;
  const int pp = live ? p : P - 1;
  const float tau = *tau_ptr;
  const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};

  unsigned* frag = reinterpret_cast<unsigned*>(smem);
  float* stage = smem + kFragWords + warp * kWarpStage;
  const RevStore res{smem + L::kRes + tid, T};
  float* raw = smem + L::kRaw;
  float* misc = raw + kRawSize;
  float* logits = RDF ? smem + L::kFixed : smem;  // [T][N + 1]
  const int lrow = N + 1;

  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;
  auto next_active = [&](int i) {
    for (++i; i < N && !instance_active(valid[i], any_valid); ++i) {
    }
    return i;
  };
  auto prefetch = [&](int i) {
    const float* src = weights + (size_t)i * kWeights;
    for (int e = tid; e < kWeights; e += T) cp_async4(raw + e, src + e);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const int first = next_active(-1);
  if constexpr (RDF) {
    if (first < N) prefetch(first);
  }
  OnlineUnion<3> acc;
  for (int i = first; i < N;) {
    const int next = next_active(i);
    float g[3], d;
    if constexpr (RDF) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // raw holds instance i; every warp is done with the last one's fragments
#pragma unroll
      for (int j = 0; j < kFragBlocks / L::kWarps; ++j)
        convert_block(raw, frag, warp + L::kWarps * j, lane);
      for (int e = tid; e < kRevMisc; e += T) misc[e] = raw[misc_index(e)];
      __syncthreads();  // fragments ready, raw free
      if (next < N) prefetch(next);
      WarpProduct prod(frag, stage, lane);
      d = instance_rev(x, loc + 3 * i, rot + 9 * i, half + 3 * i, misc, inv_scale, prod, res, g);
    } else {
      const BoxGrad box(x, loc + 3 * i, rot + 9 * i, half + 3 * i);
      local_to_world(rot + 9 * i, box.gl, g);
      d = box.d;
    }
    const float l = union_logit(d, valid[i], tau);
    logits[tid * lrow + i] = l;
    acc.add(l, d, g);
    i = next;
  }

  if (live) {
    float du[3];
    u[p] = acc.finish(tau, du);
    for (int j = 0; j < 3; ++j) grad[(size_t)p * 3 + j] = du[j];
  }
  for (int i = 0; i < N; ++i)
    logits[tid * lrow + i] =
        instance_active(valid[i], any_valid) ? acc.weight(logits[tid * lrow + i]) : 0.f;
  __syncthreads();
  // the tile's rows of w are one contiguous block
  const int count = min(T, P - p0) * N;
  float* wt = w + (size_t)p0 * N;
  for (int e = tid; e < count; e += T) wt[e] = logits[(e / N) * lrow + e % N];
}

// The CTA size of a launch: with the residual field 384 threads (12 warps,
// one CTA per SM) when their shared memory fits (N <= 10), else 128;
// box-only 128.
inline int rev_threads(bool rdf, int N) {
  return rdf && RevLayout<384>::bytes(true, N) <= kMaxSmem ? 384 : 128;
}

template <bool RDF, int T>
cudaError_t rev_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(rev_forward_kernel<RDF, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rev_forward_kernel<RDF, T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool RDF, int T>
cudaError_t launch_rev_forward(int F, int P, int N, const float* pos, const float* loc,
                               const float* rot, const float* half, const float* valid,
                               const float* weights, const float* tau, float scale, float* u,
                               float* w, float* grad, cudaStream_t stream) {
  const size_t smem = RevLayout<T>::bytes(RDF, N);
  const cudaError_t err = rev_attributes<RDF, T>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + T - 1) / T, F);
  rev_forward_kernel<RDF, T><<<grid, T, smem, stream>>>(P, N, pos, loc, rot, half, valid, weights,
                                                        tau, 1.f / scale, u, w, grad);
  return cudaGetLastError();
}

}  // namespace vsrd

// The reverse form's CTA size, dynamic shared memory (bytes) and CTAs per
// SM, for N instances, with the residual field (rdf) or box-only.
extern "C" int vsrd_rev_forward_info(int N, int rdf, int* threads, int* smem_bytes,
                                     int* ctas_per_sm) {
  using namespace vsrd;
  *threads = rev_threads(rdf, N);
  cudaError_t err;
  if (*threads == 384) {
    *smem_bytes = (int)RevLayout<384>::bytes(true, N);
    err = rev_attributes<true, 384>(*smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, rev_forward_kernel<true, 384>, 384, *smem_bytes);
  } else {
    *smem_bytes = (int)RevLayout<128>::bytes(rdf, N);
    err = rdf ? rev_attributes<true, 128>(*smem_bytes) : rev_attributes<false, 128>(*smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, rdf ? rev_forward_kernel<true, 128> : rev_forward_kernel<false, 128>, 128,
          *smem_bytes);
  }
  return (int)err;
}

extern "C" int vsrd_fused_forward(int F, int P, int N, int rdf, const float* pos,
                                  const float* loc, const float* rot, const float* half,
                                  const float* valid, const float* weights, const float* tau,
                                  float scale, float* u, float* w, float* grad, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!rdf)
    return vsrd::launch_rev_forward<false, 128>(F, P, N, pos, loc, rot, half, valid, nullptr, tau,
                                                scale, u, w, grad, s);
  return vsrd::rev_threads(true, N) == 384
             ? vsrd::launch_rev_forward<true, 384>(F, P, N, pos, loc, rot, half, valid, weights,
                                                   tau, scale, u, w, grad, s)
             : vsrd::launch_rev_forward<true, 128>(F, P, N, pos, loc, rot, half, valid, weights,
                                                   tau, scale, u, w, grad, s);
}
