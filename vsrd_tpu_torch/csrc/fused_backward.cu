// K2 / K4c: the backward of K1 / K4a, from the cotangents (du, dw, dg) of
// its outputs to the box parameters and the per-instance MLP weights, for
// one frame (K2) or F stacked frames in one launch (K4c).
//
// Replaces the TPU kernels vsrd_tpu/rendering/pallas_field.py::
// _bwd_kernel_manual as launched by the custom_vjp rule _fused_bwd_rule
// (K2) and by _fused_bwd_batched (K4c, grid (F, tiles), whose output
// blocks revisit their frame); the body is
// fused_field.scene_eval_stacked_dir_bwd_t. Since <dg, grad_x u> is the
// derivative of u along dg, the kernel recomputes each point's field with
// ONE tangent along dg and runs the reverse sweep of that computation with
// cotangents (du, dw, 1): first the softmin union (union_backward), then
// each instance's MLP and box (instance_backward, field_common.cuh).
//
// What bounds it on an H100: f32 arithmetic again (two one-tangent
// forwards, the reverse sweep and the weight-gradient products, ~10k FMAs
// per point and valid instance), and the reduction of the parameter
// cotangents over ~200k points. Pallas summed them into output blocks
// that its sequential grid revisits; here CTAs run in parallel and in no
// order, so the design is:
//   * a fixed number of CTAs (what fits on the card at once) each walk
//     chunks of 64 points and keep a private partial row per instance in
//     device memory: dW, dloc, drot, dhalf;
//   * per layer, each thread stages its point's factors (a, ta, hbar,
//     thbar) in shared memory and the block forms dW = sum_p hbar a^T +
//     thbar ta^T with every entry owned by one thread, summed in point
//     order;
//   * reduce_partials_kernel then sums the partial rows over CTAs in CTA
//     order.
// With F frames the grid is (CTAs per frame, F): each CTA walks only its
// frame's points with its frame's boxes and weights into its own partial
// rows [F, CTAs per frame, N, kParams], and the reduction sums each
// frame's rows alone, so no frame's points reach another frame's sums.
// The CTAs that fit on the card are shared out among the frames, which
// keeps the partial buffer at about its single-frame size.
// No atomics anywhere, so the result is bit-for-bit repeatable. The
// reverse sweep keeps 4 x 32 LayerNorm residuals per thread, which spill
// to local memory; the staging (33 KB) and the instance weights (52 KB
// for 8 instances) leave room for two CTAs per SM.
#include <cuda_runtime.h>

#include "field_common.cuh"

namespace vsrd {

constexpr int kChunk = 64;               // points (threads) per CTA step
constexpr int kStride = kChunk + 1;      // staging row stride (no bank conflicts)
constexpr int kStageRows = 2 * kEnc + 2 * kHid;  // layer 0: x, tx, hbar, thbar
constexpr int kMaxInstances = 64;

// Collects the per-point layer factors of one instance over the CTA's
// chunk and adds the chunk's weight gradient to the CTA's partial row.
struct BlockSink {
  float* stage;    // [kStageRows][kStride] shared
  float* partial;  // this CTA's row for the instance: [kParams]
  int tid;

  // host-callable in name only: instance_backward is host-compilable
  __host__ __device__ void layer(int l, int in, int out, const float* a, const float* ta,
                                 const float* hbar, const float* thbar) {
#if defined(__CUDA_ARCH__)
    __syncthreads();  // the previous reduction has finished reading
    for (int i = 0; i < in; ++i) {
      stage[i * kStride + tid] = a[i];
      stage[(in + i) * kStride + tid] = ta[i];
    }
    for (int o = 0; o < out; ++o) {
      stage[(2 * in + o) * kStride + tid] = hbar[o];
      stage[(2 * in + out + o) * kStride + tid] = thbar[o];
    }
    __syncthreads();
    float* dst = partial + layer_offset(l);
    const int cols = in + 1;
    for (int e = tid; e < out * cols; e += kChunk) {
      const int o = e / cols, i = e % cols;
      const float* hb = stage + (2 * in + o) * kStride;
      const float* thb = stage + (2 * in + out + o) * kStride;
      float acc = 0.f;
      if (i < in) {
        const float* av = stage + i * kStride;
        const float* tav = stage + (in + i) * kStride;
        for (int q = 0; q < kChunk; ++q) acc += hb[q] * av[q] + thb[q] * tav[q];
      } else {
        for (int q = 0; q < kChunk; ++q) acc += hb[q];
      }
      dst[e] += acc;
    }
#endif
  }
};

template <bool RDF>
__global__ void __launch_bounds__(kChunk)
backward_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ dg,
                const float* __restrict__ du, const float* __restrict__ dw,
                const float* __restrict__ loc, const float* __restrict__ rot,
                const float* __restrict__ half, const float* __restrict__ valid,
                const float* __restrict__ weights, const float* __restrict__ tau_ptr,
                float inv_scale, float* __restrict__ partial) {
  extern __shared__ float smem[];
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
  const int tid = threadIdx.x;
  const int gsz = min(N, kGroup);
  float* wts = smem;                                  // RDF: [gsz][kWeights]
  float* scr_d = wts + (RDF ? gsz * kWeights : 0);    // [N][kChunk]: d, then d_bar
  float* scr_t = scr_d + N * kChunk;                  // [N][kChunk]: td, then td_bar
  float* stage = scr_t + N * kChunk;                  // [kStageRows][kStride]
  float* my_partial = partial + (f * gridDim.x + blockIdx.x) * N * kParams;
  const float tau = *tau_ptr;

  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;
  for (int i = tid; i < N; i += kChunk) active[i] = instance_active(valid[i], any_valid);
  __syncthreads();

  int loaded = -1;
  auto load_group = [&](int g0) {
    if (!RDF || loaded == g0) return;
    __syncthreads();
    const int gn = min(kGroup, N - g0);
    for (int e = tid; e < gn * kWeights; e += kChunk) wts[e] = weights[(size_t)g0 * kWeights + e];
    __syncthreads();
    loaded = g0;
  };

  const int num_chunks = (P + kChunk - 1) / kChunk;
  for (int chunk = blockIdx.x; chunk < num_chunks; chunk += gridDim.x) {
    const int p = chunk * kChunk + tid;
    const bool live = p < P;
    const int pp = live ? p : P - 1;
    const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
    const float v[3] = {dg[3 * pp], dg[3 * pp + 1], dg[3 * pp + 2]};

    // pass 1: every instance's distance and its derivative along dg
    for (int g0 = 0; g0 < N; g0 += kGroup) {
      load_group(g0);
      for (int i = g0; i < min(g0 + kGroup, N); ++i) {
        if (!active[i]) continue;
        const float* Ri = rot + 9 * i;
        float tl[1][3];
        for (int c = 0; c < 3; ++c) tl[0][c] = v[0] * Ri[c] + v[1] * Ri[3 + c] + v[2] * Ri[6 + c];
        float td[1];
        scr_d[i * kChunk + tid] = instance_forward<1>(
            x, loc + 3 * i, Ri, half + 3 * i, RDF ? wts + (i - g0) * kWeights : nullptr,
            inv_scale, tl, td);
        scr_t[i * kChunk + tid] = td[0];
      }
    }
    // stage A: cotangents of every instance's (d, td) through the union
    union_backward(N, active, scr_d + tid, scr_t + tid, valid, tau, live ? du[pp] : 0.f,
                   dw + (size_t)pp * N, kChunk);
    if (!live) {
      for (int i = 0; i < N; ++i) scr_d[i * kChunk + tid] = scr_t[i * kChunk + tid] = 0.f;
    }

    // pass 2: per instance, the reverse sweep and the CTA-wide sums
    for (int g0 = 0; g0 < N; g0 += kGroup) {
      load_group(g0);
      for (int i = g0; i < min(g0 + kGroup, N); ++i) {
        if (!active[i]) continue;  // uniform over the CTA
        float geo[kGeo];
        for (int k = 0; k < kGeo; ++k) geo[k] = 0.f;
        BlockSink sink{stage, my_partial + (size_t)i * kParams, tid};
        instance_backward(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                          RDF ? wts + (i - g0) * kWeights : nullptr, inv_scale,
                          scr_d[i * kChunk + tid], scr_t[i * kChunk + tid], geo, sink);
        __syncthreads();
        for (int k = 0; k < kGeo; ++k) stage[k * kStride + tid] = geo[k];
        __syncthreads();
        if (tid < kGeo) {
          float s = 0.f;
          for (int q = 0; q < kChunk; ++q) s += stage[tid * kStride + q];
          my_partial[(size_t)i * kParams + kWeights + tid] += s;
        }
      }
    }
  }
}

// out[f][e] = sum over CTAs b, in order, of partial[f][b][e]; grid
// (ceil(total / 256), F)
__global__ void reduce_partials_kernel(int num_ctas, int total, const float* __restrict__ partial,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t f = blockIdx.y;
  partial += f * num_ctas * total;
  out += f * total;
  float s = 0.f;
  for (int b = 0; b < num_ctas; ++b) s += partial[(size_t)b * total + e];
  out[e] = s;
}

inline size_t backward_smem(int N, bool rdf) {
  const size_t floats = (rdf ? (size_t)(N < kGroup ? N : kGroup) * kWeights : 0) + 2 * (size_t)N * kChunk +
                        (size_t)(rdf ? kStageRows : kGeo) * kStride;
  return floats * sizeof(float);
}

template <bool RDF>
cudaError_t prepare_backward(int N, int* blocks_per_sm) {
  const size_t smem = backward_smem(N, RDF);
  cudaError_t err = cudaFuncSetAttribute(backward_kernel<RDF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, backward_kernel<RDF>, kChunk,
                                                       smem);
}

}  // namespace vsrd

// CTAs the backward launches per frame for F frames of P points: as many
// as fit on the card at once, shared out among the frames, at least one
// and at most one per 64-point chunk. Returns a negative CUDA error code
// on failure.
extern "C" int vsrd_fused_backward_ctas(int F, int P, int N, int rdf) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = rdf ? vsrd::prepare_backward<true>(N, &per_sm) : vsrd::prepare_backward<false>(N, &per_sm);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1 || F < 1) return -(int)cudaErrorInvalidConfiguration;
  const int chunks = (P + vsrd::kChunk - 1) / vsrd::kChunk;
  const int per_frame = per_sm * sms / F > 1 ? per_sm * sms / F : 1;
  return chunks < per_frame ? chunks : per_frame;
}

// partial: [F, num_ctas, N, kParams] zero-initialised scratch (num_ctas per
// frame); out: [F, N, kParams] with each row [dW 1617 | dloc 3 | drot 9 |
// dhalf 3] (dW zero when !rdf).
extern "C" int vsrd_fused_backward(int F, int P, int N, int rdf, const float* pos, const float* dg,
                                   const float* du, const float* dw, const float* loc,
                                   const float* rot, const float* half, const float* valid,
                                   const float* weights, const float* tau, float scale,
                                   int num_ctas, float* partial, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N > vsrd::kMaxInstances) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = rdf ? vsrd::prepare_backward<true>(N, &per_sm)
                        : vsrd::prepare_backward<false>(N, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = vsrd::backward_smem(N, rdf);
  const dim3 grid(num_ctas, F);
  if (rdf)
    vsrd::backward_kernel<true><<<grid, vsrd::kChunk, smem, s>>>(
        P, N, pos, dg, du, dw, loc, rot, half, valid, weights, tau, 1.f / scale, partial);
  else
    vsrd::backward_kernel<false><<<grid, vsrd::kChunk, smem, s>>>(
        P, N, pos, dg, du, dw, loc, rot, half, valid, nullptr, tau, 1.f / scale, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = N * vsrd::kParams;
  const dim3 reduce_grid((total + 255) / 256, F);
  vsrd::reduce_partials_kernel<<<reduce_grid, 256, 0, s>>>(num_ctas, total, partial, out);
  return (int)cudaGetLastError();
}
