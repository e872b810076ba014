// K3 / K4b: the coarse-pass forward of the scene field with the derivative
// of the union along each point's ray direction, for one frame (K3) or F
// stacked frames in one launch (K4b).
//
// Replaces the TPU kernels vsrd_tpu/rendering/pallas_field.py::
// _dir_fwd_kernel as launched by fused_field_dir_forward (K3) and by
// _fused_dir_forward_batched (K4b, grid (F, tiles)); the body is
// fused_field.scene_eval_stacked_dir_t (K = 1 tangent). Outputs u [F, P],
// w [F, P, N] and u_dot [F, P] = <dir, grad_x u>; forward only, the coarse
// pass is gradient-stopped.
//
// What bounds it on an H100: in the default configuration it runs box
// only (no MLP), ~60 flops per point and instance against 24 bytes read
// and 8 + 4N written per point, so it is bound by memory traffic and
// launch latency rather than arithmetic; one thread per point with the
// union accumulated online keeps the traffic at the inputs and outputs.
// With the residual field each thread runs its point's MLP and one tangent
// as scalar FMAs, the instance's weights broadcast from shared memory.
#include <cuda_runtime.h>

#include "field_common.cuh"

namespace vsrd {

constexpr int kDirThreads = 128;

// One thread per point; the grid is (point blocks, frames). Every input
// and output but the temperature has a leading frame axis (F = 1 for a
// single frame), and a block first moves its pointers to its frame's
// slice, so the validity, the staged weights and the outputs it touches
// are its own frame's. Instances are visited in groups of kGroup whose
// weights (6.5 KB each) are staged in dynamic shared memory; inactive
// instances (instance_active) are skipped with weight 0. The union is
// accumulated online (OnlineUnion), and w is written as the logits first,
// normalised once the max is known.
template <bool RDF>
__global__ void __launch_bounds__(kDirThreads)
dir_forward_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ dirs,
                   const float* __restrict__ loc, const float* __restrict__ rot,
                   const float* __restrict__ half, const float* __restrict__ valid,
                   const float* __restrict__ weights, const float* __restrict__ tau_ptr,
                   float inv_scale, float* __restrict__ u, float* __restrict__ w,
                   float* __restrict__ u_dot) {
  extern __shared__ float wts[];
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
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const int pp = live ? p : P - 1;
  const float tau = *tau_ptr;
  const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
  const float v[3] = {dirs[3 * pp], dirs[3 * pp + 1], dirs[3 * pp + 2]};
  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;

  OnlineUnion<1> acc;
  for (int g0 = 0; g0 < N; g0 += kGroup) {
    const int gn = min(kGroup, N - g0);
    if constexpr (RDF) {
      __syncthreads();
      for (int e = threadIdx.x; e < gn * kWeights; e += blockDim.x)
        wts[e] = weights[(size_t)g0 * kWeights + e];
      __syncthreads();
    }
    for (int i = g0; i < g0 + gn; ++i) {
      if (!instance_active(valid[i], any_valid)) {
        if (live) w[(size_t)p * N + i] = 0.f;
        continue;
      }
      float li[3], Ri[9], hi[3];
      for (int c = 0; c < 3; ++c) {
        li[c] = loc[3 * i + c];
        hi[c] = half[3 * i + c];
      }
      for (int c = 0; c < 9; ++c) Ri[c] = rot[9 * i + c];
      float tl[1][3];
      for (int c = 0; c < 3; ++c) tl[0][c] = v[0] * Ri[c] + v[1] * Ri[3 + c] + v[2] * Ri[6 + c];
      float td[1];
      const float d = instance_forward<1>(x, li, Ri, hi, RDF ? wts + (i - g0) * kWeights : nullptr,
                                          inv_scale, tl, td);
      const float l = union_logit(d, valid[i], tau);
      if (live) w[(size_t)p * N + i] = l;
      acc.add(l, d, td);
    }
  }
  if (!live) return;
  float du[1];
  u[p] = acc.finish(tau, du);
  u_dot[p] = du[0];
  for (int i = 0; i < N; ++i) {
    if (instance_active(valid[i], any_valid)) w[(size_t)p * N + i] = acc.weight(w[(size_t)p * N + i]);
  }
}

// F frames of P points each: one launch, grid (ceil(P / kDirThreads), F).
template <bool RDF>
cudaError_t launch_dir_forward(int F, int P, int N, const float* pos, const float* dirs,
                               const float* loc, const float* rot, const float* half,
                               const float* valid, const float* weights, const float* tau,
                               float scale, float* u, float* w, float* u_dot,
                               cudaStream_t stream) {
  const size_t smem = RDF ? (size_t)(N < kGroup ? N : kGroup) * kWeights * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(dir_forward_kernel<RDF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kDirThreads - 1) / kDirThreads, F);
  dir_forward_kernel<RDF><<<grid, kDirThreads, smem, stream>>>(
      P, N, pos, dirs, loc, rot, half, valid, weights, tau, 1.f / scale, u, w, u_dot);
  return cudaGetLastError();
}

}  // namespace vsrd

extern "C" int vsrd_dir_forward(int F, int P, int N, int rdf, const float* pos,
                                const float* dirs, const float* loc, const float* rot,
                                const float* half, const float* valid, const float* weights,
                                const float* tau, float scale, float* u, float* w, float* u_dot,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rdf)
    return vsrd::launch_dir_forward<true>(F, P, N, pos, dirs, loc, rot, half, valid, weights,
                                          tau, scale, u, w, u_dot, s);
  return vsrd::launch_dir_forward<false>(F, P, N, pos, dirs, loc, rot, half, valid, nullptr,
                                         tau, scale, u, w, u_dot, s);
}
