// Forward kernel template shared by K1 (three tangents: the spatial
// gradient) and K3 (one tangent: the derivative along a per-point
// direction). See fused_forward.cu and dir_forward.cu.
#pragma once

#include <cuda_runtime.h>

#include "field_common.cuh"

namespace vsrd {

constexpr int kFwdThreads = 128;

// One thread per point; the grid is (point blocks, frames). Every input
// and output but the temperature has a leading frame axis (F = 1 for a
// single frame), and a block first moves its pointers to its frame's
// slice, so the validity, the staged weights and the outputs it touches
// are its own frame's. Instances are visited in groups of kGroup whose
// weights (6.5 KB each) are staged in dynamic shared memory; inactive
// instances (instance_active) are skipped with weight 0. The union is
// accumulated online (OnlineUnion), and w is written as the logits first,
// normalised once the max is known.
template <int K, bool RDF>
__global__ void __launch_bounds__(kFwdThreads)
forward_kernel(int P, int N, const float* __restrict__ pos, const float* __restrict__ dirs,
               const float* __restrict__ loc, const float* __restrict__ rot,
               const float* __restrict__ half, const float* __restrict__ valid,
               const float* __restrict__ weights, const float* __restrict__ tau_ptr,
               float inv_scale, float* __restrict__ u, float* __restrict__ w,
               float* __restrict__ grad) {
  extern __shared__ float wts[];
  const size_t f = blockIdx.y;
  pos += f * P * 3;
  if constexpr (K == 1) dirs += f * P * 3;
  loc += f * N * 3;
  rot += f * N * 9;
  half += f * N * 3;
  valid += f * N;
  if constexpr (RDF) weights += f * N * kWeights;
  u += f * P;
  w += f * P * N;
  grad += f * P * K;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const int pp = live ? p : P - 1;
  const float tau = *tau_ptr;
  const float x[3] = {pos[3 * pp], pos[3 * pp + 1], pos[3 * pp + 2]};
  float v[3] = {0.f, 0.f, 0.f};
  if constexpr (K == 1) {
    v[0] = dirs[3 * pp];
    v[1] = dirs[3 * pp + 1];
    v[2] = dirs[3 * pp + 2];
  }
  bool any_valid = false;
  for (int i = 0; i < N; ++i) any_valid |= valid[i] > 0.5f;

  OnlineUnion<K> acc;
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
      float tl[K][3];
      if constexpr (K == 3) {
        for (int j = 0; j < 3; ++j)
          for (int c = 0; c < 3; ++c) tl[j][c] = Ri[j * 3 + c];  // world axis j
      } else {
        for (int c = 0; c < 3; ++c) tl[0][c] = v[0] * Ri[c] + v[1] * Ri[3 + c] + v[2] * Ri[6 + c];
      }
      float td[K];
      const float d = instance_forward<K>(x, li, Ri, hi, RDF ? wts + (i - g0) * kWeights : nullptr,
                                          inv_scale, tl, td);
      const float l = union_logit(d, valid[i], tau);
      if (live) w[(size_t)p * N + i] = l;
      acc.add(l, d, td);
    }
  }
  if (!live) return;
  float du[K];
  u[p] = acc.finish(tau, du);
  for (int j = 0; j < K; ++j) grad[(size_t)p * K + j] = du[j];
  for (int i = 0; i < N; ++i) {
    if (instance_active(valid[i], any_valid)) w[(size_t)p * N + i] = acc.weight(w[(size_t)p * N + i]);
  }
}

// F frames of P points each: one launch, grid (ceil(P / kFwdThreads), F).
template <int K, bool RDF>
cudaError_t launch_forward(int F, int P, int N, const float* pos, const float* dirs,
                           const float* loc, const float* rot, const float* half,
                           const float* valid, const float* weights, const float* tau,
                           float scale, float* u, float* w, float* grad, cudaStream_t stream) {
  const size_t smem = RDF ? (size_t)(N < kGroup ? N : kGroup) * kWeights * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(forward_kernel<K, RDF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kFwdThreads - 1) / kFwdThreads, F);
  forward_kernel<K, RDF><<<grid, kFwdThreads, smem, stream>>>(
      P, N, pos, dirs, loc, rot, half, valid, weights, tau, 1.f / scale, u, w, grad);
  return cudaGetLastError();
}

}  // namespace vsrd
