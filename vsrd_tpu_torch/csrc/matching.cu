// JV: minimum-cost perfect matching of F square cost matrices [F, n, n],
// 8 < n <= 128, by Jonker-Volgenant shortest augmenting paths with dual
// potentials, one launch for all frames and no host synchronisation.
//
// Replaces vsrd_tpu/ops/matching.py::linear_sum_assignment, which the JAX
// package runs as a lax.while_loop (not a Pallas kernel) and masked_linear_
// sum_assignment takes above n = 8. The plain twin is
// vsrd_tpu_torch/ops/matching.py::linear_sum_assignment_twin, a transcription
// of the JAX solver; this kernel gives the same row_to_col entry for entry
// from the same f32 cost:
//   * the same constants (INF = 1e18, the phantom row and column 0);
//   * the same f32 operations in the same order, cur = (c[i0] - up[j0]) - v,
//     minv - delta, up + delta, v - delta;
//   * ties of the argmin go to the lowest column, as jnp.argmin's do.
//
// The design: one CTA of one warp per frame (grid F). The n x n cost goes to
// dynamic shared memory once, coalesced (n^2 f32: 16 KB at n = 64, 40 KB at
// DETR's 100 queries, 64 KB at 128, above the 48 KB of static shared memory,
// so the kernel opts in to more once per device); the row potentials u, the
// composed potentials up[j] = u[p[j]], p (row of each column) and way (the
// Dijkstra tree) live in static shared memory; each lane owns the columns
// j = lane + 32 k, k < kSlots, and keeps their minv, v and used in registers
// (kSlots = 3 up to n = 64, 5 up to n = 128: the column count n + 1 over the
// warp). One Dijkstra expansion is one column update by every lane, then a
// warp argmin of (value, column) pairs by shuffles; the rows, their Dijkstra
// runs and the augmenting paths all run inside the kernel. It is bound by
// latency: n sequential Dijkstra runs of up to n + 1 dependent expansions
// each, a few hundred cycles apiece.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace vsrd {

constexpr int kJvMaxN = 128;
constexpr int kJvSmallN = 64;          // the 3-slot instantiation's largest n
constexpr int kJvMaxDevices = 64;
constexpr float kJvInf = 1e18f;

// columns per lane for costs up to n x n: the n + 1 columns over the warp
constexpr int jv_slots(int n) { return (n + 1 + 31) / 32; }

// (value, column) argmin over the warp; ties go to the lower column.
__device__ __forceinline__ void warp_argmin(float& value, int& column) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, value, offset);
    const int other_column = __shfl_xor_sync(0xffffffffu, column, offset);
    if (other < value || (other == value && other_column < column)) {
      value = other;
      column = other_column;
    }
  }
}

template <int kJvSlots>
__global__ void __launch_bounds__(32) jv_assignment_kernel(const float* __restrict__ cost, int n,
                                                           long long* __restrict__ row_to_col) {
  extern __shared__ float c[];          // n x n
  __shared__ float u[32 * kJvSlots];
  __shared__ float up[32 * kJvSlots];
  __shared__ int p[32 * kJvSlots];
  __shared__ int way[32 * kJvSlots];

  const int lane = threadIdx.x;
  const float* frame_cost = cost + (size_t)blockIdx.x * n * n;
  for (int k = lane; k < n * n; k += 32) c[k] = frame_cost[k];
  for (int j = lane; j <= n; j += 32) {
    u[j] = 0.0f;
    p[j] = 0;
  }
  float v[kJvSlots], minv[kJvSlots];
  bool used[kJvSlots];
#pragma unroll
  for (int k = 0; k < kJvSlots; ++k) v[k] = 0.0f;
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kJvSlots; ++k) {
      const int j = lane + 32 * k;
      if (j <= n) {
        up[j] = u[p[j]];
        way[j] = 0;
      }
      minv[k] = kJvInf;
      used[k] = false;
    }
    __syncwarp();

    // Dijkstra from row i until the frontier reaches a free column
    int j0 = 0;
    for (;;) {
      const int i0 = p[j0];
      const float base = up[j0];
      float best = __int_as_float(0x7f800000);  // +inf: lanes without columns lose
      int best_column = INT_MAX;
#pragma unroll
      for (int k = 0; k < kJvSlots; ++k) {
        const int j = lane + 32 * k;
        if (j <= n) {
          if (j == j0) used[k] = true;
          const float cij = j == 0 ? kJvInf : c[(i0 - 1) * n + j - 1];
          const float cur = (cij - base) - v[k];
          if (cur < minv[k] && !used[k]) {
            minv[k] = cur;
            way[j] = j0;
          }
          const float masked = used[k] ? kJvInf : minv[k];
          if (masked < best) {
            best = masked;
            best_column = j;
          }
        }
      }
      warp_argmin(best, best_column);
      const float delta = best;
#pragma unroll
      for (int k = 0; k < kJvSlots; ++k) {
        const int j = lane + 32 * k;
        if (j <= n) {
          if (used[k]) {
            up[j] = up[j] + delta;
            v[k] = v[k] - delta;
          } else {
            minv[k] = minv[k] - delta;
          }
        }
      }
      __syncwarp();
      j0 = best_column;
      if (p[j0] == 0) break;
    }

    // the row potentials back from the composed ones (matched columns only:
    // u[0], the phantom row's, is never read for a result)
#pragma unroll
    for (int k = 0; k < kJvSlots; ++k) {
      const int j = lane + 32 * k;
      if (j <= n && p[j] != 0) u[p[j]] = up[j];
    }
    __syncwarp();
    if (lane == 0) {
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }

  long long* out = row_to_col + (size_t)blockIdx.x * n;
  for (int j = lane + 1; j <= n; j += 32) out[p[j] - 1] = j - 1;
}

// One launch of the instantiation for costs up to kMaxN x kMaxN, its dynamic
// shared memory opted in to kMaxN^2 floats once per device.
template <int kMaxN>
static int launch_jv(int F, int n, const float* cost, long long* row_to_col,
                     cudaStream_t stream) {
  static bool opted[kJvMaxDevices] = {};
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return (int)status;
  if (device >= kJvMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr int kSlots = jv_slots(kMaxN);
  if (!opted[device]) {
    status = cudaFuncSetAttribute(jv_assignment_kernel<kSlots>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(kMaxN * kMaxN * sizeof(float)));
    if (status != cudaSuccess) return (int)status;
    opted[device] = true;
  }
  jv_assignment_kernel<kSlots><<<F, 32, (size_t)n * n * sizeof(float), stream>>>(cost, n,
                                                                                row_to_col);
  return (int)cudaGetLastError();
}

}  // namespace vsrd

extern "C" int vsrd_jv_assignment(int F, int n, const float* cost, long long* row_to_col,
                                  void* stream) {
  using namespace vsrd;
  if (n < 1 || n > kJvMaxN || F < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n <= kJvSmallN ? launch_jv<kJvSmallN>(F, n, cost, row_to_col, s)
                        : launch_jv<kJvMaxN>(F, n, cost, row_to_col, s);
}
