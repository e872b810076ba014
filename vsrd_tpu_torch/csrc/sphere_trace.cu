// The sphere tracer's march for F frames of R rays in one call: positions
// [F, R, 3], converged [F, R] and each frame's trip count [F].
//
// Replaces the gradient-stopped lax.while_loop of
// vsrd_tpu/rendering/renderer.py::sphere_tracing (not a Pallas kernel), which
// eager PyTorch would run with one blocking host read of its exit test per
// trip. Its plain twin is vsrd_tpu_torch/rendering/renderer.py::march_loop.
// Under vmap the JAX loop runs each frame until none of ITS rays is in the
// foreground and unconverged (or num_iterations), and keeps the carry of a
// frame that stopped, so frames do not couple, but the rays of a frame do:
// an inactive ray is re-evaluated on every later trip of its frame.
//
// The design: G lanes per ray (N rounded up to a power of two, at most 32:
// lanes_per_ray), each evaluating every G-th instance, the group combining
// the union by shuffles (GroupField), so that a trip costs about one
// instance's value forward; the per-ray march is field_common.cuh's
// (SceneField, march_ray, finish_ray), which the CPU tests run on the host
// with one lane per ray.
//   * march_kernel<G>: grid (ray blocks, F). A CTA stages its frame's boxes
//     and, when they fit in shared memory (up to N = 35), the frame's N x 1617
//     weights, then each group marches its ray until it is inactive for good
//     (one trip after it stops), marking in marked[f][t] every trip t at
//     whose start it was active, and writes its record.
//   * finish_kernel: the frame's trip count T is its first unmarked trip
//     (each CTA finds it from the marks); each ray's state after T trips
//     follows from its record, or, for a ray that stopped and went on again
//     and whose frame stopped in between, from a replay of T trips.
// The launcher (vsrd_sphere_trace) is one call of the wrapper; the marks are
// zeroed by the caller. Box parameters and weights are f32, contiguous.

#include <cuda_runtime.h>

#include "field_common.cuh"

namespace vsrd {

constexpr int kTraceThreads = 128;

// marks a trip of the frame: one store per group of lanes at the same trip
struct TripMark {
  unsigned char* row;
  __device__ void operator()(int t) const {
    const unsigned group = __match_any_sync(__activemask(), t);
    if ((threadIdx.x & 31) == __ffs(group) - 1 && !row[t]) row[t] = 1;
  }
};

__device__ bool any_valid_of(int n, const float* valid) {
  bool any = false;
  for (int i = 0; i < n; ++i) any |= valid[i] > 0.5f;
  return any;
}

__device__ TraceRay start_of(const float* origins, const bool* fg, long long ray) {
  TraceRay s;
  for (int c = 0; c < 3; ++c) s.p[c] = origins[3 * ray + c];
  s.fg = fg[ray];
  s.conv = false;
  return s;
}

// The scene distance for the G lanes of one ray: lane `sub` takes the
// instances sub, sub + G, ... (SceneField::part) and the group merges the
// parts by shuffles within its mask. The lanes follow the same ray through
// the same trips, so they reach every call together.
template <int G>
struct GroupField {
  SceneField scene;
  int sub;
  unsigned mask;

  __device__ float operator()(const float x[3]) const {
    UnionPart p = scene.part(x, sub, G);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const UnionPart q{__shfl_xor_sync(mask, p.mx, o), __shfl_xor_sync(mask, p.z, o),
                        __shfl_xor_sync(mask, p.sd, o)};
      p = scene.merge(p, q);
    }
    return scene.finish(p);
  }
};

template <int G>
__global__ void __launch_bounds__(kTraceThreads)
    march_kernel(int R, int N, int num_iterations, const float* __restrict__ origins,
                 const float* __restrict__ dirs, const bool* __restrict__ fg,
                 const float* __restrict__ loc, const float* __restrict__ rot,
                 const float* __restrict__ half, const float* __restrict__ valid,
                 const float* __restrict__ W, int weights_in_smem, Scaler inv, float tau,
                 float radius, float crit, unsigned char* marked, float* positions,
                 int* t_in, unsigned char* bits) {
  extern __shared__ float smem[];
  const int f = blockIdx.y;
  float* s_loc = smem;
  float* s_rot = s_loc + 3 * N;
  float* s_half = s_rot + 9 * N;
  float* s_valid = s_half + 3 * N;
  float* s_w = s_valid + N;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) {
    s_loc[i] = loc[(long long)f * 3 * N + i];
    s_half[i] = half[(long long)f * 3 * N + i];
  }
  for (int i = threadIdx.x; i < 9 * N; i += blockDim.x) s_rot[i] = rot[(long long)f * 9 * N + i];
  for (int i = threadIdx.x; i < N; i += blockDim.x) s_valid[i] = valid[(long long)f * N + i];
  const float* Wf = nullptr;
  if (W != nullptr) {
    const float* src = W + (long long)f * N * kWeights;
    if (weights_in_smem) {
      for (int i = threadIdx.x; i < N * kWeights; i += blockDim.x) s_w[i] = src[i];
      Wf = s_w;
    } else {
      Wf = src;
    }
  }
  __syncthreads();

  // G lanes per ray; a group returns as one
  const int sub = threadIdx.x % G;
  const int r = blockIdx.x * (kTraceThreads / G) + threadIdx.x / G;
  if (r >= R) return;
  const long long ray = (long long)f * R + r;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const GroupField<G> field{
      SceneField{N, s_loc, s_rot, s_half, s_valid, Wf, any_valid_of(N, s_valid), inv, tau},
      sub, mask};
  const float v[3] = {dirs[3 * ray], dirs[3 * ray + 1], dirs[3 * ray + 2]};
  TripMark mark{marked + (long long)f * num_iterations};
  const TraceRecord rec =
      march_ray(field, start_of(origins, fg, ray), v, num_iterations, radius, crit, mark);
  if (sub != 0) return;
  for (int c = 0; c < 3; ++c) positions[3 * ray + c] = rec.s.p[c];
  t_in[ray] = rec.t_in;
  bits[ray] = (unsigned char)(rec.s.fg | (rec.conv_in << 1) | (rec.conv_after << 2));
}

// Lanes per ray: the instances' count rounded up to a power of two, at most
// a warp. At the photometric branch's 100 rays per frame a trip's latency
// falls by the group size (0.69 ms against 3.8 for one lane per ray with the
// residual field); over a whole view the two designs come within 1.5x of
// each other either way, as the scene's padded share and trip spread decide
// (PERF.md, section 6).
int lanes_per_ray(int N) {
  int g = 1;
  while (g < N && g < 32) g *= 2;
  return g;
}

__global__ void __launch_bounds__(kTraceThreads)
    finish_kernel(int R, int N, int num_iterations, const float* __restrict__ origins,
                  const float* __restrict__ dirs, const bool* __restrict__ fg,
                  const float* __restrict__ loc, const float* __restrict__ rot,
                  const float* __restrict__ half, const float* __restrict__ valid,
                  const float* __restrict__ W, Scaler inv, float tau, float radius,
                  float crit, const unsigned char* __restrict__ marked,
                  const int* __restrict__ t_in, const unsigned char* __restrict__ bits,
                  float* positions, bool* converged, int* trips) {
  __shared__ int s_trips;
  const int f = blockIdx.y;
  if (threadIdx.x == 0) s_trips = num_iterations;
  __syncthreads();
  const unsigned char* row = marked + (long long)f * num_iterations;
  for (int t = threadIdx.x; t < num_iterations; t += blockDim.x)
    if (!row[t]) atomicMin(&s_trips, t);
  __syncthreads();
  const int T = s_trips;
  if (blockIdx.x == 0 && threadIdx.x == 0) trips[f] = T;

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long ray = (long long)f * R + r;
  TraceRecord rec;
  for (int c = 0; c < 3; ++c) rec.s.p[c] = positions[3 * ray + c];
  rec.s.fg = bits[ray] & 1;
  rec.conv_in = (bits[ray] >> 1) & 1;
  rec.conv_after = (bits[ray] >> 2) & 1;
  rec.t_in = t_in[ray];
  if (T >= rec.t_in) {
    converged[ray] = T == rec.t_in ? rec.conv_in : rec.conv_after;
    return;
  }
  const float* vf = valid + (long long)f * N;
  const SceneField field{N,  loc + (long long)f * 3 * N, rot + (long long)f * 9 * N,
                         half + (long long)f * 3 * N, vf,
                         W ? W + (long long)f * N * kWeights : nullptr, any_valid_of(N, vf),
                         inv, tau};
  const float v[3] = {dirs[3 * ray], dirs[3 * ray + 1], dirs[3 * ray + 2]};
  const TraceRay s = finish_ray(field, start_of(origins, fg, ray), v, rec, T, radius, crit);
  for (int c = 0; c < 3; ++c) positions[3 * ray + c] = s.p[c];
  converged[ray] = s.conv;
}

// dynamic shared memory of march_kernel<G>, and whether the weights are in it
template <int G>
cudaError_t march_smem(int N, bool rdf, int* bytes, int* weights_in_smem) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int geometry = 16 * N * (int)sizeof(float);
  const int weights = rdf ? N * kWeights * (int)sizeof(float) : 0;
  *weights_in_smem = rdf && geometry + weights <= limit;
  *bytes = geometry + (*weights_in_smem ? weights : 0);
  return cudaFuncSetAttribute(march_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

template <int G>
cudaError_t launch_march(int F, int R, int N, int num_iterations, const float* origins,
                         const float* dirs, const bool* fg, const float* loc, const float* rot,
                         const float* half, const float* valid, const float* W, Scaler inv,
                         float tau, float radius, float crit, unsigned char* marked,
                         float* positions, int* t_in, unsigned char* bits, cudaStream_t s) {
  int bytes = 0, weights_in_smem = 0;
  const cudaError_t err = march_smem<G>(N, W != nullptr, &bytes, &weights_in_smem);
  if (err != cudaSuccess) return err;
  constexpr int rays = kTraceThreads / G;
  march_kernel<G><<<dim3((R + rays - 1) / rays, F), kTraceThreads, bytes, s>>>(
      R, N, num_iterations, origins, dirs, fg, loc, rot, half, valid, W, weights_in_smem,
      inv, tau, radius, crit, marked, positions, t_in, bits);
  return cudaGetLastError();
}

}  // namespace vsrd

// positions and converged [F, R(, 3)] out; marked [F, num_iterations] zeroed
// by the caller; t_in [F, R] int32 and bits [F, R] uint8 scratch; trips [F].
// tau > 0: the softmin union at tau, else the hard union; radius 0: no
// bounding sphere. Returns a cudaError_t.
extern "C" int vsrd_sphere_trace(int F, int R, int N, int num_iterations, const float* origins,
                                 const float* dirs, const bool* fg, const float* loc,
                                 const float* rot, const float* half, const float* valid,
                                 const float* W, float scale, float tau, float radius, float crit,
                                 unsigned char* marked, int* t_in, unsigned char* bits,
                                 float* positions, bool* converged, int* trips, void* stream) {
  using namespace vsrd;
  if (F < 1 || F > 65535 || R < 1 || N < 1 || N > 64 || num_iterations < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scaler inv(scale);
  cudaError_t err;
  switch (lanes_per_ray(N)) {
#define VSRD_MARCH(G)                                                                       \
  case G:                                                                                   \
    err = launch_march<G>(F, R, N, num_iterations, origins, dirs, fg, loc, rot, half, valid, \
                          W, inv, tau, radius, crit, marked, positions, t_in, bits, s);       \
    break;
    VSRD_MARCH(1) VSRD_MARCH(2) VSRD_MARCH(4) VSRD_MARCH(8) VSRD_MARCH(16) VSRD_MARCH(32)
#undef VSRD_MARCH
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTraceThreads - 1) / kTraceThreads, F);
  finish_kernel<<<grid, kTraceThreads, 0, s>>>(R, N, num_iterations, origins, dirs, fg, loc, rot,
                                               half, valid, W, inv, tau, radius, crit,
                                               marked, t_in, bits, positions, converged, trips);
  return (int)cudaGetLastError();
}
