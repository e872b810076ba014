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
// With the residual field it shares K1's design with one tangent.
#include "forward_kernel.cuh"

extern "C" int vsrd_dir_forward(int F, int P, int N, int rdf, const float* pos,
                                const float* dirs, const float* loc, const float* rot,
                                const float* half, const float* valid, const float* weights,
                                const float* tau, float scale, float* u, float* w, float* u_dot,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rdf)
    return vsrd::launch_forward<1, true>(F, P, N, pos, dirs, loc, rot, half, valid, weights,
                                         tau, scale, u, w, u_dot, s);
  return vsrd::launch_forward<1, false>(F, P, N, pos, dirs, loc, rot, half, valid, nullptr,
                                        tau, scale, u, w, u_dot, s);
}
