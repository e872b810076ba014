// K1 / K4a: the fine-pass forward of the scene field with its spatial
// gradient, for one frame (K1) or F stacked frames in one launch (K4a).
//
// Replaces the TPU kernels vsrd_tpu/rendering/pallas_field.py::_fwd_kernel
// as launched by _fused_forward (K1, grid (tiles,)) and by
// _fused_forward_batched (K4a, grid (F, tiles)); the body is
// fused_field.scene_eval_stacked_t. Outputs u [F, P], w [F, P, N] and
// grad_x u [F, P, 3] = sum_i w_i (1 + (u - d_i) / tau) grad_x d_i, each
// frame from its own boxes, validity and weights (F = 1 for K1).
//
// What bounds it on an H100: f32 arithmetic. Per point and valid instance
// the residual-field MLP costs ~1.6k FMAs for the value and ~4.9k for the
// three tangents (plus 24 sincos and 64 erf/exp), against 12 bytes read
// and 16 + 4N bytes written per point, so it sits far above the card's
// ~20 FLOP/byte f32 ridge. The TPU version fed the MXU with block-diagonal
// packed weights; here each thread runs its point's MLP as scalar FMAs
// with the instance's weights broadcast from shared memory (52 KB for 8
// instances, above the 48 KB default, hence the attribute in the
// launcher), and keeps the union online so nothing per instance is stored
// but the weights' logits. The tangents are 3 forward chains (not a
// reverse sweep), which keeps registers bounded. Tensor cores are left to
// a later version.
#include "forward_kernel.cuh"

extern "C" int vsrd_fused_forward(int F, int P, int N, int rdf, const float* pos,
                                  const float* loc, const float* rot, const float* half,
                                  const float* valid, const float* weights, const float* tau,
                                  float scale, float* u, float* w, float* grad, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rdf)
    return vsrd::launch_forward<3, true>(F, P, N, pos, nullptr, loc, rot, half, valid, weights,
                                         tau, scale, u, w, grad, s);
  return vsrd::launch_forward<3, false>(F, P, N, pos, nullptr, loc, rot, half, valid, nullptr,
                                        tau, scale, u, w, grad, s);
}
