"""The field kernels' own arithmetic against their plain PyTorch twins.

Two halves, neither importing JAX (so that the file also runs on a machine
with a card and no JAX):

* on the CPU: ``csrc/field_common.cuh``, the per-point math that K1-K3 run
  on the card (box SDF, encoding, MLP with LayerNorm and GELU, forward
  tangents, online softmin union, K1's reverse sweep, the union's and the
  instance's reverse sweeps), is compiled for the host with the C++
  compiler and driven point by point by a small harness that mirrors the
  kernels' loops, with the card's layouts (padded weight rows, strided
  residual columns) and, where a kernel takes its products from an object
  (K1's sweep, K3's one-tangent forward, both stages of K2), scalar loops
  in its place; K3's math also at the main path's magnitudes (100 m)
  against the float64 twin. What this cannot reach (shared-memory staging,
  the tensor-core layer products and weight-gradient sums, the CTA partial
  sums and their reduction) is covered by the card tests, and the choice of
  3xTF32 for those products by numpy emulations of TF32 rounding;
* on the card (marker ``gpu``, skipped without one): the CUDA kernels
  against the twins, including N=12 (two instance groups of shared
  memory), an all-invalid frame, and K2's run-to-run repeatability; the
  frame-batched launches K4a/K4b/K4c on a batch whose frames differ in
  validity (one with no valid instance), K4c's repeatability and frame
  isolation, F=1 through the batched entry points against the
  single-frame launch, and K4c on a grid with ragged edges (F=3, N=5, P
  not a multiple of the backward's chunks); K1/K4a against the float64
  twin (N = 1, 4, 5, 8, 10 and 12, a ragged P, the all-invalid frame),
  their repeatability, F=1 through the batched entry point and frame
  isolation at F=3; the same for K3/K4b, with N = 2 and with N = 64 for
  its 128-thread CTAs with the residual field. K1/K2 and K4a/K4c also at
  the driver's instance buckets N = 16, 24 and 32; the JV matching kernel
  (``csrc/matching.cu``) against its twin at n = 9 to 128, at the DETR
  loss's 8 x {1, 3} levels of [50, 50] costs and at the published DETR's
  6 x 8 levels of [100, 100]; and the detector
  (``models/detr3d.py``) on the card against float64 on the CPU.

Tolerances, with their reasons:
* host math: u and w 2e-6 absolute (+ 2e-7 relative): the same f32
  arithmetic in another order; grad_x u and u_dot 2e-5 relative to scale:
  the tangents go through four LayerNorm Jacobians; pullbacks 1e-4
  relative to scale (bench.py's err()): sums over all points; at 100 m
  the f32 floor (see test_host_dir_forward_math_matches_float64_twin_at_100m);
* card: 2e-4 relative to scale, bench.py's bar for compiled kernels
  (fast-math intrinsics, fused multiply-adds and another summation order).

Run the card half with ``python -m pytest tests/test_torch_kernels.py -m gpu``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vsrd_tpu_torch.ops import matching as tmatch
from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import fused_field as tff
from vsrd_tpu_torch.rendering import renderer, scene

torch.set_num_threads(2)
TAU = 0.5
SCALE = 100.0

HARNESS = r"""
#include <vector>

#include "field_common.cuh"

using namespace vsrd;

namespace {

// The layer products of instance_rev, instance_dir and instance_backward as
// scalar loops over one point's staging rows (rows: the first block's value
// rows, trows: its tangent rows, which instance_rev leaves at 0; irows and
// itrows: the second block's, instance_backward's layer inputs); W: the
// instance's 1617 flattened weights (BF16: rounded, and each staged operand
// rounded where it is multiplied, as the card's bf16 mma rounds its B
// fragments); dW: where grad adds the weight cotangents (BF16: every factor
// rounded, as the card's bf16 mma of the staged rows).
template <bool BF16>
struct HostProduct {
  const float* W;
  float* dW = nullptr;
  float rows[kHid], c[kHid], held[kHid], trows[kHid] = {}, tc[kHid] = {}, theld[kHid] = {};
  float irows[kHid], itrows[kHid];
  float& at(int r) { return rows[r]; }
  float& tan_at(int r) { return trows[r]; }
  float& in_at(int r) { return irows[r]; }
  float& in_tan_at(int r) { return itrows[r]; }
  void second(int) {}
  void sync() {}
  void begin(const float* bias) {
    for (int o = 0; o < kHid; ++o) {
      c[o] = bias ? bias[o] : 0.f;
      tc[o] = 0.f;
    }
  }
  void forward(int l, int m) {
    const int row = (l == 0 ? kEnc : kHid) + 1, k0 = l == 0 ? m * kHid : 0;
    for (int o = 0; o < kHid; ++o)
      for (int k = 0; k < kHid; ++k) {
        const float wv = W[layer_offset(l) + o * row + k0 + k];
        c[o] += wv * operand<BF16>(rows[k]);
        tc[o] += wv * operand<BF16>(trows[k]);
      }
  }
  void reverse(int l) {
    for (int i = 0; i < kHid; ++i)
      for (int o = 0; o < kHid; ++o) {
        const float wv = W[layer_offset(l) + o * (kHid + 1) + i];
        c[i] += wv * operand<BF16>(rows[o]);
        tc[i] += wv * operand<BF16>(trows[o]);
      }
  }
  void hold() {
    for (int o = 0; o < kHid; ++o) {
      held[o] = rows[o];
      theld[o] = trows[o];
    }
  }
  void reverse0(int m) {
    for (int j = 0; j < kHid; ++j)
      for (int o = 0; o < kHid; ++o) {
        const float wv = W[o * (kEnc + 1) + m * kHid + j];
        c[j] += wv * operand<BF16>(held[o]);
        tc[j] += wv * operand<BF16>(theld[o]);
      }
  }
  void store() {
    for (int o = 0; o < kHid; ++o) {
      rows[o] = c[o];
      trows[o] = tc[o];
    }
  }
  void store_in() {
    for (int o = 0; o < kHid; ++o) {
      irows[o] = c[o];
      itrows[o] = tc[o];
    }
  }
  void grad(int l, int m) {
    const int in = l == 0 ? kEnc : kHid, k0 = l == 0 ? m * kHid : 0;
    float* G = dW + layer_offset(l);
    for (int o = 0; o < kHid; ++o) {
      const float hb = operand<BF16>(rows[o]), thb = operand<BF16>(trows[o]);
      for (int i = 0; i < kHid; ++i)
        G[o * (in + 1) + k0 + i] += hb * operand<BF16>(irows[i]) + thb * operand<BF16>(itrows[i]);
      if (m == 0) G[o * (in + 1) + in] += hb;
    }
  }
  void grad4(float hb, float thb) {
    float* G = dW + layer_offset(4);
    const float h = operand<BF16>(hb), th = operand<BF16>(thb);
    for (int i = 0; i < kHid; ++i)
      G[i] += h * operand<BF16>(irows[i]) + th * operand<BF16>(itrows[i]);
    G[kHid] += h;
  }
};

// the misc blocks (instance_rev's and instance_dir's) of N instances
std::vector<float> misc_blocks(int N, const float* W) {
  std::vector<float> misc(W ? N * kRevMisc : 0);
  for (int i = 0; W && i < N; ++i)
    for (int e = 0; e < kRevMisc; ++e) misc[i * kRevMisc + e] = W[i * kWeights + misc_index(e)];
  return misc;
}

bool any_valid_of(int n, const float* valid) {
  bool any = false;
  for (int i = 0; i < n; ++i) any |= valid[i] > 0.5f;
  return any;
}

}  // namespace

// K3's per-point loop: with the residual field instance_dir, the forward the
// kernel runs, with its layer products as scalar loops; box-only box_dir.
// Then the kernel's union (dir_union) over the point's row of logits,
// distances and tangents. BF16: the default precision (W rounded by the
// caller). inv: the encoding's 1 / scale (a Scaler, or the rounded
// reciprocal).
template <bool BF16, class Inv>
void dir_forward(int P, int N, const float* pos, const float* dirs, const float* loc,
                 const float* rot, const float* half, const float* valid, const float* W,
                 float tau, const Inv& inv, float* u, float* w, float* u_dot) {
  const bool any_valid = any_valid_of(N, valid);
  const std::vector<float> misc = misc_blocks(N, W);
  std::vector<float> d(N), td(N);
  for (int p = 0; p < P; ++p) {
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) continue;
      const float* x = pos + 3 * p;
      const float* v = dirs + 3 * p;
      if (W) {
        HostProduct<BF16> prod{W + i * kWeights};
        d[i] = instance_dir<BF16>(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                  misc.data() + i * kRevMisc, inv, prod, td[i]);
      } else {
        float tl[3];
        d[i] = box_dir(BoxGrad(x, loc + 3 * i, rot + 9 * i, half + 3 * i), v, rot + 9 * i, tl,
                       td[i]);
      }
      w[p * N + i] = union_logit(d[i], valid[i], tau);
    }
    u[p] = dir_union(N, valid, any_valid, w + p * N, d.data(), td.data(), tau, u_dot[p]);
  }
}

// K3's loop as the kernel runs it: the strict mode's encoding divides by the
// scale (Scaler), the default mode's multiplies by the rounded 1 / scale
extern "C" void host_dir_forward(int P, int N, const float* pos, const float* dirs,
                                 const float* loc, const float* rot, const float* half,
                                 const float* valid, const float* W, float tau, float scale,
                                 int bf16, float* u, float* w, float* u_dot) {
  if (bf16)
    dir_forward<true>(P, N, pos, dirs, loc, rot, half, valid, W, tau, 1.f / scale, u, w, u_dot);
  else
    dir_forward<false>(P, N, pos, dirs, loc, rot, half, valid, W, tau, Scaler(scale), u, w,
                       u_dot);
}

// The same function in the strict form of K2's first stage, whose encoding
// multiplies by the rounded 1 / scale (as K1's), for the comparison of the
// two forms' rounding (u_dot only)
extern "C" void host_dir_forward_rounded(int P, int N, const float* pos, const float* dirs,
                                         const float* loc, const float* rot, const float* half,
                                         const float* valid, const float* W, float tau,
                                         float scale, float* u_dot) {
  std::vector<float> u(P), w((size_t)P * N);
  dir_forward<false>(P, N, pos, dirs, loc, rot, half, valid, W, tau, 1.f / scale, u.data(),
                     w.data(), u_dot);
}

// K1's per-point loop: with the residual field instance_rev, the sweep the
// kernel runs, with its layer products as scalar loops and its residuals
// in a strided column; box-only the box's analytic gradient, as on the card.
// bf16 (with W, rounded by the caller): the default precision's two passes,
// the values and the union, then each sweep seeded with its union cotangent.
extern "C" void host_forward_rev(int P, int N, const float* pos, const float* loc,
                                 const float* rot, const float* half, const float* valid,
                                 const float* W, float tau, float scale, int bf16, float* u,
                                 float* w, float* grad) {
  const bool any_valid = any_valid_of(N, valid);
  std::vector<float> column(kRevResLayers * kRevRes * 2), misc = misc_blocks(N, W);
  const RevStore res{column.data() + 1, 2};
  for (int p = 0; bf16 && W && p < P; ++p) {
    OnlineUnion<3> acc;
    const float zero[3] = {0.f, 0.f, 0.f};
    float g[3];
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) continue;
      HostProduct<true> prod{W + i * kWeights};
      const float d = instance_rev<true>(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                         misc.data() + i * kRevMisc, 1.f / scale, prod, res,
                                         [](float) { return 0.f; }, g, false);
      const float l = union_logit(d, valid[i], tau);
      w[p * N + i] = l;
      acc.add(l, d, zero);
    }
    float du[3], sum[3] = {0.f, 0.f, 0.f};
    u[p] = acc.finish(tau, du);
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) {
        w[p * N + i] = 0.f;
        continue;
      }
      const float vi = valid[i];
      auto seed = [&](float di) {
        return expf(union_logit(di, vi, tau) - acc.mx) / acc.z * (1.f + (u[p] - di) / tau);
      };
      HostProduct<true> prod{W + i * kWeights};
      instance_rev<true>(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i,
                         misc.data() + i * kRevMisc, 1.f / scale, prod, res, seed, g);
      for (int j = 0; j < 3; ++j) sum[j] += g[j];
      w[p * N + i] = acc.weight(w[p * N + i]);
    }
    for (int j = 0; j < 3; ++j) grad[p * 3 + j] = sum[j];
  }
  for (int p = 0; !(bf16 && W) && p < P; ++p) {
    OnlineUnion<3> acc;
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) {
        w[p * N + i] = 0.f;
        continue;
      }
      float g[3], d;
      if (W) {
        HostProduct<false> prod{W + i * kWeights};
        d = instance_rev<false>(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                misc.data() + i * kRevMisc, 1.f / scale, prod, res,
                                [](float) { return 1.f; }, g);
      } else {
        const BoxGrad box(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i);
        local_to_world(rot + 9 * i, box.gl, g);
        d = box.d;
      }
      const float l = union_logit(d, valid[i], tau);
      w[p * N + i] = l;
      acc.add(l, d, g);
    }
    float du[3];
    u[p] = acc.finish(tau, du);
    for (int j = 0; j < 3; ++j) grad[p * 3 + j] = du[j];
    for (int i = 0; i < N; ++i)
      if (instance_active(valid[i], any_valid)) w[p * N + i] = acc.weight(w[p * N + i]);
  }
}

// The sphere-trace kernel's two passes on the host, frame by frame: every
// ray's march_ray with the frame's trip marks, the frame's trip count, then
// finish_ray. fg [F, R] bytes; converged [F, R] bytes out.
extern "C" void host_sphere_trace(int F, int R, int N, int num_iterations, const float* origins,
                                  const float* dirs, const unsigned char* fg, const float* loc,
                                  const float* rot, const float* half, const float* valid,
                                  const float* W, float scale, float tau, float radius,
                                  float crit, float* positions, unsigned char* converged,
                                  int* trips) {
  struct Mark {
    unsigned char* row;
    void operator()(int t) const { row[t] = 1; }
  };
  for (int f = 0; f < F; ++f) {
    std::vector<unsigned char> marked(num_iterations + 1, 0);
    Mark mark{marked.data()};
    const float* vf = valid + f * N;
    const SceneField field{N, loc + f * 3 * N, rot + f * 9 * N, half + f * 3 * N, vf,
                           W ? W + f * N * kWeights : nullptr, any_valid_of(N, vf),
                           Scaler(scale), tau};
    std::vector<TraceRecord> records(R);
    std::vector<TraceRay> starts(R);
    for (int r = 0; r < R; ++r) {
      const int ray = f * R + r;
      starts[r] = TraceRay{{origins[3 * ray], origins[3 * ray + 1], origins[3 * ray + 2]},
                           fg[ray] != 0, false};
      records[r] = march_ray(field, starts[r], dirs + 3 * ray, num_iterations, radius, crit, mark);
    }
    trips[f] = frame_trips(marked.data(), num_iterations);
    for (int r = 0; r < R; ++r) {
      const int ray = f * R + r;
      const TraceRay s =
          finish_ray(field, starts[r], dirs + 3 * ray, records[r], trips[f], radius, crit);
      for (int c = 0; c < 3; ++c) positions[3 * ray + c] = s.p[c];
      converged[ray] = s.conv;
    }
  }
}

// K2's two stages at each point, summed over points in order: out [N,
// kParams]. Stage 1: every active instance's d and td along dg, with the
// residual field by instance_dir with the rounded 1 / scale (box-only
// box_dir), then union_backward; stage 2: with the residual field
// instance_backward, its layer products and weight cotangents as scalar
// loops and its residuals in a strided column, as on the card (box-only
// box_backward). BF16: the default precision (W rounded by the caller).
template <bool BF16>
void backward(int P, int N, const float* pos, const float* dg, const float* du, const float* dw,
              const float* loc, const float* rot, const float* half, const float* valid,
              const float* W, float tau, float scale, float* out) {
  constexpr int stride = 2;
  std::vector<float> column(kResLayers * kRes * stride), misc = misc_blocks(N, W);
  const bool any_valid = any_valid_of(N, valid);
  std::vector<unsigned char> active(N);
  for (int i = 0; i < N; ++i) active[i] = instance_active(valid[i], any_valid);
  std::vector<float> d(N), td(N);
  for (int p = 0; p < P; ++p) {
    const float* x = pos + 3 * p;
    const float* v = dg + 3 * p;
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;
      if (W) {
        HostProduct<BF16> prod{W + i * kWeights};
        d[i] = instance_dir<BF16>(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                  misc.data() + i * kRevMisc, 1.f / scale, prod, td[i]);
      } else {
        float tl[3];
        d[i] = box_dir(BoxGrad(x, loc + 3 * i, rot + 9 * i, half + 3 * i), v, rot + 9 * i, tl,
                       td[i]);
      }
    }
    union_backward(N, active.data(), d.data(), td.data(), valid, tau, du[p], dw + p * N, 1);
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;
      float geo[kGeo] = {};
      if (W) {
        HostProduct<BF16> prod{W + i * kWeights};
        prod.dW = out + i * kParams;
        instance_backward<BF16>(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                misc.data() + i * kRevMisc, 1.f / scale, d[i], td[i], geo, prod,
                                ColumnStore{column.data(), stride});
      } else {
        float lbar[3] = {}, tlbar[3] = {};
        box_backward(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i, d[i], td[i], lbar, tlbar,
                     geo);
      }
      for (int k = 0; k < kGeo; ++k) out[i * kParams + kWeights + k] += geo[k];
    }
  }
}

extern "C" void host_backward(int P, int N, const float* pos, const float* dg, const float* du,
                              const float* dw, const float* loc, const float* rot,
                              const float* half, const float* valid, const float* W, float tau,
                              float scale, int bf16, float* out) {
  (bf16 ? backward<true> : backward<false>)(P, N, pos, dg, du, dw, loc, rot, half, valid, W, tau,
                                            scale, out);
}
"""


def _inputs(n=4, p=96, seed=0, valid=None):
    rng = np.random.default_rng(seed)
    if valid is None:
        valid = (1.0,) * (n - 1) + (0.0,)
    angles = rng.uniform(-1, 1, n)
    dirs = rng.normal(size=(p, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    x = dict(
        pos=rng.normal(size=(p, 3)) * 5,
        loc=rng.normal(size=(n, 3)) * 3,
        rot=np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                      for a in angles]),
        half=rng.uniform(0.5, 2.0, size=(n, 3)),
        valid=np.asarray(valid),
        w=rng.normal(size=(n, fk.NUM_WEIGHTS)) * 0.3,
        dirs=dirs,
        du=rng.normal(size=p), dw=rng.normal(size=(p, n)), dg=rng.normal(size=(p, 3)),
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _twin_pullback(x, use_rdf, device="cpu", precision="highest"):
    """The twin's (u, w, grad_x u) and the pullback of (du, dw, dg) to
    (loc, rot, half[, weights])."""
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    u, w, g = tff.scene_eval_with_grad(c["pos"], *params[:3], c["valid"],
                                       params[3] if use_rdf else None,
                                       torch.tensor(TAU, device=device), precision=precision)
    loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    return [t.detach().cpu().numpy() for t in (u, w, g, *grads)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    compiler = shutil.which("c++") or shutil.which("g++")
    if compiler is None:
        pytest.skip("needs a C++ compiler to build the kernels' math for the host")
    build = tmp_path_factory.mktemp("host_field")
    source = build / "host_field.cpp"
    source.write_text(HARNESS)
    lib_path = build / "libhost_field.so"
    subprocess.run([compiler, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{fk.CSRC}",
                    "-o", str(lib_path), str(source)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_dir_forward.argtypes = [i32, i32] + [ptr] * 7 + [f32, f32, i32] + [ptr] * 3
    lib.host_dir_forward_rounded.argtypes = [i32, i32] + [ptr] * 7 + [f32, f32, ptr]
    lib.host_backward.argtypes = [i32, i32] + [ptr] * 9 + [f32, f32, i32, ptr]
    lib.host_forward_rev.argtypes = [i32, i32] + [ptr] * 6 + [f32, f32, i32] + [ptr] * 3
    lib.host_sphere_trace.argtypes = [i32] * 4 + [ptr] * 8 + [f32] * 4 + [ptr] * 3
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _host_dir_forward(lib, x, use_rdf, bf16=False):
    """K3's host loop; ``bf16``: the default precision, on weights rounded
    here as the kernel rounds them where it stages them."""
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    u, w, ud = np.zeros(p, np.float32), np.zeros((p, n), np.float32), np.zeros(p, np.float32)
    lib.host_dir_forward(p, n, *map(_ptr, (x["pos"], x["dirs"], x["loc"], x["rot"], x["half"],
                                           x["valid"], _host_weights(x, use_rdf, bf16))),
                         TAU, SCALE, int(bf16), _ptr(u), _ptr(w), _ptr(ud))
    return u, w, ud


def _host_weights(x, use_rdf, bf16):
    if not use_rdf:
        return None
    return tff.bf16_round(_t(x["w"])).numpy() if bf16 else x["w"]


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("valid", [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_host_forward_math_matches_twin(host_lib, use_rdf, valid):
    """K1's per-point math (the reverse sweep) and K3's (one tangent, along
    dirs)."""
    x = _inputs(valid=valid)
    u, w, g = _host_forward_rev(host_lib, x, use_rdf)
    u2, w2, g2 = _twin_pullback(x, use_rdf)[:3]
    np.testing.assert_allclose(u, u2, atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w, w2, atol=2e-6, rtol=2e-7)
    assert _err(g, g2) <= 2e-5
    ud_twin = tff.scene_eval_dir(*(_t(x[k]) for k in ("pos", "dirs", "loc", "rot", "half",
                                                     "valid")),
                                 _t(x["w"]) if use_rdf else None, torch.tensor(TAU))
    u3, w3, ud = _host_dir_forward(host_lib, x, use_rdf)
    np.testing.assert_allclose(u3, ud_twin[0].numpy(), atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w3, ud_twin[1].numpy(), atol=2e-6, rtol=2e-7)
    assert _err(ud, ud_twin[2].numpy()) <= 2e-5


def _host_forward_rev(lib, x, use_rdf, bf16=False):
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    u, w, g = np.zeros(p, np.float32), np.zeros((p, n), np.float32), np.zeros((p, 3), np.float32)
    lib.host_forward_rev(p, n, *map(_ptr, (x["pos"], x["loc"], x["rot"], x["half"], x["valid"],
                                           _host_weights(x, use_rdf, bf16))),
                         TAU, SCALE, int(bf16), _ptr(u), _ptr(w), _ptr(g))
    return u, w, g


def _twin64(x, use_rdf, device="cpu"):
    """The twin's (u, w, grad_x u) in float64 on the same float32 inputs."""
    c = {k: _t(v).to(device, torch.float64) for k, v in x.items()}
    with torch.no_grad():
        outs = tff.scene_eval_with_grad(c["pos"], c["loc"], c["rot"], c["half"], c["valid"],
                                        c["w"] if use_rdf else None,
                                        torch.tensor(TAU, dtype=torch.float64, device=device))
    return [t.cpu().numpy() for t in outs]


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("valid", [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_host_rev_forward_math_matches_float64_twin(host_lib, use_rdf, valid):
    """K1's reverse form, per point: the value forward keeping the LayerNorm
    residuals, one reverse sweep seeded with 1 per instance, the union
    weighing the gradients online. The all-invalid frame is the one where
    the uniform union multiplies each instance's error by up to
    |1 + (u - d_i) / tau|."""
    x = _inputs(seed=4, valid=valid)
    u, w, g = _host_forward_rev(host_lib, x, use_rdf)
    u2, w2, g2 = _twin64(x, use_rdf)
    np.testing.assert_allclose(u, u2, atol=2e-6, rtol=2e-7)
    np.testing.assert_allclose(w, w2, atol=2e-6, rtol=2e-7)
    assert _err(g, g2) <= 2e-5


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("valid", [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_host_backward_math_matches_twin_pullback(host_lib, use_rdf, valid):
    """K2's per-point reverse sweep: union, MLP (with the LayerNorm's
    second-order terms) and box, summed over points."""
    x = _inputs(seed=1, valid=valid)
    got = _host_backward(host_lib, x, use_rdf)
    ref = _twin_pullback(x, use_rdf)[3:]
    for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), got, ref):
        assert _err(a, b) <= 1e-4, name


def _host_backward(lib, x, use_rdf, bf16=False):
    """K2's host loop: (dloc, drot, dhalf, dweights); ``bf16`` as in
    ``_host_dir_forward``."""
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    out = np.zeros((n, fk.NUM_WEIGHTS + 15), np.float32)
    lib.host_backward(p, n, *map(_ptr, (x["pos"], x["dg"], x["du"], x["dw"], x["loc"], x["rot"],
                                        x["half"], x["valid"], _host_weights(x, use_rdf, bf16))),
                      TAU, SCALE, int(bf16), _ptr(out))
    geo = out[:, fk.NUM_WEIGHTS:]
    return [geo[:, 0:3], geo[:, 3:12].reshape(n, 3, 3), geo[:, 12:15], out[:, :fk.NUM_WEIGHTS]]


def _trace_inputs(frames=2, n=4, r=64, seed=0, valid_counts=None):
    """F frames of N boxes about 12 m ahead, the first half of each frame's
    rays from the camera (some hit, some leave the 30 m sphere), the rest
    from 40 m behind it, entering the sphere by initialization; frame 1
    (if any) has no valid instance by default."""
    rng = np.random.default_rng(seed)
    if valid_counts is None:
        valid_counts = [max(n - 1, 1)] + [0] * (frames - 1)
    angles = rng.uniform(-1, 1, (frames, n))
    x = dict(
        loc=rng.normal(size=(frames, n, 3)) * 2.0 + np.array([0.0, 0.0, 12.0]),
        rot=np.stack([[[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                       for a in row] for row in angles]),
        half=rng.uniform(0.5, 2.0, size=(frames, n, 3)),
        valid=np.stack([np.arange(n) < c for c in valid_counts]).astype(np.float64),
        w=rng.normal(size=(frames, n, fk.NUM_WEIGHTS)) * 0.3,
    )
    half_r = r // 2
    spread = np.concatenate([np.full(half_r, 0.5), np.full(r - half_r, 0.08)])
    d = np.stack([rng.uniform(-1, 1, (frames, r)) * spread,
                  rng.uniform(-1, 1, (frames, r)) * spread, np.ones((frames, r))], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((frames, r, 3))
    o[:, half_r:, 2] = -40.0
    x.update(origins=o, dirs=d)
    x = {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}
    # the camera's rays start where they are; the far ones on the sphere
    t = {k: _t(v) for k, v in x.items()}
    near, _, hit = renderer.sphere_intersection(t["origins"], t["dirs"], 30.0)
    far = torch.arange(r) >= half_r
    start = torch.where(hit & far[:, None], t["origins"] + t["dirs"] * near, t["origins"])
    x["origins"] = np.ascontiguousarray(start.numpy())
    x["fg"] = np.ascontiguousarray((~far | hit[..., 0]).numpy())
    return x


def _twin_trace(x, use_rdf, iters, tau=None, device="cpu", dtype=torch.float32):
    c = {k: _t(v).to(device) for k, v in x.items()}
    c = {k: v.to(dtype) if v.is_floating_point() else v for k, v in c.items()}
    sp = scene.SceneParams(c["loc"], c["rot"], c["half"], c["valid"] > 0.5,
                           c["w"] if use_rdf else None)
    p, conv, trips = scene.march(sp.__class__(*(t.cpu() if t is not None else None for t in sp)),
                                 c["origins"].cpu(), c["dirs"].cpu(), c["fg"].cpu()[..., None],
                                 iters, 0.01, 30.0, temperature=tau)
    return p.numpy(), conv[..., 0].numpy(), trips.numpy()


def _host_trace(lib, x, use_rdf, iters, tau=None):
    f, r, _ = x["origins"].shape
    n = x["loc"].shape[1]
    pos = np.zeros((f, r, 3), np.float32)
    conv = np.zeros((f, r), np.uint8)
    trips = np.zeros(f, np.int32)
    fg = np.ascontiguousarray(x["fg"].astype(np.uint8))
    lib.host_sphere_trace(f, r, n, iters, _ptr(x["origins"]), _ptr(x["dirs"]), _ptr(fg),
                          *map(_ptr, (x["loc"], x["rot"], x["half"], x["valid"],
                                      x["w"] if use_rdf else None)),
                          SCALE, 0.0 if tau is None else tau, 30.0, 0.01, _ptr(pos),
                          _ptr(conv), _ptr(trips))
    return pos, conv.astype(bool), trips


def _assert_trace_positions(pos, ref, converged, tolerance=4e-6):
    """The surfels (converged rays) within 1e-4 m; every ray within
    ``tolerance`` of the 100 m position scale. A ray that left the sphere
    ends tens of metres out after as many f32 steps, each rounded to the
    ulp of its position: the host's arithmetic follows the twin's order
    (4e-6), the card's adds fused multiply-adds and its own sincosf (2e-4,
    the bar for compiled kernels)."""
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(pos), finite)
    surfels = finite & converged[..., None]
    np.testing.assert_allclose(pos[surfels], ref[surfels], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pos[finite], ref[finite], atol=tolerance * SCALE, rtol=0)


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("iters, tau", [(200, None), (7, None), (200, TAU)])
def test_host_sphere_trace_matches_twin(host_lib, use_rdf, iters, tau):
    """The kernel's per-ray march, its trip marks and its finish, against
    the eager loop per frame: the hard union (with a frame of no valid
    instance, which stops after one trip), a cap at 7 trips with rays
    still marching, and the softmin union of render_surface_mask."""
    x = _trace_inputs()
    pos, conv, trips = _host_trace(host_lib, x, use_rdf, iters, tau)
    tpos, tconv, ttrips = _twin_trace(x, use_rdf, iters, tau)
    np.testing.assert_array_equal(trips, ttrips)
    np.testing.assert_array_equal(conv, tconv)
    _assert_trace_positions(pos, tpos, tconv)
    assert conv[0].any() and (~x["fg"][0] | (np.linalg.norm(pos[0], axis=-1) >= 30)).any()
    if tau is None:
        assert trips[1] == min(iters, 1)
    if iters == 7:
        assert trips[0] == 7


def test_build_dir_takes_the_override_then_the_checkout_then_the_package(
        monkeypatch, tmp_path):
    monkeypatch.setenv("VSRD_TORCH_BUILD_DIR", str(tmp_path / "override"))
    assert fk.build_dir() == tmp_path / "override"
    monkeypatch.delenv("VSRD_TORCH_BUILD_DIR")
    assert fk.build_dir() == fk.PACKAGE.parent / "build"      # a source checkout
    installed = tmp_path / "site-packages" / "vsrd_tpu_torch"
    monkeypatch.setattr(fk, "PACKAGE", installed)
    assert fk.build_dir() == installed / "build"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_pullback(x, use_rdf, device, precision="highest"):
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    u, w, g = fk.fused_field_with_grad(c["pos"], *params[:3], c["valid"],
                                       params[3] if use_rdf else None,
                                       torch.tensor(TAU, device=device), precision=precision)
    loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    return [t.detach().cpu().numpy() for t in (u, w, g, *grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n, valid", [
    (8, (1.0,) * 6 + (0.0,) * 2),     # the main path's shape
    (12, (1.0,) * 11 + (0.0,)),       # two groups of staged weights
    (4, (0.0,) * 4),                  # no valid instance: uniform weights
    (16, (1.0,) * 12 + (0.0,) * 4),   # the driver's instance buckets
    (24, (1.0,) * 20 + (0.0,) * 4),
    (32, (1.0,) * 30 + (0.0,) * 2),
])
def test_kernels_match_twins_on_card(cuda, use_rdf, n, valid):
    x = _inputs(n=n, p=3000, valid=valid)
    launches = (fk.field_forward.launches, fk.field_backward.launches,
                fk.field_dir_forward.launches)
    got = _kernel_pullback(x, use_rdf, cuda)
    ref = _twin_pullback(x, use_rdf, cuda)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b in zip(names, got, ref):
        assert _err(a, b) <= 2e-4, name
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = (c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, torch.tensor(TAU, device=cuda))
    for name, a, b in zip(("u", "w", "u_dot"), fk.fused_field_dir_forward(*args),
                          tff.scene_eval_dir(*args)):
        assert _err(a.cpu().numpy(), b.cpu().numpy()) <= 2e-4, name
    assert (fk.field_forward.launches, fk.field_backward.launches,
            fk.field_dir_forward.launches) == tuple(k + 1 for k in launches)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("n, valid", [
    (8, (1.0,) * 6 + (0.0,) * 2),     # the main path's shape
    (12, (1.0,) * 11 + (0.0,)),       # two groups of staged weights
    (4, (0.0,) * 4),                  # no valid instance: uniform weights
])
def test_kernels_match_twins_in_both_precisions_on_card(cuda, precision, n, valid):
    """K1-K3 with the residual field at each precision against the float64
    twin at that precision on the card. "highest": every output within 2e-4
    of the twin's scale, as above. "default" (bf16 operands), by the bars of
    ``chip_smoke.RMS_HELD``: the per-point outputs and the weights' pullback
    within 2e-4 in RMS relative to scale (at isolated entries an f32 and a
    float64 evaluation round an operand to different bf16 neighbours), grad_x
    u, the weights' pullback and u_dot at least 10x nearer the rounded twin
    than the strict one, the box pullbacks (sums over every point, whose RMS
    those flips take to 2e-4 and beyond) at least 4x; each default-mode
    launch counted in ``bf16_launches``."""
    x = _inputs(n=n, p=3000, valid=valid)
    x64 = {k: v.astype(np.float64) for k, v in x.items()}
    counts = [fn.bf16_launches for fn in (fk.field_forward, fk.field_backward,
                                          fk.field_dir_forward)]

    def rms(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2))) / max(float(np.abs(b).max()), 1.0)

    def outputs(fn, dir_fn, data, prec):
        c = {k: _t(v).to(cuda) for k, v in data.items()}
        dirs = dir_fn(c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"], c["w"],
                      torch.tensor(TAU, device=cuda), precision=prec)
        return [*fn(data, True, cuda, precision=prec), *(t.cpu().numpy() for t in dirs)]

    got = outputs(_kernel_pullback, fk.fused_field_dir_forward, x, precision)
    ref = outputs(_twin_pullback, tff.scene_eval_dir, x64, precision)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights", "u3", "w3", "u_dot")
    if precision == "highest":
        for name, a, b in zip(names, got, ref):
            assert _err(a, b) <= 2e-4, name
        return
    strict = outputs(_twin_pullback, tff.scene_eval_dir, x64, "highest")
    for name, a, b, c in zip(names, got, ref, strict):
        if name in ("dloc", "drot", "dhalf"):
            assert rms(a, c) >= 4 * rms(a, b), name
            continue
        assert rms(a, b) <= 2e-4, name
        if name in ("grad", "dweights", "u_dot"):
            assert rms(a, c) >= 10 * rms(a, b), name
    assert [fn.bf16_launches for fn in (fk.field_forward, fk.field_backward,
                                        fk.field_dir_forward)] == [k + 1 for k in counts]


@pytest.mark.gpu
def test_backward_kernel_is_repeatable_on_card(cuda):
    """K2 sums its partials in a fixed order with no atomics: two runs on
    the same inputs agree bit for bit."""
    x = _inputs(n=8, p=20_000, valid=(1.0,) * 6 + (0.0,) * 2)
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = (c["pos"], c["loc"], c["rot"], c["half"], c["valid"], c["w"],
            torch.tensor(TAU, device=cuda), c["du"], c["dw"], c["dg"])
    first = fk.field_backward(*args)
    second = fk.field_backward(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _batched_inputs(valid_counts, n=8, p=3000, seed=0):
    """Per-frame ``_inputs`` stacked on a leading frame axis; frame f has
    ``valid_counts[f]`` valid instances."""
    frames = [_inputs(n=n, p=p, seed=seed + f, valid=(1.0,) * c + (0.0,) * (n - c))
              for f, c in enumerate(valid_counts)]
    return {k: np.stack([x[k] for x in frames]) for k in frames[0]}


def _batched_pullback(x, use_rdf, device, field):
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    u, w, g = field(c["pos"], *params[:3], c["valid"], params[3] if use_rdf else None,
                    torch.tensor(TAU, device=device))
    loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    return [t.detach().cpu().numpy() for t in (u, w, g, *grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n", [8, 16, 24, 32])
def test_batched_kernels_match_twins_on_card(cuda, use_rdf, n):
    """K4a, K4c and K4b on three frames of n - 2, 0 and n valid instances, at
    the main path's N = 8 and the driver's instance buckets 16, 24 and 32:
    each frame against the twin, and one launch of each kernel for the
    batch."""
    x = _batched_inputs((n - 2, 0, n), n=n)
    launches = [(fn.launches, fn.batched_launches)
                for fn in (fk.field_forward, fk.field_backward, fk.field_dir_forward)]
    got = _batched_pullback(x, use_rdf, cuda, fk.fused_field_with_grad)
    ref = _batched_pullback(x, use_rdf, cuda, tff.scene_eval_with_grad_batched)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and a.shape[0] == 3, name
        for f in range(3):
            assert _err(a[f], b[f]) <= 2e-4, (name, f)
    np.testing.assert_allclose(got[1][1], 1.0 / n, rtol=1e-6)   # no valid instance
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = (c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, torch.tensor(TAU, device=cuda))
    for name, a, b in zip(("u", "w", "u_dot"), fk.fused_field_dir_forward(*args),
                          tff.scene_eval_dir_batched(*args)):
        for f in range(3):
            assert _err(a[f].cpu().numpy(), b[f].cpu().numpy()) <= 2e-4, (name, f)
    after = [(fn.launches, fn.batched_launches)
             for fn in (fk.field_forward, fk.field_backward, fk.field_dir_forward)]
    assert after == [(a + 1, b + 1) for a, b in launches]


@pytest.mark.gpu
def test_batched_backward_is_repeatable_and_keeps_frames_apart_on_card(cuda):
    """K4c: two runs agree bit for bit; a frame with zero cotangents gets
    exactly zero; changing one frame's inputs leaves the others' results
    bit for bit as they were."""
    x = _batched_inputs((6, 0, 8), p=20_000)
    c = {k: _t(v).to(cuda) for k, v in x.items()}

    def run(c):
        return fk.field_backward(c["pos"], c["loc"], c["rot"], c["half"], c["valid"], c["w"],
                                 torch.tensor(TAU, device=cuda), c["du"], c["dw"], c["dg"])

    first, second = run(c), run(c)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    zeroed = dict(c, du=c["du"].clone(), dw=c["dw"].clone(), dg=c["dg"].clone())
    for key in ("du", "dw", "dg"):
        zeroed[key][1] = 0.0
    for a, b in zip(run(zeroed), first):
        assert not a[1].any()
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    moved = dict(c, pos=c["pos"].clone(), w=c["w"].clone())
    moved["pos"][2] += 1.0
    moved["w"][2] *= 0.5
    for a, b in zip(run(moved), first):
        assert torch.equal(a[:2], b[:2]) and not torch.equal(a[2], b[2])


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
def test_one_frame_through_the_batched_entry_points_equals_the_single_launch(cuda, use_rdf):
    """F=1 with a leading frame axis is the single-frame launch: the same
    grid and the same CTAs, so the same bits."""
    x = _inputs(n=8, p=5000, valid=(1.0,) * 6 + (0.0,) * 2)
    single = _kernel_pullback(x, use_rdf, cuda)
    batched = _batched_pullback({k: v[None] for k, v in x.items()}, use_rdf, cuda,
                                fk.fused_field_with_grad)
    for a, b in zip(batched, single):
        np.testing.assert_array_equal(a[0], b)
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = [c[k] for k in ("pos", "dirs", "loc", "rot", "half", "valid")]
    weights = c["w"] if use_rdf else None
    tau = torch.tensor(TAU, device=cuda)
    for a, b in zip(fk.field_dir_forward(*[t[None] for t in args],
                                         None if weights is None else weights[None], tau),
                    fk.field_dir_forward(*args, weights, tau)):
        assert torch.equal(a[0], b)



@pytest.mark.gpu
def test_batched_backward_on_a_ragged_grid_matches_the_twin_on_card(cuda):
    """K4c at F=3 frames of N=5 instances and P=2,777 points, which is not a
    multiple of the backward's 128-point chunks nor of its 1,024-point
    tiles: each frame against the twin."""
    x = _batched_inputs((4, 0, 5), n=5, p=2777, seed=3)
    got = _batched_pullback(x, True, cuda, fk.fused_field_with_grad)
    ref = _batched_pullback(x, True, cuda, tff.scene_eval_with_grad_batched)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and a.shape[0] == 3, name
        for f in range(3):
            assert _err(a[f], b[f]) <= 2e-4, (name, f)


def _twin_pullback_by_chunks(x, device, precision, chunk=50_000):
    """``_twin_pullback``'s box and weight cotangents of one frame in
    float64, summed over chunks of its points (each point's cotangents
    depend on that point alone), so that the twin's graph stays small."""
    sums, p = None, x["pos"].shape[0]
    for s in range(0, p, chunk):
        part = {k: (v[s:s + chunk] if k in ("pos", "dirs", "du", "dw", "dg") else v)
                for k, v in x.items()}
        grads = _twin_pullback({k: v.astype(np.float64) for k, v in part.items()}, True, device,
                               precision)[3:]
        sums = grads if sums is None else [a + b for a, b in zip(sums, grads)]
    return sums


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_batched_backward_at_the_heaviest_cell_shape_matches_the_twin_on_card(cuda, precision):
    """K4c at the shape of the benchmark's heaviest cell: F=8 frames of N=32
    instances (one frame with none valid) and P=199,000 points, in one
    launch, against the float64 twin frame by frame at the same precision:
    the pullback to the box parameters and to the packed weights [N, 1617].
    "highest": each within 2e-4 of the twin's scale. "default" (bf16
    operands): the weights' pullback within 2e-4 in RMS relative to scale,
    the bar of ``chip_smoke.RMS_HELD`` (an f32 and a float64 evaluation
    round a few operands to different bf16 neighbours, which moves isolated
    entries by 1e-3 and more), and the box pullbacks, sums over every point,
    at least 4x nearer the rounded twin than the strict one. The second
    stage keeps two CTAs on an SM in either precision."""
    assert fk.backward_info(True, precision)[1][2] >= 2
    x = _batched_inputs((32, 30, 0, 32, 24, 32, 31, 16), n=32, p=199_000, seed=7)
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    got = [t.cpu().numpy() for t in fk.field_backward(
        c["pos"], c["loc"], c["rot"], c["half"], c["valid"], c["w"],
        torch.tensor(TAU, device=cuda), c["du"], c["dw"], c["dg"], precision=precision)]
    del c
    names = ("dloc", "drot", "dhalf", "dweights")

    def rms(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2))) / max(float(np.abs(b).max()), 1.0)

    for f in range(8):
        frame = {k: v[f] for k, v in x.items()}
        ref = _twin_pullback_by_chunks(frame, cuda, precision)
        if precision == "highest":
            for name, a, b in zip(names, got, ref):
                assert _err(a[f], b) <= 2e-4, (name, f)
            continue
        strict = _twin_pullback_by_chunks(frame, cuda, "highest")
        assert rms(got[3][f], ref[3]) <= 2e-4, ("dweights", f)
        for name, a, b, d in zip(names[:3], got, ref, strict):
            assert rms(a[f], d) >= 4 * rms(a[f], b), (name, f)


def _tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_weight_gradient_sums_need_the_split_tf32_products():
    """The dW sums of the backward's tensor-core sink, sum_p hbar a^T +
    thbar ta^T, shaped as the main path's (16 x 17 outputs, bounded
    activations, heavy-tailed cotangents), emulated in numpy: one TF32
    product per term is off by more than 1e-4 relative to scale of the
    float64 sums, the 3xTF32 split (big*big + big*small + small*big) stays
    within 1e-6. Each product is rounded to f32 as the tensor cores do and
    the sums run in float64, so that what is measured is the operands'
    rounding alone: the f32 accumulation adds the same error to every
    variant, plain f32 included."""
    rng = np.random.default_rng(0)
    points = 4096
    a = np.tanh(rng.normal(size=(2 * points, 17))).astype(np.float32)
    a[:points, 16] = 1.0        # the bias column: a = 1, ta = 0
    a[points:, 16] = 0.0
    h = (rng.standard_t(2.5, size=(16, 2 * points)) * 1e-3).astype(np.float32)
    exact = h.astype(np.float64) @ a.astype(np.float64)
    scale = np.abs(exact).max()

    def f32_sum(x, y):          # products rounded to f32, summed in float64
        return (x.astype(np.float64)[:, :, None] * y.astype(np.float64)[None]).astype(
            np.float32).astype(np.float64).sum(axis=1)

    one = f32_sum(_tf32(h), _tf32(a))
    hb, ab = _tf32(h), _tf32(a)
    hs, as_ = _tf32(h - hb), _tf32(a - ab)
    three = f32_sum(hs, ab) + f32_sum(hb, as_) + f32_sum(hb, ab)
    assert np.abs(one - exact).max() / scale > 1e-4
    assert np.abs(three - exact).max() / scale <= 1e-6


def _far_inputs(n=8, p=2000, seed=0, num_valid=0):
    """Field inputs shaped like the main path's (``bench_common.field_inputs``):
    points along rays from the origin out to 100 m, boxes 5-40 m ahead,
    weights at the hypernetwork's output scale."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(p, 3)) * [0.3, 0.1, 1.0]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pos = dirs * rng.uniform(0.0, 100.0, size=(p, 1))
    loc = np.stack([rng.uniform(-6, 6, n), rng.uniform(0.3, 0.8, n), rng.uniform(5, 40, n)], -1)
    yaw = rng.uniform(-0.4, 0.4, n)
    x = dict(
        pos=pos, dirs=dirs, loc=loc,
        rot=np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                      for a in yaw]),
        half=rng.uniform([0.75, 0.75, 1.5], [1.0, 1.0, 2.5], size=(n, 3)),
        valid=(np.arange(n) < num_valid).astype(np.float64),
        w=rng.normal(size=(n, fk.NUM_WEIGHTS)) * 0.3,
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}


def _rev_union_gradient(products, points=2048, n=8, seed=0):
    """u and grad_x u of the reverse form, in float64, with every layer
    product that the reverse-form kernel runs on the tensor cores (W_l a for
    layers 0-3, W_l^T hbar for layers 3..0) computed by ``products(A, B)``
    on float32 operands; layer 4 and all per-point work stay exact. Inputs
    as ``_far_inputs``: points along rays out to 100 m, where the encoding's
    top frequency reaches 128 pi, and no valid instance, so the union is
    uniform and weighs each instance's gradient by up to
    |1 + (u - d_i) / tau|."""
    from math import erf

    x = {k: v.astype(np.float64) for k, v in _far_inputs(n, points, seed).items()}
    pos, loc, rot, half, weights = x["pos"], x["loc"], x["rot"], x["half"], x["w"]
    cdf_of = np.vectorize(lambda v: 0.5 * (1.0 + erf(v / np.sqrt(2.0))))
    mm = lambda a, b: products(a.astype(np.float32), b.astype(np.float32))  # noqa: E731
    distances, gradients = [], []
    for i in range(n):
        flat = weights[i]
        mats = [flat[:16 * 49].reshape(16, 49)]
        mats += [flat[16 * 49 + j * 272:16 * 49 + (j + 1) * 272].reshape(16, 17) for j in range(3)]
        last = flat[16 * 49 + 3 * 272:].reshape(1, 17)
        local = (pos - loc[i]) @ rot[i]
        sign, q = np.sign(local), np.abs(local) - half[i]
        r = np.maximum(q, 0.0)
        outside = np.sqrt((r ** 2).sum(-1) + 1e-6)
        gate = (q.max(-1) < 0).astype(np.float64)
        d = outside - np.maximum(-q.max(-1), 0.0)
        grad_local = sign * (r / outside[:, None] + gate[:, None] * np.eye(3)[np.argmax(q, -1)])
        sym = np.stack([np.abs(local[:, 0]), local[:, 1], local[:, 2]]) / SCALE   # [3, P]
        freq = np.pi * 2.0 ** np.arange(8)
        phase = sym[:, None, :] * freq[None, :, None]                              # [3, 8, P]
        enc = np.stack([np.cos(phase), np.sin(phase)], 2).reshape(48, points)
        h = mm(mats[0][:, :48], enc) + mats[0][:, 48:]
        residuals = []
        for layer in (*mats[1:], last):
            centered = h - h.mean(0)
            istd = 1.0 / np.sqrt((centered ** 2).mean(0) + 1e-5)
            y = centered * istd
            cdf = cdf_of(y)
            residuals.append((y, istd, cdf + y * np.exp(-0.5 * y * y) / np.sqrt(2 * np.pi)))
            a = y * cdf
            h = (mm(layer[:, :16], a) if layer is not last else last[:, :16] @ a) + layer[:, 16:]
        sig = 1.0 / (1.0 + np.exp(1.0 - h[0]))
        abar = last[:, :16].T * (sig * (1.0 - sig))
        for j in range(3, -1, -1):
            y, istd, dgelu = residuals[j]
            ybar = abar * dgelu
            hbar = istd * (ybar - ybar.mean(0) - y * (ybar * y).mean(0))
            abar = mm(mats[j][:, :-1].T, hbar)
        ebar = abar.reshape(3, 8, 2, points)
        cs, sn = enc.reshape(3, 8, 2, points)[:, :, 0], enc.reshape(3, 8, 2, points)[:, :, 1]
        symbar = (freq[None, :, None] * (cs * ebar[:, :, 1] - sn * ebar[:, :, 0])).sum(1)
        symbar[0] *= sign[:, 0]
        distances.append(d + sig)
        gradients.append((grad_local + symbar.T / SCALE) @ rot[i].T)
    d, g = np.stack(distances, -1), np.stack(gradients, 1)
    logits = -d / TAU
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    u = (w * d).sum(-1)
    return u, ((w * (1.0 + (u[:, None] - d) / TAU))[..., None] * g).sum(1)


def test_rev_forward_products_need_the_split_tf32_products():
    """The reverse form's layer products on the tensor cores, emulated in
    numpy at the main path's magnitudes (``_rev_union_gradient``): one TF32
    product per term breaks the 2e-4 bar on grad_x u relative to its scale,
    the 3xTF32 split (big*big + big*small + small*big) stays within 2e-6.
    Products of TF32 operands are exact in f32, and the sums run in float64,
    so that what is measured is the operands' rounding alone."""
    f64 = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)  # noqa: E731

    def one(a, b):
        return f64(_tf32(a), _tf32(b))

    def three(a, b):
        ab, bb = _tf32(a), _tf32(b)
        return f64(_tf32(a - ab), bb) + f64(ab, _tf32(b - bb)) + f64(ab, bb)

    u, g = _rev_union_gradient(f64)
    scale = max(float(np.abs(g).max()), 1.0)
    u1, g1 = _rev_union_gradient(one)
    u3, g3 = _rev_union_gradient(three)
    assert float(np.abs(g1 - g).max()) / scale > 2e-4
    assert float(np.abs(g3 - g).max()) / scale <= 2e-6
    assert float(np.abs(u3 - u).max()) <= 2e-6


def _bf16(x):
    """``cvt.rn.bf16x2.f32`` on each value: 8 significant bits, to nearest
    even (finite x), as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _mma_bf16_k8(a_words, b_words):
    """``mma.sync.m16n8k8.row.col.f32.bf16.bf16.f32`` on 32 lanes'
    registers, laid out as the PTX ISA lays out the .bf16 fragments (gid =
    lane / 4, t = lane % 4; the lower k in a word's low half): a0 = A[gid,
    2t | 2t + 1], a1 = A[gid + 8, 2t | 2t + 1], b0 = B[2t | 2t + 1, gid].
    ``a_words[lane] = ((lo, hi), (lo, hi))`` and ``b_words[lane] = (lo,
    hi)``, each value rounded to bf16; returns A B in float64 (the products
    of bf16 values are exact in f32)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        gid, t = lane >> 2, lane & 3
        (a[gid, 2 * t], a[gid, 2 * t + 1]), (a[gid + 8, 2 * t], a[gid + 8, 2 * t + 1]) = \
            a_words[lane]
        b[2 * t, gid], b[2 * t + 1, gid] = b_words[lane]
    return a @ b


def _warp_product_bf16(a_of, b_of, k, nt):
    """C [16, 8 nt] = A [16, k] B [k, 8 nt] through _mma_bf16_k8, each
    lane's words read as the kernels read them: A's word at k-step s from
    (row, s * 8 + 2t) and (row, s * 8 + 2t + 1) (``a_of(row, col)``;
    convert_block's packing of the weights, or the backward sink's rows of
    hbar), B's from the staging rows s * 8 + 2t and s * 8 + 2t + 1 of
    column 8 n + gid (``b_of(row, col)``). Also counts how many times each
    element of A and of B was read."""
    c = np.zeros((16, 8 * nt))
    uses_a, uses_b = np.zeros((16, k), int), np.zeros((k, 8 * nt), int)
    for s in range(k // 8):
        a_words = []
        for lane in range(32):
            gid, t = lane >> 2, lane & 3
            pairs = []
            for row in (gid, gid + 8):
                cols = (s * 8 + 2 * t, s * 8 + 2 * t + 1)
                pairs.append(tuple(float(_bf16(a_of(row, col))) for col in cols))
                for col in cols:
                    uses_a[row, col] += 1
            a_words.append(tuple(pairs))
        for n in range(nt):
            b_words = []
            for lane in range(32):
                gid, t = lane >> 2, lane & 3
                rows, col = (s * 8 + 2 * t, s * 8 + 2 * t + 1), 8 * n + gid
                b_words.append(tuple(float(_bf16(b_of(row, col))) for row in rows))
                for row in rows:
                    uses_b[row, col] += 1
            c[:, 8 * n:8 * n + 8] += _mma_bf16_k8(a_words, b_words)
    return c, uses_a, uses_b


def test_bf16_fragments_take_each_operand_once():
    """The default precision's layer products (warp_product.cuh's bf16 path:
    K1's forward W_l a and reverse W_l^T hbar, K3's value and tangent
    columns) and K2's weight-gradient sink (A = hbar | thbar over the
    chunk's points, B = a | ta), emulated in numpy from the lanes'
    registers by the PTX ISA's fragment layout: every element of both
    operands is read exactly once, rounded to bf16, so each product is
    bf16(A) bf16(B) with exact products; one bf16 product of f32 operands
    is then off by more than 1e-3 of scale, where the strict mode's 3xTF32
    products hold 1e-6."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(16, 17)) * 0.3).astype(np.float32)       # a hidden layer, bias last
    act = np.tanh(rng.normal(size=(16, 32))).astype(np.float32)    # 16 staging rows, 32 points
    hbar = (rng.standard_t(2.5, size=(16, 32)) * 1e-3).astype(np.float32)
    cases = {
        "forward W a": (lambda r, k: w[r, k], lambda r, n: act[r, n], w[:, :16], act),
        "reverse W^T hbar": (lambda r, k: w[k, r], lambda r, n: hbar[r, n], w[:16, :16].T, hbar),
        # the sink: A[o, p] = hbar of output o at point p, B[p, i] = a of input i
        "sink hbar a^T": (lambda r, k: hbar[r, k], lambda p, i: act[i, p], hbar, act.T),
    }
    for name, (a_of, b_of, a_mat, b_mat) in cases.items():
        k, nt = a_mat.shape[1], b_mat.shape[1] // 8
        c, uses_a, uses_b = _warp_product_bf16(a_of, b_of, k, nt)
        assert (uses_a == 1).all() and (uses_b == 1).all(), name
        want = _bf16(a_mat).astype(np.float64) @ _bf16(b_mat).astype(np.float64)
        np.testing.assert_allclose(c, want, rtol=1e-12, atol=1e-18, err_msg=name)
        exact = a_mat.astype(np.float64) @ b_mat.astype(np.float64)
        scale = np.abs(exact).max()
        assert np.abs(c - exact).max() / scale > 1e-3, name
        ab, bb = _tf32(a_mat), _tf32(b_mat)
        f64 = lambda x, y: x.astype(np.float64) @ y.astype(np.float64)  # noqa: E731
        three = f64(_tf32(a_mat - ab), bb) + f64(ab, _tf32(b_mat - bb)) + f64(ab, bb)
        assert np.abs(three - exact).max() / scale <= 1e-6, name


@pytest.mark.parametrize("valid", [(1.0, 1.0, 1.0, 0.0), (0.0, 0.0, 0.0, 0.0)])
def test_host_default_precision_math_matches_the_rounded_twin(host_lib, valid):
    """The kernels' math in the default precision (BF16, field_common.cuh
    with the bf16 forms of the host products and sink): K1's two passes,
    each instance's reverse sweep seeded with its union cotangent; K3's
    one-tangent forward; K2's recompute, reverse and weight-gradient sums;
    against the twin at "default" (bf16_matmul). Each output within 1e-4 of
    the rounded twin in RMS relative to scale (the host measures at most
    4.1e-5, dloc in the frame with no valid instance: the scalar products
    sum in another order than the twin's, so a few operands round apart),
    and grad_x u, u_dot and the weights' pullback at least 10x nearer it
    than the strict twin (the host measures 75x and more)."""
    x = _inputs(seed=4, valid=valid)

    def rms(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2))) / max(float(np.abs(b).max()), 1.0)

    host = [*_host_forward_rev(host_lib, x, True, bf16=True),
            *_host_backward(host_lib, x, True, bf16=True),
            *_host_dir_forward(host_lib, x, True, bf16=True)]
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights", "u3", "w3", "u_dot")
    twins = {}
    for precision in ("default", "highest"):
        u, w, g, *grads = _twin_pullback(x, True, precision=precision)
        dirf = tff.scene_eval_dir(*(_t(x[k]) for k in ("pos", "dirs", "loc", "rot", "half",
                                                       "valid")),
                                  _t(x["w"]), torch.tensor(TAU), precision=precision)
        twins[precision] = [u, w, g, grads[0], grads[1], grads[2], grads[3],
                            *(t.numpy() for t in dirf)]
    for name, got, rounded, strict in zip(names, host, twins["default"], twins["highest"]):
        assert rms(got, rounded) <= 1e-4, name
        if name in ("grad", "u_dot", "dweights"):
            assert rms(got, strict) >= 10 * rms(got, rounded), name


@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("num_valid", [0, 6])
def test_host_dir_forward_math_matches_float64_twin_at_100m(host_lib, use_rdf, num_valid):
    """K3's per-point math (instance_dir with scalar products, box_dir,
    dir_union) at the main path's magnitudes, against the twin in float64.
    At 100 m the f32 local coordinates carry ~6e-6 m of rounding, a phase
    error of ~2e-5 at the top frequency (128 pi / 100 m), and with no valid
    instance the uniform union weighs each instance's tangent by up to
    |1 + (u - d_i) / tau|: so u_dot is held to 1e-4 relative to scale, and
    to within twice the float32 twin's own error (+ 1e-5). u to 1e-6
    relative to scale; w to 2e-5 absolute, the f32 spacing of the logits
    -d/tau (up to 200) that the weights inherit."""
    x = _far_inputs(num_valid=num_valid)
    u, w, ud = _host_dir_forward(host_lib, x, use_rdf)
    u2, w2, ud2 = _twin64_dir(x, use_rdf)
    twin32 = tff.scene_eval_dir(*(_t(x[k]) for k in ("pos", "dirs", "loc", "rot", "half",
                                                     "valid")),
                                _t(x["w"]) if use_rdf else None, torch.tensor(TAU))
    assert _err(u, u2) <= 1e-6
    np.testing.assert_allclose(w, w2, atol=2e-5, rtol=0)
    assert _err(ud, ud2) <= min(1e-4, 2 * _err(twin32[2].numpy(), ud2) + 1e-5)


def _smoke_frame_with_no_valid_instance():
    """chip_smoke.py's K4b frame with no valid instance (frame 1 of its
    kernel phase's coarse pass: 99,000 points out to 100 m, N=8), built by
    bench_common.field_inputs on the CPU."""
    from vsrd_tpu_torch.scripts import bench_common

    x = bench_common.field_inputs(99_000, num_valid=0, seed=1 + 100, device="cpu")
    return {("w" if k == "weights" else k): v.numpy() for k, v in x.items()
            if k in ("pos", "dirs", "loc", "rot", "half", "valid", "weights")}


def test_host_dir_forward_holds_the_smoke_frame_with_no_valid_instance(host_lib):
    """The frame where the card's K4b reads its largest u_dot error against
    the float64 twin (chip_smoke.py, residual field), through the host build
    of K3's math (instance_dir with scalar products) in both of its
    encodings: the kernel's, which divides by the position scale (Scaler),
    and the one of K2's first stage in the strict mode, which multiplies by
    the rounded 1 / scale (as K1 does). Their errors relative to scale are
    printed (``pytest -s``). The first stays within half the card's 2e-4
    bar, leaving the other half to the tensor-core products; the second
    within the bar."""
    x = _smoke_frame_with_no_valid_instance()
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    chunks = [_twin64_dir({**x, "pos": x["pos"][s:s + 11_000], "dirs": x["dirs"][s:s + 11_000]},
                          True)[2] for s in range(0, p, 11_000)]
    ref = np.concatenate(chunks)
    _, _, ud = _host_dir_forward(host_lib, x, True)
    rounded = np.zeros(p, np.float32)
    host_lib.host_dir_forward_rounded(p, n, *map(_ptr, (x["pos"], x["dirs"], x["loc"], x["rot"],
                                                        x["half"], x["valid"], x["w"])),
                                      TAU, SCALE, _ptr(rounded))
    forms = {"Scaler": ud, "rounded 1 / scale": rounded}
    errs = {k: _err(a, ref) for k, a in forms.items()}
    tails = {k: np.quantile(np.abs(a - ref), 0.999) / max(float(np.abs(ref).max()), 1.0)
             for k, a in forms.items()}
    print("u_dot rel err against the float64 twin, chip_smoke.py's K4b frame 1 (max, 99.9th "
          "percentile): " + ", ".join(f"{k} {errs[k]:.3e}, {tails[k]:.3e}" for k in errs))
    assert errs["Scaler"] <= 1e-4 and errs["rounded 1 / scale"] <= 2e-4


def _dir_union_derivative(products, points=2048, n=8, seed=0):
    """u and u_dot = <dir, grad_x u> of the one-tangent forward, in float64,
    with every layer product that the K3 kernel runs on the tensor cores
    (W_l [a | ta] for layers 0-3, the value and its tangent as two column
    blocks) computed by ``products(A, B)`` on float32 operands; layer 4 and
    all per-point work stay exact. Inputs as ``_far_inputs``: points out to
    100 m along their rays, no valid instance, so the union is uniform and
    weighs each instance's tangent by up to |1 + (u - d_i) / tau|."""
    from math import erf

    x = {k: v.astype(np.float64) for k, v in _far_inputs(n, points, seed).items()}
    pos, dirs = x["pos"], x["dirs"]
    cdf_of = np.vectorize(lambda v: 0.5 * (1.0 + erf(v / np.sqrt(2.0))))
    mm = lambda a, b: products(a.astype(np.float32), b.astype(np.float32))  # noqa: E731
    distances, tangents = [], []
    for i in range(n):
        flat = x["w"][i]
        mats = [flat[:16 * 49].reshape(16, 49)]
        mats += [flat[16 * 49 + j * 272:16 * 49 + (j + 1) * 272].reshape(16, 17) for j in range(3)]
        last = flat[16 * 49 + 3 * 272:]
        rot = x["rot"][i]
        local, tl = (pos - x["loc"][i]) @ rot, dirs @ rot
        sign, q = np.sign(local), np.abs(local) - x["half"][i]
        r = np.maximum(q, 0.0)
        outside = np.sqrt((r ** 2).sum(-1) + 1e-6)
        gate = (q.max(-1) < 0).astype(np.float64)
        d = outside - np.maximum(-q.max(-1), 0.0)
        grad_local = sign * (r / outside[:, None] + gate[:, None] * np.eye(3)[np.argmax(q, -1)])
        td = (grad_local * tl).sum(-1)
        sym = np.stack([np.abs(local[:, 0]), local[:, 1], local[:, 2]]) / SCALE   # [3, P]
        tsym = np.stack([sign[:, 0] * tl[:, 0], tl[:, 1], tl[:, 2]]) / SCALE
        freq = np.pi * 2.0 ** np.arange(8)
        phase = sym[:, None, :] * freq[None, :, None]                              # [3, 8, P]
        tphase = tsym[:, None, :] * freq[None, :, None]
        enc = np.stack([np.cos(phase), np.sin(phase)], 2).reshape(48, points)
        tenc = np.stack([-np.sin(phase) * tphase, np.cos(phase) * tphase], 2).reshape(48, points)
        both = mm(mats[0][:, :48], np.concatenate([enc, tenc], 1))
        h, th = both[:, :points] + mats[0][:, 48:], both[:, points:]
        for layer in (*mats[1:], None):
            centered = h - h.mean(0)
            istd = 1.0 / np.sqrt((centered ** 2).mean(0) + 1e-5)
            y, tc = centered * istd, th - th.mean(0)
            ty = istd * (tc - y * (y * tc).mean(0))
            cdf = cdf_of(y)
            a, ta = y * cdf, (cdf + y * np.exp(-0.5 * y * y) / np.sqrt(2 * np.pi)) * ty
            if layer is None:
                break
            both = mm(layer[:, :16], np.concatenate([a, ta], 1))
            h, th = both[:, :points] + layer[:, 16:], both[:, points:]
        sig = 1.0 / (1.0 + np.exp(1.0 - (last[:16] @ a + last[16])))
        distances.append(d + sig)
        tangents.append(td + sig * (1.0 - sig) * (last[:16] @ ta))
    d, td = np.stack(distances, -1), np.stack(tangents, -1)
    w = np.full_like(d, 1.0 / n)
    u = (w * d).sum(-1)
    return u, (w * td * (1.0 + (u[:, None] - d) / TAU)).sum(-1)


def test_dir_forward_products_need_the_split_tf32_products():
    """K3's layer products on the tensor cores, value and tangent blocks
    alike, emulated in numpy at the main path's magnitudes
    (``_dir_union_derivative``): one TF32 product per term breaks the 2e-4
    bar on u_dot relative to its scale, the 3xTF32 split (big*big +
    big*small + small*big) stays within 2e-6. Products of TF32 operands are
    exact in f32, and the sums run in float64, so that what is measured is
    the operands' rounding alone."""
    f64 = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)  # noqa: E731

    def one(a, b):
        return f64(_tf32(a), _tf32(b))

    def three(a, b):
        ab, bb = _tf32(a), _tf32(b)
        return f64(_tf32(a - ab), bb) + f64(ab, _tf32(b - bb)) + f64(ab, bb)

    u, ud = _dir_union_derivative(f64)
    scale = max(float(np.abs(ud).max()), 1.0)
    u1, ud1 = _dir_union_derivative(one)
    u3, ud3 = _dir_union_derivative(three)
    assert float(np.abs(ud1 - ud).max()) / scale > 2e-4
    assert float(np.abs(ud3 - ud).max()) / scale <= 2e-6
    assert float(np.abs(u3 - u).max()) <= 2e-6


class _ReverseProducts(torch.autograd.Function):
    """C = W B in float64; in the backward the input cotangent W^T G goes
    through ``products`` on float32 operands (the backward kernel's reverse
    products on the tensor cores), the weight cotangent G B^T stays exact."""

    @staticmethod
    def forward(ctx, w, b, products):
        ctx.save_for_backward(w, b)
        ctx.products = products
        return w @ b

    @staticmethod
    def backward(ctx, g):
        w, b = ctx.saved_tensors
        gb = ctx.products(w.T.numpy().astype(np.float32), g.numpy().astype(np.float32))
        return g @ b.T, torch.from_numpy(np.asarray(gb, np.float64)), None


def _backward_weight_cotangent(products, points=2048, n=8, seed=0):
    """The weights' cotangent [n, 1617] of sum_p dbar d + tdbar td, d and td
    the one-tangent forward (instance_dir's) of each instance along the unit
    directions, in float64 by autograd, with every product that the backward
    kernel's reverse runs on the tensor cores (W_l^T [hbar | thbar] for
    layers 3..0, the value and tangent cotangents as two column blocks)
    computed by ``products(A, B)`` on float32 operands; everything else,
    the weight-cotangent sums included, exact. Inputs as ``_far_inputs``:
    points out to 100 m along their rays, where the encoding's top frequency
    reaches 128 pi; the cotangents dbar and tdbar heavy-tailed, as the
    union's are."""
    x = {k: torch.from_numpy(v.astype(np.float64)) for k, v in _far_inputs(n, points, seed).items()}
    rng = np.random.default_rng(seed + 1)
    dbar = torch.from_numpy(rng.standard_t(2.5, size=(n, points)) * 0.1)
    tdbar = torch.from_numpy(rng.standard_t(2.5, size=(n, points)) * 0.1)
    weights = x["w"].clone().requires_grad_()
    pos, dirs = x["pos"], x["dirs"]
    freq = torch.pi * 2.0 ** torch.arange(8, dtype=torch.float64)
    loss = 0.0
    for i in range(n):
        flat = weights[i]
        mats = [flat[:16 * 49].reshape(16, 49)]
        mats += [flat[16 * 49 + j * 272:16 * 49 + (j + 1) * 272].reshape(16, 17) for j in range(3)]
        last = flat[16 * 49 + 3 * 272:]
        rot = x["rot"][i]
        local, tl = (pos - x["loc"][i]) @ rot, dirs @ rot
        sign = torch.sign(local)
        sym = torch.stack([local[:, 0].abs(), local[:, 1], local[:, 2]]) / SCALE   # [3, P]
        tsym = torch.stack([sign[:, 0] * tl[:, 0], tl[:, 1], tl[:, 2]]) / SCALE
        phase = sym[:, None, :] * freq[None, :, None]                              # [3, 8, P]
        tphase = tsym[:, None, :] * freq[None, :, None]
        enc = torch.stack([phase.cos(), phase.sin()], 2).reshape(48, points)
        tenc = torch.stack([-phase.sin() * tphase, phase.cos() * tphase], 2).reshape(48, points)
        both = _ReverseProducts.apply(mats[0][:, :48], torch.cat([enc, tenc], 1), products)
        h, th = both[:, :points] + mats[0][:, 48:], both[:, points:]
        for layer in (*mats[1:], None):
            centered = h - h.mean(0)
            istd = 1.0 / torch.sqrt((centered ** 2).mean(0) + 1e-5)
            y, tc = centered * istd, th - th.mean(0)
            ty = istd * (tc - y * (y * tc).mean(0))
            cdf = 0.5 * (1.0 + torch.erf(y / np.sqrt(2.0)))
            a = y * cdf
            ta = (cdf + y * torch.exp(-0.5 * y * y) / np.sqrt(2 * np.pi)) * ty
            if layer is None:
                break
            both = _ReverseProducts.apply(layer[:, :16], torch.cat([a, ta], 1), products)
            h, th = both[:, :points] + layer[:, 16:], both[:, points:]
        sig = torch.sigmoid(last[:16] @ a + last[16] - 1.0)
        d = sig          # the box's part carries no product
        td = sig * (1.0 - sig) * (last[:16] @ ta)
        loss = loss + (dbar[i] * d).sum() + (tdbar[i] * td).sum()
    return torch.autograd.grad(loss, weights)[0].numpy()


def test_backward_reverse_products_need_the_split_tf32_products():
    """The backward kernel's reverse products W_l^T [hbar | thbar] (the value
    and tangent cotangents as two column blocks, layer 0's one coordinate at
    a time), emulated in numpy at the main path's magnitudes
    (``_backward_weight_cotangent``): one TF32 product per term moves the
    weights' cotangent by more than 2e-4 of its scale, the 3xTF32 split
    (big*big + big*small + small*big) by at most 2e-6. Products of TF32
    operands are exact in f32, and the sums run in float64, so that what is
    measured is the operands' rounding alone. Then the bf16 form, from the
    lanes' registers by the PTX ISA's fragment layout (``_warp_product_bf16``):
    the reverse W_l^T [hbar | thbar] over a warp's 32 value and 32 tangent
    columns, layer 0's W_0^T of one coordinate, and the per-warp weight
    cotangent [hbar | thbar] [a | ta]^T over the same 64 columns each read
    every element of both operands exactly once, rounded to bf16, so each
    product is bf16(A) bf16(B) with exact products."""
    f64 = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)  # noqa: E731

    def one(a, b):
        return f64(_tf32(a), _tf32(b))

    def three(a, b):
        ab, bb = _tf32(a), _tf32(b)
        return f64(_tf32(a - ab), bb) + f64(ab, _tf32(b - bb)) + f64(ab, bb)

    exact = _backward_weight_cotangent(f64)
    scale = max(float(np.abs(exact).max()), 1e-30)
    assert float(np.abs(_backward_weight_cotangent(one) - exact).max()) / scale > 2e-4
    assert float(np.abs(_backward_weight_cotangent(three) - exact).max()) / scale <= 2e-6

    rng = np.random.default_rng(1)
    w0 = (rng.normal(size=(16, 49)) * 0.3).astype(np.float32)     # layer 0, bias last
    w = (rng.normal(size=(16, 17)) * 0.3).astype(np.float32)      # a hidden layer
    cot = (rng.standard_t(2.5, size=(16, 64)) * 1e-3).astype(np.float32)  # [hbar | thbar]
    act = np.tanh(rng.normal(size=(16, 64))).astype(np.float32)   # [a | ta]
    m = 2
    cases = {
        "reverse W^T [hbar | thbar]": (lambda r, k: w[k, r], lambda r, n: cot[r, n], 16, 8,
                                       w[:, :16].T, cot),
        "layer 0's W_0^T of coordinate m": (lambda r, k: w0[k, 16 * m + r],
                                            lambda r, n: cot[r, n], 16, 8,
                                            w0[:, 16 * m:16 * m + 16].T, cot),
        "weight cotangent [hbar | thbar] [a | ta]^T": (lambda r, k: cot[r, k],
                                                       lambda k, n: act[n, k], 64, 2,
                                                       cot, act.T),
    }
    for name, (a_of, b_of, k, nt, a_mat, b_mat) in cases.items():
        c, uses_a, uses_b = _warp_product_bf16(a_of, b_of, k, nt)
        assert (uses_a == 1).all() and (uses_b == 1).all(), name
        want = _bf16(a_mat).astype(np.float64) @ _bf16(b_mat).astype(np.float64)
        np.testing.assert_allclose(c, want, rtol=1e-12, atol=1e-18, err_msg=name)


def _field_args(x, device, use_rdf=True):
    c = {k: _t(v).to(device) for k, v in x.items()}
    return (c["pos"], c["loc"], c["rot"], c["half"], c["valid"], c["w"] if use_rdf else None,
            torch.tensor(TAU, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n, p, valid", [
    (8, 3000, (1.0,) * 6 + (0.0,) * 2),   # the main path's shape
    (10, 3000, (1.0,) * 9 + (0.0,)),      # the largest N of the 384-thread CTAs
    (12, 3000, (1.0,) * 11 + (0.0,)),     # N > 10: the 128-thread CTAs
    (4, 3000, (0.0,) * 4),                # no valid instance: uniform weights
    (5, 2777, (1.0,) * 4 + (0.0,)),       # P not a multiple of the 128-point tiles
    (1, 2777, (1.0,)),                    # one instance: w's rows are one float wide
    (16, 3000, (1.0,) * 12 + (0.0,) * 4),  # the driver's instance buckets
    (24, 3000, (1.0,) * 20 + (0.0,) * 4),
    (32, 2777, (1.0,) * 30 + (0.0,) * 2),
])
def test_rev_forward_matches_float64_twin_on_card(cuda, use_rdf, n, p, valid):
    """K1 (tensor-core layer products in 3xTF32) against the twin in
    float64, with its CTA size and shared memory at N, counted by its
    launch counter."""
    x = _inputs(n=n, p=p, valid=valid, seed=5)
    threads, smem, ctas = fk.rev_forward_info(n, use_rdf)
    assert threads == (384 if use_rdf and n <= 10 else 128) and smem <= 232_448 and ctas >= 1
    before = fk.field_forward.launches
    got = [t.cpu().numpy() for t in fk.field_forward(*_field_args(x, cuda, use_rdf))]
    assert fk.field_forward.launches == before + 1
    for name, a, b in zip(("u", "w", "grad"), got, _twin64(x, use_rdf, cuda)):
        assert _err(a, b) <= 2e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
def test_rev_forward_is_repeatable_and_one_frame_batched_is_the_single_launch_on_card(
        cuda, use_rdf):
    """No atomics, sums in a fixed order: two launches agree bit for bit,
    and F=1 through the batched entry point is the single-frame launch."""
    x = _inputs(n=8, p=5000, valid=(1.0,) * 6 + (0.0,) * 2)
    args = _field_args(x, cuda, use_rdf)
    first, second = fk.field_forward(*args), fk.field_forward(*args)
    batched = fk.field_forward(*[t if t is None or t.ndim == 0 else t[None] for t in args])
    for a, b, c in zip(first, second, batched):
        assert torch.equal(a, b) and torch.equal(c[0], a)


@pytest.mark.gpu
def test_rev_forward_keeps_frames_apart_on_card(cuda):
    """K4a at F=3 frames of N=5 with ragged validity (4, 0 and 5 valid) and
    P=2,777: each frame against the float64 twin, and changing one frame's
    inputs leaves the others' outputs bit for bit."""
    x = _batched_inputs((4, 0, 5), n=5, p=2777, seed=3)
    args = _field_args(x, cuda)
    before = fk.field_forward.batched_launches
    got = [t.cpu().numpy() for t in fk.field_forward(*args)]
    assert fk.field_forward.batched_launches == before + 1
    for f in range(3):
        ref = _twin64({k: v[f] for k, v in x.items()}, True, cuda)
        for name, a, b in zip(("u", "w", "grad"), got, ref):
            assert _err(a[f], b) <= 2e-4, (name, f)
    moved = dict(x, pos=x["pos"].copy(), w=x["w"].copy())
    moved["pos"][2] += 1.0
    moved["w"][2] *= 0.5
    for a, b in zip(fk.field_forward(*_field_args(moved, cuda)), got):
        a = a.cpu().numpy()
        np.testing.assert_array_equal(a[:2], b[:2])
        assert not np.array_equal(a[2], b[2])


def _dir_args(x, device, use_rdf=True):
    c = {k: _t(v).to(device) for k, v in x.items()}
    return (c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, torch.tensor(TAU, device=device))


def _twin64_dir(x, use_rdf, device="cpu"):
    """The twin's (u, w, u_dot) in float64 on the same float32 inputs."""
    c = {k: _t(v).to(device, torch.float64) for k, v in x.items()}
    outs = tff.scene_eval_dir(c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
                              c["w"] if use_rdf else None,
                              torch.tensor(TAU, dtype=torch.float64, device=device))
    return [t.cpu().numpy() for t in outs]


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n, p, valid", [
    (8, 3000, (1.0,) * 6 + (0.0,) * 2),   # the main path's shape
    (10, 3000, (1.0,) * 9 + (0.0,)),
    (12, 3000, (1.0,) * 11 + (0.0,)),
    (4, 3000, (0.0,) * 4),                # no valid instance: uniform weights
    (5, 2777, (1.0,) * 4 + (0.0,)),       # P not a multiple of the CTA's points
    (64, 600, (1.0,) * 63 + (0.0,)),      # the largest N: 128-thread CTAs with the field
    (1, 2777, (1.0,)),                    # one instance: w's rows are one float wide
    (2, 2777, (1.0, 0.0)),
])
def test_dir_forward_matches_float64_twin_on_card(cuda, use_rdf, n, p, valid):
    """K3 (value and tangent as two column blocks of 3xTF32 tensor-core
    products) against the twin in float64, with its CTA size and shared
    memory at N, counted by its launch counters."""
    x = _inputs(n=n, p=p, valid=valid, seed=6)
    threads, smem, ctas = fk.dir_forward_info(n, use_rdf)
    assert threads % 32 == 0 and smem <= 232_448 and ctas >= 1
    fn = fk.field_dir_forward
    before = (fn.launches, fn.rdf_launches)
    got = [t.cpu().numpy() for t in fn(*_dir_args(x, cuda, use_rdf))]
    assert (fn.launches, fn.rdf_launches) == (before[0] + 1, before[1] + int(use_rdf))
    for name, a, b in zip(("u", "w", "u_dot"), got, _twin64_dir(x, use_rdf, cuda)):
        assert _err(a, b) <= 2e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
def test_dir_forward_is_repeatable_and_one_frame_batched_is_the_single_launch_on_card(
        cuda, use_rdf):
    """No atomics, sums in a fixed order: two launches agree bit for bit,
    and F=1 through the batched entry point is the single-frame launch."""
    x = _inputs(n=8, p=5000, valid=(1.0,) * 6 + (0.0,) * 2)
    args = _dir_args(x, cuda, use_rdf)
    first, second = fk.field_dir_forward(*args), fk.field_dir_forward(*args)
    batched = fk.field_dir_forward(*[t if t is None or t.ndim == 0 else t[None] for t in args])
    for a, b, c in zip(first, second, batched):
        assert torch.equal(a, b) and torch.equal(c[0], a)


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
def test_dir_forward_keeps_frames_apart_on_card(cuda, use_rdf):
    """K4b at F=3 frames of N=5 with ragged validity (4, 0 and 5 valid) and
    P=2,777: each frame against the float64 twin, and changing one frame's
    inputs leaves the others' outputs bit for bit."""
    x = _batched_inputs((4, 0, 5), n=5, p=2777, seed=3)
    before = fk.field_dir_forward.batched_launches
    got = [t.cpu().numpy() for t in fk.field_dir_forward(*_dir_args(x, cuda, use_rdf))]
    assert fk.field_dir_forward.batched_launches == before + 1
    for f in range(3):
        ref = _twin64_dir({k: v[f] for k, v in x.items()}, use_rdf, cuda)
        for name, a, b in zip(("u", "w", "u_dot"), got, ref):
            assert _err(a[f], b) <= 2e-4, (name, f)
    moved = dict(x, pos=x["pos"].copy(), w=x["w"].copy())
    moved["pos"][2] += 1.0
    moved["w"][2] *= 0.5
    for a, b in zip(fk.field_dir_forward(*_dir_args(moved, cuda, use_rdf)), got):
        a = a.cpu().numpy()
        np.testing.assert_array_equal(a[:2], b[:2])
        assert not np.array_equal(a[2], b[2])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [9, 16, 24, 32, 50, 64, 65, 100, 128])
def test_jv_kernel_matches_its_twin_on_card(cuda, n):
    """The JV kernel (csrc/matching.cu) against its plain twin on 8 frames
    of padded costs (valid counts below n, one frame of tied costs): the
    same row_to_col entry for entry, from ONE launch for the batch; one
    frame alone equals its row of the batch. n <= 64 runs the 3-slot
    instantiation, 65-128 the 5-slot one with 64 KB of dynamic shared
    memory."""
    rng = np.random.default_rng(n)
    cost = rng.normal(size=(8, n, n)).astype(np.float32)
    cost[1] = np.round(cost[1] * 2.0) / 2.0
    counts = np.concatenate([[n, n - 1], rng.integers(1, n + 1, size=6)])
    valid = torch.from_numpy(np.arange(n)[None, :] < counts[:, None])
    cost = torch.from_numpy(cost)
    before = tmatch.jv_assignment.launches
    got = tmatch.masked_linear_sum_assignment(cost.to(cuda), valid.to(cuda), valid.to(cuda))
    assert tmatch.jv_assignment.launches == before + 1
    want = tmatch.masked_linear_sum_assignment(cost, valid, valid)
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    padded = torch.where(valid[3][:, None] & valid[3][None, :], cost[3], tmatch.PAD_COST)
    assert torch.equal(tmatch.jv_assignment(padded.to(cuda)).cpu(), want[3])


def _detr_batch(b, n, hw, seed):
    rng = np.random.default_rng(seed)
    corner = rng.uniform(0.1, 0.6, size=(b, n, 2)).astype(np.float32)
    k = np.asarray([[552.5, 0, hw[1] / 2], [0, 552.5, hw[0] / 2], [0, 0, 1]], np.float32)
    return {
        "images": torch.from_numpy(rng.random((b, *hw, 3)).astype(np.float32)),
        "intrinsics": torch.from_numpy(np.broadcast_to(k * hw[1] / 1408, (b, 3, 3)).copy()),
        "labels": torch.zeros(b, n, dtype=torch.int32),
        "boxes_2d": torch.from_numpy(np.concatenate([corner, corner + 0.2], -1)),
        "boxes_3d": torch.from_numpy((rng.normal(size=(b, n, 8, 3)) * 2 + [0, 1, 20]).astype(
            np.float32)),
        "valid": torch.from_numpy(np.arange(n)[None] < rng.integers(1, n + 1, size=(b, 1))),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [1, 3])
def test_jv_kernel_takes_the_detr_costs_on_card(cuda, levels):
    """The DETR loss's matching shape: 8 images x ``levels`` decoder levels of
    [50, 50] costs (up to 16 targets in the first columns, 0 in the rest)
    in ONE launch, equal to the twin entry for entry."""
    from vsrd_tpu_torch.models import detr3d

    torch.manual_seed(levels)
    batch = _detr_batch(8, 16, (64, 96), levels)
    costs = torch.cat([detr3d.matching_cost(
        {"logits": torch.randn(8, 50, 2), "boxes_2d": torch.rand(8, 50, 4)},
        batch["labels"], batch["boxes_2d"], batch["valid"]) for _ in range(levels)])
    assert costs.shape == (8 * levels, 50, 50)
    before = tmatch.jv_assignment.launches
    got = tmatch.linear_sum_assignment(costs.to(cuda))
    assert tmatch.jv_assignment.launches == before + 1
    assert torch.equal(got.cpu(), tmatch.linear_sum_assignment_twin(costs))


@pytest.mark.gpu
@pytest.mark.parametrize("pad_cost", [0.0, tmatch.PAD_COST])
def test_jv_kernel_takes_the_published_detr_costs_on_card(cuda, pad_cost):
    """The published DETR loss's matching shape: 6 decoder levels x 8 images
    of [100, 100] costs (GIoU, up to 32 targets in the first columns, the
    rest padded with ``pad_cost``: the loss's 0, and the large pad of the
    labeling loss's matching) in ONE launch, equal to the twin entry for
    entry."""
    from vsrd_tpu_torch.models import detr3d

    torch.manual_seed(int(pad_cost))
    batch = _detr_batch(8, 32, (64, 96), 5)
    costs = torch.cat([detr3d.matching_cost(
        {"logits": torch.randn(8, 100, 2), "boxes_2d": torch.rand(8, 100, 4)},
        batch["labels"], batch["boxes_2d"], batch["valid"], giou=True) for _ in range(6)])
    assert costs.shape == (48, 100, 100)
    valid = torch.zeros(48, 100, dtype=torch.bool)
    valid[:, :32] = batch["valid"].repeat(6, 1)
    costs = torch.where(valid[:, None, :], costs, pad_cost)
    before = tmatch.jv_assignment.launches
    got = tmatch.linear_sum_assignment(costs.to(cuda))
    assert tmatch.jv_assignment.launches == before + 1
    assert torch.equal(got.cpu(), tmatch.linear_sum_assignment_twin(costs))


@pytest.mark.gpu
@pytest.mark.parametrize("deformable", [False, True])
def test_detector_forward_and_gradients_on_card_match_the_cpu(cuda, deformable):
    """The port's detector (hidden 64, 2+2 layers, 50 queries) on a 96x352
    batch of 4 on the card (f32) against the same weights on the CPU in
    float64, with that run's assignment injected: outputs and loss within
    2e-5 of each one's scale and gradients within 5e-4 of each leaf's for
    DETR3D, 2e-4 and 2e-3 for DeformableDETR3D, the bars of ``chip_smoke.py``
    (the deformable decoder amplifies f32 rounding layer by layer, on the
    card and in f32 on the CPU alike, which is why float64 is the
    reference). An attention key bias's gradient is zero in exact
    arithmetic, so it is held to the largest gradient."""
    from vsrd_tpu_torch.models import detr3d

    kwargs = dict(num_queries=50, hidden_dim=64, num_encoder_layers=2, num_decoder_layers=2,
                  num_heads=8)
    batch = _detr_batch(4, 12, (96, 352), 0)
    results, rows = {}, None
    for device, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        model = detr3d.make_detector("deformable" if deformable else "detr3d", seed=0,
                                     device="cpu", **kwargs).to(device, dtype)
        on = {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
              for k, v in batch.items()}
        out = model(on["images"], on["intrinsics"], aux_outputs=True)
        if rows is None:
            costs = torch.cat([detr3d.matching_cost(level, on["labels"], on["boxes_2d"],
                                                    on["valid"])
                               for level in [out] + out["aux_outputs"]])
            rows = tmatch.linear_sum_assignment(costs).reshape(2, 4, 50).unbind(0)
        loss, _ = detr3d.detr_loss(out, on["labels"], on["boxes_2d"], on["boxes_3d"],
                                   on["valid"], row_to_col=rows)
        loss.backward()
        results[dtype] = (
            {k: out[k].detach().double().cpu() for k in ("logits", "boxes_2d", "boxes_3d")},
            float(loss.detach()), {n: p.grad.double().cpu() for n, p in model.named_parameters()
                                   if p.grad is not None})
    (out_ref, loss_ref, grad_ref), (out_g, loss_g, grad_g) = (results[torch.float64],
                                                              results[torch.float32])
    out_bar, grad_bar = (2e-4, 2e-3) if deformable else (2e-5, 5e-4)
    for key, value in out_ref.items():
        err = float((out_g[key] - value).abs().max() / value.abs().max())
        assert err <= out_bar, (key, err)
    assert abs(loss_g - loss_ref) <= out_bar * abs(loss_ref), (loss_g, loss_ref)
    assert set(grad_g) == set(grad_ref)
    largest = max(float(g.abs().max()) for g in grad_ref.values())
    for name, value in grad_ref.items():
        scale = largest if name.endswith("key.bias") else float(value.abs().max())
        err = float((grad_g[name] - value).abs().max()) / scale
        assert err <= grad_bar, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("frames", [1, 3])
def test_sphere_trace_matches_twin_on_card(cuda, use_rdf, n, frames):
    """The sphere-trace kernel against the eager loop: one launch for all
    frames (frame 1 of 3 has no valid instance), the hard union and, at
    N = 8, the softmin union."""
    x = _trace_inputs(frames=frames, n=n, r=300, seed=n,
                      valid_counts=[max(n - 2, 1), 0, n][:frames])
    for tau in (None, TAU) if n == 8 else (None,):
        c = {k: _t(v).to(cuda) for k, v in x.items()}
        st = fk.sphere_trace
        before = (st.launches, st.batched_launches, st.rdf_launches, st.soft_launches)
        pos, conv, trips, _ = fk.sphere_trace(
            c["origins"], c["dirs"], c["fg"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, 300, 0.01, 30.0, tau, SCALE)
        after = (st.launches, st.batched_launches, st.rdf_launches, st.soft_launches)
        assert np.subtract(after, before).tolist() == [1, int(frames > 1), int(use_rdf),
                                                       int(tau is not None)]
        tpos, tconv, ttrips = _twin_trace(x, use_rdf, 300, tau)
        np.testing.assert_array_equal(trips.cpu().numpy(), ttrips)
        np.testing.assert_array_equal(conv.cpu().numpy(), tconv)
        _assert_trace_positions(pos.cpu().numpy(), tpos, tconv, tolerance=2e-4)


def _skip_inputs(n, p=3000, seed=0, frames=None, valid_counts=None):
    """A scene where group skipping drops groups: instance group g (8
    instances each, the last one partial where n is not a multiple of 8)
    sits 60 m down +z from group g - 1, the points come in coherent runs
    around one group after another, and the last instance is invalid. With
    ``frames``, per-frame scenes (frame f with ``valid_counts[f]`` valid
    instances) stacked on a leading axis."""
    if frames is not None:
        per = [_skip_inputs(n, p, seed + f, valid_counts=(valid_counts[f],))
               for f in range(frames)]
        return {k: np.stack([x[k] for x in per]) for k in per[0]}
    x = _inputs(n=n, p=p, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    groups = -(-n // 8)
    offset = np.float32(60.0)
    x["loc"] = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    x["loc"][:, 2] += offset * (np.arange(n) // 8)
    run = (np.arange(p) * groups) // p
    x["pos"] = (rng.normal(size=(p, 3)) * 4).astype(np.float32)
    x["pos"][:, 2] += offset * run
    count = n - 1 if valid_counts is None else valid_counts[0]
    x["valid"] = (np.arange(n) < count).astype(np.float32)
    return x


def _masked_pullback(x, use_rdf, device, field, mask):
    """(u, w, grad_x u) and the pullback of (du, dw, dg) through ``field``
    with the keep mask ``mask`` (``None``: no skip)."""
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    tau = torch.tensor(TAU, device=device)
    if field is fk.fused_field_with_grad:
        u, w, g = field(c["pos"], *params[:3], c["valid"], params[3] if use_rdf else None, tau,
                        group_mask=mask)
    else:
        u, w, g = field(c["pos"], *params[:3], c["valid"], params[3] if use_rdf else None, tau,
                        group_mask=mask, mask_tile=fk.MASK_TILE)
    loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    return [t.detach().cpu().numpy() for t in (u, w, g, *grads)]


def _skip_mask(x, device):
    c = {k: _t(v).to(device) for k, v in x.items()}
    return fk.group_mask_for(c["pos"], c["loc"], c["half"], c["valid"],
                             torch.tensor(TAU, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n", [16, 20, 24, 32])
def test_masked_kernels_match_masked_twins_on_card(cuda, use_rdf, n):
    """The skip mode: K1/K2 and K3 with a keep mask that drops the far
    groups of most tiles (N = 20: a partial last group) against the masked
    twins; a dropped instance's weight is exactly 0; and skip on against
    skip off, whose difference is the O(e^-12) the criterion allows."""
    x = _skip_inputs(n)
    mask = _skip_mask(x, cuda)
    assert mask.shape == (-(-n // 8), -(-3000 // fk.MASK_TILE))
    assert 0 < int(mask.sum()) < mask.numel()
    before = [(fn.launches, fn.skip_launches)
              for fn in (fk.field_forward, fk.field_backward, fk.field_dir_forward)]
    got = _masked_pullback(x, use_rdf, cuda, fk.fused_field_with_grad, mask)
    ref = _masked_pullback(x, use_rdf, cuda, tff.scene_eval_with_grad, mask)
    off = _masked_pullback(x, use_rdf, cuda, fk.fused_field_with_grad, None)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b, c in zip(names, got, ref, off):
        assert _err(a, b) <= 2e-4, name
        assert _err(a, c) <= 2e-4, (name, "skip off")
    dropped = ~tff.point_keep(mask, 3000, n, fk.MASK_TILE).cpu().numpy()
    assert dropped.any() and not got[1][dropped].any()
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = (c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, torch.tensor(TAU, device=cuda))
    outs = fk.fused_field_dir_forward(*args, group_mask=mask)
    for name, a, b, d in zip(("u", "w", "u_dot"), outs,
                             tff.scene_eval_dir(*args, group_mask=mask, mask_tile=fk.MASK_TILE),
                             fk.fused_field_dir_forward(*args)):
        assert _err(a.cpu().numpy(), b.cpu().numpy()) <= 2e-4, name
        assert _err(a.cpu().numpy(), d.cpu().numpy()) <= 2e-4, (name, "skip off")
    assert not outs[1].cpu().numpy()[dropped].any()
    after = [(fn.launches, fn.skip_launches)
             for fn in (fk.field_forward, fk.field_backward, fk.field_dir_forward)]
    # K1 and K2 twice (on, off), K3 twice (on, off): one of each with the mask
    assert [(a - b, c - d) for (a, c), (b, d) in zip(after, before)] == [(2, 1)] * 3


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n", [16, 20, 24, 32])
def test_masked_batched_kernels_match_masked_twins_on_card(cuda, use_rdf, n):
    """K4a/K4c and K4b with per-frame masks [F, G, T] on three frames (n - 1,
    0 and n valid; the frame with none keeps every group) against the
    masked twins frame by frame, and against skip off."""
    x = _skip_inputs(n, frames=3, valid_counts=(n - 1, 0, n))
    mask = _skip_mask(x, cuda)
    assert bool(mask[1].all()) and 0 < int(mask[0].sum()) < mask[0].numel()
    got = _masked_pullback(x, use_rdf, cuda, fk.fused_field_with_grad, mask)
    ref = _masked_pullback(x, use_rdf, cuda, tff.scene_eval_with_grad_batched, mask)
    off = _masked_pullback(x, use_rdf, cuda, fk.fused_field_with_grad, None)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b, c in zip(names, got, ref, off):
        for f in range(3):
            assert _err(a[f], b[f]) <= 2e-4, (name, f)
            assert _err(a[f], c[f]) <= 2e-4, (name, f, "skip off")
    c = {k: _t(v).to(cuda) for k, v in x.items()}
    args = (c["pos"], c["dirs"], c["loc"], c["rot"], c["half"], c["valid"],
            c["w"] if use_rdf else None, torch.tensor(TAU, device=cuda))
    before = fk.field_dir_forward.skip_launches
    outs = fk.fused_field_dir_forward(*args, group_mask=mask)
    assert fk.field_dir_forward.skip_launches == before + 1
    for name, a, b, d in zip(("u", "w", "u_dot"), outs,
                             tff.scene_eval_dir_batched(*args, group_mask=mask,
                                                        mask_tile=fk.MASK_TILE),
                             fk.fused_field_dir_forward(*args)):
        for f in range(3):
            assert _err(a[f].cpu().numpy(), b[f].cpu().numpy()) <= 2e-4, (name, f)
            assert _err(a[f].cpu().numpy(), d[f].cpu().numpy()) <= 2e-4, (name, f, "skip off")


@pytest.mark.gpu
def test_masked_launches_refuse_a_wrong_mask_on_card(cuda):
    """A mask of the wrong shape or type raises before any launch."""
    x = _skip_inputs(16)
    mask = _skip_mask(x, cuda)
    args = _field_args(x, cuda)
    before = fk.field_forward.launches
    for bad in (mask[:1], mask.float(), mask.cpu()):
        with pytest.raises(ValueError):
            fk.field_forward(*args, group_mask=bad)
    assert fk.field_forward.launches == before
