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
  (K1's sweep, K3's one-tangent forward, K2's weight-gradient sink), scalar
  loops in its place; K3's math also at the main path's magnitudes (100 m)
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
  its 128-thread CTAs with the residual field.

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
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from vsrd_tpu_torch.rendering import field_kernels as fk
from vsrd_tpu_torch.rendering import fused_field as tff

torch.set_num_threads(2)
TAU = 0.5
SCALE = 100.0

HARNESS = r"""
#include <vector>

#include "field_common.cuh"

using namespace vsrd;

namespace {

// dW_l[o][i] += hbar[o] a[i] + thbar[o] ta[i]; the bias column takes hbar[o]
struct HostSink {
  float* dW;
  void layer(int l, int in, int out, const float* a, const float* ta, const float* hbar,
             const float* thbar) {
    float* W = dW + layer_offset(l);
    for (int o = 0; o < out; ++o) {
      for (int i = 0; i < in; ++i) W[o * (in + 1) + i] += hbar[o] * a[i] + thbar[o] * ta[i];
      W[o * (in + 1) + in] += hbar[o];
    }
  }
};

// instance_rev's and instance_dir's layer products as scalar loops over one
// point's staging rows (rows: the value block, trows: the tangent block,
// which instance_rev leaves at 0); W: the instance's 1617 flattened weights
struct HostProduct {
  const float* W;
  float rows[kHid], c[kHid], held[kHid], trows[kHid] = {}, tc[kHid] = {};
  float& at(int r) { return rows[r]; }
  float& tan_at(int r) { return trows[r]; }
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
        c[o] += wv * rows[k];
        tc[o] += wv * trows[k];
      }
  }
  void reverse(int l) {
    for (int i = 0; i < kHid; ++i)
      for (int o = 0; o < kHid; ++o) c[i] += W[layer_offset(l) + o * (kHid + 1) + i] * rows[o];
  }
  void hold() {
    for (int o = 0; o < kHid; ++o) held[o] = rows[o];
  }
  void reverse0(int m) {
    for (int j = 0; j < kHid; ++j)
      for (int o = 0; o < kHid; ++o) c[j] += W[o * (kEnc + 1) + m * kHid + j] * held[o];
  }
  void store() {
    for (int o = 0; o < kHid; ++o) {
      rows[o] = c[o];
      trows[o] = tc[o];
    }
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

// world direction v in the frame of an instance with rotation R
void to_local(const float* v, const float* R, float t[3]) {
  for (int c = 0; c < 3; ++c) t[c] = v[0] * R[c] + v[1] * R[3 + c] + v[2] * R[6 + c];
}

}  // namespace

// K3's per-point loop: with the residual field instance_dir, the forward the
// kernel runs, with its layer products as scalar loops; box-only box_dir.
// Then the kernel's union (dir_union) over the point's row of logits,
// distances and tangents.
extern "C" void host_dir_forward(int P, int N, const float* pos, const float* dirs,
                                 const float* loc, const float* rot, const float* half,
                                 const float* valid, const float* W, float tau, float scale,
                                 float* u, float* w, float* u_dot) {
  const bool any_valid = any_valid_of(N, valid);
  const std::vector<float> misc = misc_blocks(N, W);
  std::vector<float> d(N), td(N);
  for (int p = 0; p < P; ++p) {
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) continue;
      const float* x = pos + 3 * p;
      const float* v = dirs + 3 * p;
      if (W) {
        HostProduct prod{W + i * kWeights};
        d[i] = instance_dir(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                            misc.data() + i * kRevMisc, Scaler(scale), prod, td[i]);
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

// The same function in the form K3 took before its tensor-core redesign:
// the scalar one-tangent instance_forward<1> and the online union, for the
// comparison of the two forms' rounding (u_dot only)
extern "C" void host_dir_forward_scalar(int P, int N, const float* pos, const float* dirs,
                                        const float* loc, const float* rot, const float* half,
                                        const float* valid, const float* W, float tau,
                                        float scale, float* u_dot) {
  const bool any_valid = any_valid_of(N, valid);
  for (int p = 0; p < P; ++p) {
    OnlineUnion<1> acc;
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) continue;
      float tl[1][3], td[1];
      to_local(dirs + 3 * p, rot + 9 * i, tl[0]);
      const float d = instance_forward<1>(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                          W ? W + i * kWeights : nullptr, 1.f / scale, tl, td);
      acc.add(union_logit(d, valid[i], tau), d, td);
    }
    float du[1];
    acc.finish(tau, du);
    u_dot[p] = du[0];
  }
}

// K1's per-point loop: with the residual field instance_rev, the sweep the
// kernel runs, with its layer products as scalar loops and its residuals
// in a strided column; box-only the box's analytic gradient, as on the card
extern "C" void host_forward_rev(int P, int N, const float* pos, const float* loc,
                                 const float* rot, const float* half, const float* valid,
                                 const float* W, float tau, float scale, float* u, float* w,
                                 float* grad) {
  const bool any_valid = any_valid_of(N, valid);
  std::vector<float> column(kRevResLayers * kRevRes * 2), misc = misc_blocks(N, W);
  for (int p = 0; p < P; ++p) {
    OnlineUnion<3> acc;
    for (int i = 0; i < N; ++i) {
      if (!instance_active(valid[i], any_valid)) {
        w[p * N + i] = 0.f;
        continue;
      }
      float g[3], d;
      if (W) {
        HostProduct prod{W + i * kWeights};
        d = instance_rev(pos + 3 * p, loc + 3 * i, rot + 9 * i, half + 3 * i,
                         misc.data() + i * kRevMisc, 1.f / scale, prod,
                         RevStore{column.data() + 1, 2}, g);
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

// K2's per-point work, summed over points in order: out [N, kParams]. As on
// the card, the weights are copied into the Padded layout and the LayerNorm
// residuals kept in a strided column.
extern "C" void host_backward(int P, int N, const float* pos, const float* dg, const float* du,
                              const float* dw, const float* loc, const float* rot,
                              const float* half, const float* valid, const float* W, float tau,
                              float scale, float* out) {
  std::vector<float> padded(W ? N * Padded::kSize : 0);
  for (int i = 0; W && i < N; ++i)
    for (int l = 0; l <= 4; ++l) {
      const int in = l == 0 ? kEnc : kHid, rows = l == 4 ? 1 : kHid;
      for (int o = 0; o < rows; ++o)
        for (int c = 0; c <= in; ++c)
          padded[i * Padded::kSize + Padded::at(l, o, c)] =
              W[i * kWeights + layer_offset(l) + o * (in + 1) + c];
    }
  constexpr int stride = 2;
  std::vector<float> column(4 * kRes * stride);
  const bool any_valid = any_valid_of(N, valid);
  std::vector<unsigned char> active(N);
  for (int i = 0; i < N; ++i) active[i] = instance_active(valid[i], any_valid);
  std::vector<float> d(N), td(N);
  for (int p = 0; p < P; ++p) {
    const float* x = pos + 3 * p;
    const float* v = dg + 3 * p;
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;
      float tl[1][3], t[1];
      to_local(v, rot + 9 * i, tl[0]);
      d[i] = instance_forward<1>(x, loc + 3 * i, rot + 9 * i, half + 3 * i,
                                 W ? W + i * kWeights : nullptr, 1.f / scale, tl, t);
      td[i] = t[0];
    }
    union_backward(N, active.data(), d.data(), td.data(), valid, tau, du[p], dw + p * N, 1);
    for (int i = 0; i < N; ++i) {
      if (!active[i]) continue;
      HostSink sink{out + i * kParams};
      float geo[kGeo] = {};
      instance_backward(x, v, loc + 3 * i, rot + 9 * i, half + 3 * i,
                        W ? padded.data() + i * Padded::kSize : nullptr, 1.f / scale, d[i],
                        td[i], geo, sink, ColumnStore{column.data(), stride});
      for (int k = 0; k < kGeo; ++k) out[i * kParams + kWeights + k] += geo[k];
    }
  }
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


def _twin_pullback(x, use_rdf, device="cpu"):
    """The twin's (u, w, grad_x u) and the pullback of (du, dw, dg) to
    (loc, rot, half[, weights])."""
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    u, w, g = tff.scene_eval_with_grad(c["pos"], *params[:3], c["valid"],
                                       params[3] if use_rdf else None,
                                       torch.tensor(TAU, device=device))
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
    lib.host_dir_forward.argtypes = [i32, i32] + [ptr] * 7 + [f32, f32] + [ptr] * 3
    lib.host_dir_forward_scalar.argtypes = [i32, i32] + [ptr] * 7 + [f32, f32, ptr]
    lib.host_backward.argtypes = [i32, i32] + [ptr] * 9 + [f32, f32, ptr]
    lib.host_forward_rev.argtypes = [i32, i32] + [ptr] * 6 + [f32, f32] + [ptr] * 3
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _host_dir_forward(lib, x, use_rdf):
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    u, w, ud = np.zeros(p, np.float32), np.zeros((p, n), np.float32), np.zeros(p, np.float32)
    lib.host_dir_forward(p, n, *map(_ptr, (x["pos"], x["dirs"], x["loc"], x["rot"], x["half"],
                                           x["valid"], x["w"] if use_rdf else None)),
                         TAU, SCALE, _ptr(u), _ptr(w), _ptr(ud))
    return u, w, ud


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


def _host_forward_rev(lib, x, use_rdf):
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    u, w, g = np.zeros(p, np.float32), np.zeros((p, n), np.float32), np.zeros((p, 3), np.float32)
    lib.host_forward_rev(p, n, *map(_ptr, (x["pos"], x["loc"], x["rot"], x["half"], x["valid"],
                                           x["w"] if use_rdf else None)),
                         TAU, SCALE, _ptr(u), _ptr(w), _ptr(g))
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
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    out = np.zeros((n, fk.NUM_WEIGHTS + 15), np.float32)
    host_lib.host_backward(p, n, *map(_ptr, (x["pos"], x["dg"], x["du"], x["dw"], x["loc"],
                                             x["rot"], x["half"], x["valid"],
                                             x["w"] if use_rdf else None)),
                           TAU, SCALE, _ptr(out))
    geo = out[:, fk.NUM_WEIGHTS:]
    got = [geo[:, 0:3], geo[:, 3:12].reshape(n, 3, 3), geo[:, 12:15], out[:, :fk.NUM_WEIGHTS]]
    ref = _twin_pullback(x, use_rdf)[3:]
    for name, a, b in zip(("dloc", "drot", "dhalf", "dweights"), got, ref):
        assert _err(a, b) <= 1e-4, name


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


def _kernel_pullback(x, use_rdf, device):
    c = {k: _t(v).to(device) for k, v in x.items()}
    params = [c[k].clone().requires_grad_() for k in ("loc", "rot", "half", "w")]
    if not use_rdf:
        params = params[:3]
    u, w, g = fk.fused_field_with_grad(c["pos"], *params[:3], c["valid"],
                                       params[3] if use_rdf else None,
                                       torch.tensor(TAU, device=device))
    loss = (u * c["du"]).sum() + (w * c["dw"]).sum() + (g * c["dg"]).sum()
    grads = torch.autograd.grad(loss, params)
    return [t.detach().cpu().numpy() for t in (u, w, g, *grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdf", [False, True])
@pytest.mark.parametrize("n, valid", [
    (8, (1.0,) * 6 + (0.0,) * 2),     # the main path's shape
    (12, (1.0,) * 11 + (0.0,)),       # two groups of staged weights
    (4, (0.0,) * 4),                  # no valid instance: uniform weights
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
def test_batched_kernels_match_twins_on_card(cuda, use_rdf):
    """K4a, K4c and K4b on three frames of 6, 0 and 8 valid instances: each
    frame against the twin, and one launch of each kernel for the batch."""
    x = _batched_inputs((6, 0, 8))
    launches = [(fn.launches, fn.batched_launches)
                for fn in (fk.field_forward, fk.field_backward, fk.field_dir_forward)]
    got = _batched_pullback(x, use_rdf, cuda, fk.fused_field_with_grad)
    ref = _batched_pullback(x, use_rdf, cuda, tff.scene_eval_with_grad_batched)
    names = ("u", "w", "grad", "dloc", "drot", "dhalf", "dweights")
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and a.shape[0] == 3, name
        for f in range(3):
            assert _err(a[f], b[f]) <= 2e-4, (name, f)
    np.testing.assert_allclose(got[1][1], 1.0 / 8, rtol=1e-6)   # no valid instance
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
    """Field inputs shaped like the main path's (``chip_smoke.field_inputs``):
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
    chip_smoke.field_inputs on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = smoke.field_inputs(99_000, num_valid=0, seed=1 + 100, device="cpu")
    return {("w" if k == "weights" else k): v.numpy() for k, v in x.items()
            if k in ("pos", "dirs", "loc", "rot", "half", "valid", "weights")}


def test_host_dir_forward_holds_the_smoke_frame_with_no_valid_instance(host_lib):
    """The frame where the card's K4b reads its largest u_dot error against
    the float64 twin (chip_smoke.py, residual field), through the host build
    of K3's math in both forms: instance_dir with scalar products (the
    kernel's) and the scalar one-tangent instance_forward<1> with the online
    union (K3's form before its tensor-core redesign). Their errors relative
    to scale are printed (``pytest -s``). instance_dir, whose encoding
    divides by the position scale (Scaler), stays within half the card's
    2e-4 bar, leaving the other half to the tensor-core products; the other
    form, which multiplies by the rounded 1 / scale, within the bar."""
    x = _smoke_frame_with_no_valid_instance()
    p, n = x["pos"].shape[0], x["loc"].shape[0]
    chunks = [_twin64_dir({**x, "pos": x["pos"][s:s + 11_000], "dirs": x["dirs"][s:s + 11_000]},
                          True)[2] for s in range(0, p, 11_000)]
    ref = np.concatenate(chunks)
    _, _, ud = _host_dir_forward(host_lib, x, True)
    scalar = np.zeros(p, np.float32)
    host_lib.host_dir_forward_scalar(p, n, *map(_ptr, (x["pos"], x["dirs"], x["loc"], x["rot"],
                                                       x["half"], x["valid"], x["w"])),
                                     TAU, SCALE, _ptr(scalar))
    errs = {"instance_dir": _err(ud, ref), "instance_forward<1>": _err(scalar, ref)}
    tails = {k: np.quantile(np.abs(a - ref), 0.999) / max(float(np.abs(ref).max()), 1.0)
             for k, a in (("instance_dir", ud), ("instance_forward<1>", scalar))}
    print("u_dot rel err against the float64 twin, chip_smoke.py's K4b frame 1 (max, 99.9th "
          "percentile): " + ", ".join(f"{k} {errs[k]:.3e}, {tails[k]:.3e}" for k in errs))
    assert errs["instance_dir"] <= 1e-4 and errs["instance_forward<1>"] <= 2e-4


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
