// Per-point math of the multi-instance scene field, shared by kernels K1-K3.
//
// One instance's signed distance at a point x:
//
//   local = R^T (x - loc)                              instance frame
//   d     = sqrt(|relu(q)|^2 + 1e-6) - relu(-max q),   q = |local| - half
//   (residual phase) d += sigmoid(MLP(enc) - 1), where enc holds
//   cos/sin(pi 2^k s_dim), s = (|l0|, l1, l2) / scale, k < 8, in the
//   reference channel order dim*16 + k*2 + (0 cos | 1 sin), and the MLP is
//   48 -> 16 -> 16 -> 16 -> 16 -> 1 with LayerNorm + exact GELU before
//   every layer but the first. Per instance the MLP is the flattened
//   hypernetwork output: 1617 floats, layer l an [out][in + 1] row-major
//   block with the bias last.
//
// The functions here carry tangents forward (K of them, seeded in the
// instance frame; K2's stage 1), run the value forward and its first-order
// reverse with respect to the position (K1/K4a), run the value forward with
// one tangent along the ray as a second column block of its layer products
// (K3/K4b), and, for the backward kernel, run the reverse sweep of the
// one-tangent forward. The per-point work is scalar f32 per thread, and the
// functions compile for the host too (without nvcc), so that the math is
// checked against the PyTorch twin on a machine without a GPU
// (tests/test_torch_kernels.py).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define VSRD_HD __host__ __device__ __forceinline__
#define VSRD_UNROLL _Pragma("unroll")
#else
#define VSRD_HD inline
#define VSRD_UNROLL
#endif

namespace vsrd {

constexpr int kFreq = 8;          // encoding frequencies
constexpr int kEnc = 6 * kFreq;   // 48 encoding channels
constexpr int kHid = 16;          // hidden width
constexpr int kWeights = 1617;    // flattened MLP weights per instance
constexpr int kGeo = 15;          // dloc 3 + drot 9 + dhalf 3
constexpr int kParams = kWeights + kGeo;  // per-instance cotangent row
constexpr int kGroup = 8;         // instances whose weights share memory

// offset of layer l's [out][in + 1] block in the flattened weights
VSRD_HD constexpr int layer_offset(int l) {
  return l == 0 ? 0 : kHid * (kEnc + 1) + (l - 1) * kHid * (kHid + 1);
}

VSRD_HD float frequency(int k) { return (float)(3.14159265358979323846 * (double)(1 << k)); }

VSRD_HD float signf(float x) { return (float)(x > 0.f) - (float)(x < 0.f); }

VSRD_HD float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// GELU(y) = y Phi(y) and its first two derivatives' factors.
struct Gelu {
  float cdf, pdf;
  VSRD_HD explicit Gelu(float y)
      : cdf(0.5f * (1.f + erff(y * 0.70710678118654752f))),
        pdf(expf(-0.5f * y * y) * 0.39894228040143268f) {}
};

// Box part of one instance: geometry and its tangents.
template <int K>
struct BoxEval {
  float rel[3], l[3], s[3], q[3], r[3];
  float o, d;
  int jmax;
  float gate;
  float tq[K][3], to[K], td[K];

  // tl[j][c]: d local_c along tangent j
  VSRD_HD BoxEval(const float x[3], const float* loc, const float* rot,
                  const float* half, const float tl[K][3]) {
    for (int k = 0; k < 3; ++k) rel[k] = x[k] - loc[k];
    for (int c = 0; c < 3; ++c) {
      l[c] = rel[0] * rot[c] + rel[1] * rot[3 + c] + rel[2] * rot[6 + c];
      s[c] = signf(l[c]);
      q[c] = fabsf(l[c]) - half[c];
      r[c] = fmaxf(q[c], 0.f);
    }
    o = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + 1e-6f);
    // max face with the JAX kernels' tie-break
    const int j01 = q[0] > q[1] ? 0 : 1;
    jmax = q[2] > q[j01] ? 2 : j01;
    gate = q[jmax] < 0.f ? 1.f : 0.f;
    d = o - fmaxf(-q[jmax], 0.f);
    for (int j = 0; j < K; ++j) {
      for (int c = 0; c < 3; ++c) tq[j][c] = s[c] * tl[j][c];
      to[j] = (r[0] * tq[j][0] + r[1] * tq[j][1] + r[2] * tq[j][2]) / o;
      td[j] = to[j] + gate * tq[j][jmax];
    }
  }
};

// LayerNorm (no affine) of h with tangents th; y = (h - mean) istd and
// ty = istd (tc - y P), tc = th - mean(th), P = mean(y tc).
template <int K>
VSRD_HD void layer_norm_fwd(const float h[kHid], const float th[K][kHid],
                            float y[kHid], float tc[K][kHid], float ty[K][kHid],
                            float& istd) {
  float mean = 0.f;
  for (int i = 0; i < kHid; ++i) mean += h[i];
  mean *= 1.f / kHid;
  float var = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] = h[i] - mean;
    var += y[i] * y[i];
  }
  istd = 1.f / sqrtf(var * (1.f / kHid) + 1e-5f);
  for (int i = 0; i < kHid; ++i) y[i] *= istd;
  for (int j = 0; j < K; ++j) {
    float tmean = 0.f;
    for (int i = 0; i < kHid; ++i) tmean += th[j][i];
    tmean *= 1.f / kHid;
    float p = 0.f;
    for (int i = 0; i < kHid; ++i) {
      tc[j][i] = th[j][i] - tmean;
      p += y[i] * tc[j][i];
    }
    p *= 1.f / kHid;
    for (int i = 0; i < kHid; ++i) ty[j][i] = istd * (tc[j][i] - y[i] * p);
  }
}

// Encoding of one (dim, k) pair: value (cos, sin) of phase f*sym.
VSRD_HD void enc_pair(float sym, int k, float& cs, float& sn) {
#if defined(__CUDACC__)
  sincosf(sym * frequency(k), &sn, &cs);
#else
  const float ph = sym * frequency(k);
  cs = cosf(ph);
  sn = sinf(ph);
#endif
}

// One instance's distance d and K directional derivatives td, for the
// tangent seeds tl (instance frame). W: the instance's 1617 weights, or
// nullptr for the box-only phase.
template <int K>
VSRD_HD float instance_forward(const float x[3], const float* loc, const float* rot,
                               const float* half, const float* W, float inv_scale,
                               const float tl[K][3], float td[K]) {
  BoxEval<K> box(x, loc, rot, half, tl);
  float d = box.d;
  for (int j = 0; j < K; ++j) td[j] = box.td[j];
  if (W == nullptr) return d;

  const float sym[3] = {fabsf(box.l[0]) * inv_scale, box.l[1] * inv_scale, box.l[2] * inv_scale};
  float tsym[K][3];
  for (int j = 0; j < K; ++j) {
    tsym[j][0] = box.s[0] * tl[j][0] * inv_scale;
    tsym[j][1] = tl[j][1] * inv_scale;
    tsym[j][2] = tl[j][2] * inv_scale;
  }

  // layer 0: encoding channels are produced and consumed one pair at a time
  float h[kHid], th[K][kHid];
  for (int o = 0; o < kHid; ++o) {
    h[o] = W[o * (kEnc + 1) + kEnc];
    for (int j = 0; j < K; ++j) th[j][o] = 0.f;
  }
  for (int dim = 0; dim < 3; ++dim) {
    for (int k = 0; k < kFreq; ++k) {
      float cs, sn;
      enc_pair(sym[dim], k, cs, sn);
      const float f = frequency(k);
      float txc[K], txs[K];
      for (int j = 0; j < K; ++j) {
        const float tf = f * tsym[j][dim];
        txc[j] = -sn * tf;
        txs[j] = cs * tf;
      }
      const int c = dim * 2 * kFreq + 2 * k;
      for (int o = 0; o < kHid; ++o) {
        const float wc = W[o * (kEnc + 1) + c], ws = W[o * (kEnc + 1) + c + 1];
        h[o] += wc * cs + ws * sn;
        for (int j = 0; j < K; ++j) th[j][o] += wc * txc[j] + ws * txs[j];
      }
    }
  }

  // layers 1..4: LayerNorm + GELU, then Linear
  float raw = 0.f, traw[K];
  for (int l = 1; l <= 4; ++l) {
    float y[kHid], tc[K][kHid], ty[K][kHid], istd;
    layer_norm_fwd<K>(h, th, y, tc, ty, istd);
    float a[kHid], ta[K][kHid];
    for (int i = 0; i < kHid; ++i) {
      const Gelu g(y[i]);
      a[i] = y[i] * g.cdf;
      const float g1 = g.cdf + y[i] * g.pdf;
      for (int j = 0; j < K; ++j) ta[j][i] = g1 * ty[j][i];
    }
    const float* Wl = W + layer_offset(l);
    const int out = l < 4 ? kHid : 1;
    for (int o = 0; o < out; ++o) {
      float acc = Wl[o * (kHid + 1) + kHid];
      float tacc[K];
      for (int j = 0; j < K; ++j) tacc[j] = 0.f;
      for (int i = 0; i < kHid; ++i) {
        const float wv = Wl[o * (kHid + 1) + i];
        acc += wv * a[i];
        for (int j = 0; j < K; ++j) tacc[j] += wv * ta[j][i];
      }
      if (l < 4) {
        h[o] = acc;
        for (int j = 0; j < K; ++j) th[j][o] = tacc[j];
      } else {
        raw = acc;
        for (int j = 0; j < K; ++j) traw[j] = tacc[j];
      }
    }
  }
  const float sig = sigmoidf(raw - 1.f);
  const float dsig = sig * (1.f - sig);
  for (int j = 0; j < K; ++j) td[j] += dsig * traw[j];
  return d + sig;
}

// Whether instance i takes part in the union: invalid instances have
// softmin weight exactly 0 under the f32 logit mask (valid - 1) * 1e30,
// unless no instance is valid, when all logits shift alike and the
// weights are uniform.
VSRD_HD bool instance_active(float valid, bool any_valid) { return valid > 0.5f || !any_valid; }

VSRD_HD float union_logit(float d, float valid, float tau) { return -d / tau + (valid - 1.f) * 1e30f; }

// The softmin union of one point, accumulated online over its instances.
// With e_i = exp(l_i - max),
//   u = sum e d / Z,  D_j u = G_j + (u G_j - DG_j) / tau,
//   G_j = sum e td_j / Z, DG_j = sum e d td_j / Z.
template <int K>
struct OnlineUnion {
  float mx, z, sd, sg[K], sdg[K];

  VSRD_HD OnlineUnion() : mx(-INFINITY), z(0.f), sd(0.f) {
    for (int j = 0; j < K; ++j) sg[j] = sdg[j] = 0.f;
  }

  VSRD_HD void add(float l, float d, const float td[K]) {
    if (l > mx) {
      const float sc = expf(mx - l);
      z *= sc;
      sd *= sc;
      for (int j = 0; j < K; ++j) {
        sg[j] *= sc;
        sdg[j] *= sc;
      }
      mx = l;
    }
    const float e = expf(l - mx);
    z += e;
    sd += e * d;
    for (int j = 0; j < K; ++j) {
      sg[j] += e * td[j];
      sdg[j] += e * d * td[j];
    }
  }

  // u; du[j] = D_j u
  VSRD_HD float finish(float tau, float du[K]) const {
    const float u = sd / z;
    for (int j = 0; j < K; ++j) {
      const float gj = sg[j] / z, dgj = sdg[j] / z;
      du[j] = gj + (u * gj - dgj) / tau;
    }
    return u;
  }

  // the softmin weight of an instance with logit l
  VSRD_HD float weight(float l) const { return expf(l - mx) / z; }
};

// ---- The fine forward's reverse-sweep form (K1/K4a) ----
//
// d_i and grad_x d_i from the value forward and ONE reverse sweep seeded
// with 1, with respect to the position only: no tangent is carried, and the
// LayerNorm needs only its first-order reverse. The union then weighs each
// instance's gradient online (OnlineUnion<3>). The sweep (instance_rev) is
// written once; its layer products go through a product object, on the
// card warp-wide mma.sync in 3xTF32 (fused_forward.cu), on the host scalar
// loops (tests/test_torch_kernels.py).

// Box value d and its gradient gl in the instance frame:
//   d/dl_c = s_c (r_c / o + gate [c == jmax]).
struct BoxGrad {
  float l[3], s[3], gl[3];
  float d;

  VSRD_HD BoxGrad(const float x[3], const float* loc, const float* rot, const float* half) {
    float rel[3], q[3], r[3];
    for (int k = 0; k < 3; ++k) rel[k] = x[k] - loc[k];
    for (int c = 0; c < 3; ++c) {
      l[c] = rel[0] * rot[c] + rel[1] * rot[3 + c] + rel[2] * rot[6 + c];
      s[c] = signf(l[c]);
      q[c] = fabsf(l[c]) - half[c];
      r[c] = fmaxf(q[c], 0.f);
    }
    const float o = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + 1e-6f);
    // the max face with the JAX kernels' tie-break, as BoxEval, by selects
    // (an array indexed by it would go to local memory on the card)
    const bool first = q[0] > q[1];
    const float q01 = first ? q[0] : q[1];
    const bool third = q[2] > q01;
    const float qmax = third ? q[2] : q01;
    const int jmax = third ? 2 : (first ? 0 : 1);
    const float gate = qmax < 0.f ? 1.f : 0.f, io = 1.f / o;
    d = o - fmaxf(-qmax, 0.f);
    for (int c = 0; c < 3; ++c) gl[c] = s[c] * (r[c] * io + (c == jmax ? gate : 0.f));
  }
};

// Encoding of one (dim, k) pair for the reverse form: (cos, sin) of pi 2^k
// sym, with the phase's factor pi applied inside the sine (sincospif on the
// card), so that sym 2^k is exact and no rounding of pi 2^k enters.
VSRD_HD void enc_pair_pi(float sym, int k, float& cs, float& sn) {
  const float x = sym * (float)(1 << k);
#if defined(__CUDACC__)
  sincospif(x, &sn, &cs);
#else
  cs = (float)cos(3.14159265358979323846 * (double)x);
  sn = (float)sin(3.14159265358979323846 * (double)x);
#endif
}

// The 8 (cos, sin) pairs of one coordinate, channel order k*2 + (0 | 1):
// exact (enc_pair_pi) at every STRIDE-th k, the others by the double-angle
// formulas cos 2x = (c - s)(c + s), sin 2x = 2 s c, as the JAX package's
// fast encoding (_encoding_trig, STRIDE 4) does. Each doubling grows the
// error by up to 2.8x: ~2e-7 absolute with STRIDE 2 (the reverse form's
// forward), ~1.3e-6 with STRIDE 4 (its reverse, where these values only
// weigh the cotangents in enc_rev, so grad_x d moves by ~1e-6 of the
// encoding's part of it).
template <int STRIDE>
VSRD_HD void enc_dim(float sym, float e[2 * kFreq]) {
  VSRD_UNROLL
  for (int k = 0; k < kFreq; ++k) {
    if (k % STRIDE == 0) {
      enc_pair_pi(sym, k, e[2 * k], e[2 * k + 1]);
    } else {
      const float c = e[2 * k - 2], s = e[2 * k - 1];
      e[2 * k] = (c - s) * (c + s);
      e[2 * k + 1] = 2.f * s * c;
    }
  }
}

// a = GELU(y) = y Phi(y), y = LayerNorm(h) (no affine); returns istd, and
// Phi(y) in cdf. The primal arithmetic of layer_norm_fwd.
VSRD_HD float ln_gelu(const float h[kHid], float y[kHid], float a[kHid], float cdf[kHid]) {
  float mean = 0.f;
  for (int i = 0; i < kHid; ++i) mean += h[i];
  mean *= 1.f / kHid;
  float var = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] = h[i] - mean;
    var += y[i] * y[i];
  }
  const float istd = 1.f / sqrtf(var * (1.f / kHid) + 1e-5f);
  for (int i = 0; i < kHid; ++i) {
    y[i] *= istd;
    cdf[i] = Gelu(y[i]).cdf;
    a[i] = y[i] * cdf[i];
  }
  return istd;
}

// phi(y), the standard normal density, of a LayerNorm output y
VSRD_HD float ln_pdf(float y) {
#if defined(__CUDA_ARCH__)
  // the fast exponential: |y| < 4 after a LayerNorm of 16, so a few ulp
  return __expf(-0.5f * y * y) * 0.39894228040143268f;
#else
  return expf(-0.5f * y * y) * 0.39894228040143268f;
#endif
}

// First-order reverse of a = GELU(LayerNorm(h)) from its residuals y, istd
// and Phi(y): ybar = abar (Phi(y) + y phi(y)),
// hbar = istd (ybar - mean(ybar) - y mean(ybar y)).
VSRD_HD void ln_gelu_rev(const float y[kHid], float istd, const float cdf[kHid],
                         const float abar[kHid], float hbar[kHid]) {
  float ybar[kHid], s = 0.f, sy = 0.f;
  for (int i = 0; i < kHid; ++i) {
    ybar[i] = abar[i] * (cdf[i] + y[i] * ln_pdf(y[i]));
    s += ybar[i];
    sy += ybar[i] * y[i];
  }
  s *= 1.f / kHid;
  sy *= 1.f / kHid;
  for (int i = 0; i < kHid; ++i) hbar[i] = istd * (ybar[i] - s - y[i] * sy);
}

// The cotangent of one encoding coordinate from its 16 channels' values e
// and cotangents ebar, both in channel order (k*2 + (0 cos | 1 sin)):
// sum_k f_k (cos_k sbar_k - sin_k cbar_k).
VSRD_HD float enc_rev(const float e[2 * kFreq], const float ebar[2 * kFreq]) {
  float sb = 0.f;
  for (int k = 0; k < kFreq; ++k)
    sb += frequency(k) * (e[2 * k] * ebar[2 * k + 1] - e[2 * k + 1] * ebar[2 * k]);
  return sb;
}

// grad_x d from the local gradient: d/dx_k = sum_c R[k][c] gl[c]
VSRD_HD void local_to_world(const float* rot, const float gl[3], float g[3]) {
  for (int k = 0; k < 3; ++k)
    g[k] = rot[3 * k] * gl[0] + rot[3 * k + 1] * gl[1] + rot[3 * k + 2] * gl[2];
}

// Where the sweep keeps the forward's residuals of layers 1..3 (index
// l - 1): y[16], istd and Phi(y)[16], kRevRes values per layer, at
// col[(l * kRevRes + e) * stride] (on the card a thread's own column of a
// shared-memory block). Keeping Phi saves the reverse an erf per element.
// Layer 4's stay in registers, since its reverse follows at once.
constexpr int kRevRes = 2 * kHid + 1;
constexpr int kRevResLayers = 3;

struct RevStore {
  float* col;
  int stride;
  VSRD_HD float& y(int l, int i) const { return col[(l * kRevRes + i) * stride]; }
  VSRD_HD float& istd(int l) const { return col[(l * kRevRes + kHid) * stride]; }
  VSRD_HD float& cdf(int l, int i) const { return col[(l * kRevRes + kHid + 1 + i) * stride]; }
};

// The sweep's per-instance "misc" block of kRevMisc floats: the biases of
// layers 0-3, then layer 4's 16 weights and its bias. Entry e lies at
// misc_index(e) in the flattened weights.
constexpr int kRevMisc = 5 * kHid + 1;

VSRD_HD int misc_index(int e) {
  if (e < 4 * kHid) {
    const int l = e / kHid, in = l == 0 ? kEnc : kHid;
    return layer_offset(l) + (e % kHid) * (in + 1) + in;
  }
  return layer_offset(4) + (e - 4 * kHid);
}

// One instance's distance d and grad_x d (world frame) at the point x with
// the residual field: the value forward, then the reverse sweep seeded with
// 1. misc: the instance's kRevMisc block. The layer products of layers 0-3
// go through prod, which holds their accumulator C (16 rows) and reads
// their operand B from 16 staging rows; prod.at(r) is this point's entry
// of row r:
//   begin(bias)   C = the bias rows, or 0 for nullptr
//   forward(l, m) C += W_l B; for l = 0, W_0's 16 columns of coordinate m
//   reverse(l)    C += W_l^T B, l = 1..3
//   hold()        keep B (layer 0's hbar) for reverse0
//   reverse0(m)   C += the 16 rows of W_0^T of coordinate m times the kept B
//   store()       the staging rows = C
//   sync()        orders a point's writes of the rows before the product's
//                 reads and back (on the card a warp's points share them)
// Every call makes the same sequence of product calls, as the card's
// warp-wide mma needs.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Prod>
VSRD_HD float instance_rev(const float x[3], const float* loc, const float* rot,
                           const float* half, const float* misc, float inv_scale, Prod& prod,
                           RevStore res, float g[3]) {
  const BoxGrad box(x, loc, rot, half);
  const float sym[3] = {fabsf(box.l[0]) * inv_scale, box.l[1] * inv_scale, box.l[2] * inv_scale};

  // layer 0, one coordinate's 16 encoding channels (two k-steps) at a time
  float e[2 * kFreq];
  prod.begin(misc);
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    enc_dim<2>(sym[m], e);
    for (int j = 0; j < 2 * kFreq; ++j) prod.at(j) = e[j];
    prod.sync();
    prod.forward(0, m);
    prod.sync();
  }
  prod.store();
  prod.sync();

  // forward, layers 1-4: LayerNorm + GELU per point, then the product
  float a[kHid], y4[kHid], cdf4[kHid], istd4 = 0.f, raw = misc[4 * kHid + kHid];
  VSRD_UNROLL
  for (int l = 1; l <= 4; ++l) {
    float h[kHid];
    for (int i = 0; i < kHid; ++i) h[i] = prod.at(i);
    if (l < 4) {
      float y[kHid], cdf[kHid];
      res.istd(l - 1) = ln_gelu(h, y, a, cdf);
      for (int i = 0; i < kHid; ++i) {
        res.y(l - 1, i) = y[i];
        res.cdf(l - 1, i) = cdf[i];
      }
      for (int i = 0; i < kHid; ++i) prod.at(i) = a[i];
      prod.sync();
      prod.begin(misc + l * kHid);
      prod.forward(l, 0);
      prod.sync();
      prod.store();
      prod.sync();
    } else {
      istd4 = ln_gelu(h, y4, a, cdf4);
    }
  }
  for (int i = 0; i < kHid; ++i) raw += misc[4 * kHid + i] * a[i];
  const float sig = sigmoidf(raw - 1.f);
  const float dsig = sig * (1.f - sig);

  // reverse, layers 4..1: first-order LayerNorm + GELU per point, then W^T
  float abar[kHid], hbar[kHid];
  for (int i = 0; i < kHid; ++i) abar[i] = misc[4 * kHid + i] * dsig;
  ln_gelu_rev(y4, istd4, cdf4, abar, hbar);
  VSRD_UNROLL
  for (int l = 3; l >= 1; --l) {
    for (int i = 0; i < kHid; ++i) prod.at(i) = hbar[i];
    prod.sync();
    prod.begin(nullptr);
    prod.reverse(l);
    prod.sync();
    prod.store();
    prod.sync();
    float y[kHid], cdf[kHid];
    for (int i = 0; i < kHid; ++i) {
      abar[i] = prod.at(i);
      y[i] = res.y(l - 1, i);
      cdf[i] = res.cdf(l - 1, i);
    }
    ln_gelu_rev(y, res.istd(l - 1), cdf, abar, hbar);
  }

  // layer 0's reverse, one coordinate (16 rows of W_0^T) at a time; the
  // product keeps hbar, so that each coordinate's cotangents can go over
  // the staging rows
  for (int i = 0; i < kHid; ++i) prod.at(i) = hbar[i];
  prod.sync();
  prod.hold();
  float gl[3] = {box.gl[0], box.gl[1], box.gl[2]};
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    prod.begin(nullptr);
    prod.reverse0(m);
    prod.sync();  // every point has read the rows (B, or the last coordinate's cotangents)
    prod.store();
    prod.sync();
    float ebar[2 * kFreq];
    for (int j = 0; j < 2 * kFreq; ++j) ebar[j] = prod.at(j);
    enc_dim<4>(sym[m], e);
    gl[m] += enc_rev(e, ebar) * (m == 0 ? box.s[0] : 1.f) * inv_scale;
  }
  local_to_world(rot, gl, g);
  return box.d + sig;
}

// ---- The coarse forward's one-tangent form (K3/K4b) ----
//
// d_i and its derivative td_i along the point's world direction v, forward
// mode: the tangent rides beside the value through every layer, so the
// layer products take the value and the tangent as two column blocks of one
// product and nothing is kept for a reverse. The union then weighs the
// tangents once the max logit is known (dir_union). instance_dir is written
// once; its layer products go through a product object, on the card
// warp-wide mma.sync in 3xTF32 over both blocks (dir_forward.cu), on the
// host scalar loops (tests/test_torch_kernels.py).

// Box value d and its derivative td = <grad_x d, v> along the world
// direction v, from the local gradient: td = <gl, R^T v>. tl = R^T v.
VSRD_HD float box_dir(const BoxGrad& box, const float v[3], const float* rot, float tl[3],
                      float& td) {
  for (int c = 0; c < 3; ++c) tl[c] = v[0] * rot[c] + v[1] * rot[3 + c] + v[2] * rot[6 + c];
  td = box.gl[0] * tl[0] + box.gl[1] * tl[1] + box.gl[2] * tl[2];
  return box.d;
}

// x / scale as one product and one fma: 1 / scale split into hi = fl(1 /
// scale) and lo = (1 - hi scale) / scale, the fma adding x lo to the exact
// x hi before it rounds, so the result is the division's. x hi alone would
// scale every encoding phase by one relative error (2.2e-8 at scale 100),
// which the top frequency and a union with no valid instance carry into
// u_dot (tests/test_torch_kernels.py, the smoke frame with no valid
// instance: 1.9e-4 of scale against the float64 twin, 8.7e-5 with this).
struct Scaler {
  float hi, lo;
  VSRD_HD explicit Scaler(float scale) : hi(1.f / scale), lo(fmaf(-hi, scale, 1.f) / scale) {}
  VSRD_HD float operator()(float x) const { return fmaf(x, hi, x * lo); }
};

// a = GELU(y), y = LayerNorm(h) (no affine), and its tangent ta along th:
// ty = istd (tc - y mean(y tc)), tc = th - mean(th), ta = (Phi(y) + y phi(y)) ty.
// The arithmetic of layer_norm_fwd<1> and Gelu, once for both.
VSRD_HD void ln_gelu_dir(const float h[kHid], const float th[kHid], float a[kHid],
                         float ta[kHid]) {
  float mean = 0.f, tmean = 0.f;
  for (int i = 0; i < kHid; ++i) {
    mean += h[i];
    tmean += th[i];
  }
  mean *= 1.f / kHid;
  tmean *= 1.f / kHid;
  float y[kHid], tc[kHid], var = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] = h[i] - mean;
    tc[i] = th[i] - tmean;
    var += y[i] * y[i];
  }
  const float istd = 1.f / sqrtf(var * (1.f / kHid) + 1e-5f);
  float p = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] *= istd;
    p += y[i] * tc[i];
  }
  p *= 1.f / kHid;
  for (int i = 0; i < kHid; ++i) {
    const float cdf = Gelu(y[i]).cdf;
    a[i] = y[i] * cdf;
    ta[i] = (cdf + y[i] * ln_pdf(y[i])) * istd * (tc[i] - y[i] * p);
  }
}

// One instance's distance d and its derivative td along the world direction
// v at the point x with the residual field. misc: the instance's kRevMisc
// block (instance_rev's). The layer products of layers 0-3 go through prod,
// which holds their accumulator C (16 rows, a value and a tangent block) and
// reads their operand B from 16 staging rows of both blocks; prod.at(r) and
// prod.tan_at(r) are this point's value and tangent entries of row r:
//   begin(bias)   the value block of C = the bias rows, the tangent block 0
//   forward(l, m) C += W_l B; for l = 0, W_0's 16 columns of coordinate m
//   store()       the staging rows = C
//   sync()        orders a point's writes of the rows before the product's
//                 reads and back (on the card a warp's points share them)
// Every call makes the same sequence of product calls, as the card's
// warp-wide mma needs.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Prod>
VSRD_HD float instance_dir(const float x[3], const float v[3], const float* loc,
                           const float* rot, const float* half, const float* misc,
                           const Scaler& inv, Prod& prod, float& td) {
  const BoxGrad box(x, loc, rot, half);
  float tl[3];
  const float d = box_dir(box, v, rot, tl, td);
  const float sym[3] = {inv(fabsf(box.l[0])), inv(box.l[1]), inv(box.l[2])};
  const float tsym[3] = {inv(box.s[0] * tl[0]), inv(tl[1]), inv(tl[2])};

  // layer 0, one coordinate's 16 encoding channels (two k-steps) at a time;
  // the tangent of (cos, sin)(pi 2^k s) is pi 2^k ds (-sin, cos): no new
  // transcendental
  float e[2 * kFreq];
  prod.begin(misc);
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    enc_dim<2>(sym[m], e);
    for (int k = 0; k < kFreq; ++k) {
      const float f = frequency(k) * tsym[m];
      prod.at(2 * k) = e[2 * k];
      prod.at(2 * k + 1) = e[2 * k + 1];
      prod.tan_at(2 * k) = -e[2 * k + 1] * f;
      prod.tan_at(2 * k + 1) = e[2 * k] * f;
    }
    prod.sync();
    prod.forward(0, m);
    prod.sync();
  }
  prod.store();
  prod.sync();

  // layers 1-4: LayerNorm + GELU with its tangent per point, then the product
  float raw = misc[4 * kHid + kHid], traw = 0.f;
  VSRD_UNROLL
  for (int l = 1; l <= 4; ++l) {
    float h[kHid], th[kHid], a[kHid], ta[kHid];
    for (int i = 0; i < kHid; ++i) {
      h[i] = prod.at(i);
      th[i] = prod.tan_at(i);
    }
    ln_gelu_dir(h, th, a, ta);
    if (l < 4) {
      for (int i = 0; i < kHid; ++i) {
        prod.at(i) = a[i];
        prod.tan_at(i) = ta[i];
      }
      prod.sync();
      prod.begin(misc + l * kHid);
      prod.forward(l, 0);
      prod.sync();
      prod.store();
      prod.sync();
    } else {
      for (int i = 0; i < kHid; ++i) {
        raw += misc[4 * kHid + i] * a[i];
        traw += misc[4 * kHid + i] * ta[i];
      }
    }
  }
  const float sig = sigmoidf(raw - 1.f);
  td += sig * (1.f - sig) * traw;
  return d + sig;
}

// The softmin union of one point from its instances' logits l, distances d
// and tangents td (entries of inactive instances are not read): the max
// logit first, then the sums, so no running rescale. Overwrites l with the
// weights w (0 for inactive instances), returns u = sum w d and sets
// u_dot = sum w td (1 + (u - d) / tau).
VSRD_HD float dir_union(int n, const float* valid, bool any_valid, float* l, const float* d,
                        const float* td, float tau, float& u_dot) {
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i)
    if (instance_active(valid[i], any_valid)) mx = fmaxf(mx, l[i]);
  float z = 0.f, sd = 0.f;
  for (int i = 0; i < n; ++i) {
    if (!instance_active(valid[i], any_valid)) continue;
    l[i] = expf(l[i] - mx);
    z += l[i];
    sd += l[i] * d[i];
  }
  const float u = sd / z;
  float ud = 0.f;
  for (int i = 0; i < n; ++i) {
    if (!instance_active(valid[i], any_valid)) {
      l[i] = 0.f;
      continue;
    }
    l[i] /= z;
    ud += l[i] * td[i] * (1.f + (u - d[i]) / tau);
  }
  u_dot = ud;
  return u;
}

// Softmin-union cotangents at one point (stage A of the backward).
// Given each instance's d, its derivative td along the point's direction,
// and the cotangents du, dw[i] of u and w, and 1 on u_dot = <dg, grad u>,
// overwrites d[i] with d_bar[i] and td[i] with td_bar[i]. Inactive
// instances (weight exactly 0) get zero cotangents.
VSRD_HD void union_backward(int n, const unsigned char* active, float* d, float* td,
                            const float* valid, float tau, float du, const float* dw,
                            int stride) {
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i)
    if (active[i]) mx = fmaxf(mx, union_logit(d[i * stride], valid[i], tau));
  float z = 0.f;
  for (int i = 0; i < n; ++i)
    if (active[i]) z += expf(union_logit(d[i * stride], valid[i], tau) - mx);
  float u = 0.f, m = 0.f;
  for (int i = 0; i < n; ++i) {
    if (!active[i]) continue;
    const float w = expf(union_logit(d[i * stride], valid[i], tau) - mx) / z;
    u += w * d[i * stride];
    m += w * td[i * stride];
  }
  float sw = 0.f;
  for (int i = 0; i < n; ++i) {
    if (!active[i]) continue;
    const float di = d[i * stride], ti = td[i * stride];
    const float w = expf(union_logit(di, valid[i], tau) - mx) / z;
    sw += w * (dw[i] + du * di + ti * (1.f + (u - di) / tau) + m * di / tau);
  }
  for (int i = 0; i < n; ++i) {
    if (!active[i]) {
      d[i * stride] = 0.f;
      td[i * stride] = 0.f;
      continue;
    }
    const float di = d[i * stride], ti = td[i * stride];
    const float w = expf(union_logit(di, valid[i], tau) - mx) / z;
    const float wtot = dw[i] + du * di + ti * (1.f + (u - di) / tau) + m * di / tau;
    const float lbar = w * (wtot - sw);
    d[i * stride] = du * w + w * (m - ti) / tau - lbar / tau;
    td[i * stride] = w * (1.f + (u - di) / tau);
  }
}

// Where the reverse sweep keeps the forward's LayerNorm residuals of
// layers 1..4 (index l - 1): y[16], tc[16], istd and P = mean(y tc), kRes
// values per layer, at col[(l * kRes + e) * stride]: on the card a thread's
// own column of a shared-memory block (stride = threads, so neighbouring
// threads hit neighbouring banks).
constexpr int kRes = 2 * kHid + 2;

struct ColumnStore {
  float* col;
  int stride;
  VSRD_HD float& y(int l, int i) const { return col[(l * kRes + i) * stride]; }
  VSRD_HD float& tc(int l, int i) const { return col[(l * kRes + kHid + i) * stride]; }
  VSRD_HD float& istd(int l) const { return col[(l * kRes + 2 * kHid) * stride]; }
  VSRD_HD float& p(int l) const { return col[(l * kRes + 2 * kHid + 1) * stride]; }
};

// The weights instance_backward reads: the hypernetwork's 1617 in rows that
// start 16 bytes apart (52 floats for layer 0, 20 for the others), so that a
// row loads four at a time from shared memory; weight (o, i) of layer l at
// Padded::at(l, o, i), the bias at i = in.
struct Padded {
  static constexpr int kSize = kHid * 52 + 3 * kHid * 20 + 20;
  VSRD_HD static constexpr int row(int l) { return l == 0 ? 52 : 20; }
  VSRD_HD static constexpr int offset(int l) {
    return l == 0 ? 0 : kHid * 52 + (l - 1) * kHid * 20;
  }
  VSRD_HD static constexpr int at(int l, int o, int i) { return offset(l) + o * row(l) + i; }
};

// Reverse sweep of the one-tangent forward of one instance along the
// world direction v, with cotangents dbar (on d) and tdbar (on td).
// Adds the point's box-parameter cotangents to geo = [dloc 3 | drot 9 |
// dhalf 3] and hands each MLP layer's per-point factors to the sink:
// sink.layer(l, in, out, a, ta, hbar, thbar), with
// dW_l[o][i] = hbar[o] a[i] + thbar[o] ta[i] (a[in] = 1, ta[in] = 0).
// Every call reaches the sink in the same order (layers 4..0), which the
// CUDA sink relies on for its block-wide barriers. W is laid out as
// Padded; the LayerNorm residuals go to ``store``. The layer loops are
// unrolled on the card so that every per-layer width is a constant there.
template <class Sink>
VSRD_HD void instance_backward(const float x[3], const float v[3], const float* loc,
                               const float* rot, const float* half, const float* W,
                               float inv_scale, float dbar, float tdbar, float geo[kGeo],
                               Sink& sink, ColumnStore store) {
  float tl[1][3];
  for (int c = 0; c < 3; ++c) tl[0][c] = v[0] * rot[c] + v[1] * rot[3 + c] + v[2] * rot[6 + c];
  BoxEval<1> box(x, loc, rot, half, tl);
  float lbar[3] = {0.f, 0.f, 0.f}, tlbar[3] = {0.f, 0.f, 0.f};

  if (W != nullptr) {
    const float sym[3] = {fabsf(box.l[0]) * inv_scale, box.l[1] * inv_scale, box.l[2] * inv_scale};
    const float tsym[3] = {box.s[0] * tl[0][0] * inv_scale, tl[0][1] * inv_scale,
                           tl[0][2] * inv_scale};
    // ---- forward, keeping each LayerNorm's y, tc and istd ----
    float h[kHid], th[1][kHid];
    for (int o = 0; o < kHid; ++o) {
      h[o] = W[Padded::at(0, o, kEnc)];
      th[0][o] = 0.f;
    }
    for (int dim = 0; dim < 3; ++dim) {
      for (int k = 0; k < kFreq; ++k) {
        float cs, sn;
        enc_pair(sym[dim], k, cs, sn);
        const float tf = frequency(k) * tsym[dim];
        const int c = dim * 2 * kFreq + 2 * k;
        for (int o = 0; o < kHid; ++o) {
          const float wc = W[Padded::at(0, o, c)], ws = W[Padded::at(0, o, c + 1)];
          h[o] += wc * cs + ws * sn;
          th[0][o] += (ws * cs - wc * sn) * tf;
        }
      }
    }
    float raw = 0.f, traw = 0.f;
    VSRD_UNROLL
    for (int l = 1; l <= 4; ++l) {
      float y[kHid], tc[1][kHid], ty[1][kHid], istd;
      layer_norm_fwd<1>(h, th, y, tc, ty, istd);
      float p = 0.f;
      for (int i = 0; i < kHid; ++i) {
        store.y(l - 1, i) = y[i];
        store.tc(l - 1, i) = tc[0][i];
        p += y[i] * tc[0][i];
      }
      store.istd(l - 1) = istd;
      store.p(l - 1) = p * (1.f / kHid);
      float a[kHid], ta[kHid];
      for (int i = 0; i < kHid; ++i) {
        const Gelu g(y[i]);
        a[i] = y[i] * g.cdf;
        ta[i] = (g.cdf + y[i] * g.pdf) * ty[0][i];
      }
      const float* Wl = W + Padded::offset(l);
      const int out = l < 4 ? kHid : 1;
      for (int o = 0; o < out; ++o) {
        float acc = Wl[o * Padded::row(l) + kHid], tacc = 0.f;
        for (int i = 0; i < kHid; ++i) {
          acc += Wl[o * Padded::row(l) + i] * a[i];
          tacc += Wl[o * Padded::row(l) + i] * ta[i];
        }
        if (l < 4) {
          h[o] = acc;
          th[0][o] = tacc;
        } else {
          raw = acc;
          traw = tacc;
        }
      }
    }
    const float sig = sigmoidf(raw - 1.f);
    const float dsig = sig * (1.f - sig);

    // ---- reverse ----
    float hbar[kHid], thbar[kHid];
    hbar[0] = dbar * dsig + tdbar * traw * dsig * (1.f - 2.f * sig);
    thbar[0] = tdbar * dsig;
    VSRD_UNROLL
    for (int l = 4; l >= 1; --l) {
      const int out = l == 4 ? 1 : kHid;
      float y[kHid], tc[kHid];
      for (int i = 0; i < kHid; ++i) {
        y[i] = store.y(l - 1, i);
        tc[i] = store.tc(l - 1, i);
      }
      const float istd = store.istd(l - 1), p = store.p(l - 1);
      float a[kHid], ta[kHid], ty[kHid], g1[kHid], g2[kHid];
      for (int i = 0; i < kHid; ++i) {
        const Gelu g(y[i]);
        ty[i] = istd * (tc[i] - y[i] * p);
        g1[i] = g.cdf + y[i] * g.pdf;
        g2[i] = g.pdf * (2.f - y[i] * y[i]);
        a[i] = y[i] * g.cdf;
        ta[i] = g1[i] * ty[i];
      }
      sink.layer(l, kHid, out, a, ta, hbar, thbar);
      const float* Wl = W + Padded::offset(l);
      // row by row, so that each weight row is read in order and the 16
      // sums advance side by side (each still in the order of o)
      float abar[kHid], tabar[kHid];
      for (int i = 0; i < kHid; ++i) abar[i] = tabar[i] = 0.f;
      for (int o = 0; o < out; ++o) {
        for (int i = 0; i < kHid; ++i) {
          abar[i] += Wl[o * Padded::row(l) + i] * hbar[o];
          tabar[i] += Wl[o * Padded::row(l) + i] * thbar[o];
        }
      }
      float ybar[kHid], tybar[kHid];
      for (int i = 0; i < kHid; ++i) {
        ybar[i] = abar[i] * g1[i] + tabar[i] * ty[i] * g2[i];
        tybar[i] = tabar[i] * g1[i];
      }
      // LayerNorm pair: the tangent transposes like the primal; the
      // primal input also picks up the second-order term through istd, y
      float s_tyb = 0.f, s_ytyb = 0.f, s_yb = 0.f, s_yyb = 0.f, s_tctyb = 0.f;
      for (int i = 0; i < kHid; ++i) {
        s_tyb += tybar[i];
        s_ytyb += y[i] * tybar[i];
        s_yb += ybar[i];
        s_yyb += y[i] * ybar[i];
        s_tctyb += tc[i] * tybar[i];
      }
      const float inv_c = 1.f / kHid;
      float g[kHid], g_mean = 0.f;
      for (int i = 0; i < kHid; ++i) {
        g[i] = istd * istd *
               (-y[i] * (s_tctyb - 3.f * p * s_ytyb) * inv_c - tc[i] * s_ytyb * inv_c -
                p * tybar[i]);
        g_mean += g[i];
      }
      g_mean *= inv_c;
      for (int i = 0; i < kHid; ++i) {
        thbar[i] = istd * (tybar[i] - s_tyb * inv_c - y[i] * s_ytyb * inv_c);
        hbar[i] = istd * (ybar[i] - s_yb * inv_c - y[i] * s_yyb * inv_c) + g[i] - g_mean;
      }
    }

    // layer 0 and the encoding
    float x0[kEnc], tx0[kEnc];
    for (int dim = 0; dim < 3; ++dim) {
      for (int k = 0; k < kFreq; ++k) {
        float cs, sn;
        enc_pair(sym[dim], k, cs, sn);
        const float tf = frequency(k) * tsym[dim];
        const int c = dim * 2 * kFreq + 2 * k;
        x0[c] = cs;
        x0[c + 1] = sn;
        tx0[c] = -sn * tf;
        tx0[c + 1] = cs * tf;
      }
    }
    sink.layer(0, kEnc, kHid, x0, tx0, hbar, thbar);
    float symbar[3] = {0.f, 0.f, 0.f}, tsymbar[3] = {0.f, 0.f, 0.f};
    for (int dim = 0; dim < 3; ++dim) {
      for (int k = 0; k < kFreq; ++k) {
        const int c = dim * 2 * kFreq + 2 * k;
        float xc = 0.f, xs = 0.f, txc = 0.f, txs = 0.f;
        for (int o = 0; o < kHid; ++o) {
          const float wc = W[Padded::at(0, o, c)], ws = W[Padded::at(0, o, c + 1)];
          xc += wc * hbar[o];
          xs += ws * hbar[o];
          txc += wc * thbar[o];
          txs += ws * thbar[o];
        }
        const float f = frequency(k), cs = x0[c], sn = x0[c + 1];
        const float tf = f * tsym[dim];
        symbar[dim] += f * (cs * xs - sn * xc) - f * tf * (cs * txc + sn * txs);
        tsymbar[dim] += f * (cs * txs - sn * txc);
      }
    }
    lbar[0] += symbar[0] * box.s[0] * inv_scale;
    tlbar[0] += tsymbar[0] * box.s[0] * inv_scale;
    for (int c = 1; c < 3; ++c) {
      lbar[c] += symbar[c] * inv_scale;
      tlbar[c] += tsymbar[c] * inv_scale;
    }
  }

  // box: d = o - relu(-q_max), td = to + gate tq[jmax]
  const float obar = dbar - tdbar * box.to[0] / box.o;
  float qbar[3], tqbar[3];
  for (int c = 0; c < 3; ++c) {
    const float rbar = (obar * box.r[c] + tdbar * box.tq[0][c]) / box.o;
    tqbar[c] = tdbar * box.r[c] / box.o;
    qbar[c] = box.q[c] > 0.f ? rbar : 0.f;
  }
  qbar[box.jmax] += dbar * box.gate;
  tqbar[box.jmax] += tdbar * box.gate;
  for (int c = 0; c < 3; ++c) {
    geo[12 + c] -= qbar[c];
    lbar[c] += qbar[c] * box.s[c];
    tlbar[c] += tqbar[c] * box.s[c];
  }
  for (int k = 0; k < 3; ++k) {
    float rl = 0.f;
    for (int c = 0; c < 3; ++c) {
      geo[3 + k * 3 + c] += lbar[c] * box.rel[k] + tlbar[c] * v[k];
      rl += rot[k * 3 + c] * lbar[c];
    }
    geo[k] -= rl;
  }
}

}  // namespace vsrd
