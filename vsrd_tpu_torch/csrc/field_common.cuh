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
// The functions here run the value forward (the sphere tracer's march,
// sphere_trace.cu), the value forward and its first-order reverse with
// respect to the position (K1/K4a), the value forward with one tangent along
// a direction as a second column block of its layer products (K3/K4b and
// K2/K4c's first stage), and the reverse sweep of that one-tangent forward
// (K2/K4c's second stage). The per-point work is scalar f32 per thread; the
// layer products of the field kernels go through a product object (on the
// card warp-wide mma.sync, warp_product.cuh), and the functions compile for
// the host too (without nvcc, with scalar products), so that the math is
// checked against the PyTorch twin on a machine without a GPU
// (tests/test_torch_kernels.py).
#pragma once

#include <math.h>
#include <string.h>

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

// ---- The default precision (bf16 operands, f32 sums) ----
//
// The JAX package's kernels run their layer products at Precision.DEFAULT
// unless pallas_matmul_precision is "highest": on the TPU both f32 operands
// of every product are rounded to bf16 (to nearest, ties to even), the
// products are exact in f32 and the sums f32. That holds for the bias (a
// column of the interleaved matrix times an exact row of ones), for the
// 16 -> 1 last layer and for the tangent columns stacked beside the values,
// in the forward and in the backward's weight-gradient sums and input
// cotangents. The functions below take the mode as a template parameter
// BF16; with it, W holds weights already rounded (bf16_round, once per
// instance where they are staged), and each per-point operand is rounded
// where it enters a product. Without it, every line is the strict mode's.

// x rounded to the nearest bf16 value, ties to even, as f32 (finite x; an
// overflow gives the infinity of x's sign): integer arithmetic on the bits,
// so that the host harness computes what cvt.rn.bf16x2.f32 does on the card
VSRD_HD float bf16_round(float x) {
  unsigned u;
#if defined(__CUDA_ARCH__)
  u = __float_as_uint(x);
#else
  memcpy(&u, &x, sizeof u);
#endif
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float r;
  memcpy(&r, &u, sizeof r);
  return r;
#endif
}

// a product operand in the mode BF16
template <bool BF16>
VSRD_HD float operand(float x) {
  return BF16 ? bf16_round(x) : x;
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

// The 8 (cos, sin) pairs of one coordinate, channel order k*2 + (0 | 1), as
// the JAX package's fast encoding computes them (_encoding_trig with
// fast=True, the form of its default precision): cos and sin of the phase
// sym fl(pi 2^k) at k = 0 and 4, the others by c' = 2 c c - 1 and
// s' = 2 s c, every product and difference rounded on its own (no fused
// multiply-add). The default mode encodes so, since its layer-0 operands
// are rounded to bf16: an encoding ~1e-6 away (enc_dim below) would round
// operands the other way far more often than f32 noise does (an estimate
// from the two errors' sizes, 1e-6 against an ulp).
VSRD_HD void enc_dim_jax(float sym, float e[2 * kFreq]) {
  VSRD_UNROLL
  for (int k = 0; k < kFreq; ++k) {
    if (k % 4 == 0) {
      enc_pair(sym, k, e[2 * k], e[2 * k + 1]);
    } else {
      const float c = e[2 * k - 2], s = e[2 * k - 1];
#if defined(__CUDA_ARCH__)
      e[2 * k] = __fsub_rn(__fmul_rn(2.f * c, c), 1.f);
      e[2 * k + 1] = __fmul_rn(2.f * s, c);
#else
      e[2 * k] = 2.f * c * c - 1.f;
      e[2 * k + 1] = 2.f * s * c;
#endif
    }
  }
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

// x / scale by the rounded reciprocal (K1 and K2's encoding, K3's in the
// default precision) or by Scaler (K3's strict one and the sphere tracer's)
VSRD_HD float scaled(float inv_scale, float x) { return x * inv_scale; }
VSRD_HD float scaled(const Scaler& inv, float x) { return inv(x); }

// Whether instance i takes part in the union: invalid instances have
// softmin weight exactly 0 under the f32 logit mask (valid - 1) * 1e30,
// unless no instance is valid, when all logits shift alike and the
// weights are uniform.
VSRD_HD bool instance_active(float valid, bool any_valid) { return valid > 0.5f || !any_valid; }

VSRD_HD float union_logit(float d, float valid, float tau) { return -d / tau + (valid - 1.f) * 1e30f; }

// ---- Per-tile instance-group skipping ----
//
// A keep mask [G][Tm] (G = ceil(N / kGroup) groups of kGroup instances, Tm
// tiles of `tile` points) says which groups a tile evaluates; at a point
// whose tile drops a group, the group's instances read kSkipDistance with a
// zero gradient or tangent, so their softmin weights underflow to 0 (the
// JAX package's _SKIP_DISTANCE; fused_field.py in both packages).
constexpr float kSkipDistance = 1.0e4f;

// The groups (one bit each) that some tile over the points [first, last]
// keeps; all of them without a mask.
VSRD_HD unsigned kept_groups(const int* mask, int N, int P, int tile, int first, int last) {
  if (mask == nullptr) return ~0u;
  const int groups = (N + kGroup - 1) / kGroup, tiles = (P + tile - 1) / tile;
  unsigned bits = 0;
  for (int g = 0; g < groups; ++g)
    for (int t = first / tile; t <= last / tile; ++t)
      if (mask[g * tiles + t] != 0) {
        bits |= 1u << g;
        break;
      }
  return bits;
}

VSRD_HD bool group_kept(unsigned bits, int i) { return (bits >> (i / kGroup)) & 1u; }

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
    // the max face with the JAX kernels' tie-break (q[0] wins ties with
    // q[1], both lose them to q[2]), by selects (an array indexed by it
    // would go to local memory on the card)
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
// Phi(y) in cdf.
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
// seed_of(d) (1 in the strict mode, where the union weighs the gradients
// afterwards; the union's cotangent w (1 + (u - d) / tau) in the default
// mode, as the JAX body _scene_eval_stacked_rev seeds it, since a bf16
// operand does not scale with its seed). With reverse false, the value
// forward alone (g unwritten). misc: the instance's kRevMisc block. The
// layer products of layers 0-3 go through prod, which holds their
// accumulator C (16 rows) and reads their operand B from 16 staging rows;
// prod.at(r) is this point's entry of row r:
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
template <bool BF16, class Prod, class Seed>
VSRD_HD float instance_rev(const float x[3], const float* loc, const float* rot,
                           const float* half, const float* misc, float inv_scale, Prod& prod,
                           RevStore res, const Seed& seed_of, float g[3], bool reverse = true) {
  const BoxGrad box(x, loc, rot, half);
  const float sym[3] = {fabsf(box.l[0]) * inv_scale, box.l[1] * inv_scale, box.l[2] * inv_scale};

  // layer 0, one coordinate's 16 encoding channels (two k-steps) at a time
  float e[2 * kFreq];
  prod.begin(misc);
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    if (BF16)
      enc_dim_jax(sym[m], e);
    else
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
  for (int i = 0; i < kHid; ++i) raw += misc[4 * kHid + i] * operand<BF16>(a[i]);
  const float sig = sigmoidf(raw - 1.f);
  if (!reverse) return box.d + sig;
  const float dsig = sig * (1.f - sig);
  const float seed = seed_of(box.d + sig);

  // reverse, layers 4..1: first-order LayerNorm + GELU per point, then W^T
  float abar[kHid], hbar[kHid];
  const float xo = operand<BF16>(seed * dsig);
  for (int i = 0; i < kHid; ++i) abar[i] = misc[4 * kHid + i] * xo;
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
  float gl[3] = {seed * box.gl[0], seed * box.gl[1], seed * box.gl[2]};
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    prod.begin(nullptr);
    prod.reverse0(m);
    prod.sync();  // every point has read the rows (B, or the last coordinate's cotangents)
    prod.store();
    prod.sync();
    float ebar[2 * kFreq];
    for (int j = 0; j < 2 * kFreq; ++j) ebar[j] = prod.at(j);
    if (BF16)
      enc_dim_jax(sym[m], e);
    else
      enc_dim<4>(sym[m], e);
    gl[m] += enc_rev(e, ebar) * (m == 0 ? box.s[0] : 1.f) * inv_scale;
  }
  local_to_world(rot, gl, g);
  return box.d + sig;
}

// ---- The one-tangent form (K3/K4b, K2/K4c's first stage) ----
//
// d_i and its derivative td_i along a world direction v (the point's ray in
// K3, the cotangent dg of grad_x u in K2), forward mode: the tangent rides
// beside the value through every layer, so the layer products take the
// value and the tangent as two column blocks of one product. K3's union
// then weighs the tangents once the max logit is known (dir_union), K2's
// gives each instance its cotangents (union_backward). instance_dir is
// written once; its layer products go through a product object, on the card
// warp-wide mma.sync over both blocks (warp_product.cuh), on the host scalar
// loops (tests/test_torch_kernels.py).

// Box value d and its derivative td = <grad_x d, v> along the world
// direction v, from the local gradient: td = <gl, R^T v>. tl = R^T v.
VSRD_HD float box_dir(const BoxGrad& box, const float v[3], const float* rot, float tl[3],
                      float& td) {
  for (int c = 0; c < 3; ++c) tl[c] = v[0] * rot[c] + v[1] * rot[3 + c] + v[2] * rot[6 + c];
  td = box.gl[0] * tl[0] + box.gl[1] * tl[1] + box.gl[2] * tl[2];
  return box.d;
}

// y = LayerNorm(h) (no affine) and the tangent's centred tc = th - mean(th)
// along th; returns istd and sets p = mean(y tc). The tangent of y is
// ty = istd (tc - y p).
VSRD_HD float ln_dir(const float h[kHid], const float th[kHid], float y[kHid], float tc[kHid],
                     float& p) {
  float mean = 0.f, tmean = 0.f;
  for (int i = 0; i < kHid; ++i) {
    mean += h[i];
    tmean += th[i];
  }
  mean *= 1.f / kHid;
  tmean *= 1.f / kHid;
  float var = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] = h[i] - mean;
    tc[i] = th[i] - tmean;
    var += y[i] * y[i];
  }
  const float istd = 1.f / sqrtf(var * (1.f / kHid) + 1e-5f);
  p = 0.f;
  for (int i = 0; i < kHid; ++i) {
    y[i] *= istd;
    p += y[i] * tc[i];
  }
  p *= 1.f / kHid;
  return istd;
}

// One element of a = GELU(y) and its tangent ta = g1 ty, with g1 = Phi(y) +
// y phi(y) and ty = istd (tc - y p), from ln_dir's outputs and cdf =
// Phi(y); g2 = phi(y) (2 - y^2), the derivative of g1, for the reverse
// (backward_ln_gelu_dir).
struct GeluDir {
  float g1, ty, a, ta;
  VSRD_HD GeluDir(float y, float tc, float istd, float p, float cdf) {
    g1 = cdf + y * ln_pdf(y);
    ty = istd * (tc - y * p);
    a = y * cdf;
    ta = g1 * ty;
  }
  VSRD_HD static float g2(float y) { return ln_pdf(y) * (2.f - y * y); }
};

// The encoding's 16 channels of one coordinate for the one-tangent forms,
// by the encoding's 1 / scale: in the default precision (BF16) the JAX
// package's fast encoding (enc_dim_jax); in the strict one, with the exact
// 1 / scale (a Scaler, K3's) enc_dim<2>, with the rounded reciprocal (a
// float, K2's) the float32 twin's own arithmetic, cos and sin of sym
// fl(pi 2^k) (enc_pair). enc_dim<2> is nearer float64, but a frame with no
// valid instance weighs each instance's error by up to |1 + (u - d) / tau|,
// and the card tests hold K2 to the float32 twin at 2e-4 of scale: in the
// masked batched test's frame with no valid instance at N = 20, drot reads
// 2.1e-4 off that twin with enc_dim<2> and 1.2e-4 with enc_pair, the twin
// itself 2.6e-4 off float64 (PERF.md).
template <bool BF16>
VSRD_HD void enc_fwd(const Scaler&, float sym, float e[2 * kFreq]) {
  if (BF16)
    enc_dim_jax(sym, e);
  else
    enc_dim<2>(sym, e);
}

template <bool BF16>
VSRD_HD void enc_fwd(float, float sym, float e[2 * kFreq]) {
  if (BF16) {
    enc_dim_jax(sym, e);
    return;
  }
  for (int k = 0; k < kFreq; ++k) enc_pair(sym, k, e[2 * k], e[2 * k + 1]);
}

// The residual field's MLP with one tangent (instance_dir's and
// instance_backward's forward) from the encoding's inputs sym and their
// tangents tsym: raw and traw, the last layer's output and its tangent.
// misc: the instance's kRevMisc block; inv: the encoding's 1 / scale
// (enc_fwd). BF16: the default precision, layer 4's operands rounded here
// (the product object rounds the others). The layer products of layers 0-3
// go through prod, which holds their accumulator C (16 rows, a value and a
// tangent block) and reads their operand B from 16 staging rows of both
// blocks; prod.at(r) and prod.tan_at(r) are this point's value and tangent
// entries of row r:
//   begin(bias)   the value block of C = the bias rows, the tangent block 0
//   forward(l, m) C += W_l B; for l = 0, W_0's 16 columns of coordinate m
//   store()       the staging rows = C
//   sync()        orders a point's writes of the rows before the product's
//                 reads and back (on the card a warp's points share them)
// Each LayerNorm's outputs (ln_dir) and Phi of layers l = 1..3 go to
// keep(l, y, tc, cdf, istd, p); layer 4's stay in y, tc, cdf, istd and p.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <bool BF16, class Inv, class Prod, class Keep>
VSRD_HD void mlp_dir(const float sym[3], const float tsym[3], const float* misc, const Inv& inv,
                     Prod& prod, const Keep& keep, float y[kHid], float tc[kHid],
                     float cdf[kHid], float& istd, float& p, float& raw, float& traw) {
  // layer 0, one coordinate's 16 encoding channels (two k-steps) at a time;
  // the tangent of (cos, sin)(pi 2^k s) is pi 2^k ds (-sin, cos): no new
  // transcendental
  float e[2 * kFreq];
  prod.begin(misc);
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    enc_fwd<BF16>(inv, sym[m], e);
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
  raw = misc[4 * kHid + kHid];
  traw = 0.f;
  VSRD_UNROLL
  for (int l = 1; l <= 4; ++l) {
    float h[kHid], th[kHid];
    for (int i = 0; i < kHid; ++i) {
      h[i] = prod.at(i);
      th[i] = prod.tan_at(i);
    }
    istd = ln_dir(h, th, y, tc, p);
    for (int i = 0; i < kHid; ++i) cdf[i] = Gelu(y[i]).cdf;
    if (l < 4) {
      keep(l, y, tc, cdf, istd, p);
      for (int i = 0; i < kHid; ++i) {
        const GeluDir g(y[i], tc[i], istd, p, cdf[i]);
        prod.at(i) = g.a;
        prod.tan_at(i) = g.ta;
      }
      prod.sync();
      prod.begin(misc + l * kHid);
      prod.forward(l, 0);
      prod.sync();
      prod.store();
      prod.sync();
    } else {
      for (int i = 0; i < kHid; ++i) {
        const GeluDir g(y[i], tc[i], istd, p, cdf[i]);
        raw += misc[4 * kHid + i] * operand<BF16>(g.a);
        traw += misc[4 * kHid + i] * operand<BF16>(g.ta);
      }
    }
  }
}

// One instance's distance d and its derivative td along the world direction
// v at the point x with the residual field. misc: the instance's kRevMisc
// block (instance_rev's). inv: the encoding's 1 / scale, a Scaler (K3's
// strict mode) or the rounded reciprocal (a float, as the JAX body: K3's
// default mode, K2's first stage). BF16: the default precision, which also
// encodes by enc_dim_jax. prod: mlp_dir's product object. Every call makes
// the same sequence of product calls, as the card's warp-wide mma needs.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <bool BF16, class Prod, class Inv>
VSRD_HD float instance_dir(const float x[3], const float v[3], const float* loc,
                           const float* rot, const float* half, const float* misc,
                           const Inv& inv, Prod& prod, float& td) {
  const BoxGrad box(x, loc, rot, half);
  float tl[3];
  const float d = box_dir(box, v, rot, tl, td);
  const float sym[3] = {scaled(inv, fabsf(box.l[0])), scaled(inv, box.l[1]),
                        scaled(inv, box.l[2])};
  const float tsym[3] = {scaled(inv, box.s[0] * tl[0]), scaled(inv, tl[1]),
                         scaled(inv, tl[2])};
  float y[kHid], tc[kHid], cdf[kHid], istd, p, raw, traw;
  mlp_dir<BF16>(sym, tsym, misc, inv, prod,
                [](int, const float*, const float*, const float*, float, float) {}, y, tc, cdf,
                istd, p, raw, traw);
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

// Softmin-union cotangents at one point (the backward's first stage).
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

// ---- The backward's reverse sweep (K2/K4c's second stage) ----
//
// The reverse of instance_dir's one-tangent forward along the direction v,
// with cotangents dbar on d and tdbar on td (the JAX body _group_dir_bwd):
// the forward runs again, keeping each LayerNorm's residuals, then each
// layer's value and tangent cotangents are the two column blocks of ONE
// product with W_l^T, and the weight cotangents dW_l = sum_p hbar a^T +
// thbar ta^T go through the same product object: on the card warp-wide
// mma.sync (fused_backward.cu), on the host scalar loops
// (tests/test_torch_kernels.py).

// Where the sweep keeps the forward's LayerNorm residuals of layers 1..3
// (index l - 1): y[16], tc[16], Phi(y)[16], istd and p = mean(y tc), kRes
// values per layer, at col[(l * kRes + e) * stride]: on the card a thread's
// own column of its warp's shared-memory block (stride = 32, so
// neighbouring threads hit neighbouring banks). Keeping Phi spares the
// reverse an erf per element. Layer 4's stay in registers, since its
// reverse follows at once.
constexpr int kRes = 3 * kHid + 2;
constexpr int kResLayers = 3;

struct ColumnStore {
  float* col;
  int stride;
  VSRD_HD float& y(int l, int i) const { return col[(l * kRes + i) * stride]; }
  VSRD_HD float& tc(int l, int i) const { return col[(l * kRes + kHid + i) * stride]; }
  VSRD_HD float& cdf(int l, int i) const { return col[(l * kRes + 2 * kHid + i) * stride]; }
  VSRD_HD float& istd(int l) const { return col[(l * kRes + 3 * kHid) * stride]; }
  VSRD_HD float& p(int l) const { return col[(l * kRes + 3 * kHid + 1) * stride]; }
};

// Reverse of a = GELU(LayerNorm(h)) and its tangent ta along th (ln_dir,
// GeluDir) from the cotangents abar of a and tabar of ta: hbar and thbar of
// h and th. y, tc, istd, p: ln_dir's outputs; g1, ty: each element's
// GeluDir factors. The tangent transposes like the primal; the primal input
// also picks up the second-order terms through istd and y.
VSRD_HD void backward_ln_gelu_dir(const float y[kHid], const float tc[kHid], float istd,
                                  float p, const float g1[kHid], const float ty[kHid],
                                  const float abar[kHid], const float tabar[kHid],
                                  float hbar[kHid], float thbar[kHid]) {
  float ybar[kHid], tybar[kHid];
  for (int i = 0; i < kHid; ++i) {
    ybar[i] = abar[i] * g1[i] + tabar[i] * ty[i] * GeluDir::g2(y[i]);
    tybar[i] = tabar[i] * g1[i];
  }
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
           (-y[i] * (s_tctyb - 3.f * p * s_ytyb) * inv_c - tc[i] * s_ytyb * inv_c - p * tybar[i]);
    g_mean += g[i];
  }
  g_mean *= inv_c;
  for (int i = 0; i < kHid; ++i) {
    thbar[i] = istd * (tybar[i] - s_tyb * inv_c - y[i] * s_ytyb * inv_c);
    hbar[i] = istd * (ybar[i] - s_yb * inv_c - y[i] * s_yyb * inv_c) + g[i] - g_mean;
  }
}

// The box's part of the reverse sweep at the point x along v: d = o -
// relu(-q_max) and td = to + gate tq[jmax] (q = |l| - half, r = relu(q), o =
// sqrt(|r|^2 + 1e-6), tq = s tl with tl = R^T v, to = <r, tq> / o), with the
// cotangents dbar and tdbar, and lbar and tlbar, those the MLP gave the
// local position l and its tangent tl (both are updated). Recomputes the
// box from x, so nothing of it lives across the MLP. Adds the point's
// cotangents to geo = [dloc 3 | drot 9 | dhalf 3].
VSRD_HD void box_backward(const float x[3], const float v[3], const float* loc, const float* rot,
                          const float* half, float dbar, float tdbar, float lbar[3],
                          float tlbar[3], float geo[kGeo]) {
  float rel[3], s[3], q[3], r[3], tq[3];
  for (int k = 0; k < 3; ++k) rel[k] = x[k] - loc[k];
  for (int c = 0; c < 3; ++c) {
    const float l = rel[0] * rot[c] + rel[1] * rot[3 + c] + rel[2] * rot[6 + c];
    s[c] = signf(l);
    q[c] = fabsf(l) - half[c];
    r[c] = fmaxf(q[c], 0.f);
    tq[c] = s[c] * (v[0] * rot[c] + v[1] * rot[3 + c] + v[2] * rot[6 + c]);
  }
  const float o = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + 1e-6f);
  // the max face as BoxGrad picks it, by selects
  const bool first = q[0] > q[1];
  const bool third = q[2] > (first ? q[0] : q[1]);
  const int jmax = third ? 2 : (first ? 0 : 1);
  const float gate = (third ? q[2] : (first ? q[0] : q[1])) < 0.f ? 1.f : 0.f;
  const float to = (r[0] * tq[0] + r[1] * tq[1] + r[2] * tq[2]) / o;
  const float obar = dbar - tdbar * to / o;
  for (int c = 0; c < 3; ++c) {
    const float rbar = (obar * r[c] + tdbar * tq[c]) / o;
    const float qbar = (q[c] > 0.f ? rbar : 0.f) + (c == jmax ? dbar * gate : 0.f);
    const float tqbar = tdbar * r[c] / o + (c == jmax ? tdbar * gate : 0.f);
    geo[12 + c] -= qbar;
    lbar[c] += qbar * s[c];
    tlbar[c] += tqbar * s[c];
  }
  for (int k = 0; k < 3; ++k) {
    float rl = 0.f;
    for (int c = 0; c < 3; ++c) {
      geo[3 + k * 3 + c] += lbar[c] * rel[k] + tlbar[c] * v[k];
      rl += rot[k * 3 + c] * lbar[c];
    }
    geo[k] -= rl;
  }
}

// One instance's reverse sweep at the point x along the world direction v
// with the residual field (K2/K4c's second stage; its first, instance_dir
// with the rounded 1 / scale, gave dbar and tdbar): adds the point's box
// cotangents to geo = [dloc 3 | drot 9 | dhalf 3] and its weight cotangents,
// through prod, to the instance's sums. misc: the instance's kRevMisc block.
// BF16: the default precision of the JAX body _group_dir_bwd: the forward
// rounds as instance_dir<true>, the input cotangents W_l^T [hbar | thbar]
// round hbar and thbar (the product rounds its B), layer 4's round its
// operands here, and the weight cotangents are sums of products of the
// rounded hbar, thbar, a and ta. prod is mlp_dir's product object, its 16
// staging rows of value and tangent (at, tan_at) being the first block,
// with a second block of 16 such rows (in_at, in_tan_at) and:
//   second(l)     where the second block lies for layer l's reverse (on the
//                 card the residual block that layer just read, or the
//                 first block for layer 4)
//   hold()        keep the first block's rows as B for reverse0
//   reverse(l)    C += W_l^T B, B the first block's rows, l = 1..3
//   reverse0(m)   C += the 16 rows of W_0^T of coordinate m times the kept B
//   store_in()    the second block's rows = C
//   grad(l, m)    dW_l += [hbar | thbar] [a | ta]^T over the value and
//                 tangent columns, l = 0..3: hbar|thbar the first block's
//                 rows, a|ta the second block's (for l = 0 W_0's 16 inputs
//                 of coordinate m); for m = 0 also the bias column, the sum
//                 of the first block's value rows
//   grad4(hb, thb) the same for layer 4's one output, whose cotangents this
//                 point passes as hb and thb
// Every call makes the same sequence of product calls, as the card's
// warp-wide mma needs. The layer loops are unrolled on the card, so that
// every layer index is a constant there.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <bool BF16, class Prod>
VSRD_HD void instance_backward(const float x[3], const float v[3], const float* loc,
                               const float* rot, const float* half, const float* misc,
                               float inv_scale, float dbar, float tdbar, float geo[kGeo],
                               Prod& prod, ColumnStore store) {
  const BoxGrad box(x, loc, rot, half);
  float tl[3], td;
  box_dir(box, v, rot, tl, td);
  const float sym[3] = {fabsf(box.l[0]) * inv_scale, box.l[1] * inv_scale, box.l[2] * inv_scale};
  const float tsym[3] = {box.s[0] * tl[0] * inv_scale, tl[1] * inv_scale, tl[2] * inv_scale};

  // ---- forward, keeping each LayerNorm's residuals ----
  float y[kHid], tc[kHid], cdf[kHid], istd, p, raw, traw;
  mlp_dir<BF16>(
      sym, tsym, misc, inv_scale, prod,
      [&](int l, const float* yl, const float* tcl, const float* cdfl, float istd_l, float p_l) {
        for (int i = 0; i < kHid; ++i) {
          store.y(l - 1, i) = yl[i];
          store.tc(l - 1, i) = tcl[i];
          store.cdf(l - 1, i) = cdfl[i];
        }
        store.istd(l - 1) = istd_l;
        store.p(l - 1) = p_l;
      },
      y, tc, cdf, istd, p, raw, traw);
  const float sig = sigmoidf(raw - 1.f);
  const float dsig = sig * (1.f - sig);
  prod.sync();  // every point has read the forward's last rows

  // ---- reverse, layers 4..1: the weight cotangents, W_l^T (layer 4's one
  // output row on the CUDA cores), then the pair's reverse per point ----
  float hbar[kHid], thbar[kHid];
  VSRD_UNROLL
  for (int l = 4; l >= 1; --l) {
    if (l < 4) {
      for (int i = 0; i < kHid; ++i) {
        y[i] = store.y(l - 1, i);
        tc[i] = store.tc(l - 1, i);
        cdf[i] = store.cdf(l - 1, i);
      }
      istd = store.istd(l - 1);
      p = store.p(l - 1);
      prod.sync();  // every point has read its residuals
    }
    prod.second(l);
    float g1[kHid], ty[kHid], abar[kHid], tabar[kHid];
    for (int i = 0; i < kHid; ++i) {
      const GeluDir g(y[i], tc[i], istd, p, cdf[i]);
      g1[i] = g.g1;
      ty[i] = g.ty;
      prod.in_at(i) = g.a;
      prod.in_tan_at(i) = g.ta;
    }
    if (l == 4) {
      const float hb = dbar * dsig + tdbar * traw * dsig * (1.f - 2.f * sig);
      const float thb = tdbar * dsig;
      prod.sync();
      prod.grad4(hb, thb);
      prod.sync();  // every point has read the rows
      const float xo = operand<BF16>(hb), txo = operand<BF16>(thb);
      for (int i = 0; i < kHid; ++i) {
        abar[i] = misc[4 * kHid + i] * xo;
        tabar[i] = misc[4 * kHid + i] * txo;
      }
    } else {
      for (int o = 0; o < kHid; ++o) {
        prod.at(o) = hbar[o];
        prod.tan_at(o) = thbar[o];
      }
      prod.sync();
      prod.grad(l, 0);
      prod.begin(nullptr);
      prod.reverse(l);
      prod.sync();  // every point has read the second block's rows
      prod.store_in();
      prod.sync();
      for (int i = 0; i < kHid; ++i) {
        abar[i] = prod.in_at(i);
        tabar[i] = prod.in_tan_at(i);
      }
    }
    backward_ln_gelu_dir(y, tc, istd, p, g1, ty, abar, tabar, hbar, thbar);
  }

  // ---- layer 0, one coordinate (16 encoding channels, 16 rows of W_0^T)
  // at a time: its weight cotangents, then the channels' cotangents ----
  for (int o = 0; o < kHid; ++o) {
    prod.at(o) = hbar[o];
    prod.tan_at(o) = thbar[o];
  }
  prod.sync();
  prod.hold();
  prod.second(0);
  float lbar[3], tlbar[3], e[2 * kFreq];
  VSRD_UNROLL
  for (int m = 0; m < 3; ++m) {
    enc_fwd<BF16>(inv_scale, sym[m], e);
    for (int k = 0; k < kFreq; ++k) {
      const float tf = frequency(k) * tsym[m];
      prod.in_at(2 * k) = e[2 * k];
      prod.in_at(2 * k + 1) = e[2 * k + 1];
      prod.in_tan_at(2 * k) = -e[2 * k + 1] * tf;
      prod.in_tan_at(2 * k + 1) = e[2 * k] * tf;
    }
    prod.sync();
    prod.grad(0, m);
    prod.begin(nullptr);
    prod.reverse0(m);
    prod.sync();  // every point has read the second block's rows
    prod.store_in();
    prod.sync();
    float symbar = 0.f, tsymbar = 0.f;
    for (int k = 0; k < kFreq; ++k) {
      const float f = frequency(k), cs = e[2 * k], sn = e[2 * k + 1];
      const float tf = f * tsym[m];
      const float xc = prod.in_at(2 * k), xs = prod.in_at(2 * k + 1);
      const float txc = prod.in_tan_at(2 * k), txs = prod.in_tan_at(2 * k + 1);
      symbar += f * (cs * xs - sn * xc) - f * tf * (cs * txc + sn * txs);
      tsymbar += f * (cs * txs - sn * txc);
    }
    lbar[m] = m == 0 ? symbar * box.s[0] * inv_scale : symbar * inv_scale;
    tlbar[m] = m == 0 ? tsymbar * box.s[0] * inv_scale : tsymbar * inv_scale;
  }
  box_backward(x, v, loc, rot, half, dbar, tdbar, lbar, tlbar, geo);
}

// One instance's distance d at the point x, the value forward alone (the
// sphere tracer's). W: the instance's 1617 weights, or nullptr for box
// only. inv: the encoding's 1 / scale, a float or a Scaler. Strict products,
// as the JAX package's photometric field runs them.
template <class Inv>
VSRD_HD float instance_forward(const float x[3], const float* loc, const float* rot,
                               const float* half, const float* W, const Inv& inv) {
  const BoxGrad box(x, loc, rot, half);
  if (W == nullptr) return box.d;
  const float sym[3] = {scaled(inv, fabsf(box.l[0])), scaled(inv, box.l[1]),
                        scaled(inv, box.l[2])};

  // layer 0: encoding channels are produced and consumed one pair at a time
  float h[kHid];
  for (int o = 0; o < kHid; ++o) h[o] = W[o * (kEnc + 1) + kEnc];
  for (int dim = 0; dim < 3; ++dim) {
    for (int k = 0; k < kFreq; ++k) {
      float cs, sn;
      enc_pair(sym[dim], k, cs, sn);
      const int c = dim * 2 * kFreq + 2 * k;
      for (int o = 0; o < kHid; ++o)
        h[o] += W[o * (kEnc + 1) + c] * cs + W[o * (kEnc + 1) + c + 1] * sn;
    }
  }

  // layers 1..4: LayerNorm + GELU, then Linear
  float raw = 0.f;
  for (int l = 1; l <= 4; ++l) {
    float y[kHid], a[kHid], cdf[kHid];
    ln_gelu(h, y, a, cdf);
    const float* Wl = W + layer_offset(l);
    const int out = l < 4 ? kHid : 1;
    for (int o = 0; o < out; ++o) {
      float acc = Wl[o * (kHid + 1) + kHid];
      for (int i = 0; i < kHid; ++i) acc += Wl[o * (kHid + 1) + i] * a[i];
      if (l < 4)
        h[o] = acc;
      else
        raw = acc;
    }
  }
  return box.d + sigmoidf(raw - 1.f);
}

// ---- Sphere tracing (sphere_trace.cu) ----
//
// The gradient-stopped march of renderer.sphere_tracing, ray by ray. The
// distance it steps by is the hard union, the least d_i over the valid
// instances (NaN if a d_i is NaN, as argmin picks a NaN first; FLT_MAX when
// no instance is valid), or with tau > 0 the softmin union. d_i is the value
// forward instance_forward, its encoding dividing by the scale as the
// twin does (Scaler: a rounded 1 / scale moves every phase by one relative
// error, which a march can turn into a step more or less). W: the scene's
// N x 1617 weights, or nullptr for box only. A union is accumulated over a subset of the instances
// (part), such subsets are merged (merge), and the merged whole gives the
// distance (finish): on the host over all instances at once, on the card
// over each lane's share of a ray's instances.
struct UnionPart {
  float mx, z, sd;  // softmin: the max logit, sum e, sum e d; hard: sd is the min
};

struct SceneField {
  int n;
  const float *loc, *rot, *half, *valid, *W;
  bool any_valid;
  Scaler inv;
  float tau;

  VSRD_HD float distance(const float x[3], int i) const {
    return instance_forward(x, loc + 3 * i, rot + 9 * i, half + 3 * i,
                            W ? W + i * kWeights : nullptr, inv);
  }

  // the union over the instances first, first + stride, ...
  VSRD_HD UnionPart part(const float x[3], int first, int stride) const {
    UnionPart p{-INFINITY, 0.f, tau > 0.f ? 0.f : 3.402823466e+38f};
    for (int i = first; i < n; i += stride) {
      if (tau > 0.f) {
        if (!instance_active(valid[i], any_valid)) continue;
        const float d = distance(x, i), l = union_logit(d, valid[i], tau);
        if (l > p.mx) {
          const float sc = expf(p.mx - l);
          p.z *= sc;
          p.sd *= sc;
          p.mx = l;
        }
        const float e = expf(l - p.mx);
        p.z += e;
        p.sd += e * d;
      } else if (valid[i] > 0.5f) {
        const float d = distance(x, i);
        if (d != d || d < p.sd) p.sd = d;  // a NaN stays: d < NaN is false
      }
    }
    return p;
  }

  VSRD_HD UnionPart merge(const UnionPart& a, const UnionPart& b) const {
    if (tau > 0.f) {
      const float m = fmaxf(a.mx, b.mx);
      const float ea = a.mx == -INFINITY ? 0.f : expf(a.mx - m);
      const float eb = b.mx == -INFINITY ? 0.f : expf(b.mx - m);
      return {m, a.z * ea + b.z * eb, a.sd * ea + b.sd * eb};
    }
    return {a.mx, 0.f, (a.sd != a.sd || b.sd != b.sd) ? NAN : fminf(a.sd, b.sd)};
  }

  VSRD_HD float finish(const UnionPart& p) const { return tau > 0.f ? p.sd / p.z : p.sd; }

  VSRD_HD float operator()(const float x[3]) const { return finish(part(x, 0, 1)); }
};

// One ray of the march: its position, whether it is in the foreground (its
// origin finite, inside the bounding sphere) and whether it converged.
struct TraceRay {
  float p[3];
  bool fg, conv;
};

// a ray that keeps its frame's march going
VSRD_HD bool trace_active(const TraceRay& s) { return s.fg && !s.conv; }

// x + v sd, rounded as the twin rounds it: the product, then the sum
VSRD_HD float step_along(float x, float v, float sd) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(x, __fmul_rn(v, sd));
#else
  return x + v * sd;
#endif
}

// One trip of the JAX while_loop's body for one ray: sd at the position;
// the move by sd along v if the ray was active BEFORE this trip; the sphere
// test (radius > 0) after the move; only then conv = |sd| < crit. So a ray
// moves once more after it first reads |sd| < crit.
template <class Field>
VSRD_HD void trace_trip(const Field& field, const float v[3], float radius, float crit,
                        TraceRay& s) {
  const float sd = field(s.p);
  if (trace_active(s))
    for (int c = 0; c < 3; ++c) s.p[c] = step_along(s.p[c], v[c], sd);
  if (radius > 0.f && s.fg) s.fg = sqrtf(s.p[0] * s.p[0] + s.p[1] * s.p[1] + s.p[2] * s.p[2]) < radius;
  s.conv = fabsf(sd) < crit;
}

// Where a ray's march stopped. From trip t_in on the ray is inactive for
// good, at the position and foreground of s, with conv_in at trip t_in and
// conv_after at every later trip (an inactive ray no longer moves, so one
// more trip re-evaluates its conv and then nothing changes). t_in =
// num_iterations when the ray was still changing at the cap.
struct TraceRecord {
  TraceRay s;
  int t_in;
  bool conv_in, conv_after;
};

// The march of one ray from its start s (trip 0), trip by trip, until the
// ray is inactive for good or num_iterations trips are made. mark(t) for
// every trip t < num_iterations at whose start the ray is active: the frame
// runs its t-th trip exactly when some ray marks t. A ray may turn active
// again (an inactive converged ray whose re-evaluated |sd| reaches crit), so
// its record names only its last inactive run.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Field, class Mark>
VSRD_HD TraceRecord march_ray(const Field& field, TraceRay s, const float v[3],
                              int num_iterations, float radius, float crit, Mark& mark) {
  TraceRecord rec;
  rec.t_in = 0;
  rec.conv_in = s.conv;
  for (int t = 0; t < num_iterations; ++t) {
    const bool was = trace_active(s);
    if (was) mark(t);
    trace_trip(field, v, radius, crit, s);
    const bool now = trace_active(s);
    if (!was && !now) {  // inactive at t and t + 1: nothing changes after t + 1
      rec.s = s;
      rec.conv_after = s.conv;
      return rec;
    }
    if (!now) {
      rec.t_in = t + 1;
      rec.conv_in = s.conv;
    }
  }
  rec.s = s;
  rec.t_in = num_iterations;
  rec.conv_in = rec.conv_after = s.conv;
  return rec;
}

// The trip count of a frame: its first trip that no ray marked, or
// num_iterations.
VSRD_HD int frame_trips(const unsigned char* marked, int num_iterations) {
  for (int t = 0; t < num_iterations; ++t)
    if (!marked[t]) return t;
  return num_iterations;
}

// The ray's state after its frame's T trips: from the record when T falls
// in its last inactive run, else (T inside an earlier inactive spell, which
// only a ray that turned active again has) by replaying T trips from s0.
template <class Field>
VSRD_HD TraceRay finish_ray(const Field& field, TraceRay s0, const float v[3],
                            const TraceRecord& rec, int T, float radius, float crit) {
  if (T >= rec.t_in) {
    TraceRay s = rec.s;
    s.conv = T == rec.t_in ? rec.conv_in : rec.conv_after;
    return s;
  }
  for (int t = 0; t < T; ++t) trace_trip(field, v, radius, crit, s0);
  return s0;
}

}  // namespace vsrd
