// The arithmetic of kernel P1, shared by its forward (projection_fwd.cu)
// and its backward (projection_bwd.cu): the activation of a Gaussian, its
// SH radiance and its EWA projection into one view, each operation in the
// order and the rounding of the plain chain it replaces
// (casualhdrsplat_torch/models/gaussians.py `activate` and
// `colors_for_view`, ops/sh.py `eval_sh`, ops/projection.py
// `project_gaussians` and `cull_invisible`, ops/binning.py
// `build_payload`), so that the forward's outputs equal the chain's bit for
// bit and the backward recomputes the very values the forward wrote.
//
// How the bits are kept.
// - Every product, sum and quotient is one float32 operation rounded to
//   nearest (`rf`: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn on the
//   card), never contracted into an FMA: the chain runs each operation as
//   its own ATen elementwise kernel.  Sums run in the association of the
//   Python expressions; Python's `sum()` starts from `0 +`.
// - A Python scalar enters as the float32 it rounds to (`(float)1.3`), as
//   ATen takes a scalar into a float32 kernel; `1.0 / x` is PyTorch's
//   `x.reciprocal() * 1.0`, a division; clamps and `where` select.
// - expf and sqrtf are the CUDA library's, compiled with nvcc's defaults
//   as ATen's are: sigmoid(x) = 1 / (1 + expf(-x)), ATen's CUDA formula.
// - The chain's three small reductions are ATen's reduce kernel over a
//   last dimension of 3 or 4 (`.sum(-1)` of the camera-space mean,
//   `torch.linalg.norm` of the quaternion and of the view direction).  With
//   fewer than 32 elements an output gets a block row of last_pow2(size)
//   threads, each thread sums its elements strided by that width, and a
//   shuffle tree joins the threads, the widest offset first: over 3
//   elements (e0 + e2) + e1, over 4 (e0 + e2) + (e1 + e3), each element
//   squared first for a norm.  Found on the card (torch 2.11, CUDA 12.8)
//   by comparing torch's results with every association over 2^20-2^23
//   inputs: these match all, each other one fails on 6-30% of them
//   (tests/test_torch_projection_cuda.py keeps the check).
// - The tangent-plane limits are `project_gaussians`' expression on the
//   0-dim intrinsics, evaluated here per thread (`camera`).
//
// Host code (the same functions without the card's intrinsics) builds with
// any C++ compiler under -ffp-contract=off.

#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define P1_FN __host__ __device__ __forceinline__
#else
#define P1_FN inline
#endif

namespace p1 {

constexpr int kPayloadDim = 16;
constexpr int kMaxBases = 16;  // SH degree 3

// One float32 operation at a time, rounded to nearest, never fused.
struct rf {
  float v;
  P1_FN rf() : v(0.0f) {}
  P1_FN rf(float x) : v(x) {}
};

#if defined(__CUDA_ARCH__)
P1_FN rf operator+(rf a, rf b) { return rf(__fadd_rn(a.v, b.v)); }
P1_FN rf operator-(rf a, rf b) { return rf(__fsub_rn(a.v, b.v)); }
P1_FN rf operator*(rf a, rf b) { return rf(__fmul_rn(a.v, b.v)); }
P1_FN rf operator/(rf a, rf b) { return rf(__fdiv_rn(a.v, b.v)); }
P1_FN rf rsqrt_(rf a) { return rf(__fsqrt_rn(a.v)); }
#else
P1_FN rf operator+(rf a, rf b) { return rf(a.v + b.v); }
P1_FN rf operator-(rf a, rf b) { return rf(a.v - b.v); }
P1_FN rf operator*(rf a, rf b) { return rf(a.v * b.v); }
P1_FN rf operator/(rf a, rf b) { return rf(a.v / b.v); }
P1_FN rf rsqrt_(rf a) { return rf(sqrtf(a.v)); }
#endif
P1_FN rf operator-(rf a) { return rf(-a.v); }
P1_FN bool operator>(rf a, rf b) { return a.v > b.v; }
P1_FN bool operator<(rf a, rf b) { return a.v < b.v; }
P1_FN bool operator>=(rf a, rf b) { return a.v >= b.v; }
P1_FN bool operator<=(rf a, rf b) { return a.v <= b.v; }
P1_FN rf rexp(rf a) { return rf(expf(a.v)); }
P1_FN rf rceil(rf a) { return rf(ceilf(a.v)); }
// torch.clamp(x, min=lo): NaN passes
P1_FN rf clamp_min(rf x, rf lo) { return isnan(x.v) ? x : rf(fmaxf(x.v, lo.v)); }
// torch.clamp(x, lo, hi) with tensor bounds
P1_FN rf clamp2(rf x, rf lo, rf hi) {
  return isnan(x.v) ? x : rf(fminf(fmaxf(x.v, lo.v), hi.v));
}
P1_FN rf sel(bool c, rf a, rf b) { return c ? a : b; }

// ATen's reduce kernel over a last dimension of 3 and of 4 (the note above)
P1_FN rf sum3(rf e0, rf e1, rf e2) { return (e0 + e2) + e1; }
P1_FN rf norm3(rf e0, rf e1, rf e2) { return rsqrt_((e0 * e0 + e2 * e2) + e1 * e1); }
P1_FN rf norm4(rf e0, rf e1, rf e2, rf e3) {
  return rsqrt_((e0 * e0 + e2 * e2) + (e1 * e1 + e3 * e3));
}
// Python's sum() of three terms
P1_FN rf psum3(rf a, rf b, rf c) { return ((rf(0.0f) + a) + b) + c; }

// ops/sh.py's constants, as the float32 a scalar rounds to
#define P1_F(x) rf((float)(x))
#define P1_C0 P1_F(0.28209479177387814)
#define P1_C1 P1_F(0.4886025119029199)
#define P1_C20 P1_F(1.0925484305920792)
#define P1_C21 P1_F(-1.0925484305920792)
#define P1_C22 P1_F(0.31539156525252005)
#define P1_C23 P1_F(-1.0925484305920792)
#define P1_C24 P1_F(0.5462742152960396)
#define P1_C30 P1_F(-0.5900435899266435)
#define P1_C31 P1_F(2.890611442640554)
#define P1_C32 P1_F(-0.4570457994644658)
#define P1_C33 P1_F(0.3731763325901154)
#define P1_C34 P1_F(-0.4570457994644658)
#define P1_C35 P1_F(1.445305721320277)
#define P1_C36 P1_F(-0.5900435899266435)

// The inputs of one call.  `raw`: the store's leaves (log-scales, opacity
// logits, alive) are activated here; else scales and opacities are given
// activated.  colors [color_views, n, 3] replace the SH term when given;
// else the SH directions start at the centres of camtoworlds (color_views
// is 1, shared by every view, or views).
struct Inputs {
  const float* means;        // [n, 3]
  const float* quats;        // [n, 4]
  const float* scales;       // [n, 3] log-scales (raw) or scales
  const float* opacity;      // [n] logits (raw) or opacities
  const float* sh_dc;        // [n, 1, 3]
  const float* sh_rest;      // [n, rest, 3]
  const float* colors;       // [color_views, n, 3] or null
  const float* viewmats;     // [views, 4, 4] world to camera
  const float* camtoworlds;  // [color_views, 4, 4] or null: their centres see the SH
  const float* offset;       // [n, 2] or null
  const uint8_t* alive;      // [n] (raw)
  const float *fx, *fy, *cx, *cy;  // one float each, in pixels
  int n, views, color_views, rest, raw, antialias;
  float near_plane, width, height;
};

// The camera: the intrinsics and ops/projection.py's tangent-plane limits
//   lim_x = 1.3 * (0.5 * width / fx + |(cx - 0.5 * width) / fx|)
// as PyTorch evaluates it on 0-dim tensors (`400.0 / fx` is
// `fx.reciprocal() * 400.0`).
struct Cam {
  rf fx, fy, cx, cy, lim_x, lim_y;
};

P1_FN rf tangent_limit(rf f, rf c, float size) {
  const rf half(0.5f * size);
  return P1_F(1.3) * ((rf(1.0f) / f) * half + rf(fabsf(((c - half) / f).v)));
}

P1_FN Cam camera(const Inputs& in) {
  Cam k;
  k.fx = rf(*in.fx);
  k.fy = rf(*in.fy);
  k.cx = rf(*in.cx);
  k.cy = rf(*in.cy);
  k.lim_x = tangent_limit(k.fx, k.cx, in.width);
  k.lim_y = tangent_limit(k.fy, k.cy, in.height);
  return k;
}

// A Gaussian's activated values (models/gaussians.py `activate` and
// lie.quat_to_rotmat) and the products of `_cov2d_components` that do not
// depend on the view.
struct Gauss {
  rf p[3], q[4], qn[4], qnorm, s[3], op, sig_logit, m[3][3], sig[3][3];
  float rot[3][3];
  bool alive;
};

P1_FN void activate(const Inputs& in, int g, Gauss& a) {
  for (int k = 0; k < 3; ++k) a.p[k] = rf(in.means[3 * g + k]);
  for (int k = 0; k < 4; ++k) a.q[k] = rf(in.quats[4 * g + k]);
  a.qnorm = norm4(a.q[0], a.q[1], a.q[2], a.q[3]);
  const rf cq = clamp_min(a.qnorm, P1_F(1e-8));
  for (int k = 0; k < 4; ++k) a.qn[k] = a.q[k] / cq;
  const rf w = a.qn[0], x = a.qn[1], y = a.qn[2], z = a.qn[3];
  const rf one(1.0f), two(2.0f);
  rf rot[3][3];
  rot[0][0] = one - two * (y * y + z * z);
  rot[0][1] = two * (x * y - w * z);
  rot[0][2] = two * (x * z + w * y);
  rot[1][0] = two * (x * y + w * z);
  rot[1][1] = one - two * (x * x + z * z);
  rot[1][2] = two * (y * z - w * x);
  rot[2][0] = two * (x * z - w * y);
  rot[2][1] = two * (y * z + w * x);
  rot[2][2] = one - two * (x * x + y * y);
  for (int k = 0; k < 3; ++k) {
    const rf sk(in.scales[3 * g + k]);
    a.s[k] = in.raw ? rexp(sk) : sk;
  }
  const rf o(in.opacity[g]);
  a.alive = in.raw ? in.alive[g] != 0 : true;
  if (in.raw) {
    a.sig_logit = one / (one + rexp(-o));
    a.op = a.sig_logit * rf(a.alive ? 1.0f : 0.0f);
  } else {
    a.sig_logit = o;
    a.op = o;
  }
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      a.rot[i][k] = rot[i][k].v;
      a.m[i][k] = rot[i][k] * a.s[k];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      a.sig[i][j] = psum3(a.m[i][0] * a.m[j][0], a.m[i][1] * a.m[j][1], a.m[i][2] * a.m[j][2]);
      a.sig[j][i] = a.sig[i][j];
    }
}

// ops/projection.py `project_gaussians` for one Gaussian and one view,
// then the offset, `cull_invisible` and `build_payload`'s opacity.
struct Proj {
  float W[3][3];
  rf t[3], tz_safe, inv_z, ux, uy, txz, tyz, a[3][3], c00, c01, c02, c11, c12, c22;
  rf j00, j02, j11, j12, sxx, sxy, syy, det_raw, sxx_b, syy_b, det, inv_det, comp, radius;
  rf mx, my, conic[3], opa;
  bool in_front, nondeg, valid;
};

P1_FN void project(const Inputs& in, const Cam& cam, const Gauss& a, int g, int v, Proj& r) {
  const float* vm = in.viewmats + 16 * v;
  rf W[3][3], tv[3];
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      W[i][k] = rf(vm[4 * i + k]);
      r.W[i][k] = vm[4 * i + k];
    }
    tv[i] = rf(vm[4 * i + 3]);
  }
  const rf fx = cam.fx, fy = cam.fy, cx = cam.cx, cy = cam.cy, lim_x = cam.lim_x,
           lim_y = cam.lim_y;
  for (int i = 0; i < 3; ++i)
    r.t[i] = sum3(a.p[0] * W[i][0], a.p[1] * W[i][1], a.p[2] * W[i][2]) + tv[i];
  const rf tx = r.t[0], ty = r.t[1], tz = r.t[2];
  r.in_front = tz > rf(in.near_plane);
  r.tz_safe = sel(r.in_front, tz, rf(1.0f));
  r.inv_z = rf(1.0f) / r.tz_safe;
  r.ux = tx * r.inv_z;
  r.uy = ty * r.inv_z;
  r.txz = clamp2(r.ux, -lim_x, lim_x) * r.tz_safe;
  r.tyz = clamp2(r.uy, -lim_y, lim_y) * r.tz_safe;

  // W Sigma (a) and W Sigma W^T (c), Python sums over k
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r.a[i][j] = psum3(W[i][0] * a.sig[0][j], W[i][1] * a.sig[1][j], W[i][2] * a.sig[2][j]);
#define P1_CAT(i, j) psum3(r.a[i][0] * W[j][0], r.a[i][1] * W[j][1], r.a[i][2] * W[j][2])
  r.c00 = P1_CAT(0, 0);
  r.c01 = P1_CAT(0, 1);
  r.c02 = P1_CAT(0, 2);
  r.c11 = P1_CAT(1, 1);
  r.c12 = P1_CAT(1, 2);
  r.c22 = P1_CAT(2, 2);
#undef P1_CAT

  const rf two(2.0f);
  r.j00 = fx * r.inv_z;
  r.j02 = ((-fx * r.txz) * r.inv_z) * r.inv_z;
  r.j11 = fy * r.inv_z;
  r.j12 = ((-fy * r.tyz) * r.inv_z) * r.inv_z;
  r.sxx = (r.j00 * r.j00 * r.c00 + two * r.j00 * r.j02 * r.c02) + r.j02 * r.j02 * r.c22;
  r.sxy = ((r.j00 * r.j11 * r.c01 + r.j00 * r.j12 * r.c02) + r.j02 * r.j11 * r.c12) +
          r.j02 * r.j12 * r.c22;
  r.syy = (r.j11 * r.j11 * r.c11 + two * r.j11 * r.j12 * r.c12) + r.j12 * r.j12 * r.c22;

  r.det_raw = r.sxx * r.syy - r.sxy * r.sxy;
  r.sxx_b = r.sxx + P1_F(0.3);
  r.syy_b = r.syy + P1_F(0.3);
  r.det = r.sxx_b * r.syy_b - r.sxy * r.sxy;
  r.nondeg = r.det > P1_F(1e-10);
  r.inv_det = rf(1.0f) / sel(r.nondeg, r.det, rf(1.0f));
  r.conic[0] = r.syy_b * r.inv_det;
  r.conic[1] = -r.sxy * r.inv_det;
  r.conic[2] = r.sxx_b * r.inv_det;
  if (in.antialias)
    r.comp = sel(r.nondeg, rsqrt_(clamp_min(r.det_raw, rf(0.0f)) * r.inv_det), rf(0.0f));
  else
    r.comp = rf(1.0f);

  const rf mid = P1_F(0.5) * (r.sxx_b + r.syy_b);
  const rf lam_max = mid + rsqrt_(clamp_min(mid * mid - r.det, P1_F(0.01)));
  rf radius = rceil(P1_F(3.0) * rsqrt_(lam_max));
  r.mx = fx * tx * r.inv_z + cx;
  r.my = fy * ty * r.inv_z + cy;
  const rf zero(0.0f);
  const bool on_screen = (r.mx + radius > zero) && (r.mx - radius < rf(in.width)) &&
                         (r.my + radius > zero) && (r.my - radius < rf(in.height));
  const bool valid = r.in_front && r.nondeg && on_screen;
  if (in.offset) {
    r.mx = r.mx + rf(in.offset[2 * g]);
    r.my = r.my + rf(in.offset[2 * g + 1]);
  }
  r.valid = valid && a.op > zero;  // cull_invisible
  r.radius = sel(r.valid, radius, zero);
  r.opa = sel(r.valid, a.op * r.comp, zero);
}

// The SH radiance (ops/projection.py `view_directions`, ops/sh.py
// `eval_sh`) with what its backward needs.
struct Shade {
  rf d0[3], n1, d1[3], n2, d[3], pre[3], rgb[3];
};

template <int DEG>
P1_FN void shade(const Gauss& a, const rf (*coef)[3], const float* c2w, Shade& s) {
  for (int k = 0; k < 3; ++k) s.d0[k] = a.p[k] - rf(c2w[4 * k + 3]);
  s.n1 = norm3(s.d0[0], s.d0[1], s.d0[2]);
  const rf c1 = clamp_min(s.n1, P1_F(1e-8));
  for (int k = 0; k < 3; ++k) s.d1[k] = s.d0[k] / c1;
  s.n2 = norm3(s.d1[0], s.d1[1], s.d1[2]);
  const rf c2 = clamp_min(s.n2, P1_F(1e-8));
  for (int k = 0; k < 3; ++k) s.d[k] = s.d1[k] / c2;
  const rf x = s.d[0], y = s.d[1], z = s.d[2];
  const rf xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  const rf two(2.0f), three(3.0f), four(4.0f);
  for (int c = 0; c < 3; ++c) {
    rf res = P1_C0 * coef[0][c];
    if (DEG >= 1) res = res + P1_C1 * (-y * coef[1][c] + z * coef[2][c] - x * coef[3][c]);
    if (DEG >= 2)
      res = res + ((((P1_C20 * xy * coef[4][c] + P1_C21 * yz * coef[5][c]) +
                     P1_C22 * (two * zz - xx - yy) * coef[6][c]) +
                    P1_C23 * xz * coef[7][c]) +
                   P1_C24 * (xx - yy) * coef[8][c]);
    if (DEG >= 3)
      res = res + ((((((P1_C30 * y * (three * xx - yy) * coef[9][c] +
                        P1_C31 * xy * z * coef[10][c]) +
                       P1_C32 * y * (four * zz - xx - yy) * coef[11][c]) +
                      P1_C33 * z * (two * zz - three * xx - three * yy) * coef[12][c]) +
                     P1_C34 * x * (four * zz - xx - yy) * coef[13][c]) +
                    P1_C35 * z * (xx - yy) * coef[14][c]) +
                   P1_C36 * x * (xx - three * yy) * coef[15][c]);
    s.pre[c] = res + P1_F(0.5);
    s.rgb[c] = clamp_min(s.pre[c], rf(0.0f));
  }
}

// The SH coefficients of Gaussian g up to degree DEG.
template <int DEG>
P1_FN void load_coefs(const Inputs& in, int g, rf (*coef)[3]) {
  for (int c = 0; c < 3; ++c) coef[0][c] = rf(in.sh_dc[3 * g + c]);
  for (int k = 1; k < (DEG + 1) * (DEG + 1); ++k)
    for (int c = 0; c < 3; ++c)
      coef[k][c] = rf(in.sh_rest[((int64_t)g * in.rest + (k - 1)) * 3 + c]);
}

// The SH bases at unit direction d and their derivatives in x, y and z
// (plain float: the backward's).
template <int DEG>
P1_FN void sh_bases(const float d[3], float b[kMaxBases], float bx[kMaxBases],
                    float by[kMaxBases], float bz[kMaxBases]) {
  const float x = d[0], y = d[1], z = d[2];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float C0 = (float)0.28209479177387814, C1 = (float)0.4886025119029199;
  const float C20 = (float)1.0925484305920792, C21 = (float)-1.0925484305920792,
              C22 = (float)0.31539156525252005, C23 = (float)-1.0925484305920792,
              C24 = (float)0.5462742152960396;
  const float C30 = (float)-0.5900435899266435, C31 = (float)2.890611442640554,
              C32 = (float)-0.4570457994644658, C33 = (float)0.3731763325901154,
              C34 = (float)-0.4570457994644658, C35 = (float)1.445305721320277,
              C36 = (float)-0.5900435899266435;
  b[0] = C0;
  bx[0] = by[0] = bz[0] = 0.0f;
  if (DEG >= 1) {
    b[1] = -C1 * y; bx[1] = 0.0f; by[1] = -C1; bz[1] = 0.0f;
    b[2] = C1 * z; bx[2] = 0.0f; by[2] = 0.0f; bz[2] = C1;
    b[3] = -C1 * x; bx[3] = -C1; by[3] = 0.0f; bz[3] = 0.0f;
  }
  if (DEG >= 2) {
    b[4] = C20 * x * y; bx[4] = C20 * y; by[4] = C20 * x; bz[4] = 0.0f;
    b[5] = C21 * y * z; bx[5] = 0.0f; by[5] = C21 * z; bz[5] = C21 * y;
    b[6] = C22 * (2.0f * zz - xx - yy);
    bx[6] = -2.0f * C22 * x; by[6] = -2.0f * C22 * y; bz[6] = 4.0f * C22 * z;
    b[7] = C23 * x * z; bx[7] = C23 * z; by[7] = 0.0f; bz[7] = C23 * x;
    b[8] = C24 * (xx - yy); bx[8] = 2.0f * C24 * x; by[8] = -2.0f * C24 * y; bz[8] = 0.0f;
  }
  if (DEG >= 3) {
    b[9] = C30 * y * (3.0f * xx - yy);
    bx[9] = 6.0f * C30 * x * y; by[9] = C30 * (3.0f * xx - 3.0f * yy); bz[9] = 0.0f;
    b[10] = C31 * x * y * z;
    bx[10] = C31 * y * z; by[10] = C31 * x * z; bz[10] = C31 * x * y;
    b[11] = C32 * y * (4.0f * zz - xx - yy);
    bx[11] = -2.0f * C32 * x * y; by[11] = C32 * (4.0f * zz - xx - 3.0f * yy);
    bz[11] = 8.0f * C32 * y * z;
    b[12] = C33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    bx[12] = -6.0f * C33 * x * z; by[12] = -6.0f * C33 * y * z;
    bz[12] = C33 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
    b[13] = C34 * x * (4.0f * zz - xx - yy);
    bx[13] = C34 * (4.0f * zz - 3.0f * xx - yy); by[13] = -2.0f * C34 * x * y;
    bz[13] = 8.0f * C34 * x * z;
    b[14] = C35 * z * (xx - yy);
    bx[14] = 2.0f * C35 * x * z; by[14] = -2.0f * C35 * y * z; bz[14] = C35 * (xx - yy);
    b[15] = C36 * x * (xx - 3.0f * yy);
    bx[15] = C36 * (3.0f * xx - 3.0f * yy); by[15] = -6.0f * C36 * x * y; bz[15] = 0.0f;
  }
}

// The gradient of y = x / max(|x|, 1e-8) in x, given the gradient of y:
// the clamp passes the norm's gradient where |x| >= 1e-8.
P1_FN void normalize_vjp(const rf x[3], rf n, const float gy[3], float gx[3]) {
  const float c = fmaxf(n.v, 1e-8f);
  float dot = 0.0f;
  for (int k = 0; k < 3; ++k) dot += gy[k] * x[k].v;
  const float through = n.v >= 1e-8f ? dot / (c * c * n.v) : 0.0f;
  for (int k = 0; k < 3; ++k) gx[k] = gy[k] / c - through * x[k].v;
}

// ---- the backward's chain (csrc/projection_bwd.cu), plain float32 ----

// The gradients asked for, null where not.
struct Outs {
  float *means, *quats, *scales, *opacity, *sh_dc, *sh_rest, *colors, *offset;
};

// One Gaussian's gradients, summed over the views.
template <int DEG>
struct Acc {
  static constexpr int kBases = DEG >= 0 ? (DEG + 1) * (DEG + 1) : 1;
  float gp[3] = {0.0f, 0.0f, 0.0f};    // the mean
  float P[3][3] = {};                   // sum over views of W^T Gs W (d M = P M)
  float g_op = 0.0f, g_off[2] = {0.0f, 0.0f};
  float gcoef[kBases][3] = {};
  float g_rgb[3] = {0.0f, 0.0f, 0.0f};  // a radiance the views share
  float gc[3] = {0.0f, 0.0f, 0.0f};     // its camera centre
};

// The SH radiance's backward for one camera centre: adds to the
// coefficients', the mean's and the centre's gradients.
template <int DEG>
P1_FN void shade_vjp(const Gauss& a, const rf (*coef)[3], const float* c2w,
                     const float grgb[3], float (*gcoef)[3], float gp[3], float gc[3]) {
  constexpr int kBases = (DEG + 1) * (DEG + 1);
  Shade s;
  shade<DEG>(a, coef, c2w, s);
  float gres[3];
  for (int c = 0; c < 3; ++c) gres[c] = s.pre[c].v >= 0.0f ? grgb[c] : 0.0f;
  const float d[3] = {s.d[0].v, s.d[1].v, s.d[2].v};
  float b[kMaxBases], bx[kMaxBases], by[kMaxBases], bz[kMaxBases];
  sh_bases<DEG>(d, b, bx, by, bz);
  float gd[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kBases; ++k) {
    float t = 0.0f;
    for (int c = 0; c < 3; ++c) {
      gcoef[k][c] += b[k] * gres[c];
      t += coef[k][c].v * gres[c];
    }
    gd[0] += bx[k] * t;
    gd[1] += by[k] * t;
    gd[2] += bz[k] * t;
  }
  float gd1[3], gd0[3];
  normalize_vjp(s.d1, s.n2, gd, gd1);
  normalize_vjp(s.d0, s.n1, gd1, gd0);
  for (int k = 0; k < 3; ++k) {
    gp[k] += gd0[k];
    gc[k] -= gd0[k];
  }
}

// View v's share of Gaussian g's gradients, given its payload row's
// gradient drow [9]: adds to `acc` and returns the view's pose gradient
// (gW: the rotation, gt: the translation, gc: the SH centre's, per-view
// colors only).  Per-view given colors' gradients are written here.
template <int DEG>
P1_FN void view_vjp(const Inputs& in, const Cam& cam, const Gauss& a, const rf (*coef)[3],
                    int g, int v, const float drow[9], const Outs& out, Acc<DEG>& acc,
                    float gW[3][3], float gt[3], float gc[3]) {
  Proj r;
  project(in, cam, a, g, v, r);
  const float gmx = drow[0], gmy = drow[1], gc0 = drow[2], gc1 = drow[3], gc2 = drow[4];
  const float gopa = drow[5], grgb[3] = {drow[6], drow[7], drow[8]};
  const float fx = cam.fx.v, fy = cam.fy.v, lim_x = cam.lim_x.v, lim_y = cam.lim_y.v;
  acc.g_off[0] += gmx;
  acc.g_off[1] += gmy;
  float g_comp = 0.0f;
  if (r.valid) {
    acc.g_op += gopa * r.comp.v;
    g_comp = gopa * a.op.v;
  }
  const float tx = r.t[0].v, ty = r.t[1].v, iz = r.inv_z.v, tzs = r.tz_safe.v;
  // means2d = (fx tx, fy ty) inv_z + (cx, cy)
  float g_tx = gmx * fx * iz, g_ty = gmy * fy * iz, g_iz = gmx * fx * tx + gmy * fy * ty;
  // the conics and the compensation
  const float inv_det = r.inv_det.v, sxx_b = r.sxx_b.v, syy_b = r.syy_b.v;
  const float sxx = r.sxx.v, syy = r.syy.v, sxy = r.sxy.v;
  float g_sxxb = gc2 * inv_det, g_syyb = gc0 * inv_det, g_sxy = -gc1 * inv_det;
  float g_invdet = gc0 * syy_b - gc1 * sxy + gc2 * sxx_b;
  float g_dr = 0.0f;
  if (in.antialias && r.nondeg && r.comp.v > 0.0f) {
    const float gu = g_comp * 0.5f / r.comp.v;
    g_dr = gu * inv_det;
    g_invdet += gu * r.det_raw.v;
  }
  const float g_det = r.nondeg ? -g_invdet * inv_det * inv_det : 0.0f;
  g_sxxb += g_det * syy_b;
  g_syyb += g_det * sxx_b;
  g_sxy += -2.0f * g_det * sxy - 2.0f * g_dr * sxy;
  const float g_sxx = g_sxxb + g_dr * syy, g_syy = g_syyb + g_dr * sxx;
  // Sigma2d = J C J^T
  const float j00 = r.j00.v, j02 = r.j02.v, j11 = r.j11.v, j12 = r.j12.v;
  const float c00 = r.c00.v, c01 = r.c01.v, c02 = r.c02.v, c11 = r.c11.v, c12 = r.c12.v,
              c22 = r.c22.v;
  const float g_j00 = g_sxx * (2.0f * j00 * c00 + 2.0f * j02 * c02) +
                      g_sxy * (j11 * c01 + j12 * c02);
  const float g_j02 = g_sxx * (2.0f * j00 * c02 + 2.0f * j02 * c22) +
                      g_sxy * (j11 * c12 + j12 * c22);
  const float g_j11 = g_syy * (2.0f * j11 * c11 + 2.0f * j12 * c12) +
                      g_sxy * (j00 * c01 + j02 * c12);
  const float g_j12 = g_syy * (2.0f * j11 * c12 + 2.0f * j12 * c22) +
                      g_sxy * (j00 * c02 + j02 * c22);
  const float G00 = g_sxx * j00 * j00, G01 = g_sxy * j00 * j11;
  const float G02 = g_sxx * 2.0f * j00 * j02 + g_sxy * j00 * j12;
  const float G11 = g_syy * j11 * j11;
  const float G12 = g_syy * 2.0f * j11 * j12 + g_sxy * j02 * j11;
  const float G22 = g_sxx * j02 * j02 + g_sxy * j02 * j12 + g_syy * j12 * j12;
  // J from inv_z and the clamped tangent-plane position
  g_iz += g_j00 * fx + g_j11 * fy;
  const float g_txz = -g_j02 * fx * iz * iz, g_tyz = -g_j12 * fy * iz * iz;
  g_iz += -2.0f * g_j02 * fx * r.txz.v * iz - 2.0f * g_j12 * fy * r.tyz.v * iz;
  const float ux = r.ux.v, uy = r.uy.v;
  float g_tzs = g_txz * fminf(fmaxf(ux, -lim_x), lim_x) + g_tyz * fminf(fmaxf(uy, -lim_y), lim_y);
  if (ux >= -lim_x && ux <= lim_x) {  // the clamp passes its gradient
    const float gu = g_txz * tzs;
    g_tx += gu * iz;
    g_iz += gu * tx;
  }
  if (uy >= -lim_y && uy <= lim_y) {
    const float gu = g_tyz * tzs;
    g_ty += gu * iz;
    g_iz += gu * ty;
  }
  g_tzs += -g_iz * iz * iz;
  gt[0] = g_tx;
  gt[1] = g_ty;
  gt[2] = r.in_front ? g_tzs : 0.0f;
  // t = W p + t_view
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      acc.gp[k] += r.W[i][k] * gt[i];
      gW[i][k] = gt[i] * a.p[k].v;
    }
  // C = W Sigma W^T, its upper triangle read: with Gs = G + G^T,
  // d W = Gs (W Sigma) and d Sigma's chain d M = W^T Gs W M
  const float Gs[3][3] = {{2.0f * G00, G01, G02}, {G01, 2.0f * G11, G12},
                          {G02, G12, 2.0f * G22}};
  float GsW[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      float sa = 0.0f, sw = 0.0f;
      for (int j = 0; j < 3; ++j) {
        sa += Gs[i][j] * r.a[j][k].v;
        sw += Gs[i][j] * r.W[j][k];
      }
      gW[i][k] += sa;
      GsW[i][k] = sw;
    }
  // P is symmetric: its upper triangle, mirrored, so that an isotropic
  // Gaussian's rotation gets the exact zero autograd's chain gives it
  for (int i = 0; i < 3; ++i)
    for (int k = i; k < 3; ++k) {
      float s = 0.0f;
      for (int j = 0; j < 3; ++j) s += r.W[j][i] * GsW[j][k];
      acc.P[i][k] += s;
      if (k != i) acc.P[k][i] = acc.P[i][k];
    }
  // the radiance: a view's own, or summed for the shared one
  for (int k = 0; k < 3; ++k) gc[k] = 0.0f;
  if (in.color_views > 1) {
    if constexpr (DEG >= 0) {
      shade_vjp<DEG>(a, coef, in.camtoworlds + 16 * v, grgb, acc.gcoef, acc.gp, gc);
    } else if (out.colors) {
      for (int c = 0; c < 3; ++c) out.colors[((int64_t)v * in.n + g) * 3 + c] = grgb[c];
    }
  } else {
    for (int c = 0; c < 3; ++c) acc.g_rgb[c] += grgb[c];
  }
}

// After the views: the radiance the views share, or the shared given
// colors' gradient.
template <int DEG>
P1_FN void shared_vjp(const Inputs& in, const Gauss& a, const rf (*coef)[3], int g,
                      const Outs& out, Acc<DEG>& acc) {
  if (in.color_views != 1) return;
  if constexpr (DEG >= 0) {
    shade_vjp<DEG>(a, coef, in.camtoworlds, acc.g_rgb, acc.gcoef, acc.gp, acc.gc);
  } else if (out.colors) {
    for (int c = 0; c < 3; ++c) out.colors[(int64_t)g * 3 + c] = acc.g_rgb[c];
  }
}

// The leaves' gradients of Gaussian g, written once.
template <int DEG>
P1_FN void write_grads(const Inputs& in, const Gauss& a, int g, const Acc<DEG>& acc,
                       const Outs& out) {
  // Sigma = M M^T, M = R(q) diag(s)
  float g_s[3] = {0.0f, 0.0f, 0.0f}, G[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      float gm = 0.0f;
      for (int j = 0; j < 3; ++j) gm += acc.P[i][j] * a.m[j][k].v;
      G[i][k] = gm * a.s[k].v;
      g_s[k] += gm * a.rot[i][k];
    }
  if (out.quats) {
    const float w = a.qn[0].v, x = a.qn[1].v, y = a.qn[2].v, z = a.qn[3].v;
    const float gq[4] = {
        2.0f * (-z * G[0][1] + y * G[0][2] + z * G[1][0] - x * G[1][2] - y * G[2][0] +
                x * G[2][1]),
        2.0f * (y * G[0][1] + z * G[0][2] + y * G[1][0] - 2.0f * x * G[1][1] - w * G[1][2] +
                z * G[2][0] + w * G[2][1] - 2.0f * x * G[2][2]),
        2.0f * (-2.0f * y * G[0][0] + x * G[0][1] + w * G[0][2] + x * G[1][0] + z * G[1][2] -
                w * G[2][0] + z * G[2][1] - 2.0f * y * G[2][2]),
        2.0f * (-2.0f * z * G[0][0] - w * G[0][1] + x * G[0][2] + w * G[1][0] -
                2.0f * z * G[1][1] + y * G[1][2] + x * G[2][0] + y * G[2][1])};
    // q / max(|q|, 1e-8)
    const float n = a.qnorm.v, c = fmaxf(n, 1e-8f);
    float dot = 0.0f;
    for (int k = 0; k < 4; ++k) dot += gq[k] * a.q[k].v;
    const float through = n >= 1e-8f ? dot / (c * c * n) : 0.0f;
    for (int k = 0; k < 4; ++k) out.quats[4 * g + k] = gq[k] / c - through * a.q[k].v;
  }
  if (out.means)
    for (int k = 0; k < 3; ++k) out.means[3 * g + k] = acc.gp[k];
  if (out.scales)
    for (int k = 0; k < 3; ++k) out.scales[3 * g + k] = in.raw ? g_s[k] * a.s[k].v : g_s[k];
  if (out.opacity) {
    const float sg = a.sig_logit.v;
    out.opacity[g] = in.raw ? (a.alive ? acc.g_op * (sg * (1.0f - sg)) : 0.0f) : acc.g_op;
  }
  if (out.offset) {
    out.offset[2 * g] = acc.g_off[0];
    out.offset[2 * g + 1] = acc.g_off[1];
  }
  if constexpr (DEG >= 0) {
    if (out.sh_dc)
      for (int c = 0; c < 3; ++c) out.sh_dc[3 * g + c] = acc.gcoef[0][c];
    if (out.sh_rest)
      for (int k = 1; k <= in.rest; ++k)
        for (int c = 0; c < 3; ++c)
          out.sh_rest[((int64_t)g * in.rest + (k - 1)) * 3 + c] =
              k < Acc<DEG>::kBases ? acc.gcoef[k][c] : 0.0f;
  }
}

}  // namespace p1
