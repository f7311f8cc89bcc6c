// Shared pieces of the preprocess kernels (preprocess_fwd.cu,
// preprocess_bwd.cu): the per-Gaussian screen-space projection of
// ops/raster/preprocess.py:preprocess, one thread per Gaussian.
//
// Layout, per Gaussian (row-major float32): means3d (P, 3), scales (P, 3),
// quats (P, 4) wxyz, opacities (P,), shs (P, K, 3), cov3d (P, 3, 3) when
// precomputed, means2d_offset (P, 2) when given. Per render: the W2C view
// matrix (4, 4), the full projection P @ W2C (4, 4) and the camera centre
// (3,), all on the card.
//
// Arithmetic: operation for operation what the plain version's PyTorch ops
// compute on the card, under --fmad=false, so that the integer outputs
// (valid, radius, the emission rect, tiles touched), which hinge on float
// thresholds, equal the plain version's on the card bit for bit. Where a
// PyTorch op rounds in its own way, the kernel does the same:
// - `x / scalar` multiplies by the scalar's float reciprocal (PyTorch's
//   CUDA division by a CPU scalar), `scalar / x` is `reciprocal(x) *
//   scalar` (torch.Tensor.__rtruediv__);
// - `means3d @ M.T` (cuBLAS's GEMM) sums the three products as a chain of
//   fused multiply-adds from the first (`dot3`), `means3d @ v` (its GEMV)
//   fuses the second product into the first and adds the third (`dot3_mv`),
//   as measured on the card at the main path's 131072 rows (PERF.md).
// The one exception is the norm of the SH view direction, a PyTorch
// reduction whose order is its own: the colour agrees to rounding.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace prep {

constexpr int BLOCK = 256;
// Entries of the per-block partials of dL/d(view) and dL/d(full_proj):
// two row-major 4x4 matrices.
constexpr int MATRIX_ENTRIES = 32;

// The float32 values of the plain version's Python constants.
constexpr float NEAR_CLIP = static_cast<float>(0.2);
constexpr float LOWPASS = static_cast<float>(0.3);
constexpr float ALPHA_MIN = static_cast<float>(1.0 / 255.0);
constexpr float W_EPS = static_cast<float>(1e-7);
constexpr float OP_MIN = static_cast<float>(1e-12);
constexpr float DISC_MIN = static_cast<float>(0.1);
constexpr float EXTENT_PAD = static_cast<float>(1e-2);
constexpr float NORM_MIN = static_cast<float>(1e-8);

constexpr float SH_C0 = static_cast<float>(0.28209479177387814);
constexpr float SH_C1 = static_cast<float>(0.4886025119029199);
constexpr float SH_C20 = static_cast<float>(1.0925484305920792);
constexpr float SH_C21 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C22 = static_cast<float>(0.31539156525252005);
constexpr float SH_C23 = static_cast<float>(-1.0925484305920792);
constexpr float SH_C24 = static_cast<float>(0.5462742152960396);
constexpr float SH_C30 = static_cast<float>(-0.5900435899266435);
constexpr float SH_C31 = static_cast<float>(2.890611442640554);
constexpr float SH_C32 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C33 = static_cast<float>(0.3731763325901154);
constexpr float SH_C34 = static_cast<float>(-0.4570457994644658);
constexpr float SH_C35 = static_cast<float>(1.445305721320277);
constexpr float SH_C36 = static_cast<float>(-0.5900435899266435);

// Everything a launch reads and writes; pointers the instance does not use
// are null. Scalars computed in double on the host, as the plain version's
// Python floats, then rounded to float.
struct Args {
  const float *means3d, *scales, *quats, *opacities, *shs, *cov3d;
  const float *view, *full_proj, *campos, *offset;
  // Forward outputs.
  float *xy, *depth, *conic, *color;
  unsigned char* valid;
  int *radius, *rect_min, *rect_max, *tiles_touched;
  // Backward: cotangents (row strides; each row's entries adjacent), then
  // per-Gaussian gradients and the per-block matrix partials.
  const float *g_xy, *g_depth, *g_conic, *g_color;
  int xy_stride, depth_stride, conic_stride, color_stride;
  float *g_means, *g_scales, *g_quats, *g_shs, *g_cov3d, *partials;
  int n, sh_coeffs, width, height, tile, tiles_x, tiles_y;
  float focal_x, focal_y, lim_x, lim_y, scale_modifier;
};

// torch.clamp / torch.maximum propagate NaN, as these do.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Row r of a (P, 3) @ (3, 3).T product as cuBLAS rounds it: a chain of
// fused multiply-adds from the first term.
__device__ __forceinline__ float dot3(float m0, float m1, float m2, const float* row) {
  return __fmaf_rn(m2, row[2], __fmaf_rn(m1, row[1], __fmul_rn(m0, row[0])));
}

// One entry of a (P, 3) @ (3,) product as cuBLAS rounds it.
__device__ __forceinline__ float dot3_mv(float m0, float m1, float m2, const float* v) {
  return __fmaf_rn(m1, v[1], __fmul_rn(m0, v[0])) + __fmul_rn(m2, v[2]);
}

// The camera of a launch, read by every thread (the same addresses: one
// broadcast load each).
struct Camera {
  float W[3][3], tv[3], F[4][4];
};

__device__ __forceinline__ Camera load_camera(const Args& a) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c.W[i][k] = __ldg(a.view + 4 * i + k);
    c.tv[i] = __ldg(a.view + 4 * i + 3);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) c.F[i / 4][i % 4] = __ldg(a.full_proj + i);
  return c;
}

// The float quantities of one Gaussian that both directions need, in the
// plain version's order.
struct Geometry {
  float m[3], t[3];        // mean; W m + tv (view space; t[2] is the depth)
  bool in_front;
  float hom0, hom1, pw;    // the full projection's x, y and 1 / (w + 1e-7)
  float tz, q0, q1, txc, tyc, rtz, a, b, tz2, c, d;  // EWA Jacobian terms
  float r[3][3], s2[3];    // rotation and squared scales (unless precomputed)
  float sigma[3][3];       // world covariance
  float s00, s01, s02, s11, s12, s22;  // W sigma W^T
  float cov0, cov1, cov2;  // 2D covariance with the low-pass
  float det, di;           // its determinant, 1 / det (1 where det == 0)
  bool det_ok;
  float px, py;            // pixel-space mean (offset added)
};

__device__ __forceinline__ void quat_to_rotmat(const float q[4], float r[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0][0] = 1.f - 2.f * (y * y + z * z);
  r[0][1] = 2.f * (x * y - w * z);
  r[0][2] = 2.f * (x * z + w * y);
  r[1][0] = 2.f * (x * y + w * z);
  r[1][1] = 1.f - 2.f * (x * x + z * z);
  r[1][2] = 2.f * (y * z - w * x);
  r[2][0] = 2.f * (x * z - w * y);
  r[2][1] = 2.f * (y * z + w * x);
  r[2][2] = 1.f - 2.f * (x * x + y * y);
}

__device__ __forceinline__ void geometry(const Args& a, const Camera& cam, int i,
                                         Geometry& g) {
#pragma unroll
  for (int k = 0; k < 3; ++k) g.m[k] = __ldg(a.means3d + 3 * i + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) g.t[k] = dot3(g.m[0], g.m[1], g.m[2], cam.W[k]) + cam.tv[k];
  g.in_front = g.t[2] > NEAR_CLIP;

  // Full projection: hom = F[:3, :3] m + F[:3, 3], w = F[3, :3] m + F[3, 3].
  g.hom0 = dot3(g.m[0], g.m[1], g.m[2], cam.F[0]) + cam.F[0][3];
  g.hom1 = dot3(g.m[0], g.m[1], g.m[2], cam.F[1]) + cam.F[1][3];
  const float w = dot3_mv(g.m[0], g.m[1], g.m[2], cam.F[3]) + cam.F[3][3];
  g.pw = 1.f / ((g.in_front ? w : 1.f) + W_EPS);

  // World covariance: R S^2 R^T, or the precomputed one.
  if (a.cov3d != nullptr) {
#pragma unroll
    for (int k = 0; k < 9; ++k) g.sigma[k / 3][k % 3] = __ldg(a.cov3d + 9 * i + k);
  } else {
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(a.quats + 4 * i + k);
    quat_to_rotmat(q, g.r);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = a.scale_modifier * __ldg(a.scales + 3 * i + k);
      g.s2[k] = s * s;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rs0 = g.r[r][0] * g.s2[0], rs1 = g.r[r][1] * g.s2[1],
                    rs2 = g.r[r][2] * g.s2[2];
        g.sigma[r][c] = (rs0 * g.r[c][0] + rs1 * g.r[c][1]) + rs2 * g.r[c][2];
      }
  }

  // EWA: the Jacobian terms at the clamped view-space mean.
  g.tz = g.in_front ? g.t[2] : 1.f;
  g.q0 = g.t[0] / g.tz;
  g.q1 = g.t[1] / g.tz;
  g.txc = clamp_to(g.q0, -a.lim_x, a.lim_x) * g.tz;
  g.tyc = clamp_to(g.q1, -a.lim_y, a.lim_y) * g.tz;
  g.rtz = 1.f / g.tz;
  g.a = g.rtz * a.focal_x;
  g.b = g.rtz * a.focal_y;
  g.tz2 = g.tz * g.tz;
  g.c = -(g.txc * a.focal_x) / g.tz2;
  g.d = -(g.tyc * a.focal_y) / g.tz2;

  // W sigma W^T, each entry summed over (k, l) in row-major order.
  float s[3][3];
#pragma unroll
  for (int ii = 0; ii < 3; ++ii)
#pragma unroll
    for (int jj = ii; jj < 3; ++jj) {
      float acc = (cam.W[ii][0] * cam.W[jj][0]) * g.sigma[0][0] + 0.f;
#pragma unroll
      for (int kl = 1; kl < 9; ++kl)
        acc = acc + (cam.W[ii][kl / 3] * cam.W[jj][kl % 3]) * g.sigma[kl / 3][kl % 3];
      s[ii][jj] = acc;
    }
  g.s00 = s[0][0]; g.s01 = s[0][1]; g.s02 = s[0][2];
  g.s11 = s[1][1]; g.s12 = s[1][2]; g.s22 = s[2][2];
  const float cxx = ((g.a * g.a) * g.s00 + ((2.f * g.a) * g.c) * g.s02) + (g.c * g.c) * g.s22;
  const float cxy = (((g.a * g.b) * g.s01 + (g.a * g.d) * g.s02) + (g.c * g.b) * g.s12) +
                    (g.c * g.d) * g.s22;
  const float cyy = ((g.b * g.b) * g.s11 + ((2.f * g.b) * g.d) * g.s12) + (g.d * g.d) * g.s22;
  g.cov0 = cxx + LOWPASS;
  g.cov1 = cxy;
  g.cov2 = cyy + LOWPASS;
  g.det = g.cov0 * g.cov2 - g.cov1 * g.cov1;
  g.det_ok = g.det != 0.f;
  g.di = 1.f / (g.det_ok ? g.det : 1.f);

  g.px = (((g.hom0 * g.pw) + 1.f) * (float)a.width) * 0.5f - 0.5f;
  g.py = (((g.hom1 * g.pw) + 1.f) * (float)a.height) * 0.5f - 0.5f;
  if (a.offset != nullptr) {
    g.px = g.px + __ldg(a.offset + 2 * i);
    g.py = g.py + __ldg(a.offset + 2 * i + 1);
  }
}

// The unit view direction of the SH lookup: (mean - campos) / max(|.|, 1e-8).
struct Direction {
  float v[3], norm, nc, u[3];
};

__device__ __forceinline__ Direction direction(const Args& a, const Geometry& g) {
  Direction d;
#pragma unroll
  for (int k = 0; k < 3; ++k) d.v[k] = g.m[k] - __ldg(a.campos + k);
  d.norm = sqrtf((d.v[0] * d.v[0] + d.v[1] * d.v[1]) + d.v[2] * d.v[2]);
  d.nc = clamp_min(d.norm, NORM_MIN);
#pragma unroll
  for (int k = 0; k < 3; ++k) d.u[k] = d.v[k] / d.nc;
  return d;
}

// The SH basis functions of degree <= DEG at unit direction (x, y, z), in
// coefficient order, each as the plain version rounds its factor of the
// coefficient (ops/sh.py: eval_sh).
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float f[16]) {
  f[0] = SH_C0;
  if (DEG > 0) {
    f[1] = SH_C1 * y;
    f[2] = SH_C1 * z;
    f[3] = SH_C1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    f[4] = SH_C20 * xy;
    f[5] = SH_C21 * yz;
    f[6] = SH_C22 * ((2.f * zz - xx) - yy);
    f[7] = SH_C23 * xz;
    f[8] = SH_C24 * (xx - yy);
    if (DEG > 2) {
      f[9] = (SH_C30 * y) * (3.f * xx - yy);
      f[10] = (SH_C31 * xy) * z;
      f[11] = (SH_C32 * y) * ((4.f * zz - xx) - yy);
      f[12] = (SH_C33 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      f[13] = (SH_C34 * x) * ((4.f * zz - xx) - yy);
      f[14] = (SH_C35 * z) * (xx - yy);
      f[15] = (SH_C36 * x) * (xx - 3.f * yy);
    }
  }
}

// eval_sh of one channel: the terms added left to right, degree 1's
// y and x terms subtracted.
template <int DEG>
__device__ __forceinline__ float sh_eval(const float f[16], const float* sh, int c) {
  float r = sh[c] * f[0];
  if (DEG > 0) {
    r = r - f[1] * sh[3 + c];
    r = r + f[2] * sh[6 + c];
    r = r - f[3] * sh[9 + c];
  }
#pragma unroll
  for (int k = 4; k < (DEG + 1) * (DEG + 1); ++k) r = r + f[k] * sh[3 * k + c];
  return r;
}

}  // namespace prep
