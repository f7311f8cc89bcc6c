// Backward preprocess kernels for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates its XLA-fused
// preprocess with autodiff. In PyTorch, autograd of the plain version
// (ops/raster/preprocess.py) was ~800 launches a tracking iteration and
// ~1150 a mapping render; these two kernels are that gradient, derived by
// hand (ops/raster/preprocess.py:preprocess_backward_plain transcribes the
// same arithmetic for the CPU).
//
// preprocess_bwd_kernel: one thread per Gaussian. It recomputes the
// forward's geometry (preprocess_common.cuh), takes the cotangents of xy,
// depth, conic and colour (opacity passes through outside) and, by the
// instance:
// - GAUSS: writes the gradients of means3d, scales, quats (or the
//   precomputed covariances) and shs, per Gaussian;
// - MATS: sums each CTA's contributions to dL/d(view) and dL/d(full_proj)
//   over its Gaussians, a warp-shuffle tree and then the 8 warps in order,
//   into one row of per-block partials (two 4x4 matrices).
// Tracking, whose Gaussians are constants, needs only the matrices;
// mapping both; colour refinement only the Gaussians'. The semantics are
// those of autograd on the plain forward: `where` sends nothing down its
// unselected side, `clamp` passes the gradient inside its range, ends
// included, Gaussians behind the near plane see tz := 1, the determinant's
// and the SH norm's guards, and the camera centre is a constant.
//
// preprocess_reduce_kernel: one CTA sums the per-block partials in a fixed
// order (8 strided sequences, then the 8 in order). No float atomics
// anywhere, so a repeat on the same inputs gives the same bits.
//
// What bounds them on this card: bytes. Per Gaussian the backward reads
// ~52 bytes of inputs and ~36 of cotangents and writes ~52 of gradients
// (mapping, SH degree 0), ~18 MB at 131072 slots, ~5.5 us at 3.35 TB/s;
// tracking writes only 128 bytes per CTA. Design: the forward recomputed
// in registers (cheaper than storing ~40 intermediates a Gaussian), strided
// cotangent rows read in place (the blend's gradient arrives as column
// slices of its per-Gaussian table), no shared memory but the CTA's 8 x 32
// partials.

#include "preprocess_common.cuh"

namespace prep {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Where entry e (0..23) of a thread's matrix contributions lands in a
// partials row: dL/d(view) rows 0-2 (entries 0-11), dL/d(full_proj) rows
// 0, 1 and 3 (entries 16-23, 28-31); the view's row 3 and the full
// projection's row 2 get no gradient.
__device__ __forceinline__ int matrix_slot(int e) {
  return e < 12 ? e : (e < 20 ? e + 4 : e + 8);
}

// d(result)/d(unit direction) of the SH lookup: sum over coefficients k of
// s[k] times the derivative of the signed basis function (degree 1's
// y and x terms enter with a minus).
template <int DEG>
__device__ __forceinline__ void sh_direction_grad(float x, float y, float z, const float s[16],
                                                  float gu[3]) {
  gu[0] = -SH_C1 * s[3];
  gu[1] = -SH_C1 * s[1];
  gu[2] = SH_C1 * s[2];
  if (DEG > 1) {
    gu[0] += SH_C20 * y * s[4] - 2.f * SH_C22 * x * s[6] + SH_C23 * z * s[7] +
             2.f * SH_C24 * x * s[8];
    gu[1] += SH_C20 * x * s[4] + SH_C21 * z * s[5] - 2.f * SH_C22 * y * s[6] -
             2.f * SH_C24 * y * s[8];
    gu[2] += SH_C21 * y * s[5] + 4.f * SH_C22 * z * s[6] + SH_C23 * x * s[7];
  }
  if (DEG > 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gu[0] += 6.f * SH_C30 * x * y * s[9] + SH_C31 * y * z * s[10] -
             2.f * SH_C32 * x * y * s[11] - 6.f * SH_C33 * x * z * s[12] +
             SH_C34 * (4.f * zz - 3.f * xx - yy) * s[13] + 2.f * SH_C35 * x * z * s[14] +
             SH_C36 * (3.f * xx - 3.f * yy) * s[15];
    gu[1] += SH_C30 * (3.f * xx - 3.f * yy) * s[9] + SH_C31 * x * z * s[10] +
             SH_C32 * (4.f * zz - xx - 3.f * yy) * s[11] - 6.f * SH_C33 * y * z * s[12] -
             2.f * SH_C34 * x * y * s[13] - 2.f * SH_C35 * y * z * s[14] -
             6.f * SH_C36 * x * y * s[15];
    gu[2] += SH_C31 * x * y * s[10] + 8.f * SH_C32 * y * z * s[11] +
             SH_C33 * (6.f * zz - 3.f * xx - 3.f * yy) * s[12] + 8.f * SH_C34 * x * z * s[13] +
             SH_C35 * (xx - yy) * s[14];
  }
}

template <int DEG, bool GAUSS, bool MATS>
__global__ void __launch_bounds__(BLOCK) preprocess_bwd_kernel(const Args a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  float mat[24];  // dL/d(view) rows 0-2, dL/d(full_proj) rows 0, 1, 3
#pragma unroll
  for (int e = 0; e < 24; ++e) mat[e] = 0.f;

  if (i < a.n) {
    const Camera cam = load_camera(a);
    Geometry g;
    geometry(a, cam, i, g);
    float gx = 0.f, gy = 0.f, gdepth = 0.f, gA = 0.f, gB = 0.f, gC = 0.f;
    if (a.g_xy != nullptr) {
      gx = a.g_xy[(size_t)i * a.xy_stride];
      gy = a.g_xy[(size_t)i * a.xy_stride + 1];
    }
    if (a.g_depth != nullptr) gdepth = a.g_depth[(size_t)i * a.depth_stride];
    if (a.g_conic != nullptr) {
      gA = a.g_conic[(size_t)i * a.conic_stride];
      gB = a.g_conic[(size_t)i * a.conic_stride + 1];
      gC = a.g_conic[(size_t)i * a.conic_stride + 2];
    }
    float gm[3] = {0.f, 0.f, 0.f};
    float gt[3] = {0.f, 0.f, gdepth};

    // xy = ((hom * pw + 1) * size) * 0.5 - 0.5 (+ offset); pw = 1 / (w + 1e-7)
    // with w := 1 behind the near plane.
    const float ghom0 = ((gx * 0.5f) * (float)a.width) * g.pw;
    const float ghom1 = ((gy * 0.5f) * (float)a.height) * g.pw;
    const float gpw = ghom0 * g.hom0 + ghom1 * g.hom1;  // (d pw) * pw, below
    const float gw = g.in_front ? -gpw * g.pw : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gm[k] += (ghom0 * cam.F[0][k] + ghom1 * cam.F[1][k]) + gw * cam.F[3][k];

    // conic = (cov2, -cov1, cov0) / det, det guarded.
    float gc0 = gC * g.di, gc1 = -gB * g.di, gc2 = gA * g.di;
    const float gdi = (gA * g.cov2 - gB * g.cov1) + gC * g.cov0;
    const float gdet = g.det_ok ? -gdi * g.di * g.di : 0.f;
    gc0 += gdet * g.cov2;
    gc2 += gdet * g.cov0;
    gc1 -= 2.f * gdet * g.cov1;

    // The 2D covariance from the Jacobian terms (a, b, c, d) and S = W sigma W^T.
    const float ga = gc0 * (2.f * g.a * g.s00 + 2.f * g.c * g.s02) +
                     gc1 * (g.b * g.s01 + g.d * g.s02);
    const float gb = gc2 * (2.f * g.b * g.s11 + 2.f * g.d * g.s12) +
                     gc1 * (g.a * g.s01 + g.c * g.s12);
    const float gcc = gc0 * (2.f * g.a * g.s02 + 2.f * g.c * g.s22) +
                      gc1 * (g.b * g.s12 + g.d * g.s22);
    const float gd = gc2 * (2.f * g.b * g.s12 + 2.f * g.d * g.s22) +
                     gc1 * (g.a * g.s02 + g.c * g.s22);
    float G[3][3] = {{gc0 * g.a * g.a, gc1 * g.a * g.b, 2.f * gc0 * g.a * g.c + gc1 * g.a * g.d},
                     {0.f, gc2 * g.b * g.b, gc1 * g.c * g.b + 2.f * gc2 * g.b * g.d},
                     {0.f, 0.f, (gc0 * g.c * g.c + gc1 * g.c * g.d) + gc2 * g.d * g.d}};

    // a = fx / tz, b = fy / tz, c = -fx txc / tz^2, d = -fy tyc / tz^2;
    // txc = clamp(t0 / tz) tz, tyc = clamp(t1 / tz) tz; tz := 1 behind.
    const float cq0 = clamp_to(g.q0, -a.lim_x, a.lim_x);
    const float cq1 = clamp_to(g.q1, -a.lim_y, a.lim_y);
    const float gtxc = -a.focal_x * (gcc / g.tz2);
    const float gtyc = -a.focal_y * (gd / g.tz2);
    const float gtz2 = -(gcc * g.c + gd * g.d) / g.tz2;
    float gtz = -(ga * a.focal_x + gb * a.focal_y) * g.rtz * g.rtz + 2.f * gtz2 * g.tz +
                gtxc * cq0 + gtyc * cq1;
    const float gq0 = (g.q0 >= -a.lim_x && g.q0 <= a.lim_x) ? gtxc * g.tz : 0.f;
    const float gq1 = (g.q1 >= -a.lim_y && g.q1 <= a.lim_y) ? gtyc * g.tz : 0.f;
    gt[0] += gq0 / g.tz;
    gt[1] += gq1 / g.tz;
    gtz -= (gq0 * g.q0 + gq1 * g.q1) / g.tz;
    if (g.in_front) gt[2] += gtz;

    // t = W m + tv.
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gm[k] += (cam.W[0][k] * gt[0] + cam.W[1][k] * gt[1]) + cam.W[2][k] * gt[2];

    if (MATS) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) mat[4 * r + k] = gt[r] * g.m[k];
        mat[4 * r + 3] = gt[r];
      }
      // S_ij = W_i sigma W_j^T over the upper entries:
      // dW = G W sigma^T + G^T W sigma.
      float ws[3][3], wst[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          ws[r][l] = (cam.W[r][0] * g.sigma[0][l] + cam.W[r][1] * g.sigma[1][l]) +
                     cam.W[r][2] * g.sigma[2][l];
          wst[r][l] = (cam.W[r][0] * g.sigma[l][0] + cam.W[r][1] * g.sigma[l][1]) +
                      cam.W[r][2] * g.sigma[l][2];
        }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          mat[4 * r + k] += ((G[r][0] * wst[0][k] + G[r][1] * wst[1][k]) + G[r][2] * wst[2][k]) +
                            ((G[0][r] * ws[0][k] + G[1][r] * ws[1][k]) + G[2][r] * ws[2][k]);
      const float row[4] = {g.m[0], g.m[1], g.m[2], 1.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        mat[12 + k] = ghom0 * row[k];
        mat[16 + k] = ghom1 * row[k];
        mat[20 + k] = gw * row[k];
      }
    }

    if (GAUSS) {
      // sigma: dsigma = W^T G W.
      float gs[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = r; c < 3; ++c) acc += G[r][c] * cam.W[r][k] * cam.W[c][l];
          gs[k][l] = acc;
        }
      if (a.cov3d != nullptr) {
#pragma unroll
        for (int k = 0; k < 9; ++k) a.g_cov3d[9 * (size_t)i + k] = gs[k / 3][k % 3];
      } else {
        // sigma_rc = sum_k R_rk s2_k R_ck.
        float gR[3][3], gs2[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float acc = 0.f, acc2 = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              acc += (gs[r][c] + gs[c][r]) * g.r[c][k];
              acc2 += gs[r][c] * g.r[c][k];
            }
            gR[r][k] = acc * g.s2[k];
            gs2[k] += acc2 * g.r[r][k];
          }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float s = a.scale_modifier * __ldg(a.scales + 3 * i + k);
          a.g_scales[3 * (size_t)i + k] = gs2[k] * 2.f * s * a.scale_modifier;
        }
        const float w = __ldg(a.quats + 4 * i), x = __ldg(a.quats + 4 * i + 1),
                    y = __ldg(a.quats + 4 * i + 2), z = __ldg(a.quats + 4 * i + 3);
        float* gq = a.g_quats + 4 * (size_t)i;
        gq[0] = 2.f * (((-z * gR[0][1] + y * gR[0][2]) + (z * gR[1][0] - x * gR[1][2])) +
                       (-y * gR[2][0] + x * gR[2][1]));
        gq[1] = 2.f * (((y * gR[0][1] + z * gR[0][2]) + (y * gR[1][0] - 2.f * x * gR[1][1] -
                        w * gR[1][2])) + (z * gR[2][0] + w * gR[2][1] - 2.f * x * gR[2][2]));
        gq[2] = 2.f * (((-2.f * y * gR[0][0] + x * gR[0][1] + w * gR[0][2]) +
                        (x * gR[1][0] + z * gR[1][2])) +
                       (-w * gR[2][0] + z * gR[2][1] - 2.f * y * gR[2][2]));
        gq[3] = 2.f * (((-2.f * z * gR[0][0] - w * gR[0][1] + x * gR[0][2]) +
                        (w * gR[1][0] - 2.f * z * gR[1][1] + y * gR[1][2])) +
                       (x * gR[2][0] + y * gR[2][1]));
      }

      // colour = max(eval_sh(sh, unit(m - campos)) + 0.5, 0).
      if (DEG >= 0) {
        const int nb = (DEG + 1) * (DEG + 1);
        float gcol[3] = {0.f, 0.f, 0.f};
        if (a.g_color != nullptr)
#pragma unroll
          for (int c = 0; c < 3; ++c) gcol[c] = a.g_color[(size_t)i * a.color_stride + c];
        float sh[48];
        const float* src = a.shs + (size_t)i * a.sh_coeffs * 3;
#pragma unroll
        for (int k = 0; k < 3 * nb; ++k) sh[k] = __ldg(src + k);
        Direction d;
        float f[16];
        if (DEG > 0) {
          d = direction(a, g);
          sh_basis<DEG>(d.u[0], d.u[1], d.u[2], f);
        } else {
          f[0] = SH_C0;
        }
        float gr[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          gr[c] = sh_eval<DEG>(f, sh, c) + 0.5f >= 0.f ? gcol[c] : 0.f;
        float* gsh = a.g_shs + (size_t)i * a.sh_coeffs * 3;
        float s[16];
#pragma unroll
        for (int k = 0; k < nb; ++k) {
          const float sign = (k == 1 || k == 3) ? -1.f : 1.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) gsh[3 * k + c] = sign * f[k] * gr[c];
          s[k] = (gr[0] * sh[3 * k] + gr[1] * sh[3 * k + 1]) + gr[2] * sh[3 * k + 2];
        }
        for (int k = 3 * nb; k < 3 * a.sh_coeffs; ++k) gsh[k] = 0.f;
        if (DEG > 0) {
          float gu[3];
          sh_direction_grad<DEG>(d.u[0], d.u[1], d.u[2], s, gu);
          // u = v / max(|v|, 1e-8).
          const float gnc = -((gu[0] * d.v[0] + gu[1] * d.v[1]) + gu[2] * d.v[2]) / (d.nc * d.nc);
          const float gnorm = d.norm >= NORM_MIN ? gnc : 0.f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            gm[k] += gu[k] / d.nc + (d.norm != 0.f ? gnorm * d.v[k] / d.norm : 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) a.g_means[3 * (size_t)i + k] = gm[k];
    }
  }

  if (MATS) {
    __shared__ float part[BLOCK / 32][MATRIX_ENTRIES];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int e = 0; e < 24; ++e) {
      const float v = warp_sum(mat[e]);
      if (lane == 0) part[warp][matrix_slot(e)] = v;
    }
    __syncthreads();
    if (threadIdx.x < MATRIX_ENTRIES) {
      const int e = threadIdx.x;
      const bool used = e < 12 || (e >= 16 && e < 24) || e >= 28;
      float acc = 0.f;
      if (used)
#pragma unroll
        for (int w = 0; w < BLOCK / 32; ++w) acc += part[w][e];
      a.partials[(size_t)blockIdx.x * MATRIX_ENTRIES + e] = acc;
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
preprocess_reduce_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ out) {
  constexpr int GROUPS = BLOCK / MATRIX_ENTRIES;
  __shared__ float acc[GROUPS][MATRIX_ENTRIES];
  const int e = threadIdx.x % MATRIX_ENTRIES, grp = threadIdx.x / MATRIX_ENTRIES;
  float s = 0.f;
  for (int b = grp; b < blocks; b += GROUPS) s += partials[(size_t)b * MATRIX_ENTRIES + e];
  acc[grp][e] = s;
  __syncthreads();
  if (threadIdx.x < MATRIX_ENTRIES) {
    float t = acc[0][e];
#pragma unroll
    for (int k = 1; k < GROUPS; ++k) t += acc[k][e];
    out[e] = t;
  }
}

template <int DEG>
cudaError_t launch_bwd(const Args& a, bool gauss, bool mats, cudaStream_t s) {
  const int grid = (a.n + BLOCK - 1) / BLOCK;
  if (gauss && mats)
    preprocess_bwd_kernel<DEG, true, true><<<grid, BLOCK, 0, s>>>(a);
  else if (gauss)
    preprocess_bwd_kernel<DEG, true, false><<<grid, BLOCK, 0, s>>>(a);
  else if (mats)
    preprocess_bwd_kernel<DEG, false, true><<<grid, BLOCK, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace prep

// Plain C entry points for ctypes.
//
// preprocess_bwd: the cotangents may be null (zero); their rows are
// `*_stride` floats apart. gaussian_grads: write g_means, g_scales and
// g_quats (or g_cov3d when cov3d is given) and g_shs (sh_degree >= 0);
// matrix_grads: write one row of 32 partials per CTA of 256 Gaussians.
// At least one of the two. Returns cudaGetLastError() after the launch.
extern "C" int preprocess_bwd(const float* means3d, const float* scales, const float* quats,
                              const float* shs, const float* cov3d, const float* view,
                              const float* full_proj, const float* campos, const float* g_xy,
                              const float* g_depth, const float* g_conic, const float* g_color,
                              float* g_means, float* g_scales, float* g_quats, float* g_shs,
                              float* g_cov3d, float* partials, int gaussians, int sh_degree,
                              int sh_coeffs, int gaussian_grads, int matrix_grads,
                              int xy_stride, int depth_stride, int conic_stride,
                              int color_stride, int width, int height, float focal_x,
                              float focal_y, float lim_x, float lim_y, float scale_modifier,
                              void* stream) {
  using namespace prep;
  if (gaussians == 0) return 0;
  Args a{};
  a.means3d = means3d; a.scales = scales; a.quats = quats; a.shs = shs; a.cov3d = cov3d;
  a.view = view; a.full_proj = full_proj; a.campos = campos;
  a.g_xy = g_xy; a.g_depth = g_depth; a.g_conic = g_conic; a.g_color = g_color;
  a.xy_stride = xy_stride; a.depth_stride = depth_stride; a.conic_stride = conic_stride;
  a.color_stride = color_stride;
  a.g_means = g_means; a.g_scales = g_scales; a.g_quats = g_quats; a.g_shs = g_shs;
  a.g_cov3d = g_cov3d; a.partials = partials;
  a.n = gaussians; a.sh_coeffs = sh_coeffs; a.width = width; a.height = height;
  a.focal_x = focal_x; a.focal_y = focal_y; a.lim_x = lim_x; a.lim_y = lim_y;
  a.scale_modifier = scale_modifier;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool gauss = gaussian_grads != 0, mats = matrix_grads != 0;
  switch (sh_degree) {
    case -1: return (int)launch_bwd<-1>(a, gauss, mats, s);
    case 0: return (int)launch_bwd<0>(a, gauss, mats, s);
    case 1: return (int)launch_bwd<1>(a, gauss, mats, s);
    case 2: return (int)launch_bwd<2>(a, gauss, mats, s);
    case 3: return (int)launch_bwd<3>(a, gauss, mats, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// preprocess_reduce: out (2, 4, 4) = dL/d(view), dL/d(full_proj), the
// `blocks` rows of partials summed in a fixed order.
extern "C" int preprocess_reduce(const float* partials, float* out, int blocks, void* stream) {
  using namespace prep;
  preprocess_reduce_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
