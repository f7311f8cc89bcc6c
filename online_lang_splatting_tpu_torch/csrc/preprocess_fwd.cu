// Forward preprocess kernel for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its preprocess
// (online_lang_splatting_tpu/ops/raster/preprocess.py) to XLA, which fuses
// it. In PyTorch the same function is some 400 small elementwise launches
// per render over every map slot, and with the autograd graph they leave
// behind they were ~71 % of a tracking iteration's launches (PERF.md).
// This kernel is ops/raster/preprocess.py:preprocess in one launch,
// one thread per Gaussian: pose-applied projection, the EWA 2D covariance
// and its conic, the colour from spherical harmonics (degree 0-3, a
// template parameter; -1 when the colours are precomputed), and the
// integer outputs of the binning: validity, radius, the emission rect
// (the 3-sigma rect cut to the alpha >= 1/255 ellipse's box) and its tile
// count.
//
// What bounds it on this card: bytes. Per Gaussian it reads ~44 bytes
// (mean, scale, rotation, opacity, SH degree 0) and writes ~69 (the
// fields of Preprocessed), ~15 MB at the main path's 131072 slots, ~4.4 us
// at 3.35 TB/s; its ~400 flops a Gaussian are ~0.8 us at 67 TFLOP/s.
// Design: one pass, nothing staged in shared memory; every thread reads
// the two 4x4 matrices from the same addresses (broadcast loads).
//
// Arithmetic follows the plain version operation for operation under
// --fmad=false (preprocess_common.cuh), so the integer outputs equal the
// plain version's on the card bit for bit.

#include "preprocess_common.cuh"

namespace prep {

__device__ __forceinline__ int tile_index(float v, float inv_tile, int hi) {
  const int k = (int)(v * inv_tile);  // truncation toward zero, saturating
  return min(max(k, 0), hi);
}

template <int DEG>
__global__ void __launch_bounds__(BLOCK) preprocess_fwd_kernel(const Args a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const Camera cam = load_camera(a);
  Geometry g;
  geometry(a, cam, i, g);

  // Radius from the larger eigenvalue.
  const float mid = 0.5f * (g.cov0 + g.cov2);
  const float disc = sqrtf(clamp_min(mid * mid - g.det, DISC_MIN));
  const float rad = ceilf(3.f * sqrtf(nan_max(mid + disc, mid - disc)));

  // Tile rects: the 3-sigma rect, then cut to the alpha >= 1/255 ellipse.
  const float tile = (float)a.tile;
  const float inv_tile = 1.f / tile;
  const int rmin_x = tile_index(g.px - rad, inv_tile, a.tiles_x);
  const int rmin_y = tile_index(g.py - rad, inv_tile, a.tiles_y);
  const int rmax_x = tile_index(((g.px + rad) + tile) - 1.f, inv_tile, a.tiles_x);
  const int rmax_y = tile_index(((g.py + rad) + tile) - 1.f, inv_tile, a.tiles_y);
  const int touched = max(rmax_x - rmin_x, 0) * max(rmax_y - rmin_y, 0);
  const bool valid = g.in_front && g.det_ok && touched > 0;

  const float op = __ldg(a.opacities + i);
  const float tau = 2.f * logf(clamp_min(op, OP_MIN) * (1.f / ALPHA_MIN));
  const bool psd = g.det > 0.f;
  const float big = (float)(2 * (a.tiles_x + a.tiles_y) * a.tile);
  const float ex = psd ? sqrtf(clamp_min(tau * g.cov0, 0.f)) + EXTENT_PAD : big;
  const float ey = psd ? sqrtf(clamp_min(tau * g.cov2, 0.f)) + EXTENT_PAD : big;
  const int emin_x = max(rmin_x, tile_index(g.px - ex, inv_tile, a.tiles_x));
  const int emin_y = max(rmin_y, tile_index(g.py - ey, inv_tile, a.tiles_y));
  const int emax_x = min(rmax_x, tile_index((g.px + ex) + tile, inv_tile, a.tiles_x));
  const int emax_y = min(rmax_y, tile_index((g.py + ey) + tile, inv_tile, a.tiles_y));
  const bool inert = psd && op < ALPHA_MIN;
  const int emit = inert ? 0 : max(emax_x - emin_x, 0) * max(emax_y - emin_y, 0);

  a.xy[2 * i] = g.px;
  a.xy[2 * i + 1] = g.py;
  a.depth[i] = g.t[2];
  a.conic[3 * i] = g.cov2 * g.di;
  a.conic[3 * i + 1] = -g.cov1 * g.di;
  a.conic[3 * i + 2] = g.cov0 * g.di;
  a.valid[i] = valid;
  a.radius[i] = valid ? (int)rad : 0;
  a.rect_min[2 * i] = emin_x;
  a.rect_min[2 * i + 1] = emin_y;
  a.rect_max[2 * i] = emax_x;
  a.rect_max[2 * i + 1] = emax_y;
  a.tiles_touched[i] = valid ? emit : 0;

  if (DEG >= 0) {
    const int nb = (DEG + 1) * (DEG + 1);
    float f[16];
    if (DEG > 0) {
      const Direction d = direction(a, g);
      sh_basis<DEG>(d.u[0], d.u[1], d.u[2], f);
    } else {
      f[0] = SH_C0;
    }
    float sh[48];
    const float* src = a.shs + (size_t)i * a.sh_coeffs * 3;
#pragma unroll
    for (int k = 0; k < 3 * nb; ++k) sh[k] = __ldg(src + k);
#pragma unroll
    for (int c = 0; c < 3; ++c) a.color[3 * i + c] = clamp_min(sh_eval<DEG>(f, sh, c) + 0.5f, 0.f);
  }
}

template <int DEG>
cudaError_t launch_fwd(const Args& a, cudaStream_t s) {
  preprocess_fwd_kernel<DEG><<<(a.n + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace prep

// Plain C entry point for ctypes. sh_degree -1: colours precomputed (no
// colour written, shs unused); cov3d non-null: precomputed covariances
// (scales, quats unused); offset may be null. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a degree outside -1..3).
extern "C" int preprocess_fwd(const float* means3d, const float* scales, const float* quats,
                              const float* opacities, const float* shs, const float* cov3d,
                              const float* view, const float* full_proj, const float* campos,
                              const float* offset, float* xy, float* depth, float* conic,
                              float* color, unsigned char* valid, int* radius, int* rect_min,
                              int* rect_max, int* tiles_touched, int gaussians, int sh_degree,
                              int sh_coeffs, int width, int height, int tile, float focal_x,
                              float focal_y, float lim_x, float lim_y, float scale_modifier,
                              void* stream) {
  using namespace prep;
  if (gaussians == 0) return 0;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.means3d = means3d; a.scales = scales; a.quats = quats; a.opacities = opacities;
  a.shs = shs; a.cov3d = cov3d; a.view = view; a.full_proj = full_proj; a.campos = campos;
  a.offset = offset; a.xy = xy; a.depth = depth; a.conic = conic; a.color = color;
  a.valid = valid; a.radius = radius; a.rect_min = rect_min; a.rect_max = rect_max;
  a.tiles_touched = tiles_touched; a.n = gaussians; a.sh_coeffs = sh_coeffs;
  a.width = width; a.height = height; a.tile = tile;
  a.tiles_x = (width + tile - 1) / tile; a.tiles_y = (height + tile - 1) / tile;
  a.focal_x = focal_x; a.focal_y = focal_y; a.lim_x = lim_x; a.lim_y = lim_y;
  a.scale_modifier = scale_modifier;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (sh_degree) {
    case -1: return (int)launch_fwd<-1>(a, s);
    case 0: return (int)launch_fwd<0>(a, s);
    case 1: return (int)launch_fwd<1>(a, s);
    case 2: return (int)launch_fwd<2>(a, s);
    case 3: return (int)launch_fwd<3>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
