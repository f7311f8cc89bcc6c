// Forward blend kernel for Hopper (sm_90a).
//
// Replaces online_lang_splatting_tpu/ops/raster/tiled.py:_fwd_kernel, the
// Pallas kernel launched by _blend_fwd_impl: front-to-back alpha
// compositing of the (tile, depth, id)-sorted instances over each tile's
// pixels, with the 0.99 alpha clamp, the 1/255 skip and the T < 1e-4 stop
// (the stopping instance does not contribute). Outputs the accumulated
// channels (C, H, W), final T (H, W), and with `stats` the per-pixel
// n_contrib (1-based last contributing position in the tile's instance
// range) and the per-Gaussian n_touched (contributions with T > 0.5 on
// in-image pixels).
//
// What bounds it on this card: each tile block streams its instance range
// from device memory once (a gather through s_gid into shared memory), then
// does ~20 flops per (instance, pixel) plus C fused multiply-adds for the
// contributing ones; the per-pixel state (T, C accumulators, last index)
// lives in registers, and at tile 32 with C = 19 that register budget is
// the limit on how many blocks an SM holds.
//
// What the design does about it: one block of 256 threads per tile with 4
// pixels per thread at tile 32 (1024 threads would leave <= 64 registers
// each and spill the 19 accumulators); the channel count C and pixels per
// thread are template parameters, so the accumulators are fixed-size
// register arrays. Instances arrive in batches of 256 through shared
// memory and are read as broadcasts; a block stops once every pixel has
// terminated. n_touched is an exact integer count: a warp reduction per
// instance, a shared-memory atomicAdd per warp, one global atomicAdd per
// (tile, Gaussian). The Pallas kernel's chunk grid, continuation flags,
// VMEM carry and DMA flush have no counterpart here: blocks are
// independent tiles.

#include "blend_common.cuh"

namespace blend {

template <int C, int PPT>
__global__ void __launch_bounds__(BLOCK)
fwd_kernel(const float* __restrict__ geom, const float* __restrict__ feat,
           const int* __restrict__ s_gid, const int* __restrict__ starts,
           const int* __restrict__ counts, float* __restrict__ out_feat,
           float* __restrict__ out_t, int* __restrict__ n_contrib,
           int* __restrict__ n_touched, TileGeometry tg, int stats) {
  __shared__ float s_geom[BLOCK][6];
  __shared__ float s_feat[BLOCK * C];
  __shared__ int s_ids[BLOCK];
  __shared__ int s_touch[BLOCK];

  const int tile_id = blockIdx.x;
  const int start = starts[tile_id];
  const int count = counts[tile_id];
  const int lane = threadIdx.x & 31;

  int px[PPT], py[PPT], last[PPT];
  bool in_img[PPT], live[PPT];
  float fx[PPT], fy[PPT], T[PPT], acc[PPT][C];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    in_img[k] = pixel_of(tg, tile_id, k, &px[k], &py[k]);
    live[k] = in_img[k];
    fx[k] = (float)px[k];
    fy[k] = (float)py[k];
    T[k] = 1.f;
    last[k] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
  }

  for (int b0 = 0; b0 < count; b0 += BLOCK) {
    int alive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) alive |= live[k] ? 1 : 0;
    // Also the barrier between the previous batch's reads and this load.
    if (__syncthreads_count(alive) == 0) break;
    const int n = min(BLOCK, count - b0);
    const int i = threadIdx.x;
    if (i < n) {
      const int g = s_gid[start + b0 + i];
      s_ids[i] = g;
      const float* gp = geom + (size_t)g * GEOM_COLS;
#pragma unroll
      for (int q = 0; q < 6; ++q) s_geom[i][q] = gp[q];
      const float* fp = feat + (size_t)g * C;
#pragma unroll
      for (int c = 0; c < C; ++c) s_feat[i * C + c] = fp[c];
    }
    s_touch[i] = 0;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float gx = s_geom[j][0], gy = s_geom[j][1];
      const float ca = s_geom[j][2], cb = s_geom[j][3], cc = s_geom[j][4];
      const float op = s_geom[j][5];
      int touched = 0;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!live[k]) continue;
        const float dx = gx - fx[k];
        const float dy = gy - fy[k];
        const float power = power_of(dx, dy, ca, cb, cc);
        if (power > 0.f) continue;
        const float alpha = fminf(ALPHA_MAX, op * expf(power));
        if (alpha < ALPHA_MIN) continue;
        const float test_t = T[k] * (1.f - alpha);
        if (test_t < T_EPS) {
          live[k] = false;
          continue;
        }
        const float w = alpha * T[k];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[k][c] += w * s_feat[j * C + c];
        T[k] = test_t;
        last[k] = b0 + j + 1;
        touched += test_t > N_TOUCHED_T ? 1 : 0;
      }
      if (stats) {
        const int warp_total = __reduce_add_sync(0xffffffffu, touched);
        if (lane == 0 && warp_total) atomicAdd(&s_touch[j], warp_total);
      }
    }
    __syncthreads();
    if (stats && i < n && s_touch[i]) atomicAdd(&n_touched[s_ids[i]], s_touch[i]);
  }

  const size_t hw = (size_t)tg.width * tg.height;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!in_img[k]) continue;
    const size_t idx = (size_t)py[k] * tg.width + px[k];
    out_t[idx] = T[k];
    n_contrib[idx] = stats ? last[k] : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) out_feat[c * hw + idx] = acc[k][c];
  }
}

template <int C>
static void launch_fwd(int ppt, dim3 grid, cudaStream_t s, const float* geom,
                       const float* feat, const int* s_gid, const int* starts,
                       const int* counts, float* out_feat, float* out_t,
                       int* n_contrib, int* n_touched, TileGeometry tg,
                       int stats) {
  if (ppt == 1)
    fwd_kernel<C, 1><<<grid, BLOCK, 0, s>>>(geom, feat, s_gid, starts, counts,
        out_feat, out_t, n_contrib, n_touched, tg, stats);
  else
    fwd_kernel<C, 4><<<grid, BLOCK, 0, s>>>(geom, feat, s_gid, starts, counts,
        out_feat, out_t, n_contrib, n_touched, tg, stats);
}

}  // namespace blend

// Plain C entry point for ctypes. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported channel count or tile).
extern "C" int blend_fwd(const float* geom, const float* feat,
                         const int* s_gid, const int* starts,
                         const int* counts, float* out_feat, float* out_t,
                         int* n_contrib, int* n_touched, int channels,
                         int width, int height, int tile, int stats,
                         void* stream) {
  using namespace blend;
  // One pixel per thread up to tile 16, four up to tile 32.
  if (tile <= 0 || tile * tile > 4 * BLOCK) return (int)cudaErrorInvalidValue;
  const int ppt = tile * tile <= BLOCK ? 1 : 4;
  TileGeometry tg{width, height, tile, (width + tile - 1) / tile};
  const int tiles_y = (height + tile - 1) / tile;
  const dim3 grid(tg.tiles_x * tiles_y);
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 4:
      launch_fwd<4>(ppt, grid, s, geom, feat, s_gid, starts, counts, out_feat,
                    out_t, n_contrib, n_touched, tg, stats);
      break;
    case 7:
      launch_fwd<7>(ppt, grid, s, geom, feat, s_gid, starts, counts, out_feat,
                    out_t, n_contrib, n_touched, tg, stats);
      break;
    case 19:
      launch_fwd<19>(ppt, grid, s, geom, feat, s_gid, starts, counts, out_feat,
                     out_t, n_contrib, n_touched, tg, stats);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
