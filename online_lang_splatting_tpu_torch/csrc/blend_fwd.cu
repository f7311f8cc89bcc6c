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
// in-image pixels of the rows py < py_limit: a band of a frame split over
// devices renders rows past the image's last one, and counts none of them,
// as the reference's `pix_ok` does; colour, depth and T cover every row).
//
// What bounds it on this card: arithmetic. Every (instance, pixel) pair a
// live pixel evaluates costs ~15 flops (offset, power, exp, alpha, tests)
// and every contributing pair 2C + 3 more; at the main path's shapes
// (1200x680, tile 32, ~55.5k instances, C = 19) that is at most
// 55.5k x 1024 = 54M pairs, ~2.9 GFLOP, ~44 us at 67 TFLOP/s, against
// ~80 MB of images and rows, ~24 us at 3.35 TB/s. chip_smoke.py phase 4
// counts the pairs this run's data needs (tiled.blend_work) and prints
// the bound beside the time.
//
// What the design does about it (the points that kept the first, per-tile
// version of this kernel far from its bound):
// - Occupancy and uneven work: one CTA per 16x16 quadrant, one pixel per
//   thread, so per-thread state is C accumulators + T + the last index and
//   3-4 CTAs fit an SM; a tile of 32 is 4 independent CTAs (4x as many,
//   each shorter), and each quadrant stops once its own pixels have
//   terminated. No cluster: n_touched is an integer atomic, exact in any
//   order, and n_contrib is per pixel.
// - Pairs that cannot contribute: at the main path's shapes only ~12 % of
//   the pairs a per-tile walk evaluates composite; the rest lie outside
//   the instance's 1/255 ellipse. Each batch, thread i computes row i's
//   conservative reach box (blend_common.cuh: reach_box), and the rows
//   whose box misses the CTA's square are dropped by an order-preserving
//   compaction. A dropped pair is one the blend would skip, so no output
//   changes.
// - The gather: the next batch's rows arrive by cp.async into the other
//   half of a double buffer while the current batch is composited.
// - --fmad=false keeps the alpha / T chain bit-identical to the reference
//   (and to the backward's recomputation); the channel accumulation, which
//   no threshold reads, uses explicit fused multiply-adds.
// - n_touched: per instance a warp __reduce_add_sync, one shared atomic per
//   warp, one global atomic per (CTA, Gaussian).

#include "blend_common.cuh"

namespace blend {

template <int C>
__global__ void __launch_bounds__(BLOCK, 4)
fwd_kernel(const float* __restrict__ geom, const float* __restrict__ feat,
           const int* __restrict__ s_gid, const int* __restrict__ starts,
           const int* __restrict__ counts, float* __restrict__ out_feat,
           float* __restrict__ out_t, int* __restrict__ n_contrib,
           int* __restrict__ n_touched, TileGeometry tg, int stats,
           int py_limit) {
  extern __shared__ float4 smem4[];
  float* s_geom = reinterpret_cast<float*>(smem4);    // [2][BATCH][8]
  float* s_feat = s_geom + 2 * BATCH * GEOM_COLS;     // [2][BATCH * C]
  int* s_list = reinterpret_cast<int*>(s_feat + 2 * BATCH * C);  // [BATCH]
  int* s_touch = s_list + BATCH;                        // [BATCH]
  int* s_warp_count = s_touch + BATCH;                  // [BLOCK / 32]

  const Quad quad = quad_of(tg);
  int px, py;
  const bool in_img = pixel_of(tg, quad, &px, &py);
  const int start = starts[quad.tile_id];
  const int count = counts[quad.tile_id];
  const int lane = threadIdx.x & 31;
  const float fx = (float)px, fy = (float)py;
  const bool counts_touched = stats && py < py_limit;
  const float4 rect = make_float4((float)quad.x0, (float)(quad.x0 + tg.quad - 1),
                                  (float)quad.y0, (float)(quad.y0 + tg.quad - 1));
  bool live = in_img;
  float T = 1.f;
  int last = 0;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  const int* ids = s_gid + start;
  if (count > 0) load_batch<C>(geom, feat, ids, min(BATCH, count), s_geom, s_feat);
  __pipeline_commit();

  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += BATCH, buf ^= 1) {
    // Also the barrier between the previous batch's reads and the copies
    // into the buffer it used.
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, count - b0);
    if (b0 + BATCH < count)
      load_batch<C>(geom, feat, ids + b0 + BATCH, min(BATCH, count - b0 - BATCH),
                    s_geom + (buf ^ 1) * BATCH * GEOM_COLS,
                    s_feat + (buf ^ 1) * BATCH * C);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this batch's group has landed
    if ((int)threadIdx.x < n) s_touch[threadIdx.x] = 0;
    __syncthreads();

    const float* bg = s_geom + buf * BATCH * GEOM_COLS;
    const float* bf = s_feat + buf * BATCH * C;
    const int m = select_rows(bg, n, rect, s_list, s_warp_count);
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const int j = s_list[k];
      int touched = 0;
      if (live) {
        const float4 g0 = *reinterpret_cast<const float4*>(bg + j * GEOM_COLS);
        const float2 g1 = *reinterpret_cast<const float2*>(bg + j * GEOM_COLS + 4);
        const float dx = g0.x - fx;
        const float dy = g0.y - fy;
        const float power = power_of(dx, dy, g0.z, g0.w, g1.x);
        if (!(power > 0.f)) {  // NaN falls through, as in the reference
          const float alpha = fminf(ALPHA_MAX, g1.y * expf(power));
          if (!(alpha < ALPHA_MIN)) {
            const float test_t = T * (1.f - alpha);
            if (test_t < T_EPS) {
              live = false;
            } else {
              const float w = alpha * T;
#pragma unroll
              for (int c = 0; c < C; ++c) acc[c] = __fmaf_rn(w, bf[j * C + c], acc[c]);
              T = test_t;
              last = b0 + j + 1;
              touched = counts_touched && test_t > N_TOUCHED_T ? 1 : 0;
            }
          }
        }
      }
      if (stats) {
        const int warp_total = __reduce_add_sync(FULL, touched);
        if (lane == 0 && warp_total) atomicAdd(&s_touch[j], warp_total);
      }
    }
    __syncthreads();
    if (stats && (int)threadIdx.x < n && s_touch[threadIdx.x])
      atomicAdd(&n_touched[ids[b0 + threadIdx.x]], s_touch[threadIdx.x]);
  }
  __pipeline_wait_prior(0);  // no copy outlives the CTA

  if (!in_img) return;
  const size_t hw = (size_t)tg.width * tg.height;
  const size_t idx = (size_t)py * tg.width + px;
  out_t[idx] = T;
  n_contrib[idx] = stats ? last : 0;
#pragma unroll
  for (int c = 0; c < C; ++c) out_feat[c * hw + idx] = acc[c];
}

template <int C>
constexpr size_t fwd_smem() {
  return sizeof(float) * 2 * BATCH * (GEOM_COLS + C) +
         sizeof(int) * (2 * BATCH + BLOCK / 32);
}

template <int C>
static cudaError_t launch_fwd(cudaStream_t s, const float* geom,
                              const float* feat, const int* s_gid,
                              const int* starts, const int* counts,
                              float* out_feat, float* out_t, int* n_contrib,
                              int* n_touched, const TileGeometry& tg,
                              int stats, int py_limit) {
  return launch(fwd_kernel<C>, num_ctas(tg), fwd_smem<C>(), s, geom, feat,
                s_gid, starts, counts, out_feat, out_t, n_contrib, n_touched,
                tg, stats, py_limit);
}

}  // namespace blend

// Plain C entry point for ctypes. Returns the launch's error code, then
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported channel
// count or tile).
extern "C" int blend_fwd(const float* geom, const float* feat,
                         const int* s_gid, const int* starts,
                         const int* counts, float* out_feat, float* out_t,
                         int* n_contrib, int* n_touched, int channels,
                         int width, int height, int tile, int stats,
                         int py_limit, void* stream) {
  using namespace blend;
  TileGeometry tg;
  if (!make_geometry(width, height, tile, &tg)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (channels) {
    case 4:
      err = launch_fwd<4>(s, geom, feat, s_gid, starts, counts, out_feat, out_t,
                          n_contrib, n_touched, tg, stats, py_limit);
      break;
    case 7:
      err = launch_fwd<7>(s, geom, feat, s_gid, starts, counts, out_feat, out_t,
                          n_contrib, n_touched, tg, stats, py_limit);
      break;
    case 19:
      err = launch_fwd<19>(s, geom, feat, s_gid, starts, counts, out_feat, out_t,
                           n_contrib, n_touched, tg, stats, py_limit);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the forward kernel at `channels` resident per SM, for the
// diagnostics of chip_smoke.py.
extern "C" int blend_fwd_occupancy(int channels, int* blocks) {
  using namespace blend;
  switch (channels) {
    case 4: return (int)occupancy(fwd_kernel<4>, fwd_smem<4>(), blocks);
    case 7: return (int)occupancy(fwd_kernel<7>, fwd_smem<7>(), blocks);
    case 19: return (int)occupancy(fwd_kernel<19>, fwd_smem<19>(), blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
