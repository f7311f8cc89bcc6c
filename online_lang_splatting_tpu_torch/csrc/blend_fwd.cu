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
// - Occupancy and uneven work: one CTA per 16x16 square, one pixel per
//   thread, so per-thread state is CP accumulators + T + the last index and
//   2-4 CTAs fit an SM (the launch bound falls with the width: 4 up to
//   CP = 20, 3 up to 32, 2 above); a tile of 32 is 4 independent CTAs (4x
//   as many, each shorter), and each square stops once its own pixels have
//   terminated. Any tile and any C from 4 to 64 (blend_common.cuh: the
//   split, the compiled widths). No cluster: n_touched is an integer
//   atomic, exact in any order, and n_contrib is per pixel.
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

// Resident CTAs the launch bound asks for: CP accumulators per thread.
__host__ __device__ constexpr int fwd_min_blocks(int cp) { return cp <= 20 ? 4 : (cp <= 32 ? 3 : 2); }

template <int CP, bool EXACT>
__global__ void __launch_bounds__(BLOCK, fwd_min_blocks(CP))
fwd_kernel(const float* __restrict__ geom, const float* __restrict__ feat,
           const int* __restrict__ s_gid, const int* __restrict__ starts,
           const int* __restrict__ counts, float* __restrict__ out_feat,
           float* __restrict__ out_t, int* __restrict__ n_contrib,
           int* __restrict__ n_touched, TileGeometry tg, int channels,
           int stats, int py_limit) {
  const int C = EXACT ? CP : channels;
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
  const float4 rect = rect_of(quad);
  bool live = in_img;
  float T = 1.f;
  int last = 0;
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.f;

  const int* ids = s_gid + start;
  if (count > 0) load_batch(geom, feat, ids, min(BATCH, count), C, s_geom, s_feat);
  __pipeline_commit();

  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += BATCH, buf ^= 1) {
    // Also the barrier between the previous batch's reads and the copies
    // into the buffer it used.
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, count - b0);
    if (b0 + BATCH < count)
      load_batch(geom, feat, ids + b0 + BATCH, min(BATCH, count - b0 - BATCH), C,
                 s_geom + (buf ^ 1) * BATCH * GEOM_COLS, s_feat + (buf ^ 1) * BATCH * C);
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
              const float* row = bf + j * C;
#pragma unroll
              for (int c = 0; c < CP; ++c)
                if (c < C) acc[c] = __fmaf_rn(w, row[c], acc[c]);
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
  for (int c = 0; c < CP; ++c)
    if (c < C) out_feat[c * hw + idx] = acc[c];
}

inline size_t fwd_smem(int C) {
  return sizeof(float) * 2 * BATCH * (GEOM_COLS + C) +
         sizeof(int) * (2 * BATCH + BLOCK / 32);
}

struct FwdLaunch {
  cudaStream_t s;
  const float *geom, *feat;
  const int *s_gid, *starts, *counts;
  float *out_feat, *out_t;
  int *n_contrib, *n_touched;
  TileGeometry tg;
  int C, stats, py_limit;

  template <int CP, bool EXACT>
  cudaError_t operator()() const {
    return launch(fwd_kernel<CP, EXACT>, num_ctas(tg), fwd_smem(C), s, geom, feat,
                  s_gid, starts, counts, out_feat, out_t, n_contrib, n_touched,
                  tg, C, stats, py_limit);
  }
};

struct FwdOccupancy {
  int C;
  int* blocks;

  template <int CP, bool EXACT>
  cudaError_t operator()() const {
    return occupancy(fwd_kernel<CP, EXACT>, fwd_smem(C), blocks);
  }
};

}  // namespace blend

// Plain C entry point for ctypes. Returns the launch's error code, then
// cudaGetLastError() (cudaErrorInvalidValue for a channel count outside
// 4..64 or a tile < 1).
extern "C" int blend_fwd(const float* geom, const float* feat,
                         const int* s_gid, const int* starts,
                         const int* counts, float* out_feat, float* out_t,
                         int* n_contrib, int* n_touched, int channels,
                         int width, int height, int tile, int stats,
                         int py_limit, void* stream) {
  using namespace blend;
  TileGeometry tg;
  if (!make_geometry(width, height, tile, &tg)) return (int)cudaErrorInvalidValue;
  const FwdLaunch f{(cudaStream_t)stream, geom, feat, s_gid, starts, counts,
                    out_feat, out_t, n_contrib, n_touched, tg, channels, stats,
                    py_limit};
  const cudaError_t err = dispatch_width(channels, f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the forward kernel at `channels` resident per SM, for the
// diagnostics of chip_smoke.py.
extern "C" int blend_fwd_occupancy(int channels, int* blocks) {
  using namespace blend;
  return (int)dispatch_width(channels, FwdOccupancy{channels, blocks});
}
