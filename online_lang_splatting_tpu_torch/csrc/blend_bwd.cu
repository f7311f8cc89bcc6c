// Backward blend kernel for Hopper (sm_90a).
//
// Replaces online_lang_splatting_tpu/ops/raster/tiled.py:_bwd_kernel, the
// Pallas kernel launched by _blend_bwd, together with the XLA scatter-add
// that reduced its per-instance rows per Gaussian (tiled.py:1087-1093).
// From the per-pixel cotangents of every channel and of final T, and the
// saved forward images, it recomputes alpha per (instance, pixel) and
// accumulates per Gaussian d(x, y), d(conic a, b, c), d(opacity) and
// d(feat) = d(color, language, depth) into d_table (P, 6 + C).
//
// It walks FORWARD, as the JAX kernel does: the suffix sum a contribution
// needs is the saved per-pixel total sum_f g_f A_f + g_T T_final minus the
// running inclusive prefix of w G, so there is no division by (1 - alpha)
// of a product and the numbers track the JAX reference closely when alpha
// is near the 0.99 clamp.
//
// What bounds it on this card: the per-instance reductions. Every
// (instance, pixel) contribution adds 6 + C partial gradients that must be
// summed over the tile's pixels and then over the tiles of the Gaussian.
// Per-pixel state (T, suffix carry, C cotangents) lives in registers.
//
// What the design does about it: one block of 256 threads per tile, 4
// pixels per thread at tile 32, the channel count a template parameter.
// Each thread sums its own pixels, a warp reduces with shuffles (skipped
// when no lane of the warp contributed), one shared-memory atomicAdd per
// warp and value collects the block's rows for a batch of 128 instances,
// and one global float atomicAdd per (tile, Gaussian, value) lands them in
// d_table. Float atomics make the summation order vary from run to run;
// the tests hold gradients at the goldens' 2e-3 normalized tolerance.

#include "blend_common.cuh"

namespace blend {

constexpr int BWD_BATCH = 128;

template <int C, int PPT>
__global__ void __launch_bounds__(BLOCK)
bwd_kernel(const float* __restrict__ geom, const float* __restrict__ feat,
           const int* __restrict__ s_gid, const int* __restrict__ starts,
           const int* __restrict__ counts, const float* __restrict__ g_feat,
           const float* __restrict__ g_t, const float* __restrict__ out_feat,
           const float* __restrict__ out_t, float* __restrict__ d_table,
           TileGeometry tg) {
  constexpr int G = 6 + C;
  __shared__ float s_geom[BWD_BATCH][6];
  __shared__ float s_feat[BWD_BATCH * C];
  __shared__ float s_grad[BWD_BATCH * G];
  __shared__ int s_ids[BWD_BATCH];

  const int tile_id = blockIdx.x;
  const int start = starts[tile_id];
  const int count = counts[tile_id];
  const int lane = threadIdx.x & 31;
  const size_t hw = (size_t)tg.width * tg.height;

  bool live[PPT];
  float fx[PPT], fy[PPT], T[PPT], S[PPT], gpix[PPT][C];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int px, py;
    live[k] = pixel_of(tg, tile_id, k, &px, &py);
    fx[k] = (float)px;
    fy[k] = (float)py;
    T[k] = 1.f;
    S[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) gpix[k][c] = 0.f;
    if (live[k]) {
      const size_t idx = (size_t)py * tg.width + px;
      float total = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gpix[k][c] = g_feat[c * hw + idx];
        total += gpix[k][c] * out_feat[c * hw + idx];
      }
      S[k] = total + g_t[idx] * out_t[idx];
    }
  }

  for (int b0 = 0; b0 < count; b0 += BWD_BATCH) {
    int alive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) alive |= live[k] ? 1 : 0;
    // Also the barrier between the previous batch's flush and this load.
    if (__syncthreads_count(alive) == 0) break;
    const int n = min(BWD_BATCH, count - b0);
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
    for (int q = i; q < n * G; q += BLOCK) s_grad[q] = 0.f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float gx = s_geom[j][0], gy = s_geom[j][1];
      const float ca = s_geom[j][2], cb = s_geom[j][3], cc = s_geom[j][4];
      const float op = s_geom[j][5];
      float lg[G];
#pragma unroll
      for (int v = 0; v < G; ++v) lg[v] = 0.f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!live[k]) continue;
        const float dx = gx - fx[k];
        const float dy = gy - fy[k];
        const float power = power_of(dx, dy, ca, cb, cc);
        if (power > 0.f) continue;
        const float expp = expf(power);
        const float alpha_raw = op * expp;
        const float alpha = fminf(ALPHA_MAX, alpha_raw);
        if (alpha < ALPHA_MIN) continue;
        const float one_minus = 1.f - alpha;
        const float test_t = T[k] * one_minus;
        if (test_t < T_EPS) {
          live[k] = false;
          continue;
        }
        const float w = alpha * T[k];
        float gdot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) gdot += s_feat[j * C + c] * gpix[k][c];
        S[k] -= w * gdot;  // suffix: everything composited after this one
        const float dalpha = T[k] * gdot - S[k] / one_minus;
#pragma unroll
        for (int c = 0; c < C; ++c) lg[6 + c] += w * gpix[k][c];
        if (alpha_raw < ALPHA_MAX) {
          const float de = dalpha * expp;
          const float dpower = de * op;
          const float ddx = dpower * dx;
          const float ddy = dpower * dy;
          lg[0] -= ddx * ca + ddy * cb;
          lg[1] -= ddy * cc + ddx * cb;
          lg[2] -= 0.5f * ddx * dx;
          lg[3] -= ddx * dy;
          lg[4] -= 0.5f * ddy * dy;
          lg[5] += de;
        }
        T[k] = test_t;
        any = true;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int v = 0; v < G; ++v) {
          const float tot = warp_sum(lg[v]);
          if (lane == 0 && tot != 0.f) atomicAdd(&s_grad[j * G + v], tot);
        }
      }
    }
    __syncthreads();
    for (int q = i; q < n * G; q += BLOCK) {
      const float v = s_grad[q];
      if (v != 0.f) atomicAdd(&d_table[(size_t)s_ids[q / G] * G + q % G], v);
    }
  }
}

template <int C>
static void launch_bwd(int ppt, dim3 grid, cudaStream_t s, const float* geom,
                       const float* feat, const int* s_gid, const int* starts,
                       const int* counts, const float* g_feat,
                       const float* g_t, const float* out_feat,
                       const float* out_t, float* d_table, TileGeometry tg) {
  if (ppt == 1)
    bwd_kernel<C, 1><<<grid, BLOCK, 0, s>>>(geom, feat, s_gid, starts, counts,
        g_feat, g_t, out_feat, out_t, d_table, tg);
  else
    bwd_kernel<C, 4><<<grid, BLOCK, 0, s>>>(geom, feat, s_gid, starts, counts,
        g_feat, g_t, out_feat, out_t, d_table, tg);
}

}  // namespace blend

// Plain C entry point for ctypes. d_table must be zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int blend_bwd(const float* geom, const float* feat,
                         const int* s_gid, const int* starts,
                         const int* counts, const float* g_feat,
                         const float* g_t, const float* out_feat,
                         const float* out_t, float* d_table, int channels,
                         int width, int height, int tile, void* stream) {
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
      launch_bwd<4>(ppt, grid, s, geom, feat, s_gid, starts, counts, g_feat,
                    g_t, out_feat, out_t, d_table, tg);
      break;
    case 7:
      launch_bwd<7>(ppt, grid, s, geom, feat, s_gid, starts, counts, g_feat,
                    g_t, out_feat, out_t, d_table, tg);
      break;
    case 19:
      launch_bwd<19>(ppt, grid, s, geom, feat, s_gid, starts, counts, g_feat,
                     g_t, out_feat, out_t, d_table, tg);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
