// Backward blend kernel for Hopper (sm_90a): the per-instance rows.
//
// Replaces online_lang_splatting_tpu/ops/raster/tiled.py:_bwd_kernel, the
// Pallas kernel launched by _blend_bwd. From the per-pixel cotangents of
// every channel and of final T, and the saved forward images, it
// recomputes alpha per (instance, pixel) and writes, per sorted instance
// and per CTA of its tile, the instance's d(x, y), d(conic a, b, c),
// d(opacity) and d(feat) = d(color, language, depth) summed over the CTA's
// pixels: rows (S, K, 6 + C), K = ceil(tile / 16)^2 CTAs per tile, as the
// JAX kernel writes its per-instance dgeom / dfeat. blend_reduce.cu then
// sums the rows per Gaussian in a fixed order (the XLA scatter-add of
// tiled.py:1087-1093). No float atomic anywhere: every sum is taken in an
// order fixed by the data, so two launches on the same inputs give the
// same bits.
//
// It walks FORWARD, as the JAX kernel does: the suffix sum a contribution
// needs is the saved per-pixel total sum_f g_f A_f + g_T T_final minus the
// running inclusive prefix of w G, so there is no division by (1 - alpha)
// of a product and the numbers track the JAX reference closely when alpha
// is near the 0.99 clamp.
//
// What bounds it on this card: arithmetic. Every pair a live pixel
// evaluates costs ~15 flops and every contributing pair ~4C + 31 more (the
// channel dot product, the C feat-gradient products, the geometry chain and
// one add per value into the per-instance sum over pixels); at the main
// path's shapes (1200x680, tile 32, ~55.5k instances, C = 19) at most 54M
// pairs, ~7 GFLOP, ~104 us at 67 TFLOP/s, against ~158 MB (two (C, H, W)
// images read, d_table written), ~47 us at 3.35 TB/s. chip_smoke.py phase 4
// counts the pairs this run's data needs (tiled.blend_work) and prints the
// bound beside the time.
//
// What the design does about the points that kept the first, per-tile
// version (2.05 ms at C = 19) far from that bound:
// 1. Occupancy: one CTA per 16x16 square, one pixel per thread. The
//    per-thread state is CP cotangents + T, S, x, y, and the launch bound
//    asks for 3 resident CTAs per SM up to CP = 20 (<= 85 registers; 80
//    at C = 19), 2 above (<= 128).
// 2. The per-instance reduction over the warp's pixels: the G = 6 + C
//    values go in groups of 32, the last padded to a power of two (16 for
//    C <= 10), each reduce-scattered by recursive halving, 16 + 8 + 4 + 2
//    + 1 = 31 shuffles for a group of 32 (15 + 1 at 16), after which lane
//    v holds the warp's total of the group's value v and stores it to the
//    warp's own slot for the row: one store per lane and group instead of
//    G butterflies. A warp none of whose lanes contributed stores zeros.
//    At C = 64 that is groups of 32, 32 and 8 (6 values), 31 + 31 + 9
//    shuffles, with one group's 32 values live at a time beside the CP
//    cotangents.
// 3. The sum over the CTA's 8 warps, in warp order: the warps' slots hold
//    SUB selected rows (8 x SUB x G floats; at SUB = 16 that is BATCH x G,
//    so up to C = 64 two CTAs fit an SM); every SUB rows the CTA adds each
//    row's 8 slots in warp order and stores the total to the instance's
//    row in `rows`. Rows a CTA never reached (culled by its reach box, or
//    past the point where all its pixels stopped) stay zero from the
//    wrapper's fill.
// 4. The gather: the next batch's rows arrive by cp.async into the other
//    half of a double buffer while the current batch is walked.
// 5. --fmad=false keeps the alpha / T / power chain bit-identical to the
//    forward's, so a pixel terminates at the same instance in both
//    directions; gdot, the suffix update, the feat-gradient rows and the
//    geometry-gradient sums, which no threshold reads, use explicit fused
//    multiply-adds.
// 6. Uneven work: a tile of 32 is 4 CTAs (3344 instead of 836 at the main
//    path's shapes), so the longest tile's walk is split 4 ways, and a
//    quadrant whose pixels have all terminated stops walking. Within the
//    walk, the rows whose conservative 1/255 reach box misses the CTA's
//    square are dropped by an order-preserving compaction (as in the
//    forward: a dropped pair is one the blend would skip).
//    A thread block cluster per tile, summing its CTAs' rows through
//    distributed shared memory, was measured slower on the H100
//    (PERF.md): its two cluster barriers per batch cost more than they
//    saved.

#include "blend_common.cuh"

namespace blend {

// Reduce-scatter of NV values (a power of two, at most 32) over a warp by
// recursive halving: on return, v[0] of lane L holds the warp's total of
// value L % NV (below 32, log2(32 / NV) more shuffles fold the lane groups
// together).
template <int NV, int O = NV / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane) {
  if constexpr (O > 0) {
    const bool hi = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = hi ? v[i] : v[i + O];
      const float keep = hi ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
  }
  if constexpr (O > 1) {
    reduce_scatter<NV, O / 2>(v, lane);
  } else {
#pragma unroll
    for (int s = NV; s < 32; s <<= 1) v[0] += __shfl_xor_sync(FULL, v[0], s);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// One pair's values q = 0 .. 6 + CP - 1 (0-5 the geometry terms, 6 + c the
// feature terms w * gpix[c]) in groups of 32 from Q0 on: each group
// reduce-scattered over the warp, then lane L stores the warp's total of
// value Q0 + L to the warp's slot `slot` when it is one of the G real values.
template <int CP, int Q0 = 0>
__device__ __forceinline__ void reduce_values(const float (&geo)[6], float w,
                                              bool any, const float (&gpix)[CP],
                                              int lane, int G, float* slot) {
  constexpr int NQ = 6 + CP;
  constexpr int NV = NQ - Q0 >= 32 ? 32 : pow2_at_least(NQ - Q0);
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int q = Q0 + i;
    if (q < 6)
      v[i] = geo[q < 6 ? q : 0];
    else if (q - 6 < CP)
      v[i] = any ? w * gpix[q >= 6 && q - 6 < CP ? q - 6 : 0] : 0.f;
    else
      v[i] = 0.f;
  }
  reduce_scatter<NV>(v, lane);
  const int q = Q0 + lane;
  if (lane < NV && q < G) slot[q] = v[0];
  if constexpr (Q0 + 32 < NQ) reduce_values<CP, Q0 + 32>(geo, w, any, gpix, lane, G, slot);
}

// Selected rows per flush of the warps' slots.
constexpr int SUB = 16;
constexpr int WARPS = BLOCK / 32;

inline size_t bwd_smem(int C) {
  return sizeof(float) * (2 * BATCH * (GEOM_COLS + C) + WARPS * SUB * (6 + C)) +
         sizeof(int) * (BATCH + WARPS);
}

// Resident CTAs the launch bound asks for: CP cotangents per thread.
__host__ __device__ constexpr int bwd_min_blocks(int cp) { return cp <= 20 ? 3 : 2; }

template <int CP, bool EXACT>
__global__ void __launch_bounds__(BLOCK, bwd_min_blocks(CP))
bwd_kernel(const float* __restrict__ geom, const float* __restrict__ feat,
           const int* __restrict__ s_gid, const int* __restrict__ starts,
           const int* __restrict__ counts, const float* __restrict__ g_feat,
           const float* __restrict__ g_t, const float* __restrict__ out_feat,
           const float* __restrict__ out_t, float* __restrict__ rows,
           TileGeometry tg, int channels) {
  const int C = EXACT ? CP : channels;
  const int G = 6 + C;
  extern __shared__ float4 smem4[];
  float* s_geom = reinterpret_cast<float*>(smem4);   // [2][BATCH][8]
  float* s_feat = s_geom + 2 * BATCH * GEOM_COLS;    // [2][BATCH * C]
  float* s_part = s_feat + 2 * BATCH * C;                      // [WARPS][SUB][G]
  int* s_list = reinterpret_cast<int*>(s_part + WARPS * SUB * G);  // [BATCH]
  int* s_warp_count = s_list + BATCH;                              // [WARPS]

  const Quad quad = quad_of(tg);
  int px, py;
  bool live = pixel_of(tg, quad, &px, &py);
  const int start = starts[quad.tile_id];
  const int count = counts[quad.tile_id];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fx = (float)px, fy = (float)py;
  const float4 rect = rect_of(quad);
  const size_t hw = (size_t)tg.width * tg.height;
  // This CTA's row of each instance: rows[(instance * K + k) * G + q].
  const int K = tg.nq * tg.nq, k_cta = blockIdx.x % K;

  float T = 1.f, S = 0.f, gpix[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) gpix[c] = 0.f;
  if (live) {
    const size_t idx = (size_t)py * tg.width + px;
    float total = 0.f;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c < C) {
        gpix[c] = g_feat[c * hw + idx];
        total = __fmaf_rn(gpix[c], out_feat[c * hw + idx], total);
      }
    }
    S = __fmaf_rn(g_t[idx], out_t[idx], total);
  }

  const int* ids = s_gid + start;
  if (count > 0) load_batch(geom, feat, ids, min(BATCH, count), C, s_geom, s_feat);
  __pipeline_commit();

  int buf = 0;
  for (int b0 = 0; b0 < count; b0 += BATCH, buf ^= 1) {
    // Also the barrier between the previous batch's last flush and this
    // batch's copies into the other buffer.
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, count - b0);
    if (b0 + BATCH < count)
      load_batch(geom, feat, ids + b0 + BATCH, min(BATCH, count - b0 - BATCH), C,
                 s_geom + (buf ^ 1) * BATCH * GEOM_COLS, s_feat + (buf ^ 1) * BATCH * C);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this batch's group has landed

    const float* bg = s_geom + buf * BATCH * GEOM_COLS;
    const float* bf = s_feat + buf * BATCH * C;
    const int m = select_rows(bg, n, rect, s_list, s_warp_count);
    for (int k0 = 0; k0 < m; k0 += SUB) {
      const int kn = min(SUB, m - k0);
      for (int r = 0; r < kn; ++r) {
        const int j = s_list[k0 + r];
        float geo[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float w = 0.f;
        bool any = false;
        if (live) {
          const float4 g0 = *reinterpret_cast<const float4*>(bg + j * GEOM_COLS);
          const float2 g1 = *reinterpret_cast<const float2*>(bg + j * GEOM_COLS + 4);
          const float ca = g0.z, cb = g0.w, cc = g1.x, op = g1.y;
          const float dx = g0.x - fx;
          const float dy = g0.y - fy;
          const float power = power_of(dx, dy, ca, cb, cc);
          if (!(power > 0.f)) {  // NaN falls through, as in the forward
            const float expp = expf(power);
            const float alpha_raw = op * expp;
            const float alpha = fminf(ALPHA_MAX, alpha_raw);
            if (!(alpha < ALPHA_MIN)) {
              const float one_minus = 1.f - alpha;
              const float test_t = T * one_minus;
              if (test_t < T_EPS) {
                live = false;
              } else {
                w = alpha * T;
                const float* row = bf + j * C;
                float gdot = 0.f;
#pragma unroll
                for (int c = 0; c < CP; ++c)
                  if (c < C) gdot = __fmaf_rn(row[c], gpix[c], gdot);
                S = __fmaf_rn(-w, gdot, S);  // suffix: everything composited after this one
                const float dalpha = T * gdot - S / one_minus;
                if (alpha_raw < ALPHA_MAX) {
                  const float de = dalpha * expp;
                  const float dpower = de * op;
                  const float ddx = dpower * dx;
                  const float ddy = dpower * dy;
                  geo[0] = -__fmaf_rn(ddx, ca, ddy * cb);
                  geo[1] = -__fmaf_rn(ddy, cc, ddx * cb);
                  geo[2] = -0.5f * ddx * dx;
                  geo[3] = -ddx * dy;
                  geo[4] = -0.5f * ddy * dy;
                  geo[5] = de;
                }
                T = test_t;
                any = true;
              }
            }
          }
        }
        float* slot = s_part + (warp * SUB + r) * G;
        if (__any_sync(FULL, any)) {
          reduce_values<CP>(geo, w, any, gpix, lane, G, slot);
        } else {
          for (int q = lane; q < G; q += 32) slot[q] = 0.f;
        }
      }
      // The kn rows' totals over the warps, added in warp order.
      __syncthreads();
      for (int e = threadIdx.x; e < kn * G; e += BLOCK) {
        const int r = e / G, q = e - r * G;
        float tot = s_part[r * G + q];
#pragma unroll
        for (int wi = 1; wi < WARPS; ++wi) tot += s_part[(wi * SUB + r) * G + q];
        const size_t inst = (size_t)start + b0 + s_list[k0 + r];
        rows[(inst * K + k_cta) * G + q] = tot;
      }
      __syncthreads();  // the slots are free again
    }
  }
  __pipeline_wait_prior(0);  // no copy outlives the CTA
}

struct BwdLaunch {
  cudaStream_t s;
  const float *geom, *feat;
  const int *s_gid, *starts, *counts;
  const float *g_feat, *g_t, *out_feat, *out_t;
  float* rows;
  TileGeometry tg;
  int C;

  template <int CP, bool EXACT>
  cudaError_t operator()() const {
    return launch(bwd_kernel<CP, EXACT>, num_ctas(tg), bwd_smem(C), s, geom, feat,
                  s_gid, starts, counts, g_feat, g_t, out_feat, out_t, rows, tg, C);
  }
};

struct BwdOccupancy {
  int C;
  int* blocks;

  template <int CP, bool EXACT>
  cudaError_t operator()() const {
    return occupancy(bwd_kernel<CP, EXACT>, bwd_smem(C), blocks);
  }
};

}  // namespace blend

// Plain C entry point for ctypes. rows (S, K, 6 + C), K = ceil(tile / 16)^2
// (1 for a tile <= 16), must be zeroed by the caller. Returns the launch's
// error code, then cudaGetLastError() (cudaErrorInvalidValue for a channel
// count outside 4..64 or a tile < 1).
extern "C" int blend_bwd(const float* geom, const float* feat,
                         const int* s_gid, const int* starts,
                         const int* counts, const float* g_feat,
                         const float* g_t, const float* out_feat,
                         const float* out_t, float* rows, int channels,
                         int width, int height, int tile, void* stream) {
  using namespace blend;
  TileGeometry tg;
  if (!make_geometry(width, height, tile, &tg)) return (int)cudaErrorInvalidValue;
  const BwdLaunch b{(cudaStream_t)stream, geom, feat, s_gid, starts, counts, g_feat,
                    g_t, out_feat, out_t, rows, tg, channels};
  const cudaError_t err = dispatch_width(channels, b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the backward kernel at `channels` resident per SM, for the
// diagnostics of chip_smoke.py.
extern "C" int blend_bwd_occupancy(int channels, int* blocks) {
  using namespace blend;
  return (int)dispatch_width(channels, BwdOccupancy{channels, blocks});
}
