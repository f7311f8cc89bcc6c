// Shared pieces of the blend kernels (blend_fwd.cu, blend_bwd.cu,
// blend_reduce.cu).
//
// Layout, per Gaussian (row-major):
//   geom  (P, 8)  float: x, y, conic a, b, c, opacity, 0, 0
//   feat  (P, C)  float: color (3), language (F), depth (1); C = F + 4
// Per render: s_gid (S,) int32 Gaussian ids in (tile, depth, id) order,
// starts / counts (T,) int32 per tile. Images are (C, H, W) / (H, W).
//
// Work split: one CTA of BLOCK = 256 threads owns one square of a tile,
// one pixel per thread. A tile of 16 or less is one CTA of its own; a
// larger tile is cut into ceil(tile / 16)^2 squares of 16x16 (independent
// CTAs, consecutive in blockIdx.x), and the squares on the tile's right and
// bottom edges are clipped to it when 16 does not divide the tile (a tile
// of 24 is 2x2 CTAs of 16x16, 16x8, 8x16 and 8x8 pixels).
//
// Channels: C = F + 4 is a runtime value. Each kernel is compiled for a
// padded width CP >= C (its accumulators and cotangents are CP registers,
// those past C never read or written), and for C = 4, 7 and 19, the main
// path's widths, also with C fixed at compile time (EXACT).
//
// Every CTA walks its tile's instance range in batches of BATCH rows. The
// next batch's rows are gathered through s_gid into shared memory with
// cp.async (double buffered) while the current batch is composited. TMA
// cannot gather rows by index, so these are per-thread asynchronous copies:
// two 16-byte copies per geom row, and 16-, 8- or 4-byte copies per feat row
// as the row width allows.
//
// The constants are the float32 values of the JAX reference's Python
// constants (ops/raster/config.py), so thresholds compare identically.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int BLOCK = 256;
constexpr int QUAD = 16;  // side of the pixel square one CTA owns
constexpr int BATCH = 128;
constexpr int GEOM_COLS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 9.900000095e-01f;   // 0.99
constexpr float ALPHA_MIN = 3.921568859e-03f;   // 1 / 255
constexpr float T_EPS = 9.999999747e-05f;       // 1e-4
constexpr float N_TOUCHED_T = 0.5f;

struct TileGeometry {
  int width, height, tile, tiles_x;
  int quad;  // pixels per side of a CTA's square: min(tile, QUAD)
  int nq;    // squares per tile side: ceil(tile / quad)
};

// Fills in the split; false for a tile the kernels do not take (< 1).
inline bool make_geometry(int width, int height, int tile, TileGeometry* g) {
  if (tile <= 0) return false;
  g->width = width;
  g->height = height;
  g->tile = tile;
  g->tiles_x = (width + tile - 1) / tile;
  g->quad = tile < QUAD ? tile : QUAD;
  g->nq = (tile + g->quad - 1) / g->quad;
  return true;
}

// Bytes per instance of the backward's `stored` flags: one per CTA of its
// tile (K of them), padded to whole 32-bit words when K > 1, so that the
// reduce kernel reads an instance's flags as words.
__host__ __device__ constexpr int flag_stride(int k) { return k == 1 ? 1 : (k + 3) & ~3; }

inline int num_ctas(const TileGeometry& g) {
  const int tiles_y = (g.height + g.tile - 1) / g.tile;
  return g.tiles_x * tiles_y * g.nq * g.nq;
}

// This CTA's tile, the top-left pixel of its square, and the end (one
// past the last pixel) of its square clipped to the tile and the image.
struct Quad {
  int tile_id, x0, y0, x1, y1;
};

__device__ __forceinline__ Quad quad_of(const TileGeometry& g) {
  const int per_tile = g.nq * g.nq;
  const int t = blockIdx.x / per_tile;
  const int q = blockIdx.x % per_tile;
  const int tx = (t % g.tiles_x) * g.tile, ty = (t / g.tiles_x) * g.tile;
  const int x0 = tx + (q % g.nq) * g.quad, y0 = ty + (q / g.nq) * g.quad;
  return {t, x0, y0, min(min(x0 + g.quad, tx + g.tile), g.width),
          min(min(y0 + g.quad, ty + g.tile), g.height)};
}

// This thread's pixel; false when it lies past the square, the tile or the
// image edge (such pixels are inert: nothing reads them). A square on the
// edge of a tile that 16 does not divide would otherwise reach into the
// next tile, whose instances are not in this tile's list.
__device__ __forceinline__ bool pixel_of(const TileGeometry& g, const Quad& q,
                                         int* px, int* py) {
  *px = q.x0 + (int)threadIdx.x % g.quad;
  *py = q.y0 + (int)threadIdx.x / g.quad;
  return (int)threadIdx.x < g.quad * g.quad && *px < q.x1 && *py < q.y1;
}

// The square as a rectangle (x0, x1, y0, y1) of pixel centres, for the
// reach-box test; empty boxes never occur (a CTA with no pixel in the
// image exits before it tests a row).
__device__ __forceinline__ float4 rect_of(const Quad& q) {
  return make_float4((float)q.x0, (float)(q.x1 - 1), (float)q.y0, (float)(q.y1 - 1));
}

// The blend's per-(instance, pixel) power, in the reference's operation
// order: power = -0.5 (a dx^2 + c dy^2) - b dx dy with d = mean - pixel.
// Built with --fmad=false, so this and the alpha / T chain that reads it
// round exactly as the reference does.
__device__ __forceinline__ float power_of(float dx, float dy, float ca,
                                          float cb, float cc) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

// Reach box (xmin, xmax, ymin, ymax) of an instance: a pixel outside it
// cannot reach alpha >= ALPHA_MIN, so the blend skips the pair there
// whatever this box is; culling with it changes no output. alpha >= 1/255
// needs op exp(power) >= 1/255, that is q = a dx^2 + 2b dx dy + c dy^2
// <= 2 ln(255 op), an ellipse whose box has half extents
// sqrt(2 ln(255 op) c / det) and sqrt(2 ln(255 op) a / det). The margins
// (+0.01 on the log, x1.01 and +0.5 px on the extents) are far above the
// float rounding of the blend's own power and alpha when the conic is
// positive definite with det > 0.01 a c, where the rounding of q is below
// ~1.4e-4 q. Any other conic, or a NaN, gets the infinite box (never
// culled); op < 1/255 the empty one (alpha_raw <= op where power <= 0).
__device__ __forceinline__ float4 reach_box(float gx, float gy, float ca,
                                            float cb, float cc, float op) {
  const float inf = __int_as_float(0x7f800000);
  if (op < ALPHA_MIN) return make_float4(inf, -inf, inf, -inf);
  const float det = ca * cc - cb * cb;
  if (ca > 0.f && cc > 0.f && det > 0.01f * ca * cc) {
    const float q = 2.f * (logf(op / ALPHA_MIN) + 0.01f);
    const float rx = sqrtf(q * cc / det) * 1.01f + 0.5f;
    const float ry = sqrtf(q * ca / det) * 1.01f + 0.5f;
    if (rx < inf && ry < inf) return make_float4(gx - rx, gx + rx, gy - ry, gy + ry);
  }
  return make_float4(-inf, inf, -inf, inf);
}

// Whether a box meets a rectangle, both (x0, x1, y0, y1); true on NaN.
__device__ __forceinline__ bool meets(const float4& box, const float4& r) {
  return !(box.y < r.x || box.x > r.y || box.w < r.z || box.z > r.w);
}

// Order-preserving selection of the batch's rows [0, n) whose reach box
// meets this CTA's square `rect` (x0, x1, y0, y1): thread i tests row i,
// and the rows kept go to s_list in their tile-range order. Every thread
// of the CTA calls it once the batch's rows are visible in shared memory;
// it returns the count and ends with a barrier.
__device__ __forceinline__ int select_rows(const float* s_geom, int n,
                                           const float4& rect, int* s_list,
                                           int* s_warp_count) {
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  bool keep = false;
  if (i < n) {
    const float* g = s_geom + i * GEOM_COLS;
    keep = meets(reach_box(g[0], g[1], g[2], g[3], g[4], g[5]), rect);
  }
  const unsigned ballot = __ballot_sync(FULL, keep);
  if (lane == 0) s_warp_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < BLOCK / 32; ++w) {
    const int c = s_warp_count[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (keep) s_list[offset + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return total;
}

// Queue the asynchronous copy of rows [b0, b0 + n) of a tile's instance
// range into one buffer: thread i copies instance i's geom row (32 bytes)
// and feat row (C floats, row stride C in both places). Commit is left to
// the caller.
__device__ __forceinline__ void load_batch(const float* __restrict__ geom,
                                           const float* __restrict__ feat,
                                           const int* __restrict__ ids, int n,
                                           int C, float* s_geom, float* s_feat) {
  const int i = threadIdx.x;
  if (i >= n) return;
  const size_t g = (size_t)ids[i];
  const float* gp = geom + g * GEOM_COLS;
  __pipeline_memcpy_async(s_geom + i * GEOM_COLS, gp, 16);
  __pipeline_memcpy_async(s_geom + i * GEOM_COLS + 4, gp + 4, 16);
  const float* fp = feat + g * C;
  float* dst = s_feat + i * C;
  // Rows of C floats are 16-byte aligned when C % 4 == 0, 8-byte when even.
  if (C % 4 == 0) {
    for (int c = 0; c < C; c += 4) __pipeline_memcpy_async(dst + c, fp + c, 16);
  } else if (C % 2 == 0) {
    for (int c = 0; c < C; c += 2) __pipeline_memcpy_async(dst + c, fp + c, 8);
  } else {
    for (int c = 0; c < C; ++c) __pipeline_memcpy_async(dst + c, fp + c, 4);
  }
}

// The compiled widths: a channel count C in [MIN_CHANNELS, MAX_CHANNELS]
// runs on its EXACT instance when it has one (4, 7, 19), else on the
// padded instance of the smallest width CP >= C. dispatch_width calls
// f.template operator()<CP, EXACT>() for it, and returns
// cudaErrorInvalidValue for a C outside that range. One launch takes at
// most MAX_CHANNELS channels; ops/raster/tiled.py runs a wider C (any
// F_lang) as channel groups of at most MAX_CHANNELS, one launch each.
// kernels.py keeps the same lists (tests/test_torch_kernel_build.py
// parses them from here).
constexpr int MIN_CHANNELS = 4, MAX_CHANNELS = 64;

template <typename F>
cudaError_t dispatch_width(int C, F&& f) {
  switch (C) {
    case 4: return f.template operator()<4, true>();
    case 7: return f.template operator()<7, true>();
    case 19: return f.template operator()<19, true>();
    default: break;
  }
  if (C < MIN_CHANNELS || C > MAX_CHANNELS) return cudaErrorInvalidValue;
  if (C <= 8) return f.template operator()<8, false>();
  if (C <= 12) return f.template operator()<12, false>();
  if (C <= 16) return f.template operator()<16, false>();
  if (C <= 20) return f.template operator()<20, false>();
  if (C <= 24) return f.template operator()<24, false>();
  if (C <= 28) return f.template operator()<28, false>();
  if (C <= 32) return f.template operator()<32, false>();
  if (C <= 48) return f.template operator()<48, false>();
  return f.template operator()<64, false>();
}

// Launch on `stream` with `smem` bytes of dynamic shared memory (opted in
// above the 48 KB default).
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), int grid, size_t smem,
                   cudaStream_t stream, Act&&... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, BLOCK, smem, stream>>>(static_cast<Act&&>(args)...);
  return cudaGetLastError();
}

// CTAs of `kernel` resident on one SM at `smem` bytes of dynamic shared
// memory.
template <typename K>
cudaError_t occupancy(K kernel, size_t smem, int* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BLOCK,
                                                       smem);
}

}  // namespace blend
