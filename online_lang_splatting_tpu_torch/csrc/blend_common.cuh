// Shared pieces of the two blend kernels (blend_fwd.cu, blend_bwd.cu).
//
// Layout, per Gaussian (row-major):
//   geom  (P, 8)  float: x, y, conic a, b, c, opacity, 0, 0
//   feat  (P, C)  float: color (3), language (F), depth (1); C = F + 4
// Per render: s_gid (S,) int32 Gaussian ids in (tile, depth, id) order,
// starts / counts (T,) int32 per tile. Images are (C, H, W) / (H, W).
//
// One thread block of BLOCK threads composites one tile; each thread owns
// PPT pixels of it (pixel p = threadIdx.x + k * BLOCK, row-major in the
// tile), so a 32x32 tile is 256 threads x 4 pixels and keeps the per-pixel
// accumulators in registers.
//
// The constants are the float32 values of the JAX reference's Python
// constants (ops/raster/config.py), so thresholds compare identically.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int BLOCK = 256;
constexpr int GEOM_COLS = 8;
constexpr float ALPHA_MAX = 9.900000095e-01f;   // 0.99
constexpr float ALPHA_MIN = 3.921568859e-03f;   // 1 / 255
constexpr float T_EPS = 9.999999747e-05f;       // 1e-4
constexpr float N_TOUCHED_T = 0.5f;

struct TileGeometry {
  int width, height, tile, tiles_x;
};

// Pixel coordinates of this thread's k-th pixel; false when it lies past
// the tile or the image edge (such pixels are inert: nothing reads them).
__device__ __forceinline__ bool pixel_of(const TileGeometry& g, int tile_id,
                                         int k, int* px, int* py) {
  const int p = threadIdx.x + k * BLOCK;
  const int lx = p % g.tile;
  const int ly = p / g.tile;
  *px = (tile_id % g.tiles_x) * g.tile + lx;
  *py = (tile_id / g.tiles_x) * g.tile + ly;
  return p < g.tile * g.tile && *px < g.width && *py < g.height;
}

// The blend's per-(instance, pixel) power, in the reference's operation
// order: power = -0.5 (a dx^2 + c dy^2) - b dx dy with d = mean - pixel.
__device__ __forceinline__ float power_of(float dx, float dy, float ca,
                                          float cb, float cc) {
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace blend
