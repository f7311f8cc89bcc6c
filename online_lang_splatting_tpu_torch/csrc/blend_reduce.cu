// Per-Gaussian sum of the backward's per-instance rows, for Hopper (sm_90a).
//
// Replaces the XLA scatter-add that reduced the JAX backward kernel's
// per-instance rows per Gaussian (online_lang_splatting_tpu/ops/raster/
// tiled.py:1087-1093, `.at[ids].add`). blend_bwd.cu writes rows (S, K, G):
// per sorted instance, one row of G = 6 + C values for each of the K CTAs
// of its tile. Here
//
//   d_table[g] = sum over g's instances i, in emission order, of
//                (rows[i, 0] + rows[i, 1] + ... + rows[i, K - 1])
//
// each sum taken left to right, with no atomic: the same bits on every
// run. Emission order (ops/raster/binning.py: EmissionOrder) lists a
// Gaussian's kept instances contiguously, in increasing tile id:
// emit_inst[emit_start[g] .. + emit_count[g]) are its sorted instances.
// A Gaussian with no instance gets a zero row, so d_table needs no fill.
// tiled.reduce_rows_plain is the plain version, in the same order, bit for
// bit.
//
// What bounds it on this card: bytes. It reads the rows once (S K G
// floats, 22 MB at the main path's shapes, most of them still in the 50 MB
// L2 from the rows kernel) and writes d_table (P G floats); a handful of
// adds per float read. Design: one warp per Gaussian, lane L owning values
// L, L + 32 and L + 64 (VPL = ceil(G / 32) of them in registers, a
// template constant), so each of an instance's K rows is one coalesced
// read of G floats. Warps of Gaussians with many instances run longer;
// with ~8 warps per CTA and P / 8 CTAs the card has enough of them in
// flight to hide that and the latency of the scattered rows.

#include "blend_common.cuh"

namespace blend {

constexpr int MAX_VPL = (6 + MAX_CHANNELS + 31) / 32;

template <int VPL>
__global__ void __launch_bounds__(BLOCK)
reduce_kernel(const float* __restrict__ rows, const int* __restrict__ emit_inst,
              const int* __restrict__ emit_start, const int* __restrict__ emit_count,
              float* __restrict__ d_table, int gaussians, int K, int G) {
  const int g = blockIdx.x * (BLOCK / 32) + (int)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= gaussians) return;
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  const int e0 = emit_start[g], n = emit_count[g];
  for (int e = e0; e < e0 + n; ++e) {
    const float* r = rows + (size_t)emit_inst[e] * K * G;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < G) {
        float row = r[v];
        for (int k = 1; k < K; ++k) row += r[k * G + v];
        acc[i] += row;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < G) d_table[(size_t)g * G + v] = acc[i];
  }
}

// Calls f.template operator()<VPL>() for the values per lane that
// G = 6 + C needs; cudaErrorInvalidValue outside the kernels' domain.
template <typename F>
cudaError_t dispatch_vpl(int C, F&& f) {
  if (C < MIN_CHANNELS || C > MAX_CHANNELS) return cudaErrorInvalidValue;
  switch ((6 + C + 31) / 32) {
    case 1: return f.template operator()<1>();
    case 2: return f.template operator()<2>();
    default: return f.template operator()<MAX_VPL>();
  }
}

struct ReduceLaunch {
  cudaStream_t s;
  const float* rows;
  const int *emit_inst, *emit_start, *emit_count;
  float* d_table;
  int gaussians, K, C;

  template <int VPL>
  cudaError_t operator()() const {
    const int grid = (gaussians + BLOCK / 32 - 1) / (BLOCK / 32);
    if (grid == 0) return cudaSuccess;
    return launch(reduce_kernel<VPL>, grid, 0, s, rows, emit_inst, emit_start,
                  emit_count, d_table, gaussians, K, 6 + C);
  }
};

struct ReduceOccupancy {
  int* blocks;

  template <int VPL>
  cudaError_t operator()() const {
    return occupancy(reduce_kernel<VPL>, 0, blocks);
  }
};

}  // namespace blend

// Plain C entry point for ctypes: rows (S, K, 6 + C) of blend_bwd, the
// binning's emission order, d_table (gaussians, 6 + C) written in full.
// Returns the launch's error code, then cudaGetLastError()
// (cudaErrorInvalidValue for a channel count outside 4..64 or K < 1).
extern "C" int blend_reduce(const float* rows, const int* emit_inst,
                            const int* emit_start, const int* emit_count,
                            float* d_table, int channels, int gaussians,
                            int ctas, void* stream) {
  using namespace blend;
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  const ReduceLaunch r{(cudaStream_t)stream, rows, emit_inst, emit_start, emit_count,
                       d_table, gaussians, ctas, channels};
  const cudaError_t err = dispatch_vpl(channels, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the reduce kernel at `channels` resident per SM, for the
// diagnostics of chip_smoke.py.
extern "C" int blend_reduce_occupancy(int channels, int* blocks) {
  using namespace blend;
  return (int)dispatch_vpl(channels, ReduceOccupancy{blocks});
}
