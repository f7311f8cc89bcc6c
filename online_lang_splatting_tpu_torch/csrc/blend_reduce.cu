// Per-Gaussian sum of the backward's per-instance rows, for Hopper (sm_90a).
//
// Replaces the XLA scatter-add that reduced the JAX backward kernel's
// per-instance rows per Gaussian (online_lang_splatting_tpu/ops/raster/
// tiled.py:1087-1093, `.at[ids].add`). blend_bwd.cu writes rows (S, K, G):
// per sorted instance, one row of G = 6 + C values for each of the K CTAs
// of its tile that stored one, flagged in stored (S, flag_stride(K)) bytes;
// the other slots hold whatever the workspace held. Here
//
//   d_table[g] = sum over g's instances i, in emission order, of
//                (sum over i's stored slots k, in increasing k, of rows[i, k])
//
// each sum taken left to right onto +0, with no atomic: the same bits on
// every run. Adding an exact +0 leaves a float unchanged but for -0 + +0 =
// +0, and the sums start at +0, so skipping the unstored slots gives the
// bits of summing all K slots of a zero-filled workspace. Emission order
// (ops/raster/binning.py: EmissionOrder) lists a Gaussian's kept instances
// contiguously, in increasing tile id: emit_inst[emit_start[g] .. +
// emit_count[g]) are its sorted instances, and the Gaussians' ranges follow
// one another (in depth order) and tile [0, S). A Gaussian with no instance
// gets a zero row, so d_table needs no fill. tiled.reduce_rows_plain is the
// plain version, in the same order, bit for bit.
//
// What bounds it on this card: bytes, and the latency of the loads an
// instance needs (its entry, its flags, its rows) where they queue behind
// one another. Its work is the scatter-add's: a row of G values and an id
// read per instance, d_table (P, G) written in full; it reads the stored
// rows (about half of the S x K slots at the main path's shapes) and the
// emission order besides. At the main path's shapes (P = 131072, ~24.9k of
// them with an instance) most Gaussians only need their zero row, and a
// large splat has a hundred instances or more. The sum over a Gaussian's
// instances is a chain that cannot be split without changing its bits; the
// sum over an instance's slots is not. So the work is cut along the
// emission order, not by Gaussian:
// 1. CTA b owns the emission window [b NE, (b + 1) NE) and the Gaussians
//    whose first instance lies in it; their instances are [lo, hi) of the
//    emission order, from the first of them on (hi may lie past the
//    window: a long Gaussian). Its threads load the window's entries, each
//    entry's K flags (as words) and Gaussian (s_gid), and compact the
//    Gaussians that start there into shared memory.
// 2. It also owns the Gaussian ids [b SPAN, (b + 1) SPAN) and writes the
//    zero rows of those with no instance: float4 stores over the CTA's
//    contiguous range of d_table (scalar stores only where a float4
//    straddles a row with instances).
// 3. In chunks of NE emission indices from the window on, up to hi: all
//    threads sum the stored slots of the chunk's (instance, value) pairs at
//    once (K a template constant for the tiles the port takes, 1, 4, 9, 16,
//    so an instance's K loads issue together) into shared memory; then one
//    thread per (Gaussian, value) adds the chunk's instances of its
//    Gaussian in emission order onto its running sum. A long Gaussian costs
//    its CTA one more chunk per NE instances, not a round of loads per
//    instance. Past K = 16 (tiles over 64) one runtime-K instance reads
//    each slot's flag byte before its row.

#include "blend_common.cuh"

namespace blend {

constexpr int WARPS_R = BLOCK / 32;
// Gaussian ids per CTA whose zero rows it writes (one per thread; a
// multiple of 4, so that the CTA's range of d_table is 16-byte aligned).
constexpr int SPAN = BLOCK;
// Emission indices per window and per chunk.
constexpr int NE = 64;

// Bit i = low bit of byte i of a word of four 0/1 flag bytes.
__device__ __forceinline__ unsigned long long byte_bits(unsigned w) {
  return (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);
}

// An instance's stored CTA slots as bits 0 .. KT - 1, from its flag bytes
// read as words.
template <int KT>
__device__ __forceinline__ unsigned long long stored_mask(
    const uint8_t* __restrict__ stored, int inst) {
  static_assert(KT > 0 && KT <= 64, "a compiled K");
  if constexpr (KT == 1) {
    return stored[inst];
  } else {
    const unsigned* w =
        reinterpret_cast<const unsigned*>(stored + (size_t)inst * flag_stride(KT));
    unsigned long long m = 0;
#pragma unroll
    for (int i = 0; i < flag_stride(KT) / 4; ++i) m |= byte_bits(w[i]) << (4 * i);
    return m;
  }
}

// Whether the CTA's Gaussian id r has no instance (its bit clear in s_live).
__device__ __forceinline__ bool dead(const unsigned* s_live, int r) {
  return ((s_live[r >> 5] >> (r & 31)) & 1u) == 0;
}

// Zero rows of the CTA's Gaussian ids that have no instance: float4 stores
// over the CTA's range of d_table, which is 16-byte aligned (SPAN % 4 == 0,
// d_table aligned); a float4 spans at most two rows (G >= 10).
__device__ __forceinline__ void zero_dead_rows(float* __restrict__ d_table, int g0,
                                               int n_rows, int G,
                                               const unsigned* s_live) {
  float* base = d_table + (size_t)g0 * G;
  const int nf = n_rows * G;
  for (int q = threadIdx.x; q < nf / 4; q += BLOCK) {
    const int f = 4 * q;
    if (dead(s_live, f / G) && dead(s_live, (f + 3) / G)) {
      reinterpret_cast<float4*>(base)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (dead(s_live, (f + i) / G)) base[f + i] = 0.f;
    }
  }
  for (int f = (nf & ~3) + (int)threadIdx.x; f < nf; f += BLOCK)
    if (dead(s_live, f / G)) base[f] = 0.f;
}

// Value v of instance `inst`'s stored slots, summed in k order onto +0.
template <int KT>
__device__ __forceinline__ float slot_sum(const float* __restrict__ rows,
                                          const uint8_t* __restrict__ stored, int inst,
                                          unsigned long long mask, int ctas, int G,
                                          int v) {
  float row = 0.f;
  if constexpr (KT > 0) {
    float x[KT];  // every stored slot's load in flight, then the adds
#pragma unroll
    for (int k = 0; k < KT; ++k)
      x[k] = (mask >> k) & 1ull ? rows[((size_t)inst * KT + k) * G + v] : 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if ((mask >> k) & 1ull) row += x[k];
  } else {
    const uint8_t* f = stored + (size_t)inst * flag_stride(ctas);
    for (int k = 0; k < ctas; ++k)
      if (f[k]) row += rows[((size_t)inst * ctas + k) * G + v];
  }
  return row;
}

// The largest of the CTA's values: each warp's by a warp reduction, then
// the warps' from shared memory. Every thread calls it and gets the result.
__device__ __forceinline__ int block_max(int v, int* s_warp) {
  v = __reduce_max_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s_warp[0];
#pragma unroll
  for (int w = 1; w < WARPS_R; ++w) m = max(m, s_warp[w]);
  return m;
}

template <int GMAX, int KT>
__global__ void __launch_bounds__(BLOCK, 4)
reduce_kernel(const float* __restrict__ rows, const uint8_t* __restrict__ stored,
              const int* __restrict__ s_gid, const int* __restrict__ emit_inst,
              const int* __restrict__ emit_start, const int* __restrict__ emit_count,
              float* __restrict__ d_table, int gaussians, int instances, int ctas,
              int G) {
  __shared__ float s_isum[NE * GMAX];  // [NE][G]: a chunk's instance sums
  __shared__ float s_acc[NE * GMAX];   // [NE][G]: the Gaussians' running sums
  __shared__ int s_inst[NE];
  __shared__ unsigned long long s_mask[NE];
  __shared__ int s_g[NE], s_from[NE], s_to[NE];  // the Gaussians starting here
  __shared__ unsigned s_live[WARPS_R];
  __shared__ int s_warp[WARPS_R], s_warp_hi[WARPS_R];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int e0 = blockIdx.x * NE, g0 = blockIdx.x * SPAN;

  // 1, 2. The window's entries, and which of the CTA's Gaussian ids have an
  // instance.
  const int count_here = g0 + t < gaussians ? emit_count[g0 + t] : 0;
  int g = -1, to = -1;
  if (t < NE && e0 + t < instances) {
    const int inst = emit_inst[e0 + t];
    s_inst[t] = inst;
    if constexpr (KT > 0) s_mask[t] = stored_mask<KT>(stored, inst);
    g = s_gid[inst];
    const int start = emit_start[g], count = emit_count[g];  // loaded together
    if (start == e0 + t) to = start + count;
  }
  const unsigned live = __ballot_sync(FULL, count_here > 0);
  const unsigned first = __ballot_sync(FULL, to >= 0);
  if (lane == 0) {
    s_live[warp] = live;
    s_warp[warp] = __popc(first);
  }
  __syncthreads();
  int offset = 0, n_gauss = 0;
#pragma unroll
  for (int w = 0; w < WARPS_R; ++w) {
    offset += w < warp ? s_warp[w] : 0;
    n_gauss += s_warp[w];
  }
  if (to >= 0) {
    const int j = offset + __popc(first & ((1u << lane) - 1u));
    s_g[j] = g;
    s_from[j] = e0 + t;
    s_to[j] = to;
  }
  if (g0 < gaussians) zero_dead_rows(d_table, g0, min(SPAN, gaussians - g0), G, s_live);
  // [lo, hi): the emission indices of the Gaussians that start here.
  const int hi = block_max(to, s_warp_hi);
  const int lo = n_gauss > 0 ? s_from[0] : hi;
  for (int p = t; p < n_gauss * G; p += BLOCK) s_acc[p] = 0.f;

  // 3. The instances [lo, hi) in chunks of NE: their slot sums, then the
  // adds in emission order.
  for (int c0 = e0; c0 < hi; c0 += NE) {
    if (c0 > e0) {  // past the window: this chunk's entries and flags
      __syncthreads();
      if (t < NE && c0 + t < hi) {
        const int inst = emit_inst[c0 + t];
        s_inst[t] = inst;
        if constexpr (KT > 0) s_mask[t] = stored_mask<KT>(stored, inst);
      }
    }
    __syncthreads();
    const int from = max(c0, lo), to_c = min(c0 + NE, hi);
#pragma unroll 2
    for (int p = t; p < (to_c - from) * G; p += BLOCK) {
      const int j = from - c0 + p / G, v = p % G;
      s_isum[j * G + v] =
          slot_sum<KT>(rows, stored, s_inst[j], KT > 0 ? s_mask[j] : 0ull, ctas, G, v);
    }
    __syncthreads();
    for (int p = t; p < n_gauss * G; p += BLOCK) {
      const int gi = p / G, v = p - gi * G;
      const int a = max(s_from[gi], c0), z = min(s_to[gi], c0 + NE);
      float acc = s_acc[p];
      for (int e = a; e < z; ++e) acc += s_isum[(e - c0) * G + v];
      s_acc[p] = acc;
    }
  }
  __syncthreads();
  for (int p = t; p < n_gauss * G; p += BLOCK) {
    const int gi = p / G;
    d_table[(size_t)s_g[gi] * G + (p - gi * G)] = s_acc[p];
  }
}

// Calls f.template operator()<GMAX, KT>() for the row width GMAX >= G = 6 +
// C of a compiled instance and the CTAs per tile K (KT = K for 1, 4, 9, 16;
// 0, read at run time, for any other); cudaErrorInvalidValue outside the
// kernels' domain.
template <int GMAX, typename F>
cudaError_t dispatch_ctas(int K, F& f) {
  switch (K) {
    case 1: return f.template operator()<GMAX, 1>();
    case 4: return f.template operator()<GMAX, 4>();
    case 9: return f.template operator()<GMAX, 9>();
    case 16: return f.template operator()<GMAX, 16>();
    default: return f.template operator()<GMAX, 0>();
  }
}

template <typename F>
cudaError_t dispatch_reduce(int C, int K, F&& f) {
  if (C < MIN_CHANNELS || C > MAX_CHANNELS || K < 1) return cudaErrorInvalidValue;
  const int G = 6 + C;
  if (G <= 16) return dispatch_ctas<16>(K, f);
  if (G <= 32) return dispatch_ctas<32>(K, f);
  if (G <= 64) return dispatch_ctas<64>(K, f);
  return dispatch_ctas<70>(K, f);
}

struct ReduceLaunch {
  cudaStream_t s;
  const float* rows;
  const uint8_t* stored;
  const int *s_gid, *emit_inst, *emit_start, *emit_count;
  float* d_table;
  int gaussians, instances, K, C;

  template <int GMAX, int KT>
  cudaError_t operator()() const {
    const int grid = max((instances + NE - 1) / NE, (gaussians + SPAN - 1) / SPAN);
    if (grid == 0) return cudaSuccess;
    return launch(reduce_kernel<GMAX, KT>, grid, 0, s, rows, stored, s_gid, emit_inst,
                  emit_start, emit_count, d_table, gaussians, instances, K, 6 + C);
  }
};

struct ReduceOccupancy {
  int* blocks;

  template <int GMAX, int KT>
  cudaError_t operator()() const {
    return occupancy(reduce_kernel<GMAX, KT>, 0, blocks);
  }
};

}  // namespace blend

// Plain C entry point for ctypes: rows (S, K, 6 + C) and stored (S,
// flag_stride(K)) of blend_bwd, the binning's s_gid (S,) and emission
// order, d_table (gaussians, 6 + C), 16-byte aligned, written in full.
// Returns the launch's error code, then cudaGetLastError()
// (cudaErrorInvalidValue for a channel count outside 4..64, K < 1 or a
// misaligned d_table).
extern "C" int blend_reduce(const float* rows, const unsigned char* stored,
                            const int* s_gid, const int* emit_inst,
                            const int* emit_start, const int* emit_count,
                            float* d_table, int channels, int gaussians,
                            int instances, int ctas, void* stream) {
  using namespace blend;
  if ((uintptr_t)d_table % 16 != 0) return (int)cudaErrorInvalidValue;
  const ReduceLaunch r{(cudaStream_t)stream, rows, stored, s_gid, emit_inst, emit_start,
                       emit_count, d_table, gaussians, instances, ctas, channels};
  const cudaError_t err = dispatch_reduce(channels, ctas, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of the reduce kernel at `channels` and `ctas` per tile resident per
// SM, for the diagnostics of chip_smoke.py.
extern "C" int blend_reduce_occupancy(int channels, int ctas, int* blocks) {
  using namespace blend;
  return (int)dispatch_reduce(channels, ctas, ReduceOccupancy{blocks});
}
