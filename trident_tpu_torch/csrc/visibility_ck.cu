// Compact-bank visibility kernel (the `ckern` knob): the same per-pixel
// result as the visibility kernel, read from per-pair banks of the pair's
// hit sub-blocks that the binner gathered contiguous.
//
// Replaces: trident_tpu/ops/raster_pallas.py _visibility_kernel_ck (CKERN,
// raster_pallas.py:1239; pallas_call at raster_pallas.py:1418), the bank
// table built at raster_pallas.py:835-857.
//
// Bound on the card: as the visibility kernel, arithmetic on the covered
// (triangle, pixel) pairs; the bytes are one 1 KB sub-block per hit slot,
// now read from the pair's own contiguous bank rows (no chunk indirection).
//
// Design: one CTA per 32x32 tile over its pair range (tile_start), as K1.
// A pair's table row holds nbank = ceil(16/ck_bank)·ck_bank sub-block slots
// of 16 record rows each: its nhit hit sub-blocks in ascending order, then
// copies of the first hit; column 15 of every row is the triangle's global
// id (f32, exact below 2^24). Bank b (slots [b·ck_bank, (b+1)·ck_bank)) runs
// only when nhit > b·ck_bank, as on the TPU; within the last bank the
// padding slots are skipped, since a copy of an already merged triangle
// leaves the lexicographic (min depth, max id) merge unchanged. A bank's
// live slots (at most 16 KB) are staged into shared memory with coalesced
// 16-byte loads and ONE __syncthreads per bank, where K1 syncs once per
// sub-block; each thread then merges them in visibility_common.cuh's
// expression order, so ids and depths equal K1's bit for bit.

#include "visibility_common.cuh"

namespace {

using namespace trident;

constexpr int kSubsPerChunk = kChunk / kSub;   // 16: nhit never exceeds it
constexpr int kSlotFloats = kSub * kRec;       // one sub-block slot

__global__ void __launch_bounds__(kVisThreads)
visibility_ck_kernel(const float* __restrict__ banks,
                     const int* __restrict__ nhit,
                     const int* __restrict__ tile_start, int ntx, int ck_bank,
                     int nbank, float* __restrict__ depth_out,
                     int* __restrict__ tri_out) {
  __shared__ __align__(16) float rows[kSubsPerChunk * kSlotFloats];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_begin(tile, ntx, px, py, best_d, best_t);

  const int p_end = tile_start[tile + 1];
  for (int p = tile_start[tile]; p < p_end; ++p) {
    const int n = min(nhit[p], kSubsPerChunk);
    const float4* pair = reinterpret_cast<const float4*>(
        banks + static_cast<size_t>(p) * nbank * kSlotFloats);
    for (int b0 = 0; b0 < n; b0 += ck_bank) {
      const int live = min(ck_bank, n - b0);
      const int n4 = live * kSlotFloats / 4;
      const float4* src = pair + b0 * kSlotFloats / 4;
      for (int i = t; i < n4; i += kVisThreads) {
        reinterpret_cast<float4*>(rows)[i] = __ldg(src + i);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < live * kSub; ++j) {
        const float* rc = rows + j * kRec;
        vis_triangle<false>(rc, static_cast<int>(rc[15]), px, py, best_d,
                            best_t);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o = static_cast<size_t>(tile) * kTilePx + t + k * kVisThreads;
    depth_out[o] = best_d[k];
    tri_out[o] = best_t[k];
  }
}

}  // namespace

extern "C" int trident_visibility_ck(const float* banks, const int* nhit,
                                     const int* tile_start, int n_tiles,
                                     int ntx, int ck_bank, int nbank,
                                     float* depth_out, int* tri_out,
                                     cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_ck_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        banks, nhit, tile_start, ntx, ck_bank, nbank, depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}
