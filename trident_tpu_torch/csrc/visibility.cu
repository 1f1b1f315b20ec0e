// Visibility kernel: per raster tile, the nearest covering triangle of each
// pixel — (min depth, max triangle id on depth ties), the reference
// pipeline's LESS_OR_EQUAL later-draw-wins state.
//
// Replaces: trident_tpu/ops/raster_pallas.py _visibility_kernel (reached via
// visibility_pallas_tiled, pallas_call at raster_pallas.py:1418), in both of
// its forms: the colour pass (trident_visibility) and the shadow map's
// depth_only light pass (trident_visibility_depth; raster_pallas.py:1075,
// 1149, 1212), which keeps only the min depth and writes no id plane.
//
// Bound on the card: arithmetic on the covered (triangle, pixel) pairs plus
// one 1 KB record block per hit 16-triangle sub-block; the per-tile pair
// lists are short, so the load is the per-tile work imbalance, not bytes.
//
// Design: one CTA per 32x32 tile walks that tile's contiguous range of
// sorted (tile, chunk) pairs (tile_start from the binner). Each of the 256
// threads owns 4 pixels and keeps their (depth, id) in registers. For each
// hit sub-block of a pair the CTA stages the 16 record rows (16 floats
// each, one float per thread) in shared memory, syncs, and every thread
// evaluates the 16 triangles in the reference kernel's expression order
// (visibility_common.cuh, shared with the compact-bank and fused kernels).
// No atomics: the merge is a lexicographic compare in registers, so the
// result is deterministic and independent of pair order. The depth-only
// instance (kDepthOnly) keeps a plain min: the same depths in the same
// order, so its depth is bit-equal to the colour pass's on the same bins.
// Built with -fmad=false so each product and sum rounds like PyTorch's
// eager elementwise ops (the plain version in ops/raster.py).

#include "visibility_common.cuh"

namespace {

using namespace trident;

template <bool kDepthOnly>
__global__ void __launch_bounds__(kVisThreads)
visibility_kernel(const float* __restrict__ records,
                  const int* __restrict__ pair_chunk,
                  const int* __restrict__ pair_mask,
                  const int* __restrict__ tile_start, int ntx,
                  float* __restrict__ depth_out, int* __restrict__ tri_out) {
  __shared__ float rows[kSub * kRec];
  const int tile = blockIdx.x;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_begin(tile, ntx, px, py, best_d, best_t);
  vis_walk<kDepthOnly>(records, pair_chunk, pair_mask, tile_start[tile],
                       tile_start[tile + 1], rows, px, py, best_d, best_t);
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o =
        static_cast<size_t>(tile) * kTilePx + threadIdx.x + k * kVisThreads;
    depth_out[o] = best_d[k];
    if (!kDepthOnly) tri_out[o] = best_t[k];
  }
}

}  // namespace

extern "C" int trident_visibility(const float* records, const int* pair_chunk,
                                  const int* pair_mask, const int* tile_start,
                                  int n_tiles, int ntx, float* depth_out,
                                  int* tri_out, cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_kernel<false><<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trident_visibility_depth(const float* records,
                                        const int* pair_chunk,
                                        const int* pair_mask,
                                        const int* tile_start, int n_tiles,
                                        int ntx, float* depth_out,
                                        cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_kernel<true><<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
