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
// Bound on the card: f32 arithmetic on the (triangle, pixel) pairs that
// can cover (22 ops each), plus one 1 KB record block per hit 16-triangle
// sub-block. Built with -fmad=false, every product and sum is its own
// instruction, so the merge reaches at most half the card's f32 FMA rate.
//
// Design (the region design of visibility_common.cuh): one CTA of 256
// threads per 32x32 tile walks that tile's contiguous range of sorted
// (tile, chunk) pairs (tile_start from the binner). Warp w owns the 16x8
// region at columns 16*(w%2), rows 8*(w/2) of the tile; each lane keeps its
// 4 pixels' (depth, id) in registers. Per pair the CTA stages all its hit
// sub-blocks at once (up to 256 record rows, one row per thread, 16-byte
// loads) with each row's triangle id and an 8-bit mask of the regions its
// three edge functions do not exclude (vis_region_bits: the edges' maxima
// over a region, exact in the kernel's own rounding), syncs, and each warp
// merges only its kept rows, a warp-uniform loop over a __ballot_sync
// mask; a second sync guards the staging buffer: two syncs per pair. No
// atomics: the merge is a lexicographic
// (min depth, max id) compare in registers, deterministic and independent
// of pair order, in the reference kernel's expression order
// (vis_triangle), so ids and depths are the sweep's bit for bit. The
// depth-only instance (kDepthOnly) keeps a plain min: the same depths, so
// its depth is bit-equal to the colour pass's on the same bins. Outputs
// go to tile index row*32 + col, two 64-byte runs per warp store.

#include "visibility_common.cuh"

// Band instances (kBand): the same kernel for one band of a taller frame
// (the banded multi-device frame, trident_tpu_torch/parallel/
// framebuffer.py): tile row r of the band is global tile row
// r + tile_y_offset, so the pixel centres and the region corners are the
// full frame's (raster_pallas.py:993, `ty = tile // ntx + band_ref[0]`)
// and the band's depths and ids are the one-device frame's rows bit for
// bit. The offset-free kernels (visibility_kernel) take no offset and
// compile to the code they had before the band instances existed.

namespace {

using namespace trident;

// one tile; tile_y_offset is read only by the band instance
template <bool kDepthOnly, bool kBand>
__device__ __forceinline__ void visibility_tile(
    const float* __restrict__ records, const int* __restrict__ pair_chunk,
    const int* __restrict__ pair_mask, const int* __restrict__ tile_start,
    int ntx, float* __restrict__ depth_out, int* __restrict__ tri_out,
    int tile_y_offset, VisRegionStage& stage) {
  const int tile = blockIdx.x;
  const int ty0 = kBand ? tile_y_offset : 0;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t, ty0);
  vis_region_walk<kDepthOnly>(records, pair_chunk, pair_mask,
                              tile_start[tile], tile_start[tile + 1], tile,
                              ntx, stage, px, py, best_d, best_t, ty0);
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o =
        static_cast<size_t>(tile) * kTilePx + vis_region_pixel(k);
    depth_out[o] = best_d[k];
    if (!kDepthOnly) tri_out[o] = best_t[k];
  }
}

template <bool kDepthOnly>
__global__ void __launch_bounds__(kVisThreads)
visibility_kernel(const float* __restrict__ records,
                  const int* __restrict__ pair_chunk,
                  const int* __restrict__ pair_mask,
                  const int* __restrict__ tile_start, int ntx,
                  float* __restrict__ depth_out, int* __restrict__ tri_out) {
  __shared__ VisRegionStage stage;
  visibility_tile<kDepthOnly, false>(records, pair_chunk, pair_mask,
                                     tile_start, ntx, depth_out, tri_out, 0,
                                     stage);
}

template <bool kDepthOnly>
__global__ void __launch_bounds__(kVisThreads)
visibility_band_kernel(const float* __restrict__ records,
                       const int* __restrict__ pair_chunk,
                       const int* __restrict__ pair_mask,
                       const int* __restrict__ tile_start, int ntx,
                       float* __restrict__ depth_out,
                       int* __restrict__ tri_out, int tile_y_offset) {
  __shared__ VisRegionStage stage;
  visibility_tile<kDepthOnly, true>(records, pair_chunk, pair_mask,
                                    tile_start, ntx, depth_out, tri_out,
                                    tile_y_offset, stage);
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

extern "C" int trident_visibility_band(const float* records,
                                       const int* pair_chunk,
                                       const int* pair_mask,
                                       const int* tile_start, int n_tiles,
                                       int ntx, int tile_y_offset,
                                       float* depth_out, int* tri_out,
                                       cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_band_kernel<false><<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, tri_out,
        tile_y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trident_visibility_depth_band(const float* records,
                                             const int* pair_chunk,
                                             const int* pair_mask,
                                             const int* tile_start,
                                             int n_tiles, int ntx,
                                             int tile_y_offset,
                                             float* depth_out,
                                             cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_band_kernel<true><<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, nullptr,
        tile_y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
