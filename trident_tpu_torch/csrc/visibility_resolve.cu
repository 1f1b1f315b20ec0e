// Fused visibility + resolve kernel (the `fuse` knob): one launch gives each
// pixel's winner (depth, id) and its 16 shading channels, in tile layout.
//
// Replaces: trident_tpu/ops/resolve_pallas.py _fused_kernel (reached via
// fused_visibility_resolve_pallas, resolve_pallas.py:330; pallas_call at
// resolve_pallas.py:386).
//
// Bound on the card: bytes (0.0640 ms at spheres1080_1m on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py phase 10): the visibility kernel's
// (records of the hit sub-blocks, pair lists, depth and ids), one 128-byte
// record row per distinct winner, and 64 B per pixel of attribute output; the
// (H, W) id round trip between two launches (write the ids, read them back)
// is gone.
//
// Design: the TPU kernel merges attributes pair by pair, in lock-step with
// the depth merge (resolve_pallas.py:302-323), because it cannot keep the
// winner across grid steps. Here a CTA owns its tile to the end, and the
// final image is the final winner's attributes whatever the order, so the
// CTA first runs K1's walk, the region design of visibility_common.cuh
// (warp w owns a 16x8 region and merges only the staged triangles whose
// edges can pass one of its pixel centres), and then each thread evaluates
// the interpolants of its 4 pixels' final winners once (resolve_common.cuh,
// the resolve kernel's own body: the winner's row of the (T, 32) record
// table in eight 16-byte loads) at the same pixel centres. Depth and ids
// are K1's bit for bit; the attributes are the tiled resolve kernel's.
// With vertex colours the record table is (T, 40) and the 40-wide instance
// runs (trident_visibility_resolve_vc, _fused_kernel with
// vertex_colors=True): ten 16-byte loads of the winner's 160-byte row, the
// colour factor's rgb times the interpolated vertex colour.
// Outputs: depth and ids (n_tiles, 1024), attributes channel-planar
// (n_tiles, 16, 1024), at tile index row*32 + col under the region map, so
// each warp store is two 64-byte runs.

#include "resolve_common.cuh"
#include "visibility_common.cuh"

namespace {

using namespace trident;

// one tile's walk and resolve (the block's work); `stage` is its shared
// staging buffer
template <int kWidth>
__device__ __forceinline__ void visibility_resolve_block(
    const float* __restrict__ records, const int* __restrict__ pair_chunk,
    const int* __restrict__ pair_mask, const int* __restrict__ tile_start,
    int ntx, const float* __restrict__ res_records,
    float* __restrict__ depth_out, int* __restrict__ tri_out,
    float* __restrict__ attr_out, VisRegionStage& stage) {
  const int tile = blockIdx.x;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t);
  vis_region_walk<false>(records, pair_chunk, pair_mask, tile_start[tile],
                         tile_start[tile + 1], tile, ntx, stage, px, py,
                         best_d, best_t);
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int r = vis_region_pixel(k);
    const size_t o = static_cast<size_t>(tile) * kTilePx + r;
    depth_out[o] = best_d[k];
    tri_out[o] = best_t[k];
    float a[kChannels];
    resolve_pixel<kWidth>(record_row<kWidth>(res_records, best_t[k]), px[k],
                          py[k], a);
    float* dst = attr_out + static_cast<size_t>(tile) * kChannels * kTilePx + r;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) dst[c * kTilePx] = a[c];
  }
}

// one kernel per record width, each named for the profiler's records
// (tools_dev/timing.py KERNEL_RECORDS)
__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_kernel(const float* __restrict__ records,
                          const int* __restrict__ pair_chunk,
                          const int* __restrict__ pair_mask,
                          const int* __restrict__ tile_start, int ntx,
                          const float* __restrict__ res_records,
                          float* __restrict__ depth_out,
                          int* __restrict__ tri_out,
                          float* __restrict__ attr_out) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidth>(records, pair_chunk, pair_mask,
                                      tile_start, ntx, res_records,
                                      depth_out, tri_out, attr_out, stage);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_vc_kernel(const float* __restrict__ records,
                             const int* __restrict__ pair_chunk,
                             const int* __restrict__ pair_mask,
                             const int* __restrict__ tile_start, int ntx,
                             const float* __restrict__ res_records,
                             float* __restrict__ depth_out,
                             int* __restrict__ tri_out,
                             float* __restrict__ attr_out) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidthVColor>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage);
}

using FusedKernel = void (*)(const float*, const int*, const int*,
                             const int*, int, const float*, float*, int*,
                             float*);

int launch(FusedKernel kernel, const float* records, const int* pair_chunk,
           const int* pair_mask, const int* tile_start, int n_tiles, int ntx,
           const float* res_records, float* depth_out, int* tri_out,
           float* attr_out, cudaStream_t stream) {
  if (n_tiles > 0) {
    kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, res_records,
        depth_out, tri_out, attr_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int trident_visibility_resolve(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, const float* res_records,
    float* depth_out, int* tri_out, float* attr_out,
    cudaStream_t stream) {
  return launch(visibility_resolve_kernel, records, pair_chunk, pair_mask,
                tile_start, n_tiles, ntx, res_records, depth_out, tri_out,
                attr_out, stream);
}

extern "C" int trident_visibility_resolve_vc(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, const float* res_records,
    float* depth_out, int* tri_out, float* attr_out,
    cudaStream_t stream) {
  return launch(visibility_resolve_vc_kernel, records, pair_chunk,
                pair_mask, tile_start, n_tiles, ntx, res_records, depth_out,
                tri_out, attr_out, stream);
}
