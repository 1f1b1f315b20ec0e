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
// Band instances (*_band_kernel, kBand): one band of a taller frame
// (trident_tpu_torch/parallel/framebuffer.py); tile row r is global tile
// row r + tile_y_offset (resolve_pallas.py:294, `ty = tile // ntx +
// band_ref[0]`), so the walk's pixel centres, its region corners and the
// resolve's centres are the full frame's. The offset-free kernels take no
// offset and compile to the code they had before the band instances.
// bf16 instances (*_bf16_kernel, kBf16; the `resolve_prec="bf16"` knob):
// the four kernels again with every record word of the resolve rounded to
// bf16 as it is loaded (resolve_common.cuh), the TPU's one raw bf16 pass of
// the winner select (resolve_pallas.py:100-102); the walk is K1's, so depth
// and ids are unchanged. The exact kernels keep their code.

#include "resolve_common.cuh"
#include "visibility_common.cuh"

namespace {

using namespace trident;

// one tile's walk and resolve (the block's work); `stage` is its shared
// staging buffer; tile_y_offset is read only by the band instance
template <int kWidth, bool kBand, bool kBf16 = false>
__device__ __forceinline__ void visibility_resolve_block(
    const float* __restrict__ records, const int* __restrict__ pair_chunk,
    const int* __restrict__ pair_mask, const int* __restrict__ tile_start,
    int ntx, const float* __restrict__ res_records,
    float* __restrict__ depth_out, int* __restrict__ tri_out,
    float* __restrict__ attr_out, VisRegionStage& stage, int tile_y_offset) {
  const int tile = blockIdx.x;
  const int ty0 = kBand ? tile_y_offset : 0;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t, ty0);
  vis_region_walk<false>(records, pair_chunk, pair_mask, tile_start[tile],
                         tile_start[tile + 1], tile, ntx, stage, px, py,
                         best_d, best_t, ty0);
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int r = vis_region_pixel(k);
    const size_t o = static_cast<size_t>(tile) * kTilePx + r;
    depth_out[o] = best_d[k];
    tri_out[o] = best_t[k];
    float a[kChannels];
    resolve_pixel<kWidth, kBf16>(record_row<kWidth>(res_records, best_t[k]),
                                 px[k], py[k], a);
    float* dst = attr_out + static_cast<size_t>(tile) * kChannels * kTilePx + r;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) dst[c * kTilePx] = a[c];
  }
}

// one kernel per record width and band form, each named for the
// profiler's records (tools_dev/timing.py KERNEL_RECORDS)
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
  visibility_resolve_block<kRecWidth, false>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, 0);
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
  visibility_resolve_block<kRecWidthVColor, false>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, 0);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_band_kernel(const float* __restrict__ records,
                               const int* __restrict__ pair_chunk,
                               const int* __restrict__ pair_mask,
                               const int* __restrict__ tile_start, int ntx,
                               const float* __restrict__ res_records,
                               float* __restrict__ depth_out,
                               int* __restrict__ tri_out,
                               float* __restrict__ attr_out,
                               int tile_y_offset) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidth, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, tile_y_offset);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_vc_band_kernel(const float* __restrict__ records,
                                  const int* __restrict__ pair_chunk,
                                  const int* __restrict__ pair_mask,
                                  const int* __restrict__ tile_start, int ntx,
                                  const float* __restrict__ res_records,
                                  float* __restrict__ depth_out,
                                  int* __restrict__ tri_out,
                                  float* __restrict__ attr_out,
                                  int tile_y_offset) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidthVColor, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, tile_y_offset);
}

// the bf16 instances of the four kernels above
__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_bf16_kernel(
    const float* __restrict__ records,
    const int* __restrict__ pair_chunk, const int* __restrict__ pair_mask,
    const int* __restrict__ tile_start, int ntx,
    const float* __restrict__ res_records, float* __restrict__ depth_out,
    int* __restrict__ tri_out, float* __restrict__ attr_out) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidth, false, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, 0);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_vc_bf16_kernel(
    const float* __restrict__ records,
    const int* __restrict__ pair_chunk, const int* __restrict__ pair_mask,
    const int* __restrict__ tile_start, int ntx,
    const float* __restrict__ res_records, float* __restrict__ depth_out,
    int* __restrict__ tri_out, float* __restrict__ attr_out) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidthVColor, false, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, 0);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_band_bf16_kernel(
    const float* __restrict__ records,
    const int* __restrict__ pair_chunk, const int* __restrict__ pair_mask,
    const int* __restrict__ tile_start, int ntx,
    const float* __restrict__ res_records, float* __restrict__ depth_out,
    int* __restrict__ tri_out, float* __restrict__ attr_out,
    int tile_y_offset) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidth, true, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, tile_y_offset);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_resolve_vc_band_bf16_kernel(
    const float* __restrict__ records,
    const int* __restrict__ pair_chunk, const int* __restrict__ pair_mask,
    const int* __restrict__ tile_start, int ntx,
    const float* __restrict__ res_records, float* __restrict__ depth_out,
    int* __restrict__ tri_out, float* __restrict__ attr_out,
    int tile_y_offset) {
  __shared__ VisRegionStage stage;
  visibility_resolve_block<kRecWidthVColor, true, true>(
      records, pair_chunk, pair_mask, tile_start, ntx, res_records,
      depth_out, tri_out, attr_out, stage, tile_y_offset);
}

// the launch; `offset` is the band instances' trailing argument (none for
// the offset-free kernels)
template <typename... Offset>
int launch(void (*kernel)(const float*, const int*, const int*, const int*,
                          int, const float*, float*, int*, float*,
                          Offset...),
           const float* records, const int* pair_chunk, const int* pair_mask,
           const int* tile_start, int n_tiles, int ntx,
           const float* res_records, float* depth_out, int* tri_out,
           float* attr_out, cudaStream_t stream, Offset... offset) {
  if (n_tiles > 0) {
    kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, res_records,
        depth_out, tri_out, attr_out, offset...);
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

extern "C" int trident_visibility_resolve_band(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, int tile_y_offset,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_band_kernel, records, pair_chunk,
                pair_mask, tile_start, n_tiles, ntx, res_records, depth_out,
                tri_out, attr_out, stream, tile_y_offset);
}

extern "C" int trident_visibility_resolve_vc_band(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, int tile_y_offset,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_vc_band_kernel, records, pair_chunk,
                pair_mask, tile_start, n_tiles, ntx, res_records, depth_out,
                tri_out, attr_out, stream, tile_y_offset);
}

// the bf16 instances' entry points, each the exact one's signature
extern "C" int trident_visibility_resolve_bf16(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_bf16_kernel, records,
                pair_chunk, pair_mask, tile_start, n_tiles, ntx,
                res_records, depth_out, tri_out, attr_out, stream);
}

extern "C" int trident_visibility_resolve_vc_bf16(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_vc_bf16_kernel, records,
                pair_chunk, pair_mask, tile_start, n_tiles, ntx,
                res_records, depth_out, tri_out, attr_out, stream);
}

extern "C" int trident_visibility_resolve_band_bf16(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, int tile_y_offset,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_band_bf16_kernel,
                records, pair_chunk, pair_mask, tile_start, n_tiles, ntx,
                res_records, depth_out, tri_out, attr_out, stream,
                tile_y_offset);
}

extern "C" int trident_visibility_resolve_vc_band_bf16(
    const float* records, const int* pair_chunk, const int* pair_mask,
    const int* tile_start, int n_tiles, int ntx, int tile_y_offset,
    const float* res_records, float* depth_out, int* tri_out,
    float* attr_out, cudaStream_t stream) {
  return launch(visibility_resolve_vc_band_bf16_kernel,
                records, pair_chunk, pair_mask, tile_start, n_tiles, ntx,
                res_records, depth_out, tri_out, attr_out, stream,
                tile_y_offset);
}
