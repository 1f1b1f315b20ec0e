// Visibility probes of the kbench decomposition (trident_tpu_torch/tools_dev/
// kbench.py): three variants of the visibility kernel (csrc/visibility.cu)
// that split its time into the per-pair walk, the mask walk, the record
// fetch and a second streamed operand.
//
// Replaces: trident_tpu's tools_dev/kbench.py probes, the pallas_calls at
// kbench.py:246 (run_kernel: _dense_kernel "nobranch" kbench.py:117,
// _dual_kernel "dual" kbench.py:180) and kbench.py:394 (run_probe:
// probe_kernel kbench.py:357, "probe" and "probe_tiny").
//
//   trident_visibility_dense  ("nobranch") K1's region walk with the hit
//       mask ignored: every pair stages all 16 sub-blocks, row t = record
//       row chunk*256 + t, with no mask walk (vis_region_walk's kDense
//       instance): K1's merge on all-ones masks, bit for bit, so full -
//       nobranch is the mask walk's cost. Against K1 on the real masks it
//       also keeps the rounding hits of near-degenerate triangles outside
//       their bbox, which the binner culls.
//   trident_visibility_dual   ("dual") K1's region walk; for each pair the
//       CTA also streams the pair chunk's strip of a second (rows, tpad)
//       f32 table (rows x 256 floats, 16-byte coalesced loads issued
//       before the pair's staging and sweep) and sums it; each pixel's
//       depth gets 1e-30 x the tile's sum at the end, as kbench.py:189-192
//       adds it. With a zero table the output equals K1's, and dual - dflt
//       is the cost of a second streamed operand on K1's design.
//   trident_visibility_reset  ("probe", "probe_tiny") the step machinery
//       alone: one CTA per tile walks its pair range and loads each pair's
//       block of a table (block_floats floats at block index pair_chunk[p]:
//       the 256 x 16 record block for probe, an (8, 128) block of a dummy
//       table for probe_tiny) and folds it with fminf into a value the
//       compiler cannot drop; every pixel comes out background (depth
//       1 + 0 x that value = 1 for finite data, id -1).
//
// Bound on the card: as K1 (its bytes, or the operations the evaluated
// (triangle, pixel) pairs need) for dense; plus the strip bytes for dual;
// bytes (the fetched blocks and the outputs) for reset. These probes
// measure, they are not tuned: each keeps K1's one-CTA-per-tile schedule
// and region design so the differences between them are differences of
// the work alone.

#include "visibility_common.cuh"

namespace {

using namespace trident;

// Outputs at tile index row*32 + col under the region map.
__device__ __forceinline__ void store_tile(int tile,
                                           const float (&best_d)[kPxPerThread],
                                           const int (&best_t)[kPxPerThread],
                                           float* __restrict__ depth_out,
                                           int* __restrict__ tri_out) {
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o =
        static_cast<size_t>(tile) * kTilePx + vis_region_pixel(k);
    depth_out[o] = best_d[k];
    tri_out[o] = best_t[k];
  }
}

__global__ void __launch_bounds__(kVisThreads)
visibility_dense_kernel(const float* __restrict__ records,
                        const int* __restrict__ pair_chunk,
                        const int* __restrict__ pair_mask,
                        const int* __restrict__ tile_start, int ntx,
                        float* __restrict__ depth_out,
                        int* __restrict__ tri_out) {
  __shared__ VisRegionStage stage;
  const int tile = blockIdx.x;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t);
  vis_region_walk<false, true>(records, pair_chunk, pair_mask,
                               tile_start[tile], tile_start[tile + 1], tile,
                               ntx, stage, px, py, best_d, best_t);
  store_tile(tile, best_d, best_t, depth_out, tri_out);
}

constexpr int kMaxStripF4 = 2048;                 // 32 rows x 256 floats
constexpr int kStripPerThread = kMaxStripF4 / kVisThreads;

__global__ void __launch_bounds__(kVisThreads)
visibility_dual_kernel(const float* __restrict__ records,
                       const int* __restrict__ pair_chunk,
                       const int* __restrict__ pair_mask,
                       const int* __restrict__ tile_start, int ntx,
                       const float* __restrict__ table2, int rows2,
                       long long tpad, float* __restrict__ depth_out,
                       int* __restrict__ tri_out) {
  __shared__ VisRegionStage stage;
  __shared__ float warp_sum[kWarps];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int col0 = (tile % ntx) * kTile;
  const int row0 = (tile / ntx) * kTile;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t);
  const int strip_f4 = rows2 * (kChunk / 4);
  float acc = 0.0f;
  const int p_end = tile_start[tile + 1];
  for (int p = tile_start[tile]; p < p_end; ++p) {
    const int chunk = pair_chunk[p];
    float4 v[kStripPerThread];
#pragma unroll
    for (int k = 0; k < kStripPerThread; ++k) {
      const int i = t + k * kVisThreads;
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < strip_f4) {
        const int row = i / (kChunk / 4);
        const int col = i % (kChunk / 4);
        v[k] = __ldg(reinterpret_cast<const float4*>(
                         table2 + row * tpad +
                         static_cast<long long>(chunk) * kChunk) +
                     col);
      }
    }
    vis_region_pair<false>(records, chunk, static_cast<unsigned>(pair_mask[p]),
                           col0, row0, stage, px, py, best_d, best_t);
#pragma unroll
    for (int k = 0; k < kStripPerThread; ++k) {
      acc += ((v[k].x + v[k].y) + v[k].z) + v[k].w;
    }
  }
  // the tile's sum in a fixed order: each warp by shuffles, then warp 0
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  }
  if (t % 32 == 0) warp_sum[t / 32] = acc;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    best_d[k] = best_d[k] + 1e-30f * total;
  }
  store_tile(tile, best_d, best_t, depth_out, tri_out);
}

__global__ void __launch_bounds__(kVisThreads)
visibility_reset_kernel(const float* __restrict__ table, int block_floats,
                        const int* __restrict__ pair_chunk,
                        const int* __restrict__ tile_start,
                        float* __restrict__ depth_out,
                        int* __restrict__ tri_out) {
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int block_f4 = block_floats / 4;
  float acc = 0.0f;
  const int p_end = tile_start[tile + 1];
  for (int p = tile_start[tile]; p < p_end; ++p) {
    const float4* src = reinterpret_cast<const float4*>(
        table + static_cast<size_t>(pair_chunk[p]) * block_floats);
    for (int i = t; i < block_f4; i += kVisThreads) {
      const float4 v = __ldg(src + i);
      acc = fminf(acc, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    }
  }
  // 0 x acc is +-0 for finite data; without fast-math it stays a real
  // multiply, so the loads above cannot be dropped
  const float d = 1.0f + 0.0f * acc;
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o = static_cast<size_t>(tile) * kTilePx + t + k * kVisThreads;
    depth_out[o] = d;
    tri_out[o] = -1;
  }
}

}  // namespace

extern "C" int trident_visibility_dense(const float* records,
                                        const int* pair_chunk,
                                        const int* pair_mask,
                                        const int* tile_start, int n_tiles,
                                        int ntx, float* depth_out,
                                        int* tri_out, cudaStream_t stream) {
  if (n_tiles > 0) {
    visibility_dense_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// table2: (rows2, tpad) f32, rows2 <= 32, tpad a multiple of 256, 16-byte
// aligned.
extern "C" int trident_visibility_dual(const float* records,
                                       const int* pair_chunk,
                                       const int* pair_mask,
                                       const int* tile_start, int n_tiles,
                                       int ntx, const float* table2, int rows2,
                                       long long tpad, float* depth_out,
                                       int* tri_out, cudaStream_t stream) {
  if (rows2 < 0 || rows2 * (kChunk / 4) > kMaxStripF4 || tpad % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    visibility_dual_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, table2, rows2, tpad,
        depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: block_floats floats per block index, block_floats a multiple of 4,
// 16-byte aligned.
extern "C" int trident_visibility_reset(const float* table, int block_floats,
                                        const int* pair_chunk,
                                        const int* tile_start, int n_tiles,
                                        float* depth_out, int* tri_out,
                                        cudaStream_t stream) {
  if (block_floats <= 0 || block_floats % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    visibility_reset_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        table, block_floats, pair_chunk, tile_start, depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}
