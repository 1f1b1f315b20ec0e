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
// (raster_pallas.py:1064-1073). No atomics: the merge is a lexicographic
// compare in registers, so the result is deterministic and independent of
// pair order. The depth-only instance (kDepthOnly) keeps a plain min: the
// same depths in the same order, so its depth is bit-equal to the colour
// pass's on the same bins. Built with -fmad=false so each product and sum rounds like
// PyTorch's eager elementwise ops (the plain version in ops/raster.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTilePx = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPxPerThread = kTilePx / kThreads;
constexpr int kChunk = 256;
constexpr int kSub = 16;
constexpr int kRec = 16;   // floats per record row: e0 e1 e2 (a,b,c), z3, w3, pad

template <bool kDepthOnly>
__global__ void __launch_bounds__(kThreads)
visibility_kernel(const float* __restrict__ records,
                  const int* __restrict__ pair_chunk,
                  const int* __restrict__ pair_mask,
                  const int* __restrict__ tile_start, int ntx,
                  float* __restrict__ depth_out, int* __restrict__ tri_out) {
  __shared__ float rows[kSub * kRec];
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int tx = tile % ntx;
  const int ty = tile / ntx;

  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int r = t + k * kThreads;
    px[k] = static_cast<float>(tx * kTile + r % kTile) + 0.5f;
    py[k] = static_cast<float>(ty * kTile + r / kTile) + 0.5f;
    best_d[k] = 1.0f;
    best_t[k] = -1;
  }

  const int p_end = tile_start[tile + 1];
  for (int p = tile_start[tile]; p < p_end; ++p) {
    const int chunk = pair_chunk[p];
    unsigned mask = static_cast<unsigned>(pair_mask[p]) & 0xFFFFu;
    while (mask != 0u) {
      const int q = __ffs(mask) - 1;
      mask &= mask - 1u;
      const int base = chunk * kChunk + q * kSub;
      rows[t] = records[static_cast<size_t>(base) * kRec + t];
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kSub; ++j) {
        const float* rc = rows + j * kRec;
        const int tid = base + j;
#pragma unroll
        for (int k = 0; k < kPxPerThread; ++k) {
          const float e0 = rc[0] * px[k] + rc[1] * py[k] + rc[2];
          const float e1 = rc[3] * px[k] + rc[4] * py[k] + rc[5];
          const float e2 = rc[6] * px[k] + rc[7] * py[k] + rc[8];
          const float zi = (e0 * rc[9] + e1 * rc[10]) + e2 * rc[11];
          const float wi = (e0 * rc[12] + e1 * rc[13]) + e2 * rc[14];
          const bool cover = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                             zi >= 0.0f && zi <= wi && wi > 1e-12f;
          if (cover) {
            // + 0.0f folds a -0.0 depth to +0.0 (the plain version orders
            // depths by their bit patterns)
            const float d = zi * (1.0f / wi) + 0.0f;
            if (kDepthOnly) {
              best_d[k] = fminf(best_d[k], d);
            } else if (d < best_d[k] || (d == best_d[k] && tid > best_t[k])) {
              best_d[k] = d;
              best_t[k] = tid;
            }
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o = static_cast<size_t>(tile) * kTilePx + t + k * kThreads;
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
    visibility_kernel<false><<<n_tiles, kThreads, 0, stream>>>(
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
    visibility_kernel<true><<<n_tiles, kThreads, 0, stream>>>(
        records, pair_chunk, pair_mask, tile_start, ntx, depth_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
