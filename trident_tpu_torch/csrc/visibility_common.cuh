// The visibility kernels' shared per-tile walk (csrc/visibility.cu,
// visibility_ck.cu, visibility_resolve.cu): one CTA of 256 threads per
// 32x32 tile, each thread owning 4 pixels (r = t + k*256) and keeping their
// (depth, id) in registers. One expression order for every kernel that
// includes it, so their depths and ids agree bit for bit: the reference
// kernel's (raster_pallas.py:1064-1073), with -fmad=false rounding each
// product and sum like PyTorch's eager ops in ops/raster.py.

#pragma once

#include <cuda_runtime.h>

namespace trident {

constexpr int kTile = 32;
constexpr int kTilePx = kTile * kTile;
constexpr int kVisThreads = 256;
constexpr int kPxPerThread = kTilePx / kVisThreads;
constexpr int kChunk = 256;
constexpr int kSub = 16;
constexpr int kRec = 16;   // floats per record row: e0 e1 e2 (a,b,c), z3, w3, id/pad

// Pixel centres of this thread's pixels in `tile`; background state
// (depth 1, id -1).
__device__ __forceinline__ void vis_begin(int tile, int ntx,
                                          float (&px)[kPxPerThread],
                                          float (&py)[kPxPerThread],
                                          float (&best_d)[kPxPerThread],
                                          int (&best_t)[kPxPerThread]) {
  const int tx = tile % ntx;
  const int ty = tile / ntx;
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int r = threadIdx.x + k * kVisThreads;
    px[k] = static_cast<float>(tx * kTile + r % kTile) + 0.5f;
    py[k] = static_cast<float>(ty * kTile + r / kTile) + 0.5f;
    best_d[k] = 1.0f;
    best_t[k] = -1;
  }
}

// Triangle `tid` (record row rc) against this thread's pixels: the
// lexicographic (min depth, max id) merge, or a plain min (kDepthOnly).
template <bool kDepthOnly>
__device__ __forceinline__ void vis_triangle(const float* rc, int tid,
                                             const float (&px)[kPxPerThread],
                                             const float (&py)[kPxPerThread],
                                             float (&best_d)[kPxPerThread],
                                             int (&best_t)[kPxPerThread]) {
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

// One 16-triangle sub-block whose first record row is `base`: stage its
// 16 record rows (one float per thread) in `rows` (kSub * kRec floats of
// shared memory), sync, merge. Triangle ids are record row indices.
template <bool kDepthOnly>
__device__ __forceinline__ void vis_sub_block(
    const float* __restrict__ records, int base, float* rows,
    const float (&px)[kPxPerThread], const float (&py)[kPxPerThread],
    float (&best_d)[kPxPerThread], int (&best_t)[kPxPerThread]) {
  rows[threadIdx.x] = records[static_cast<size_t>(base) * kRec + threadIdx.x];
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < kSub; ++j) {
    vis_triangle<kDepthOnly>(rows + j * kRec, base + j, px, py, best_d,
                             best_t);
  }
  __syncthreads();
}

// One (tile, chunk) pair: its hit sub-blocks in ascending order, or, with
// kDense (the kbench "nobranch" probe), all 16 of them with no mask walk:
// the same merge as K1 on all-ones masks. It differs from K1 on the real
// masks only where a triangle outside the tile's marked sub-blocks passes
// the cover test by rounding (the extension of a near-degenerate triangle,
// outside its bbox), a hit the binner's bbox cull drops.
template <bool kDepthOnly, bool kDense = false>
__device__ __forceinline__ void vis_pair(const float* __restrict__ records,
                                         int chunk, unsigned mask,
                                         float* rows,
                                         const float (&px)[kPxPerThread],
                                         const float (&py)[kPxPerThread],
                                         float (&best_d)[kPxPerThread],
                                         int (&best_t)[kPxPerThread]) {
  if (kDense) {
    for (int q = 0; q < kChunk / kSub; ++q) {
      vis_sub_block<kDepthOnly>(records, chunk * kChunk + q * kSub, rows, px,
                                py, best_d, best_t);
    }
    return;
  }
  mask &= 0xFFFFu;
  while (mask != 0u) {
    const int q = __ffs(mask) - 1;
    mask &= mask - 1u;
    vis_sub_block<kDepthOnly>(records, chunk * kChunk + q * kSub, rows, px,
                              py, best_d, best_t);
  }
}

// K1's walk over the sorted pairs [p_begin, p_end) of one tile.
template <bool kDepthOnly, bool kDense = false>
__device__ __forceinline__ void vis_walk(const float* __restrict__ records,
                                         const int* __restrict__ pair_chunk,
                                         const int* __restrict__ pair_mask,
                                         int p_begin, int p_end, float* rows,
                                         const float (&px)[kPxPerThread],
                                         const float (&py)[kPxPerThread],
                                         float (&best_d)[kPxPerThread],
                                         int (&best_t)[kPxPerThread]) {
  for (int p = p_begin; p < p_end; ++p) {
    vis_pair<kDepthOnly, kDense>(records, pair_chunk[p],
                                 static_cast<unsigned>(pair_mask[p]), rows,
                                 px, py, best_d, best_t);
  }
}

}  // namespace trident
