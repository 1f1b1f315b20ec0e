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

// K1's walk over the sorted pairs [p_begin, p_end) of one tile: for each
// hit 16-triangle sub-block, stage its 16 record rows (one float per
// thread) in `rows` (kSub * kRec floats of shared memory), sync, merge.
// Triangle ids are record row indices.
template <bool kDepthOnly>
__device__ __forceinline__ void vis_walk(const float* __restrict__ records,
                                         const int* __restrict__ pair_chunk,
                                         const int* __restrict__ pair_mask,
                                         int p_begin, int p_end, float* rows,
                                         const float (&px)[kPxPerThread],
                                         const float (&py)[kPxPerThread],
                                         float (&best_d)[kPxPerThread],
                                         int (&best_t)[kPxPerThread]) {
  const int t = threadIdx.x;
  for (int p = p_begin; p < p_end; ++p) {
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
        vis_triangle<kDepthOnly>(rows + j * kRec, base + j, px, py, best_d,
                                 best_t);
      }
      __syncthreads();
    }
  }
}

}  // namespace trident
