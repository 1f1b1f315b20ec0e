// The visibility kernels' shared per-tile code: one CTA of 256 threads per
// 32x32 tile, each thread owning 4 pixels and keeping their (depth, id) in
// registers. One expression order for every kernel that includes it
// (vis_triangle), so their depths and ids agree bit for bit: the reference
// kernel's (raster_pallas.py:1064-1073), with -fmad=false rounding each
// product and sum like PyTorch's eager ops in ops/raster.py.
//
// One design, the region design (vis_region_*), for every visibility
// kernel: K1 and K1b (visibility.cu), K1-CK (visibility_ck.cu, staged by
// bulk copies of its own), K-FUSE (visibility_resolve.cu) and the kbench
// probes (visibility_probe.cu). Warp w owns one compact 16x8 region of the
// tile; a pair's hit sub-blocks are staged at once with each row's 8-bit
// region mask (vis_region_bits); each warp evaluates only the staged
// triangles whose three edge functions are not all negative over its
// region. The test is exact, so the result is that of evaluating every
// staged triangle at every pixel, bit for bit.

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

constexpr int kWarps = kVisThreads / 32;          // 8 regions per tile
constexpr int kRegionW = 16;                      // region columns
constexpr int kRegionH = 8;                       // region rows
constexpr int kPairRows = (kChunk / kSub) * kSub; // 256: a pair's hit rows
// Staged row stride in floats: 20 (80 bytes) puts the 16-byte stores of
// eight consecutive rows on distinct banks; vis_triangle reads rc[0..14].
constexpr int kStageStride = 20;
static_assert(kPairRows == kVisThreads, "one staged row per thread");

// Shared memory of one CTA: a pair's hit record rows (one per thread at
// most), their triangle ids, and each row's 8-bit region mask.
struct __align__(16) VisRegionStage {
  float rows[kPairRows * kStageStride];
  int ids[kPairRows];
  unsigned char bits[kPairRows];
};

// Tile-local pixel index r = row*32 + col of this thread's k-th pixel:
// warp w owns columns 16*(w%2) .. +15 and rows 8*(w/2) .. +7; lane l's
// k-th pixel is column l%16 and row 2k + l/16 of that region.
__device__ __forceinline__ int vis_region_pixel(int k) {
  const int w = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  return (kRegionH * (w >> 1) + 2 * k + (l >> 4)) * kTile +
         kRegionW * (w & 1) + (l & 15);
}

// Pixel centres of this thread's pixels in `tile` under the region map;
// background state (depth 1, id -1).
__device__ __forceinline__ void vis_region_begin(int tile, int ntx,
                                                 float (&px)[kPxPerThread],
                                                 float (&py)[kPxPerThread],
                                                 float (&best_d)[kPxPerThread],
                                                 int (&best_t)[kPxPerThread]) {
  const int tx = tile % ntx;
  const int ty = tile / ntx;
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int r = vis_region_pixel(k);
    px[k] = static_cast<float>(tx * kTile + r % kTile) + 0.5f;
    py[k] = static_cast<float>(ty * kTile + r / kTile) + 0.5f;
    best_d[k] = 1.0f;
    best_t[k] = -1;
  }
}

// Bit w set unless triangle rc misses every pixel centre of warp w's region
// of the tile whose first pixel is (col0, row0). Each edge is written as
// vis_triangle writes it, (a*px + b*py) + c, at the region's corner
// px* = a >= 0 ? x_hi : x_lo, py* = b >= 0 ? y_hi : y_lo. Every product and
// sum is one correctly rounded op (-fmad=false) and rounding is monotone,
// so the value there is exactly the edge's maximum over the region's pixel
// centres: if it is < 0 for some edge, no pixel of the region passes
// vis_triangle's e >= 0, and skipping the triangle changes no depth and no
// id. A NaN edge is never < 0, so such a triangle is kept; an invalid row
// (e = -1) is always dropped. ops/raster.py region_keep is its plain twin.
__device__ __forceinline__ unsigned vis_region_bits(const float* rc, int col0,
                                                    int row0) {
  unsigned bits = (1u << kWarps) - 1u;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float a = rc[3 * e];
    const float b = rc[3 * e + 1];
    const float c = rc[3 * e + 2];
    const int dx = a >= 0.0f ? kRegionW - 1 : 0;
    const int dy = b >= 0.0f ? kRegionH - 1 : 0;
    float ax[2], by[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ax[i] = a * (static_cast<float>(col0 + kRegionW * i + dx) + 0.5f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      by[i] = b * (static_cast<float>(row0 + kRegionH * i + dy) + 0.5f);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (ax[w & 1] + by[w >> 1] + c < 0.0f) bits &= ~(1u << w);
    }
  }
  return bits;
}

// Stage pair (chunk, mask): thread t < 16*popc(mask) loads record row t of
// the pair's hit sub-blocks (ascending q; four 16-byte loads of one
// 64-byte row) into `st`, with its triangle id and its region mask for the
// tile at (col0, row0). kDense (the kbench "nobranch" probe) stages all 16
// sub-blocks, row t = record row chunk*256 + t, with no mask walk. Returns
// the staged row count; the caller syncs.
template <bool kDense = false>
__device__ __forceinline__ int vis_region_stage(
    const float* __restrict__ records, int chunk, unsigned mask, int col0,
    int row0, VisRegionStage& st) {
  mask &= 0xFFFFu;
  const int n_rows = kDense ? kPairRows : __popc(mask) * kSub;
  const int t = threadIdx.x;
  if (t < n_rows) {
    int id = chunk * kChunk + t;
    if (!kDense) {
      unsigned m = mask;
      for (int j = t / kSub; j > 0; --j) m &= m - 1u;   // drop j lower hits
      id = chunk * kChunk + (__ffs(m) - 1) * kSub + t % kSub;
    }
    const float4* src = reinterpret_cast<const float4*>(
        records + static_cast<size_t>(id) * kRec);
    float4* dst = reinterpret_cast<float4*>(st.rows + t * kStageStride);
    float4 v[kRec / 4];
#pragma unroll
    for (int i = 0; i < kRec / 4; ++i) {
      v[i] = __ldg(src + i);
      dst[i] = v[i];
    }
    const float rc[9] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x,
                         v[1].y, v[1].z, v[1].w, v[2].x};
    st.ids[t] = id;
    st.bits[t] = static_cast<unsigned char>(vis_region_bits(rc, col0, row0));
  }
  return n_rows;
}

// This warp's sweep of a staged pair: n_rows record rows at `rows`, kStride
// floats apart, with region masks `bits` and triangle ids `ids` (or, where
// ids is null, each row's column 15, as the compact banks carry them). 32
// rows a round: one lane per row reads its region bit, __ballot_sync gives
// the warp its kept rows, and the warp merges them in ascending order (a
// warp-uniform loop).
template <bool kDepthOnly, int kStride>
__device__ __forceinline__ void vis_region_sweep(
    const float* rows, const int* ids, const unsigned char* bits, int n_rows,
    const float (&px)[kPxPerThread], const float (&py)[kPxPerThread],
    float (&best_d)[kPxPerThread], int (&best_t)[kPxPerThread]) {
  const int w = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  for (int g = 0; g < n_rows; g += 32) {
    const bool keep = g + l < n_rows && ((bits[g + l] >> w) & 1u);
    unsigned m = __ballot_sync(0xFFFFFFFFu, keep);
    while (m != 0u) {
      const int j = g + __ffs(m) - 1;
      m &= m - 1u;
      const float* rc = rows + j * kStride;
      const int tid = ids != nullptr ? ids[j] : static_cast<int>(rc[kRec - 1]);
      vis_triangle<kDepthOnly>(rc, tid, px, py, best_d, best_t);
    }
  }
}

// One pair under the region design: one staging, one sync, this warp's
// sweep, one sync (the next staging overwrites `st`).
template <bool kDepthOnly, bool kDense = false>
__device__ __forceinline__ void vis_region_pair(
    const float* __restrict__ records, int chunk, unsigned mask, int col0,
    int row0, VisRegionStage& st, const float (&px)[kPxPerThread],
    const float (&py)[kPxPerThread], float (&best_d)[kPxPerThread],
    int (&best_t)[kPxPerThread]) {
  const int n_rows =
      vis_region_stage<kDense>(records, chunk, mask, col0, row0, st);
  __syncthreads();
  vis_region_sweep<kDepthOnly, kStageStride>(st.rows, st.ids, st.bits, n_rows,
                                             px, py, best_d, best_t);
  __syncthreads();
}

// The walk over the sorted pairs [p_begin, p_end) of one tile, one
// vis_region_pair each (kDense: all 16 sub-blocks of every pair).
template <bool kDepthOnly, bool kDense = false>
__device__ __forceinline__ void vis_region_walk(
    const float* __restrict__ records, const int* __restrict__ pair_chunk,
    const int* __restrict__ pair_mask, int p_begin, int p_end, int tile,
    int ntx, VisRegionStage& st, const float (&px)[kPxPerThread],
    const float (&py)[kPxPerThread], float (&best_d)[kPxPerThread],
    int (&best_t)[kPxPerThread]) {
  const int col0 = (tile % ntx) * kTile;
  const int row0 = (tile / ntx) * kTile;
  for (int p = p_begin; p < p_end; ++p) {
    vis_region_pair<kDepthOnly, kDense>(
        records, pair_chunk[p], kDense ? 0xFFFFu
                                       : static_cast<unsigned>(pair_mask[p]),
        col0, row0, st, px, py, best_d, best_t);
  }
}

}  // namespace trident
