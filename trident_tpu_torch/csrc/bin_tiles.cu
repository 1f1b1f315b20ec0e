// Tile binning: ops/raster.py::build_bins on the card, in four launches.
//
// Replaces no Pallas kernel: the JAX package's build_bins
// (trident_tpu/ops/raster_pallas.py:588) is plain jnp with an XLA sort. The
// port ran it as plain PyTorch (ops/raster.py::build_bins_plain): 16
// torch.where columns stacked into the (Tpad, 16) record table and
// concatenated with the padding rows, a searchsorted of every pool slot over
// the sub-blocks' claim ends, a sort of int64 keys carrying a permutation,
// and the hit masks summed with int64 atomics (index_add_). These kernels
// make the same Bins, bit for bit, with no T-sized temporary.
//
// Bound on the card: bytes. Per triangle its 15 setup columns (60 B),
// `valid` (1 B) and int32 bbox (16 B) read and its 64-byte record row
// written: 141 B, 296 MB at the crowd's 2,097,152-triangle bucket (0.088 ms
// at 3.35 TB/s), 140 MB at the field's 995,328 triangles (0.042 ms); the
// pool's keys written, sorted and merged add about 25 MB and 14 MB. About
// 0.095 and 0.05 ms a frame.
//
// Design: one pass over the triangles and three over the pool, with
// torch.cumsum and torch.sort between them, as the JAX package leaves its
// sort to XLA. bin_records_kernel, one thread per triangle and a block per
// 256-triangle chunk, reads the triangle's setup columns (each through its
// own pointer and element stride: planar columns or views of the stacked
// setup alike), writes its record row, the padding rows past T included, and
// stages a warp's 32 rows in shared memory so that they leave as contiguous
// 512-byte runs. Each 16-lane half-warp is one sub-block: it reduces the
// valid triangles' bboxes with shuffles and writes the sub-block's tile
// origin, span and claimed area. After a cumsum of the areas,
// bin_claims_kernel gives each sub-block a half-warp that writes its claimed
// tiles' keys at its own slots [start, min(end, pool)), with no search of
// the pool; slots past the total get the sentinel, and a block (one chunk)
// counts itself dropped once. A key packs (tile · n_chunks + chunk) over the
// sub-block q in 4 bits, so the sort carries the hit bit with the key and no
// permutation is gathered; keys are int32 where the key space fits 31 bits,
// else int64. bin_heads_kernel flags each run's first key; a cumsum numbers
// the pairs; bin_pairs_kernel has each run's head OR its run's bits (a run
// is one (tile, chunk): at most 16 keys, one per sub-block) and write its
// pair, the budget's truncation and padding, n_real, aux and tile_start (the
// head of a tile's first pair writes the tile_start entries from the
// previous pair's tile). Shapes are static and nothing syncs with the host,
// so a frame graph captures the stage.
//
// Numerics: integers and copies only. Records are the setup's floats or the
// plain version's constants (e ≡ (0, 0, −1), z 0, w 1, column 15 0);
// floor division and clamps as PyTorch's on int64.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // a block: one 256-triangle chunk
constexpr int kSub = 16;        // triangles per sub-block: a half-warp
constexpr int kTile = 32;       // tiles are 32×32 pixels
constexpr int kBig = 1 << 20;   // an invalid triangle's bbox min
constexpr int kCols = 15;       // setup columns: e[3k + c], z[k], w[k]

struct Cols {
  const float* p[kCols];
  long long s[kCols];           // element strides
};

// Python's // on int64
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// torch.clamp(v, lo, hi) on int64
__device__ __forceinline__ long long clamp(long long v, long long lo,
                                           long long hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) bin_records_kernel(
    Cols cols, const unsigned char* __restrict__ valid,
    const int* __restrict__ bbox, int t, int ntx, int nty,
    float4* __restrict__ records, long long* __restrict__ area,
    int4* __restrict__ sub, int* __restrict__ aux) {
  const int i = blockIdx.x * kThreads + threadIdx.x;   // < tpad
  if (i == 0) {
    aux[0] = 0;
    aux[1] = 0;
  }
  const bool v = i < t && __ldg(valid + i) != 0;
  // an invalid or padding triangle's row: e ≡ (0, 0, −1), z 0, w 1
  float r[16];
  #pragma unroll
  for (int c = 0; c < 16; ++c) {
    r[c] = (c == 2 || c == 5 || c == 8) ? -1.0f
                                        : (c >= 12 && c < 15) ? 1.0f : 0.0f;
  }
  int x0 = kBig, y0 = kBig, x1 = 0, y1 = 0;
  if (v) {
    #pragma unroll
    for (int c = 0; c < kCols; ++c) r[c] = __ldg(cols.p[c] + i * cols.s[c]);
    const int* b = bbox + 4 * static_cast<size_t>(i);
    x0 = __ldg(b);
    y0 = __ldg(b + 1);
    x1 = __ldg(b + 2);
    y1 = __ldg(b + 3);
  }

  // the warp's 32 rows through shared memory, stored as 512-byte runs
  __shared__ float4 stage[kThreads / 32][32 * 4];
  const int lane = threadIdx.x & 31;
  float4* rows = stage[threadIdx.x >> 5];
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    rows[lane * 4 + q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                     r[4 * q + 3]);
  }
  __syncwarp();
  float4* out = records + static_cast<size_t>(i - lane) * 4;
  #pragma unroll
  for (int q = 0; q < 4; ++q) out[lane + 32 * q] = rows[lane + 32 * q];

  // the sub-block's bbox over its valid triangles (sub_min / sub_max)
  #pragma unroll
  for (int o = kSub / 2; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
  if ((threadIdx.x & (kSub - 1)) == 0) {
    const bool nonempty = x1 > x0 && y1 > y0;
    const long long tx0 = clamp(floor_div(x0, kTile), 0, ntx - 1);
    const long long ty0 = clamp(floor_div(y0, kTile), 0, nty - 1);
    const long long sx = nonempty
        ? clamp(floor_div(x1 - 1LL, kTile), 0, ntx - 1) - tx0 + 1 : 0;
    const long long sy = nonempty
        ? clamp(floor_div(y1 - 1LL, kTile), 0, nty - 1) - ty0 + 1 : 0;
    const int s = i / kSub;
    area[s] = sx * sy;
    sub[s] = make_int4(static_cast<int>(tx0), static_cast<int>(ty0),
                       static_cast<int>(sx), static_cast<int>(sy));
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads) bin_claims_kernel(
    const long long* __restrict__ area, const long long* __restrict__ ends,
    const int4* __restrict__ sub, int n_sub, long long pool, int ntx,
    int n_chunks, K sentinel, K* __restrict__ keys, int* __restrict__ aux) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (g < pool && g >= __ldg(ends + n_sub - 1)) keys[g] = sentinel;
  // blocks below n_sub · 16 lanes are whole chunks: 16 sub-blocks each
  if (static_cast<long long>(blockIdx.x) * kThreads
      >= static_cast<long long>(n_sub) * kSub) {
    return;
  }
  const int s = static_cast<int>(g / kSub), lane = static_cast<int>(g % kSub);
  const long long a = __ldg(area + s), end = __ldg(ends + s);
  const long long start = end - a;
  const int4 q = __ldg(sub + s);
  const long long sx = max(q.z, 1);
  const K base = static_cast<K>(s / kSub);
  for (long long k = lane; k < min(end, pool) - start; k += kSub) {
    const long long tile = (q.y + k / sx) * ntx + q.x + k % sx;
    keys[start + k] = static_cast<K>(
        ((static_cast<K>(tile) * n_chunks + base) << 4) | (s % kSub));
  }
  // n_dropped: chunks with a non-empty sub-block whose claim passes the pool
  if (__syncthreads_or(a > 0 && end > pool) && threadIdx.x == 0) {
    atomicAdd(aux + 1, 1);
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads) bin_heads_kernel(
    const K* __restrict__ keys, long long pool, K sentinel_pair,
    int* __restrict__ heads) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (g >= pool) return;
  const K pk = __ldg(keys + g) >> 4;
  heads[g] = pk != sentinel_pair && (g == 0 || (__ldg(keys + g - 1) >> 4) != pk);
}

template <typename K>
__global__ void __launch_bounds__(kThreads) bin_pairs_kernel(
    const K* __restrict__ keys, const int* __restrict__ pair_no,
    long long pool, long long budget, int n_chunks, int n_tiles,
    K sentinel_pair, int* __restrict__ pair_tile, int* __restrict__ pair_chunk,
    int* __restrict__ pair_mask, int* __restrict__ tile_start,
    long long* __restrict__ n_real_out, int* __restrict__ aux) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long total = pool > 0 ? __ldg(pair_no + pool - 1) : 0;
  const long long n_real = min(total, budget);
  if (g == 0) {
    *n_real_out = n_real;
    aux[0] = static_cast<int>(total - n_real);
    if (n_real == 0) {
      for (int t = 0; t <= n_tiles; ++t) tile_start[t] = 0;
    }
  }
  if (g < budget && g >= n_real) {     // padding pairs
    pair_tile[g] = n_tiles;
    pair_chunk[g] = 0;
    pair_mask[g] = 0;
  }
  if (g >= pool) return;
  const K key = __ldg(keys + g);
  const K pk = key >> 4;
  if (pk == sentinel_pair || (g > 0 && (__ldg(keys + g - 1) >> 4) == pk)) {
    return;
  }
  const long long p = __ldg(pair_no + g) - 1;   // this run's pair
  if (p >= budget) return;
  int mask = 1 << static_cast<int>(key & 15);
  for (long long k = g + 1; k < pool; ++k) {
    const K kk = __ldg(keys + k);
    if ((kk >> 4) != pk) break;
    mask |= 1 << static_cast<int>(kk & 15);
  }
  const int tile = static_cast<int>(pk / n_chunks);
  pair_tile[p] = tile;
  pair_chunk[p] = static_cast<int>(pk % n_chunks);
  pair_mask[p] = mask;
  // tile_start[t] = pairs with a tile below t: p for the tiles after the
  // previous pair's, up to this one's; n_real after the last pair's
  const int prev = p == 0
      ? -1 : static_cast<int>((__ldg(keys + g - 1) >> 4) / n_chunks);
  for (int t = prev + 1; t <= tile; ++t) tile_start[t] = static_cast<int>(p);
  if (p == n_real - 1) {
    for (int t = tile + 1; t <= n_tiles; ++t) {
      tile_start[t] = static_cast<int>(n_real);
    }
  }
}

unsigned blocks_of(long long n) {
  return static_cast<unsigned>(std::max((n + kThreads - 1) / kThreads, 1LL));
}

}  // namespace

// cols: host memory, the 15 column pointers then their 15 element strides
extern "C" int trident_bin_records(const long long* cols, const void* valid,
                                   const int* bbox, int t, int tpad, int ntx,
                                   int nty, void* records, void* area,
                                   void* sub, int* aux, cudaStream_t stream) {
  Cols c;
  for (int k = 0; k < kCols; ++k) {
    c.p[k] = reinterpret_cast<const float*>(cols[k]);
    c.s[k] = cols[kCols + k];
  }
  bin_records_kernel<<<tpad / kThreads, kThreads, 0, stream>>>(
      c, static_cast<const unsigned char*>(valid), bbox, t, ntx, nty,
      static_cast<float4*>(records), static_cast<long long*>(area),
      static_cast<int4*>(sub), aux);
  return static_cast<int>(cudaGetLastError());
}

// wide: int64 keys (else int32); the sentinel key is n_tiles · n_chunks << 4
extern "C" int trident_bin_claims(const void* area, const void* ends,
                                  const void* sub, int n_sub, long long pool,
                                  int ntx, int n_chunks, long long sentinel,
                                  int wide, void* keys, int* aux,
                                  cudaStream_t stream) {
  const unsigned grid = blocks_of(
      std::max(pool, static_cast<long long>(n_sub) * kSub));
  const auto* a = static_cast<const long long*>(area);
  const auto* e = static_cast<const long long*>(ends);
  const auto* q = static_cast<const int4*>(sub);
  if (wide) {
    bin_claims_kernel<long long><<<grid, kThreads, 0, stream>>>(
        a, e, q, n_sub, pool, ntx, n_chunks, sentinel,
        static_cast<long long*>(keys), aux);
  } else {
    bin_claims_kernel<int><<<grid, kThreads, 0, stream>>>(
        a, e, q, n_sub, pool, ntx, n_chunks, static_cast<int>(sentinel),
        static_cast<int*>(keys), aux);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trident_bin_heads(const void* keys, long long pool,
                                 long long sentinel_pair, int wide,
                                 int* heads, cudaStream_t stream) {
  if (wide) {
    bin_heads_kernel<long long><<<blocks_of(pool), kThreads, 0, stream>>>(
        static_cast<const long long*>(keys), pool, sentinel_pair, heads);
  } else {
    bin_heads_kernel<int><<<blocks_of(pool), kThreads, 0, stream>>>(
        static_cast<const int*>(keys), pool,
        static_cast<int>(sentinel_pair), heads);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trident_bin_pairs(const void* keys, const int* pair_no,
                                 long long pool, long long budget,
                                 int n_chunks, int n_tiles,
                                 long long sentinel_pair, int wide,
                                 int* pair_tile, int* pair_chunk,
                                 int* pair_mask, int* tile_start,
                                 void* n_real, int* aux, cudaStream_t stream) {
  const unsigned grid = blocks_of(std::max(pool, budget));
  auto* nr = static_cast<long long*>(n_real);
  if (wide) {
    bin_pairs_kernel<long long><<<grid, kThreads, 0, stream>>>(
        static_cast<const long long*>(keys), pair_no, pool, budget, n_chunks,
        n_tiles, sentinel_pair, pair_tile, pair_chunk, pair_mask, tile_start,
        nr, aux);
  } else {
    bin_pairs_kernel<int><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(keys), pair_no, pool, budget, n_chunks,
        n_tiles, static_cast<int>(sentinel_pair), pair_tile, pair_chunk,
        pair_mask, tile_start, nr, aux);
  }
  return static_cast<int>(cudaGetLastError());
}
