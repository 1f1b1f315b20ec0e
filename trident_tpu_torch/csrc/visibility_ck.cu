// Compact-bank visibility kernel (the `ckern` knob): the same per-pixel
// result as the visibility kernel, read from per-pair banks of the pair's
// hit sub-blocks that the binner gathered contiguous.
//
// Replaces: trident_tpu/ops/raster_pallas.py _visibility_kernel_ck (CKERN,
// raster_pallas.py:1239; pallas_call at raster_pallas.py:1418), the bank
// table built at raster_pallas.py:835-857.
//
// Bound on the card: bytes, as the visibility kernel's (one 1 KB sub-block
// per live slot, the pair lists, the outputs: 0.0211 ms at spheres1080_1m
// on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 10); the f32
// operations its inputs need are a few percent of that.
//
// Design: the region design of visibility_common.cuh (one CTA per 32x32
// tile over its pair range, warp w owning a 16x8 region), staged by the
// Tensor Memory Accelerator. A pair's table row holds nbank sub-block slots
// of 16 record rows: its nhit hit sub-blocks in ascending order, then
// copies of the first hit; column 15 of every row is the triangle's global
// id (f32, exact below 2^24). So a pair's live rows are the first
// 16*min(nhit, 16) rows of its table row, contiguous, and ONE bulk copy
// (cp.async.bulk, up to 16 KB) stages them. The TPU's bank schedule (bank b
// runs when nhit > b*ck_bank, padding copies included) was a VMEM blocking;
// the copies are of an already merged triangle, so skipping them leaves the
// lexicographic merge unchanged, and ck_bank no longer shapes the work.
// Two 16 KB stage buffers form a ring, each with its own mbarrier: thread 0
// issues pair p+1's copy before the CTA waits for pair p's, so the copy is
// in flight while pair p is masked and merged. A pad pair (nhit 0) issues
// no copy and no wait. Per pair, after the wait: thread t < rows computes
// its row's 8-bit region mask from shared memory, one sync, each warp
// merges its kept rows (vis_region_sweep, ids from column 15), one sync
// (after it, the buffer is free for the copy issued next). The same kept
// (triangle, region) pairs as K1 on the same bins, in the same expression
// order, so ids and depths equal K1's bit for bit. Outputs go to tile index
// row*32 + col, two 64-byte runs per warp store.

#include "visibility_common.cuh"

namespace {

using namespace trident;

constexpr int kSubsPerChunk = kChunk / kSub;   // 16: nhit never exceeds it
constexpr int kSlotFloats = kSub * kRec;       // one sub-block slot, 1 KB
constexpr int kRing = 2;                       // stage buffers

// Shared memory of one CTA: the ring of stage buffers (a pair's live rows,
// 16 floats apart), their mbarriers, and the staged rows' region masks.
struct __align__(128) CkStage {
  float rows[kRing][kSubsPerChunk * kSlotFloats];
  unsigned long long full[kRing];
  unsigned char bits[kPairRows];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One thread: arm `bar` for `bytes` and copy them from global `src` into
// shared `dst`; the copy's completion completes the barrier's phase.
__device__ __forceinline__ void bulk_stage(float* dst, const float* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  // order the CTA's earlier reads of `dst` (generic proxy) before the
  // copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Every thread: wait until the barrier's phase of parity `parity` is done.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

// one tile; tile_y_offset (whole tiles: a band's first global tile row,
// raster_pallas.py:1255) is read only by the band instance
template <bool kBand>
__device__ __forceinline__ void visibility_ck_tile(
    const float* __restrict__ banks, const int* __restrict__ nhit,
    const int* __restrict__ tile_start, int ntx, int nbank,
    float* __restrict__ depth_out, int* __restrict__ tri_out,
    int tile_y_offset, CkStage& st) {
  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int ty0 = kBand ? tile_y_offset : 0;
  const int col0 = (tile % ntx) * kTile;
  const int row0 = (tile / ntx + ty0) * kTile;
  const int p_begin = tile_start[tile];
  const int p_end = tile_start[tile + 1];
  const size_t pair_floats = static_cast<size_t>(nbank) * kSlotFloats;
  float px[kPxPerThread], py[kPxPerThread], best_d[kPxPerThread];
  int best_t[kPxPerThread];
  vis_region_begin(tile, ntx, px, py, best_d, best_t, ty0);

  // pair p's live slots into ring buffer (p - p_begin) % 2 (thread 0)
  auto stage = [&](int p) {
    const int n = min(nhit[p], kSubsPerChunk);
    const int s = (p - p_begin) & 1;
    if (n > 0) {
      bulk_stage(st.rows[s], banks + static_cast<size_t>(p) * pair_floats,
                 static_cast<unsigned>(n * kSlotFloats * sizeof(float)),
                 &st.full[s]);
    }
  };
  if (t == 0) {
    mbar_init(&st.full[0]);
    mbar_init(&st.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0 && p_begin < p_end) stage(p_begin);

  unsigned phase = 0;   // bit s: the parity of buffer s's next completion
  for (int p = p_begin; p < p_end; ++p) {
    // buffer s^1 was last read before the sync that ended the previous
    // staged pair, so pair p+1's copy may overwrite it now
    if (t == 0 && p + 1 < p_end) stage(p + 1);
    const int n_rows = min(nhit[p], kSubsPerChunk) * kSub;
    if (n_rows == 0) continue;           // a pad pair: no copy, no wait
    const int s = (p - p_begin) & 1;
    mbar_wait(&st.full[s], (phase >> s) & 1u);
    phase ^= 1u << s;
    const float* rows = st.rows[s];
    if (t < n_rows) {
      const float4* r4 = reinterpret_cast<const float4*>(rows + t * kRec);
      const float4 v0 = r4[0], v1 = r4[1], v2 = r4[2];
      const float rc[9] = {v0.x, v0.y, v0.z, v0.w, v1.x,
                           v1.y, v1.z, v1.w, v2.x};
      st.bits[t] = static_cast<unsigned char>(vis_region_bits(rc, col0, row0));
    }
    __syncthreads();
    vis_region_sweep<false, kRec>(rows, nullptr, st.bits, n_rows, px, py,
                                  best_d, best_t);
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const size_t o =
        static_cast<size_t>(tile) * kTilePx + vis_region_pixel(k);
    depth_out[o] = best_d[k];
    tri_out[o] = best_t[k];
  }
}

__global__ void __launch_bounds__(kVisThreads)
visibility_ck_kernel(const float* __restrict__ banks,
                     const int* __restrict__ nhit,
                     const int* __restrict__ tile_start, int ntx, int nbank,
                     float* __restrict__ depth_out,
                     int* __restrict__ tri_out) {
  __shared__ CkStage st;
  visibility_ck_tile<false>(banks, nhit, tile_start, ntx, nbank, depth_out,
                            tri_out, 0, st);
}

// the band instance: one band of a taller frame (parallel/framebuffer.py)
__global__ void __launch_bounds__(kVisThreads)
visibility_ck_band_kernel(const float* __restrict__ banks,
                          const int* __restrict__ nhit,
                          const int* __restrict__ tile_start, int ntx,
                          int nbank, float* __restrict__ depth_out,
                          int* __restrict__ tri_out, int tile_y_offset) {
  __shared__ CkStage st;
  visibility_ck_tile<true>(banks, nhit, tile_start, ntx, nbank, depth_out,
                           tri_out, tile_y_offset, st);
}

}  // namespace

// banks: (n_pairs, nbank*16, 16) f32, 16-byte aligned; nbank =
// ceil(16/ck_bank)*ck_bank >= 16. ck_bank is checked, not used: the kernel
// stages each pair's live slots whatever the bank size.
extern "C" int trident_visibility_ck(const float* banks, const int* nhit,
                                     const int* tile_start, int n_tiles,
                                     int ntx, int ck_bank, int nbank,
                                     float* depth_out, int* tri_out,
                                     cudaStream_t stream) {
  if (ck_bank < 1 || nbank < kSubsPerChunk || nbank % ck_bank != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    visibility_ck_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        banks, nhit, tile_start, ntx, nbank, depth_out, tri_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// the band instance: tile row r of the grid is global tile row
// r + tile_y_offset
extern "C" int trident_visibility_ck_band(const float* banks,
                                          const int* nhit,
                                          const int* tile_start, int n_tiles,
                                          int ntx, int ck_bank, int nbank,
                                          int tile_y_offset,
                                          float* depth_out, int* tri_out,
                                          cudaStream_t stream) {
  if (ck_bank < 1 || nbank < kSubsPerChunk || nbank % ck_bank != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles > 0) {
    visibility_ck_band_kernel<<<n_tiles, kVisThreads, 0, stream>>>(
        banks, nhit, tile_start, ntx, nbank, depth_out, tri_out,
        tile_y_offset);
  }
  return static_cast<int>(cudaGetLastError());
}
