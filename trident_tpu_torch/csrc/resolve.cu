// Resolve kernel: each covered pixel's winning triangle id → the 16
// deferred-shading channels (rational normal and UV, mip level from the
// analytic UV derivatives, material constants, texture geometry).
//
// Replaces: trident_tpu/ops/resolve_pallas.py _resolve_kernel (reached via
// resolve_attrs_pallas, pallas_call at resolve_pallas.py:611), in both of
// its output layouts: the (H, W, 16) attribute image (trident_resolve) and
// the raster's tile layout (n_tiles, 16, 1024), `tiled=True`
// (resolve_pallas.py:631-635; trident_resolve_tiled), which the tiled
// shading path (the `tiled_shade` knob) reads without an untile.
//
// With vertex colours (resolve_pallas.py's vertex_colors=True branch) the
// table is (T, 40) and the same kernels run their 40-wide instance
// (trident_resolve_vc, trident_resolve_tiled_vc): ten 16-byte loads per
// row instead of eight, and the colour factor's rgb times the interpolated
// vertex colour; nothing else differs.
//
// Bound on the card: bytes — the 4-byte id and 64 B of output per pixel,
// plus one 128-byte (160-byte with vertex colours) record row per distinct
// winner (neighbouring pixels mostly share a winner).
//
// Design: one thread per pixel, no pair sweep, no one-hot select and no
// split-bf16 planes (those existed for the TPU's matrix unit). The winner's
// record is its row of the row-major (T, 32) table, read with eight 16-byte
// loads (resolve_common.cuh, the body shared with the fused kernel): a warp
// touches one 128-byte line per distinct winner (two with the 160-byte
// rows of the (T, 40) table). A CTA covers 32x8 pixels,
// one warp per 32-pixel row segment, so vertical neighbours that share a
// winner share the CTA and its L1.
//   (H, W): each warp's 32 pixels x 16 channels are 2 KB of contiguous
//   output. The warp stages them in shared memory (a float4 per 4 channels,
//   XOR-swizzled so neither the per-pixel writes nor the flat reads conflict
//   on a bank) and stores them as consecutive float4s by consecutive lanes:
//   each store instruction is one 512-byte run, four full 128-byte lines
//   where W is even.
//   Tiled: the block's 8 rows of one tile; each channel plane is one
//   coalesced 128-byte store per warp.
// Uncovered pixels get zeros; ragged frames (W not a multiple of 32, H not
// a multiple of 8) mask the lanes and warps outside the frame.

#include "resolve_common.cuh"

namespace {

using namespace trident;

constexpr int kBlockW = 32;            // pixels of a warp's row segment
constexpr int kBlockH = 8;             // rows of a CTA, one warp each
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kQuads = kChannels / 4;  // float4s per pixel
constexpr int kTile = 32;
constexpr int kTilePx = kTile * kTile;

// staging slot of pixel p's float4 q: pixel-major, q XOR-swizzled by bits
// 1-2 of p, so that 8 lanes writing one q of 8 pixels, or reading 8
// consecutive float4s (2 pixels), hit 8 distinct 4-bank groups
__device__ __forceinline__ int stage_slot(int p, int q) {
  return p * kQuads + (q ^ ((p >> 1) & (kQuads - 1)));
}

// (H, W) ids → (H, W, 16) attributes, the block's part; grid
// (ceil(W/32), ceil(H/8)); `stage` is the block's shared staging buffer
template <int kWidth>
__device__ __forceinline__ void resolve_block(
    const int* __restrict__ tri, const float* __restrict__ records,
    int width, int height, float* __restrict__ out,
    float4 (&stage)[kBlockH][kBlockW * kQuads]) {
  const int lane = threadIdx.x % kBlockW, warp = threadIdx.x / kBlockW;
  const int y = blockIdx.y * kBlockH + warp;
  if (y >= height) return;             // warp-uniform: only warp syncs follow
  const int x0 = blockIdx.x * kBlockW;
  const int n = min(kBlockW, width - x0);   // pixels of this row segment
  const size_t p0 = static_cast<size_t>(y) * width + x0;
  float4* s = stage[warp];
  if (lane < n) {
    float a[kChannels];
    resolve_pixel<kWidth>(record_row<kWidth>(records, tri[p0 + lane]),
                          static_cast<float>(x0 + lane) + 0.5f,
                          static_cast<float>(y) + 0.5f, a);
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      s[stage_slot(lane, q)] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
  __syncwarp();
  float4* o = reinterpret_cast<float4*>(out) + p0 * kQuads;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int f = k * kBlockW + lane;  // float4 f of the segment's output
    const int p = f / kQuads;
    if (p < n) o[f] = s[stage_slot(p, f % kQuads)];
  }
}

// tile-layout ids (n_tiles, 1024) → (n_tiles, 16, 1024), the block's part;
// block b covers rows 8(b % 4) .. 8(b % 4) + 7 of tile b / 4, one warp per
// row
template <int kWidth>
__device__ __forceinline__ void resolve_tiled_block(
    const int* __restrict__ tri, const float* __restrict__ records, int ntx,
    float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int tile = p / kTilePx, r = p % kTilePx;
  float a[kChannels];
  resolve_pixel<kWidth>(
      record_row<kWidth>(records, tri[p]),
      static_cast<float>(tile % ntx * kTile + r % kTile) + 0.5f,
      static_cast<float>(tile / ntx * kTile + r / kTile) + 0.5f, a);
  float* o = out + static_cast<size_t>(tile) * kChannels * kTilePx + r;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) o[c * kTilePx] = a[c];
}

// one kernel per layout and record width, each named for the profiler's
// records (tools_dev/timing.py KERNEL_RECORDS)
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ tri, const float* __restrict__ records,
               int width, int height, float* __restrict__ out) {
  __shared__ float4 stage[kBlockH][kBlockW * kQuads];
  resolve_block<kRecWidth>(tri, records, width, height, out, stage);
}

__global__ void __launch_bounds__(kThreads)
resolve_vc_kernel(const int* __restrict__ tri,
                  const float* __restrict__ records, int width, int height,
                  float* __restrict__ out) {
  __shared__ float4 stage[kBlockH][kBlockW * kQuads];
  resolve_block<kRecWidthVColor>(tri, records, width, height, out, stage);
}

__global__ void __launch_bounds__(kThreads)
resolve_tiled_kernel(const int* __restrict__ tri,
                     const float* __restrict__ records, int ntx,
                     float* __restrict__ out) {
  resolve_tiled_block<kRecWidth>(tri, records, ntx, out);
}

__global__ void __launch_bounds__(kThreads)
resolve_tiled_vc_kernel(const int* __restrict__ tri,
                        const float* __restrict__ records, int ntx,
                        float* __restrict__ out) {
  resolve_tiled_block<kRecWidthVColor>(tri, records, ntx, out);
}

using ResolveKernel = void (*)(const int*, const float*, int, int, float*);
using TiledKernel = void (*)(const int*, const float*, int, float*);

int launch_resolve(ResolveKernel kernel, const int* tri, const float* records,
                   int width, int height, float* out, cudaStream_t stream) {
  if (width > 0 && height > 0) {
    const dim3 grid((width + kBlockW - 1) / kBlockW,
                    (height + kBlockH - 1) / kBlockH);
    kernel<<<grid, kThreads, 0, stream>>>(tri, records, width, height, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_resolve_tiled(TiledKernel kernel, const int* tri,
                         const float* records, int ntx, int n_tiles,
                         float* out, cudaStream_t stream) {
  if (n_tiles > 0) {
    kernel<<<n_tiles * (kTilePx / kThreads), kThreads, 0, stream>>>(
        tri, records, ntx, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int trident_resolve(const int* tri, const float* records,
                               int width, int height, float* out,
                               cudaStream_t stream) {
  return launch_resolve(resolve_kernel, tri, records, width, height, out,
                        stream);
}

extern "C" int trident_resolve_vc(const int* tri, const float* records,
                                  int width, int height, float* out,
                                  cudaStream_t stream) {
  return launch_resolve(resolve_vc_kernel, tri, records, width, height, out,
                        stream);
}

extern "C" int trident_resolve_tiled(const int* tri, const float* records,
                                     int ntx, int n_tiles, float* out,
                                     cudaStream_t stream) {
  return launch_resolve_tiled(resolve_tiled_kernel, tri, records, ntx,
                              n_tiles, out, stream);
}

extern "C" int trident_resolve_tiled_vc(const int* tri, const float* records,
                                        int ntx, int n_tiles, float* out,
                                        cudaStream_t stream) {
  return launch_resolve_tiled(resolve_tiled_vc_kernel, tri, records, ntx,
                              n_tiles, out, stream);
}
