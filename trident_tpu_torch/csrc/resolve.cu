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
// Bound on the card: bytes — 64 B of output per pixel plus one scattered
// column read per record row of the winner (neighbouring pixels mostly
// share a winner, so a warp touches few distinct columns).
//
// Design: one thread per pixel. The winner's record is a direct load
// records[:, tri_id] from the (RW, T) column table; there is no pair sweep,
// no one-hot select and no split-bf16 planes (those existed for the TPU's
// matrix unit). The per-pixel body is resolve_common.cuh's, shared with the
// fused kernel. The template picks the pixel mapping and output layout:
// row-major pixels with four float4 stores of channel-last output, or tile
// pixels (tile, r) with one coalesced store per channel plane. Uncovered
// pixels get zeros.

#include "resolve_common.cuh"

namespace {

using namespace trident;

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kTilePx = kTile * kTile;

// kTiled: tri and out are (n_tiles, 1024) and (n_tiles, 16, 1024) in tile
// layout and `width` is the tile-row count ntx; else (H, W) and (H, W, 16)
template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ tri, const float* __restrict__ records,
               long long stride, int width, int n_px, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  float pxf, pyf;
  if (kTiled) {
    const int tile = p / kTilePx, r = p % kTilePx;
    pxf = static_cast<float>(tile % width * kTile + r % kTile) + 0.5f;
    pyf = static_cast<float>(tile / width * kTile + r / kTile) + 0.5f;
  } else {
    pxf = static_cast<float>(p % width) + 0.5f;
    pyf = static_cast<float>(p / width) + 0.5f;
  }
  float a[kChannels];
  resolve_pixel(records, stride, tri[p], pxf, pyf, a);
  if (kTiled) {
    float* o = out + static_cast<size_t>(p / kTilePx) * kChannels * kTilePx +
               p % kTilePx;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o[c * kTilePx] = a[c];
  } else {
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(p) * kChannels);
    o[0] = make_float4(a[0], a[1], a[2], a[3]);
    o[1] = make_float4(a[4], a[5], a[6], a[7]);
    o[2] = make_float4(a[8], a[9], a[10], a[11]);
    o[3] = make_float4(a[12], a[13], a[14], a[15]);
  }
}

template <bool kTiled>
int launch(const int* tri, const float* records, long long stride, int width,
           int n_px, float* out, cudaStream_t stream) {
  if (n_px > 0) {
    const int blocks = (n_px + kThreads - 1) / kThreads;
    resolve_kernel<kTiled><<<blocks, kThreads, 0, stream>>>(
        tri, records, stride, width, n_px, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int trident_resolve(const int* tri, const float* records,
                               long long stride, int width, int n_px,
                               float* out, cudaStream_t stream) {
  return launch<false>(tri, records, stride, width, n_px, out, stream);
}

extern "C" int trident_resolve_tiled(const int* tri, const float* records,
                                     long long stride, int ntx, int n_tiles,
                                     float* out, cudaStream_t stream) {
  return launch<true>(tri, records, stride, ntx, n_tiles * kTilePx, out,
                      stream);
}
