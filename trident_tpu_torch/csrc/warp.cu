// Warp kernel: fetch the 12 uint8 history channels at each half-res pixel's
// reprojected block (by, bx) for the temporal upscaler.
//
// Replaces: trident_tpu/ops/warp_pallas.py _warp_kernel (reached via
// warp_fetch_mxu, pallas_call at warp_pallas.py:150).
//
// Bound on the card: bytes. Per pixel 8 bytes of indices in, at most 12
// bytes of history, and 48 bytes of f32 out; no arithmetic beyond the
// byte-to-float conversion. The (h, w, 12) history (6.2 MB at 960x540)
// stays resident in the 50 MB L2.
//
// Design: the TPU kernel's channel planes, 32-row bands, per-block scalar
// prefetch and windowed one-hot MXU dots exist only because Mosaic has no
// vector gather. Here one thread per pixel reads its block's 12 bytes at
// (by * w + bx) * 12, a 4-byte aligned offset, as three 32-bit __ldg loads,
// unpacks them and writes the 12 byte values as three float4 stores. A
// pixel with by < 0 or bx < 0 (the caller's "skip") gets zeros; other
// indices are clamped into the history, as the plain version in ops/warp.py
// clamps them, so the two agree bit for bit. There is no band limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 unpack(unsigned v) {
  return make_float4(static_cast<float>(v & 0xFFu),
                     static_cast<float>((v >> 8) & 0xFFu),
                     static_cast<float>((v >> 16) & 0xFFu),
                     static_cast<float>((v >> 24) & 0xFFu));
}

__global__ void __launch_bounds__(kThreads)
warp_kernel(const unsigned* __restrict__ hist, int hist_h, int hist_w,
            const int* __restrict__ by, const int* __restrict__ bx, int n_px,
            float4* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  const int y = by[p], x = bx[p];
  float4* o = out + 3 * p;
  if (y < 0 || x < 0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    o[0] = z;
    o[1] = z;
    o[2] = z;
    return;
  }
  const int yc = min(y, hist_h - 1), xc = min(x, hist_w - 1);
  const unsigned* src = hist + 3 * (yc * hist_w + xc);
  o[0] = unpack(__ldg(src));
  o[1] = unpack(__ldg(src + 1));
  o[2] = unpack(__ldg(src + 2));
}

}  // namespace

extern "C" int trident_warp(const void* hist, int hist_h, int hist_w,
                            const int* by, const int* bx, int n_px, float* out,
                            cudaStream_t stream) {
  if (n_px > 0) {
    const int blocks = (n_px + kThreads - 1) / kThreads;
    warp_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const unsigned*>(hist), hist_h, hist_w, by, bx, n_px,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
