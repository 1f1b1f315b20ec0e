// Shadow-map taps: the raw f32 bits of the (S, S) light-space depth map at
// one tap (hard shadows) or the four taps of the 2x2 PCF footprint per
// pixel, as (H, W, ntaps) i32; a tap whose index lies outside the map (the
// caller's -1 for pixels outside the light frustum) reads 0.
//
// Replaces: trident_tpu/ops/shadow_pallas.py _taps_kernel (reached via
// shadow_tap_bits, pallas_call at shadow_pallas.py:176).
//
// Bound on the card: bytes. Per pixel it reads 2 (hard) or 4 (PCF) i32
// indices and writes 1 or 4 i32 bits, 12 or 32 bytes, plus one read of the
// map (4 MB at S = 1024), which stays in the 50 MB L2.
//
// Design: the TPU kernel has no gather, so it splits the map into four
// bf16 byte planes and selects each tap with one-hot MXU products over
// block windows. On Hopper a gather is a plain load: one thread per pixel
// loads its indices (coalesced), reads each tap straight from the map
// viewed as i32 (neighbouring pixels hit neighbouring texels, so the
// loads coalesce in L2), and stores its ntaps words at once (one 16-byte
// store for PCF). The bits are returned untouched, so the compare and
// the PCF lerp stay in ops/shadow.py, shared with the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int tap(const int* __restrict__ map, int s, int y,
                                   int x) {
  return (y >= 0 && y < s && x >= 0 && x < s)
             ? __ldg(map + static_cast<size_t>(y) * s + x)
             : 0;
}

__global__ void __launch_bounds__(kThreads)
taps1_kernel(const int* __restrict__ map, int s, const int* __restrict__ y0,
             const int* __restrict__ x0, int n, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = tap(map, s, y0[i], x0[i]);
}

__global__ void __launch_bounds__(kThreads)
taps4_kernel(const int* __restrict__ map, int s, const int* __restrict__ y0,
             const int* __restrict__ x0, const int* __restrict__ y1,
             const int* __restrict__ x1, int n, int4* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ya = y0[i], xa = x0[i], yb = y1[i], xb = x1[i];
  // taps ordered (y0,x0), (y0,x1), (y1,x0), (y1,x1), as the TPU kernel's
  out[i] = make_int4(tap(map, s, ya, xa), tap(map, s, ya, xb),
                     tap(map, s, yb, xa), tap(map, s, yb, xb));
}

}  // namespace

// y1/x1 null: one tap per pixel into out (n,); else four into out (n, 4).
extern "C" int trident_shadow_taps(const int* map_bits, int s, const int* y0,
                                   const int* x0, const int* y1,
                                   const int* x1, int n, int* out,
                                   cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    if (y1 == nullptr) {
      taps1_kernel<<<blocks, kThreads, 0, stream>>>(map_bits, s, y0, x0, n,
                                                    out);
    } else {
      taps4_kernel<<<blocks, kThreads, 0, stream>>>(
          map_bits, s, y0, x0, y1, x1, n, reinterpret_cast<int4*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
