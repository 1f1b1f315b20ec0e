// Texel kernel: bilinear RGBA8 fetch, one 2x2 texel quad per pixel.
//
// Replaces: trident_tpu/ops/texel_pallas.py _texel_kernel (reached via
// sample_bilinear_mxu, pallas_call at texel_pallas.py:188).
//
// Bound on the card: bytes — one scattered 16-byte quad read and one
// 16-byte store per pixel; the quad table (0.39 MB for the bench scene's
// 128² checker, 24,320 quads) stays resident in the 50 MB L2.
//
// Design: one thread per pixel reads quads[idx] as ONE 16-byte load from
// the (Q, 4) u32 table (no bf16 channel table, no one-hot window, and no
// table-size cap: the TPU kernel's cap only bounded its VMEM residency),
// unpacks the four RGBA8 texels and lerps in shading._bilinear_flat's
// expression order (shading.py:219-224). idx < 0 (uncovered) gives 0.
// -fmad=false keeps every product and sum rounded like the plain version
// in ops/texel.py, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 unpack(unsigned v) {
  return make_float4(static_cast<float>(v & 0xFFu),
                     static_cast<float>((v >> 8) & 0xFFu),
                     static_cast<float>((v >> 16) & 0xFFu),
                     static_cast<float>((v >> 24) & 0xFFu));
}

__device__ __forceinline__ float lerp2(float a, float b, float f) {
  return a * (1.0f - f) + b * f;
}

__global__ void __launch_bounds__(kThreads)
texel_kernel(const int* __restrict__ idx, const float* __restrict__ fx,
             const float* __restrict__ fy, const uint4* __restrict__ quads,
             int n_px, float4* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  const int i = idx[p];
  if (i < 0) {
    out[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const uint4 q = __ldg(quads + i);
  const float4 t00 = unpack(q.x), t10 = unpack(q.y);
  const float4 t01 = unpack(q.z), t11 = unpack(q.w);
  const float f = fx[p], g = fy[p];
  const float s = 1.0f / 255.0f;
  float4 r;
  r.x = (lerp2(t00.x, t10.x, f) * (1.0f - g) + lerp2(t01.x, t11.x, f) * g) * s;
  r.y = (lerp2(t00.y, t10.y, f) * (1.0f - g) + lerp2(t01.y, t11.y, f) * g) * s;
  r.z = (lerp2(t00.z, t10.z, f) * (1.0f - g) + lerp2(t01.z, t11.z, f) * g) * s;
  r.w = (lerp2(t00.w, t10.w, f) * (1.0f - g) + lerp2(t01.w, t11.w, f) * g) * s;
  out[p] = r;
}

}  // namespace

extern "C" int trident_texel(const int* idx, const float* fx, const float* fy,
                             const void* quads, int n_px, float* out,
                             cudaStream_t stream) {
  if (n_px > 0) {
    const int blocks = (n_px + kThreads - 1) / kThreads;
    texel_kernel<<<blocks, kThreads, 0, stream>>>(
        idx, fx, fy, static_cast<const uint4*>(quads), n_px,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
