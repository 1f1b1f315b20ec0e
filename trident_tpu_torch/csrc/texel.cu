// Texel kernel: bilinear RGBA8 fetch, one 2x2 texel quad per pixel.
//
// Replaces: trident_tpu/ops/texel_pallas.py _texel_kernel, in both of its
// call sites: sample_bilinear_mxu (pallas_call at texel_pallas.py:188; (H, W)
// pixels → (H, W, 4), trident_texel) and sample_bilinear_mxu_tiled
// (texel_pallas.py:216, pallas_call :231; the raster's tile layout
// (n_tiles, 1024) → (n_tiles, 4, 1024), trident_texel_planar, used by the
// `tiled_shade` knob).
//
// Bound on the card: bytes — one scattered 16-byte quad read and 16 bytes
// of output per pixel; the quad table (0.39 MB for the bench scene's 128²
// checker, 24,320 quads) stays resident in the 50 MB L2.
//
// Design: one thread per pixel reads quads[idx] as ONE 16-byte load from
// the (Q, 4) u32 table (no bf16 channel table, no one-hot window, and no
// table-size cap: the TPU kernel's cap only bounded its VMEM residency),
// unpacks the four RGBA8 texels and lerps in shading._bilinear_flat's
// expression order (shading.py:219-224). idx < 0 (uncovered) gives 0.
// The planar instance computes the same values and writes them as four
// coalesced channel planes of its tile row instead of one float4 a pixel.
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

// kPlanar: out is (rows, 4, npx) for pixels (rows, npx); else (n_px, 4)
template <bool kPlanar>
__global__ void __launch_bounds__(kThreads)
texel_kernel(const int* __restrict__ idx, const float* __restrict__ fx,
             const float* __restrict__ fy, const uint4* __restrict__ quads,
             int n_px, int npx, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  const int i = idx[p];
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= 0) {
    const uint4 q = __ldg(quads + i);
    const float4 t00 = unpack(q.x), t10 = unpack(q.y);
    const float4 t01 = unpack(q.z), t11 = unpack(q.w);
    const float f = fx[p], g = fy[p];
    const float s = 1.0f / 255.0f;
    r.x = (lerp2(t00.x, t10.x, f) * (1.0f - g) + lerp2(t01.x, t11.x, f) * g) * s;
    r.y = (lerp2(t00.y, t10.y, f) * (1.0f - g) + lerp2(t01.y, t11.y, f) * g) * s;
    r.z = (lerp2(t00.z, t10.z, f) * (1.0f - g) + lerp2(t01.z, t11.z, f) * g) * s;
    r.w = (lerp2(t00.w, t10.w, f) * (1.0f - g) + lerp2(t01.w, t11.w, f) * g) * s;
  }
  if (kPlanar) {
    float* o = out + static_cast<size_t>(p / npx) * 4 * npx + p % npx;
    o[0] = r.x;
    o[npx] = r.y;
    o[2 * npx] = r.z;
    o[3 * npx] = r.w;
  } else {
    reinterpret_cast<float4*>(out)[p] = r;
  }
}

template <bool kPlanar>
int launch(const int* idx, const float* fx, const float* fy,
           const void* quads, int n_px, int npx, float* out,
           cudaStream_t stream) {
  if (n_px > 0) {
    const int blocks = (n_px + kThreads - 1) / kThreads;
    texel_kernel<kPlanar><<<blocks, kThreads, 0, stream>>>(
        idx, fx, fy, static_cast<const uint4*>(quads), n_px, npx, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int trident_texel(const int* idx, const float* fx, const float* fy,
                             const void* quads, int n_px, float* out,
                             cudaStream_t stream) {
  return launch<false>(idx, fx, fy, quads, n_px, 1, out, stream);
}

extern "C" int trident_texel_planar(const int* idx, const float* fx,
                                    const float* fy, const void* quads,
                                    int rows, int npx, float* out,
                                    cudaStream_t stream) {
  return launch<true>(idx, fx, fy, quads, rows * npx, npx, out, stream);
}
