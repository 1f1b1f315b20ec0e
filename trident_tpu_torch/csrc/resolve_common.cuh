// The resolve pass's per-pixel body, shared by the resolve kernel (both of
// its layouts, csrc/resolve.cu) and the fused visibility + resolve kernel
// (csrc/visibility_resolve.cu), so all of them evaluate the interpolants in
// one expression order: resolve_pallas._eval_interpolants's, with
// -fmad=false rounding every op like the plain version in ops/resolve.py.

#pragma once

#include <cuda_runtime.h>

namespace trident {

// resolve-record rows (ops/planes.py RR_*)
constexpr int kG1 = 0, kNX = 3, kNY = 6, kNZ = 9, kU = 12, kV = 15;
constexpr int kCF = 18, kMet = 22, kRough = 23, kAmb = 24;
constexpr int kTsx = 26, kTsy = 27, kBase8 = 28;
constexpr int kChannels = 16;

// NaN-propagating max, as torch.maximum / jnp.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The 16 shading channels of winner `tid` at pixel centre (pxf, pyf), from
// column tid of the (RW, T) record table (row stride `stride` floats);
// zeros where tid < 0 (uncovered).
__device__ __forceinline__ void resolve_pixel(const float* __restrict__ records,
                                              long long stride, int tid,
                                              float pxf, float pyf,
                                              float (&o)[kChannels]) {
  if (tid < 0) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o[c] = 0.0f;
    return;
  }
  const float* rc = records + tid;
  auto row = [&](int j) { return __ldg(rc + j * stride); };
  auto plane = [&](int j) { return row(j) * pxf + row(j + 1) * pyf + row(j + 2); };

  const float denom = plane(kG1);
  const float inv = 1.0f / (fabsf(denom) < 1e-20f ? 1e-20f : denom);
  const float nx = plane(kNX) * inv;
  const float ny = plane(kNY) * inv;
  const float nz = plane(kNZ) * inv;
  const float u = plane(kU) * inv;
  const float v = plane(kV) * inv;

  const float g1x = row(kG1), g1y = row(kG1 + 1);
  const float du_dx = (row(kU) - u * g1x) * inv;
  const float du_dy = (row(kU + 1) - u * g1y) * inv;
  const float dv_dx = (row(kV) - v * g1x) * inv;
  const float dv_dy = (row(kV + 1) - v * g1y) * inv;
  const float tsx = row(kTsx), tsy = row(kTsy);
  const float ax = du_dx * tsx, bx = dv_dx * tsy;
  const float ay = du_dy * tsx, by = dv_dy * tsy;
  const float rho = max_nan(ax * ax + bx * bx, ay * ay + by * by);
  const float mip = 0.5f * log2f(max_nan(rho, 1e-12f));

  o[0] = nx; o[1] = ny; o[2] = nz; o[3] = u;
  o[4] = v; o[5] = mip; o[6] = row(kCF); o[7] = row(kCF + 1);
  o[8] = row(kCF + 2); o[9] = row(kCF + 3); o[10] = row(kMet);
  o[11] = row(kRough); o[12] = row(kAmb); o[13] = row(kBase8);
  o[14] = tsx; o[15] = tsy;
}

}  // namespace trident
