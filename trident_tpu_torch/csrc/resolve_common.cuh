// The resolve pass's per-pixel body, shared by the resolve kernel (both of
// its layouts, csrc/resolve.cu) and the fused visibility + resolve kernel
// (csrc/visibility_resolve.cu), so all of them evaluate the interpolants in
// one expression order: resolve_pallas._eval_interpolants's, with
// -fmad=false rounding every op like the plain version in ops/resolve.py.
//
// The record table is row-major (T, kWidth) f32 (ops/planes.py
// build_resolve_cols_planar): kWidth = kRecWidth (32) is one 128-byte line
// per triangle, read with eight 16-byte loads; kWidth = kRecWidthVColor
// (40) adds the three vertex-colour planes (a 160-byte row, ten 16-byte
// loads), which multiply the colour factor's rgb (resolve_pallas.py
// _eval_interpolants:231-234). Lanes of a warp that share a winner share
// the row. Both widths are instances of one template: the 32-wide one is
// the code of the table without colours, unchanged.
//
// kBf16 (the `resolve_prec="bf16"` knob) rounds each loaded record word to
// bf16, nearest-even, before the interpolants are evaluated: on the TPU
// that mode contracts the f32 records against the exact one-hot winner
// select in one raw bf16 pass (resolve_pallas.py _winner_select), so each
// pixel sees bf16(record) of its winner. Here that is the load plus a
// round; the plain version rounds the whole table once (ops/resolve.py
// bf16_records), which commutes with the select. The exact instances are
// kBf16 = false and compile to the code they had before.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trident {

// resolve-record columns (ops/planes.py RR_*)
constexpr int kG1 = 0, kNX = 3, kNY = 6, kNZ = 9, kU = 12, kV = 15;
constexpr int kCF = 18, kMet = 22, kRough = 23, kAmb = 24;
constexpr int kTsx = 26, kTsy = 27, kBase8 = 28;
constexpr int kCol = 30;               // vertex-colour planes (RR_COL)
constexpr int kRecWidth = 32;          // floats per record row (RR_WIDTH)
constexpr int kRecWidthVColor = 40;    // with vertex colours (RR_WIDTH_VCOLOR)
constexpr int kChannels = 16;

// NaN-propagating max, as torch.maximum / jnp.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The record row of winner `tid` in the (T, kWidth) table, or nullptr
// where tid < 0 (uncovered). The table's base is 16-byte aligned (the
// wrappers check it), so each row is kWidth / 4 aligned float4s.
template <int kWidth>
__device__ __forceinline__ const float4* record_row(
    const float* __restrict__ records, int tid) {
  static_assert(kWidth == kRecWidth || kWidth == kRecWidthVColor,
                "record rows are 32 or 40 floats");
  return tid < 0 ? nullptr
                 : reinterpret_cast<const float4*>(records) +
                       static_cast<size_t>(tid) * (kWidth / 4);
}

// round-to-nearest-even to bf16 and back (the kBf16 instances)
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The 16 shading channels at pixel centre (pxf, pyf) of the winner whose
// record row is `row` (record_row<kWidth>); zeros where row is nullptr.
// kBf16: every record word rounded to bf16 first.
template <int kWidth, bool kBf16 = false>
__device__ __forceinline__ void resolve_pixel(const float4* __restrict__ row,
                                              float pxf, float pyf,
                                              float (&o)[kChannels]) {
  if (row == nullptr) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o[c] = 0.0f;
    return;
  }
  float rc[kWidth];
#pragma unroll
  for (int q = 0; q < kWidth / 4; ++q) {
    float4 v = __ldg(row + q);
    if constexpr (kBf16) {
      v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                      bf16_round(v.w));
    }
    rc[4 * q] = v.x;
    rc[4 * q + 1] = v.y;
    rc[4 * q + 2] = v.z;
    rc[4 * q + 3] = v.w;
  }
  auto plane = [&](int j) { return rc[j] * pxf + rc[j + 1] * pyf + rc[j + 2]; };

  const float denom = plane(kG1);
  const float inv = 1.0f / (fabsf(denom) < 1e-20f ? 1e-20f : denom);
  const float nx = plane(kNX) * inv;
  const float ny = plane(kNY) * inv;
  const float nz = plane(kNZ) * inv;
  const float u = plane(kU) * inv;
  const float v = plane(kV) * inv;

  const float g1x = rc[kG1], g1y = rc[kG1 + 1];
  const float du_dx = (rc[kU] - u * g1x) * inv;
  const float du_dy = (rc[kU + 1] - u * g1y) * inv;
  const float dv_dx = (rc[kV] - v * g1x) * inv;
  const float dv_dy = (rc[kV + 1] - v * g1y) * inv;
  const float tsx = rc[kTsx], tsy = rc[kTsy];
  const float ax = du_dx * tsx, bx = dv_dx * tsy;
  const float ay = du_dy * tsx, by = dv_dy * tsy;
  const float rho = max_nan(ax * ax + bx * bx, ay * ay + by * by);
  const float mip = 0.5f * log2f(max_nan(rho, 1e-12f));

  float cf_r = rc[kCF], cf_g = rc[kCF + 1], cf_b = rc[kCF + 2];
  if constexpr (kWidth == kRecWidthVColor) {
    // (cf · colour plane) · inv, left to right as the reference multiplies
    cf_r = (cf_r * plane(kCol)) * inv;
    cf_g = (cf_g * plane(kCol + 3)) * inv;
    cf_b = (cf_b * plane(kCol + 6)) * inv;
  }

  o[0] = nx; o[1] = ny; o[2] = nz; o[3] = u;
  o[4] = v; o[5] = mip; o[6] = cf_r; o[7] = cf_g;
  o[8] = cf_b; o[9] = rc[kCF + 3]; o[10] = rc[kMet];
  o[11] = rc[kRough]; o[12] = rc[kAmb]; o[13] = rc[kBase8];
  o[14] = tsx; o[15] = tsy;
}

}  // namespace trident
