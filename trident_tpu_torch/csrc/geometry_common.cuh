// The per-triangle tail shared by the forward route's two geometry kernels:
// the skinned pair's triangle kernel (csrc/skinned_geometry.cu) and the
// rigid corner-stage kernel (csrc/rigid_geometry.cu). What the two fetch
// differs (packed vertex rows gathered by index against a planar corner
// table and a draw row); from a triangle's three corners on, both compute
// what ops/vertex.py::planar_setup_cols and ops/planes.py::
// build_resolve_cols_planar compute, the one Python implementation of these
// numerics, so the tail is one implementation here too.
//
// From the corners' viewport-scaled sx, sy, clip z and w, world normals,
// UVs and colours: the edge functions e_i = cross(vertex_j, vertex_k) over
// (sx, sy, w), det and the front test, the NDC bbox (IEEE division by the
// 1e-8-safe w; a triangle with a corner at w <= 1e-6 takes the full
// screen), `valid`; then the record row: the planes (a0·e0 + a1·e1) + a2·e2,
// g1 = (e0 + e1) + e2, the 12 shading consts, with kWidth 40 the colour
// planes. The setup goes out as planar (15, T) columns (9 edge
// coefficients, 3 clip z, 3 clip w), coalesced; the warp's 32 record rows
// are staged in shared memory and stored as contiguous 512-byte runs
// (stored a row a thread, the 40-wide records took twice as long: 0.403
// against 0.207 ms at the crowd's 2,097,152 triangles on an H100).
//
// -fmad=false keeps every product and sum separately rounded, as PyTorch's
// eager ops compute them; min / max / clamp propagate NaN as PyTorch's do.

#pragma once

#include <cuda_runtime.h>

namespace trident {

constexpr int kGeometryThreads = 256;

// torch.minimum / maximum / clamp / clamp_min: NaN in, NaN out
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Triangle t's setup columns, bbox, `valid` (tri_valid[t] && front &&
// on screen) and record row (kWidth 32: g1 gNx gNy gNz gU gV (18) | 12
// consts | 0 0; kWidth 40: the same, then gR gG gB (9) and one zero). Every
// lane of the warp calls it: a lane past n_tri (active false) carries the
// last triangle again, stores nothing of its own and takes part in the
// staged record store. `draw_consts()` returns the triangle's 12 shading
// consts; it runs after the setup is stored.
template <int kWidth, typename DrawConsts>
__device__ __forceinline__ void store_triangle(
    int t, int t_lane, bool active, int n_tri, int width, int height,
    const float (&sx)[3], const float (&sy)[3], const float (&zs)[3],
    const float (&ws)[3], const float (&nrm)[3][3], const float (&uv)[3][2],
    const float (&col)[3][3], const unsigned char* __restrict__ tri_valid,
    DrawConsts draw_consts, float* __restrict__ setup,
    int4* __restrict__ bbox, unsigned char* __restrict__ valid,
    float4* __restrict__ records) {
  // e_i = cross(vertex_j, vertex_k) over (sx, sy, w): (j, k) = (1, 2),
  // (2, 0), (0, 1) (ops/vertex.py::planar_setup_cols)
  float e[3][3];
  #pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    e[i][0] = sy[j] * ws[k] - ws[j] * sy[k];
    e[i][1] = ws[j] * sx[k] - sx[j] * ws[k];
    e[i][2] = sx[j] * sy[k] - sy[j] * sx[k];
  }
  const float det = (sx[0] * e[0][0] + sy[0] * e[0][1]) + ws[0] * e[0][2];
  const bool front = det > 1e-12f;
  float px[3], py[3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sw = fabsf(ws[k]) < 1e-8f ? 1e-8f : ws[k];
    px[k] = sx[k] / sw;
    py[k] = sy[k] / sw;
  }
  const bool behind = ws[0] <= 1e-6f || ws[1] <= 1e-6f || ws[2] <= 1e-6f;
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  const float fx0 = behind ? 0.0f : floorf(tmin(tmin(px[0], px[1]), px[2]));
  const float fy0 = behind ? 0.0f : floorf(tmin(tmin(py[0], py[1]), py[2]));
  const float fx1 = behind ? fw : ceilf(tmax(tmax(px[0], px[1]), px[2])) + 1.0f;
  const float fy1 = behind ? fh : ceilf(tmax(tmax(py[0], py[1]), py[2])) + 1.0f;
  const int x0 = static_cast<int>(tclamp(fx0, 0.0f, fw));
  const int y0 = static_cast<int>(tclamp(fy0, 0.0f, fh));
  const int x1 = static_cast<int>(tclamp(fx1, 0.0f, fw));
  const int y1 = static_cast<int>(tclamp(fy1, 0.0f, fh));
  const bool on_screen = x1 > x0 && y1 > y0;

  if (active) {
    #pragma unroll
    for (int i = 0; i < 3; ++i) {
      #pragma unroll
      for (int c = 0; c < 3; ++c)
        setup[static_cast<size_t>(3 * i + c) * n_tri + t] = e[i][c];
    }
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      setup[static_cast<size_t>(9 + k) * n_tri + t] = zs[k];
      setup[static_cast<size_t>(12 + k) * n_tri + t] = ws[k];
    }
    bbox[t] = make_int4(x0, y0, x1, y1);
    valid[t] = (__ldg(tri_valid + t) != 0 && front && on_screen) ? 1 : 0;
  }

  float rec[kWidth];
  #pragma unroll
  for (int c = 0; c < 3; ++c) rec[c] = (e[0][c] + e[1][c]) + e[2][c];
  #pragma unroll
  for (int a = 0; a < 3; ++a) {
    #pragma unroll
    for (int c = 0; c < 3; ++c)
      rec[3 + 3 * a + c] = (nrm[0][a] * e[0][c] + nrm[1][a] * e[1][c])
                           + nrm[2][a] * e[2][c];
  }
  #pragma unroll
  for (int a = 0; a < 2; ++a) {
    #pragma unroll
    for (int c = 0; c < 3; ++c)
      rec[12 + 3 * a + c] = (uv[0][a] * e[0][c] + uv[1][a] * e[1][c])
                            + uv[2][a] * e[2][c];
  }
  const float* dc = draw_consts();
  #pragma unroll
  for (int j = 0; j < 12; ++j) rec[18 + j] = __ldg(dc + j);
  if constexpr (kWidth == 40) {
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      #pragma unroll
      for (int c = 0; c < 3; ++c)
        rec[30 + 3 * a + c] = (col[0][a] * e[0][c] + col[1][a] * e[1][c])
                              + col[2][a] * e[2][c];
    }
    rec[39] = 0.0f;
  } else {
    rec[30] = 0.0f;
    rec[31] = 0.0f;
  }
  // the warp's 32 record rows through shared memory (the note above)
  constexpr int kRow = kWidth / 4;                   // float4s per record
  __shared__ float4 stage[kGeometryThreads / 32][32 * kRow];
  const int lane = threadIdx.x & 31;
  float4* warp_rows = stage[threadIdx.x >> 5];
  #pragma unroll
  for (int q = 0; q < kRow; ++q)
    warp_rows[lane * kRow + q] = make_float4(rec[4 * q], rec[4 * q + 1],
                                             rec[4 * q + 2], rec[4 * q + 3]);
  __syncwarp();
  const size_t first = static_cast<size_t>(t_lane - lane) * kRow;
  const size_t end = static_cast<size_t>(n_tri) * kRow;
  #pragma unroll
  for (int q = 0; q < kRow; ++q) {
    const size_t i = first + lane + 32 * q;
    if (i < end) records[i] = warp_rows[lane + 32 * q];
  }
}

}  // namespace trident
