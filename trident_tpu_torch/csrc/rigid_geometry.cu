// Rigid geometry: the forward route's corner-path geometry as one kernel.
//
// Replaces no Pallas kernel: the JAX package's corner stage
// (trident_tpu/ops/corner.py::corner_stage), its triangle setup
// (ops/vertex.py) and resolve records (ops/planes.py) are plain jnp. The
// port ran them as plain PyTorch (ops/rigid.py::rigid_geometry_plain): the
// (48, T) broadcast of the draw rows, some 60 (T,) intermediates, a stack
// of the 30 record columns and a transposing copy, each a pass over memory.
// This kernel computes the same values with no intermediate.
//
// Bound on the card: bytes. Per triangle its corner-table column (24 of the
// 36 rows, 96 bytes; 33 rows with vertex colours), `tri_valid` (and
// `tri_draw` on the gather path), and what binning and the resolve kernels
// read: 15 setup columns, the bbox, `valid` and the 32- or 40-float record.
// The (D, 48) draw rows stay in L2.
//
// Design: one thread per triangle. It reads its corners' rows of the planar
// (36, T) table (each row coalesced across the warp) and its draw row by
// 16-byte loads: under the uniform layout (draw_stride > 0) draw
// t / draw_stride for t < real_draws · draw_stride and draw 0 for the
// padding, as ops/corner.py::corner_stage broadcasts it, else
// tri_draw[t]. It computes the corners' sx, sy, w and z from the draw row's
// four transform rows, the world normals from its cofactor rows, the UVs
// from its scale and offset, then hands them to the tail it shares with
// the skinned pair's triangle kernel (geometry_common.cuh::store_triangle:
// setup columns, bbox, `valid`, the record row staged per warp and stored
// as 512-byte runs), its 12 shading consts read from draw-row columns
// 32–43. The draw rows (P·V·M, the cofactors: cuBLAS products) are built
// per draw in PyTorch and come through a pointer, so a captured graph
// replays with new transforms and a new camera.
//
// Numerics: corner_stage's association everywhere: sx = ((g0·px + g1·py) +
// g2·pz) + g3, the normal's rows alike, |n|² = (nx² + ny²) + nz², then
// rsqrtf of its NaN-propagating clamp at 1e-16 where torch.rsqrt runs, the
// UV as c·scale + offset; -fmad=false rounds every product and sum
// separately, as PyTorch's eager ops compute them. Padding triangles are
// computed as the plain path computes them.

#include <cuda_runtime.h>

#include "geometry_common.cuh"

namespace {

using namespace trident;

constexpr int kThreads = kGeometryThreads;
constexpr int kDrawRow = 48;           // floats per draw row (corner.DRAW_ROW)
constexpr int kConsts = 32;            // first shading-const column

template <int kWidth>
__global__ void __launch_bounds__(kThreads)
rigid_geometry_kernel(const float* __restrict__ corner_t,     // (36, T)
                      const float4* __restrict__ draw_rows,   // (D, 12) float4
                      const int* __restrict__ tri_draw,       // (T,)
                      const unsigned char* __restrict__ tri_valid,
                      int n_tri, int draw_stride, int n_strided,
                      int width, int height,
                      float* __restrict__ setup,              // (15, T)
                      int4* __restrict__ bbox,                // (T,)
                      unsigned char* __restrict__ valid,      // (T,)
                      float4* __restrict__ records) {         // (T, kWidth)
  // a warp's last lanes past n_tri compute the last triangle again and
  // store nothing: every lane takes part in the staged record store
  const int t_lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (t_lane - static_cast<int>(threadIdx.x & 31) >= n_tri) return;
  const bool active = t_lane < n_tri;
  const int t = active ? t_lane : n_tri - 1;
  const int d = draw_stride > 0 ? (t < n_strided ? t / draw_stride : 0)
                                : __ldg(tri_draw + t);
  const float4* row = draw_rows + (kDrawRow / 4) * static_cast<size_t>(d);
  // columns 0–15: the sx, sy, w and z rows; 16–24 the normal cofactors,
  // 25–26 the UV scale, 27–28 the UV offset
  const float4 gx = __ldg(row), gy = __ldg(row + 1);
  const float4 gw = __ldg(row + 2), gz = __ldg(row + 3);
  const float4 n0 = __ldg(row + 4), n1 = __ldg(row + 5);
  const float4 n2 = __ldg(row + 6), n3 = __ldg(row + 7);
  const float cof[9] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w, n2.x};
  const size_t rs = static_cast<size_t>(n_tri);     // the table's row stride
  float sx[3], sy[3], zs[3], ws[3], nrm[3][3], uv[3][2], col[3][3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* c = corner_t + 12 * k * rs + t;
    const float px = __ldg(c), py = __ldg(c + rs), pz = __ldg(c + 2 * rs);
    sx[k] = ((gx.x * px + gx.y * py) + gx.z * pz) + gx.w;
    sy[k] = ((gy.x * px + gy.y * py) + gy.z * pz) + gy.w;
    ws[k] = ((gw.x * px + gw.y * py) + gw.z * pz) + gw.w;
    zs[k] = ((gz.x * px + gz.y * py) + gz.z * pz) + gz.w;
    const float ox = __ldg(c + 3 * rs), oy = __ldg(c + 4 * rs);
    const float oz = __ldg(c + 5 * rs);
    float nw[3];
    #pragma unroll
    for (int i = 0; i < 3; ++i)
      nw[i] = (cof[3 * i] * ox + cof[3 * i + 1] * oy) + cof[3 * i + 2] * oz;
    float q = nw[0] * nw[0] + nw[1] * nw[1];
    q = q + nw[2] * nw[2];
    const float inv = rsqrtf(q != q ? q : fmaxf(q, 1e-16f));
    #pragma unroll
    for (int i = 0; i < 3; ++i) nrm[k][i] = nw[i] * inv;
    uv[k][0] = __ldg(c + 6 * rs) * n2.y + n2.w;
    uv[k][1] = __ldg(c + 7 * rs) * n2.z + n3.x;
    #pragma unroll
    for (int i = 0; i < 3; ++i)
      col[k][i] = kWidth == 40 ? __ldg(c + (8 + i) * rs) : 0.0f;
  }

  const float* consts = reinterpret_cast<const float*>(row) + kConsts;
  store_triangle<kWidth>(
      t, t_lane, active, n_tri, width, height, sx, sy, zs, ws, nrm, uv, col,
      tri_valid, [&] { return consts; }, setup, bbox, valid, records);
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// draw_stride > 0: the uniform layout, whose first n_strided =
// real_draws · draw_stride triangles belong to draw t / draw_stride and the
// rest to draw 0; else tri_draw[t]. The wrapper (ops/rigid.py) checks the
// shapes and that n_strided <= n_tri and real_draws <= D.
extern "C" int trident_rigid_geometry(
    const float* corner_t, const void* draw_rows, const int* tri_draw,
    const void* tri_valid, int n_tri, int draw_stride, int real_draws,
    int width, int height, int record_width, float* setup, void* bbox,
    void* valid, void* records, cudaStream_t stream) {
  if (record_width != 32 && record_width != 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tri > 0) {
    const auto* dr = static_cast<const float4*>(draw_rows);
    const auto* tv = static_cast<const unsigned char*>(tri_valid);
    auto* bb = static_cast<int4*>(bbox);
    auto* va = static_cast<unsigned char*>(valid);
    auto* rec = static_cast<float4*>(records);
    const int n_strided = draw_stride > 0 ? real_draws * draw_stride : 0;
    if (record_width == 40) {
      rigid_geometry_kernel<40><<<blocks_of(n_tri), kThreads, 0, stream>>>(
          corner_t, dr, tri_draw, tv, n_tri, draw_stride, n_strided, width,
          height, setup, bb, va, rec);
    } else {
      rigid_geometry_kernel<32><<<blocks_of(n_tri), kThreads, 0, stream>>>(
          corner_t, dr, tri_draw, tv, n_tri, draw_stride, n_strided, width,
          height, setup, bb, va, rec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
