// Skinned geometry: the forward route's indexed geometry as two kernels.
//
// Replaces no Pallas kernel: the JAX package's vertex stage
// (trident_tpu/ops/vertex.py::vertex_stage) and its triangle setup and
// resolve records (ops/vertex.py::triangle_setup, ops/planes.py) are plain
// jnp. The port ran them as a chain of plain-PyTorch gathers, cats and
// elementwise ops over (TV, 4, 4, 4) and (T, 3, 16) intermediates
// (ops/indexed.py::indexed_geometry_plain); these kernels compute the same
// values with no intermediate but the packed vertex table.
//
// Bound on the card: bytes. Per vertex the attribute row, the skin inputs
// and the 64-byte packed row written and read again; per triangle the
// indices, the corner rows (mostly L2 hits: a vertex is shared by about six
// triangles), and what binning and the resolve kernels read: 15 setup
// columns, the bbox, `valid` and the 32- or 40-float record. The palette
// and the per-draw tables stay in L2.
//
// Design: two launches. skinned_vertex_kernel, one thread per expanded
// vertex, gathers its attribute row (16-byte loads), skins it from up to 4
// palette matrices, transforms it to world and clip space and writes one
// 64-byte packed row (ops/vertex.py::VertexStageOut.packed's layout), so
// that each shared vertex is skinned once. skinned_triangle_kernel, one
// thread per triangle, reads its three packed rows and writes the planar
// setup columns ((15, T): 9 edge coefficients, 3 clip z, 3 clip w),
// coalesced, the bbox, `valid` and the record row (kWidth 32, or 40 with the
// vertex-colour planes), its 12 shading consts read from the (D, 12) draw
// table by the triangle's draw; from its corners on it runs the tail it
// shares with csrc/rigid_geometry.cu (geometry_common.cuh::
// store_triangle). Both kernels stage a warp's 32 rows in
// shared memory and store them as contiguous 512-byte runs: stored a row a
// thread, the 40-wide records took twice as long (0.403 against 0.207 ms
// at the crowd's 2,097,152 triangles on an H100). Per-frame values (the
// palette, the draw rows, P·V and the per-draw normal cofactors) come
// through pointers, so a captured graph replays with new values.
//
// Numerics: the plain path's association everywhere: _matvec's row sums
// left to right from +0, skinning summed over the influences in order from
// +0, the clip product summed pairwise, the planes as (a0·e0 + a1·e1) +
// a2·e2; rsqrtf where torch.rsqrt runs, IEEE division, and NaN-propagating
// min / max / clamp as PyTorch's. -fmad=false keeps every product and sum
// separately rounded, as PyTorch's eager ops compute them. The one PyTorch
// kernel that may contract a multiply-add, torch.linalg.cross inside the
// normal cofactors, is not redone here: the wrapper computes the cofactors
// once per draw with the plain path's own function and passes them in.
// Padded vertices and triangles are computed as the plain path computes
// them.

#include <cuda_runtime.h>

#include "geometry_common.cuh"

namespace {

using namespace trident;

constexpr int kThreads = kGeometryThreads;

__global__ void __launch_bounds__(kThreads)
skinned_vertex_kernel(const int* __restrict__ vtx_src,
                      const int* __restrict__ vtx_draw,
                      const float4* __restrict__ attr,      // (V, 3) float4
                      const int4* __restrict__ bone_idx,    // (V,) int4
                      const float4* __restrict__ bone_w,    // (V,) float4
                      const float* __restrict__ xform_a,    // (D, 12)
                      const float* __restrict__ xform_b,    // (D, 12)
                      const float* __restrict__ cof,        // (D, 9)
                      const int* __restrict__ bone_offset,  // (D,)
                      const int* __restrict__ bone_count,   // (D,)
                      const float* __restrict__ palette,    // (P, 16)
                      int n_palette, int skinned,
                      const float* __restrict__ vp,         // (4, 4) P·V
                      int n_vtx, float4* __restrict__ packed) {
  // as in the triangle kernel: lanes past n_vtx redo the last vertex
  const int v_lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (v_lane - static_cast<int>(threadIdx.x & 31) >= n_vtx) return;
  const int v = v_lane < n_vtx ? v_lane : n_vtx - 1;
  const int src = __ldg(vtx_src + v);
  const int d = __ldg(vtx_draw + v);
  const float4 a0 = __ldg(attr + 3 * static_cast<size_t>(src));
  const float4 a1 = __ldg(attr + 3 * static_cast<size_t>(src) + 1);
  const float4 a2 = __ldg(attr + 3 * static_cast<size_t>(src) + 2);
  float p[3] = {a0.x, a0.y, a0.z};
  float n[3] = {a0.w, a1.x, a1.y};

  if (skinned) {
    const int4 bi = __ldg(bone_idx + src);
    const float4 bw = __ldg(bone_w + src);
    const int count = __ldg(bone_count + d);
    const long long off = __ldg(bone_offset + d);
    const int idx[4] = {bi.x, bi.y, bi.z, bi.w};
    const float wt[4] = {bw.x, bw.y, bw.z, bw.w};
    const float* m[4];
    float w[4];
    #pragma unroll
    for (int b = 0; b < 4; ++b) {
      const bool ok = wt[b] > 0.0f && idx[b] >= 0 && idx[b] < count;
      w[b] = ok ? wt[b] : 0.0f;
      long long j = off + idx[b];
      j = j < 0 ? 0 : (j > n_palette - 1 ? n_palette - 1 : j);
      m[b] = palette + 16 * j;
    }
    float s[16];
    #pragma unroll
    for (int e = 0; e < 16; ++e) {
      float acc = w[0] * __ldg(m[0] + e) + 0.0f;
      acc = acc + w[1] * __ldg(m[1] + e);
      acc = acc + w[2] * __ldg(m[2] + e);
      s[e] = acc + w[3] * __ldg(m[3] + e);
    }
    if (count <= 0) {
      #pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = (e % 5 == 0) ? 1.0f : 0.0f;
    }
    float q[3], r[3];
    #pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* row = s + 4 * i;
      q[i] = ((row[0] * p[0] + 0.0f) + row[1] * p[1]) + row[2] * p[2];
      q[i] = q[i] + row[3] * 1.0f;
      r[i] = ((row[0] * n[0] + 0.0f) + row[1] * n[1]) + row[2] * n[2];
    }
    #pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = q[i];
      n[i] = r[i];
    }
  }

  // model = [xform_a[0:12] | xform_b[0:4]] as a row-major 4 × 4
  const float* xa = xform_a + 12 * static_cast<size_t>(d);
  const float* xb = xform_b + 12 * static_cast<size_t>(d);
  float wh[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = i < 3 ? xa + 4 * i : xb;
    float acc = __ldg(row) * p[0] + 0.0f;
    acc = acc + __ldg(row + 1) * p[1];
    acc = acc + __ldg(row + 2) * p[2];
    wh[i] = acc + __ldg(row + 3) * 1.0f;
  }
  const float* c = cof + 9 * static_cast<size_t>(d);
  float nr[3];
  #pragma unroll
  for (int i = 0; i < 3; ++i) {
    nr[i] = ((__ldg(c + 3 * i) * n[0] + 0.0f) + __ldg(c + 3 * i + 1) * n[1])
            + __ldg(c + 3 * i + 2) * n[2];
  }
  float n2 = nr[0] * nr[0] + nr[1] * nr[1];
  n2 = n2 + nr[2] * nr[2];
  const float inv = rsqrtf(n2 != n2 ? n2 : fmaxf(n2, 1e-16f));
  float clip[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = vp + 4 * i;
    clip[i] = (wh[0] * __ldg(row) + wh[1] * __ldg(row + 1))
              + (wh[2] * __ldg(row + 2) + wh[3] * __ldg(row + 3));
  }
  const float u = a1.z * __ldg(xb + 4) * __ldg(xb + 8) + __ldg(xb + 6);
  const float t = a1.w * __ldg(xb + 5) * __ldg(xb + 8) + __ldg(xb + 7);
  // the warp's 32 packed rows through shared memory (the module note)
  __shared__ float4 stage[kThreads / 32][32 * 4];
  const int lane = threadIdx.x & 31;
  float4* warp_rows = stage[threadIdx.x >> 5];
  warp_rows[4 * lane] = make_float4(clip[0], clip[1], clip[2], clip[3]);
  warp_rows[4 * lane + 1] = make_float4(nr[0] * inv, nr[1] * inv,
                                        nr[2] * inv, u);
  warp_rows[4 * lane + 2] = make_float4(t, a2.x, a2.y, a2.z);
  warp_rows[4 * lane + 3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncwarp();
  const size_t first = static_cast<size_t>(v_lane - lane) * 4;
  const size_t end = static_cast<size_t>(n_vtx) * 4;
  #pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t i = first + lane + 32 * q;
    if (i < end) packed[i] = warp_rows[lane + 32 * q];
  }
}

// kWidth 32: the record row g1 gNx gNy gNz gU gV (18) | 12 consts | 0 0;
// kWidth 40: the same, then gR gG gB (9) and one zero (ops/planes.py)
template <int kWidth>
__global__ void __launch_bounds__(kThreads)
skinned_triangle_kernel(const int* __restrict__ tri_vtx,         // (T, 3)
                        const unsigned char* __restrict__ tri_valid,
                        const int* __restrict__ tri_draw,         // (T,)
                        const float4* __restrict__ packed,        // (TV, 4)
                        const float* __restrict__ consts,         // (D, 12)
                        int n_tri, int width, int height,
                        float* __restrict__ setup,                // (15, T)
                        int4* __restrict__ bbox,                  // (T,)
                        unsigned char* __restrict__ valid,        // (T,)
                        float4* __restrict__ records) {           // (T, kWidth)
  // a warp's last lanes past n_tri compute the last triangle again and
  // store nothing: every lane takes part in the staged record store
  const int t_lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (t_lane - static_cast<int>(threadIdx.x & 31) >= n_tri) return;
  const bool active = t_lane < n_tri;
  const int t = active ? t_lane : n_tri - 1;
  const float half_w = 0.5f * static_cast<float>(width);
  const float half_h = 0.5f * static_cast<float>(height);
  float sx[3], sy[3], zs[3], ws[3], nrm[3][3], uv[3][2], col[3][3];
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t vk = static_cast<size_t>(__ldg(tri_vtx + 3 * static_cast<size_t>(t) + k));
    const float4 c0 = __ldg(packed + 4 * vk);
    const float4 c1 = __ldg(packed + 4 * vk + 1);
    const float4 c2 = __ldg(packed + 4 * vk + 2);
    sx[k] = (c0.x + c0.w) * half_w;
    sy[k] = (c0.y + c0.w) * half_h;
    zs[k] = c0.z;
    ws[k] = c0.w;
    nrm[k][0] = c1.x;
    nrm[k][1] = c1.y;
    nrm[k][2] = c1.z;
    uv[k][0] = c1.w;
    uv[k][1] = c2.x;
    col[k][0] = c2.y;
    col[k][1] = c2.z;
    col[k][2] = c2.w;
  }

  store_triangle<kWidth>(
      t, t_lane, active, n_tri, width, height, sx, sy, zs, ws, nrm, uv, col,
      tri_valid,
      [&] { return consts + 12 * static_cast<size_t>(__ldg(tri_draw + t)); },
      setup, bbox, valid, records);
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int trident_skinned_vertices(
    const int* vtx_src, const int* vtx_draw, const void* attr,
    const void* bone_idx, const void* bone_w, const float* xform_a,
    const float* xform_b, const float* cof, const int* bone_offset,
    const int* bone_count, const float* palette, int n_palette, int skinned,
    const float* vp, int n_vtx, void* packed, cudaStream_t stream) {
  if (n_vtx > 0) {
    skinned_vertex_kernel<<<blocks_of(n_vtx), kThreads, 0, stream>>>(
        vtx_src, vtx_draw, static_cast<const float4*>(attr),
        static_cast<const int4*>(bone_idx), static_cast<const float4*>(bone_w),
        xform_a, xform_b, cof, bone_offset, bone_count, palette, n_palette,
        skinned, vp, n_vtx, static_cast<float4*>(packed));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trident_skinned_triangles(
    const int* tri_vtx, const void* tri_valid, const int* tri_draw,
    const void* packed, const float* consts, int n_tri, int width,
    int height, int record_width, float* setup, void* bbox, void* valid,
    void* records, cudaStream_t stream) {
  if (record_width != 32 && record_width != 40) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tri > 0) {
    const auto* tv = static_cast<const unsigned char*>(tri_valid);
    const auto* pk = static_cast<const float4*>(packed);
    auto* bb = static_cast<int4*>(bbox);
    auto* va = static_cast<unsigned char*>(valid);
    auto* rec = static_cast<float4*>(records);
    if (record_width == 40) {
      skinned_triangle_kernel<40><<<blocks_of(n_tri), kThreads, 0, stream>>>(
          tri_vtx, tv, tri_draw, pk, consts, n_tri, width, height, setup, bb,
          va, rec);
    } else {
      skinned_triangle_kernel<32><<<blocks_of(n_tri), kThreads, 0, stream>>>(
          tri_vtx, tv, tri_draw, pk, consts, n_tri, width, height, setup, bb,
          va, rec);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
