// Deferred shading kernel: the resolved attribute image → the RGBA f32 frame.
//
// Replaces: no Pallas kernel. The JAX package's forward shading is plain jnp
// (trident_tpu/ops/deferred.py::deferred_shade_attrs → _shade_common, whose
// bilinear texel fetch is site 5, texel_pallas.py:188); the port ran it as
// about a hundred PyTorch launches over (H, W, 1..4) tensors
// (ops/deferred.py::deferred_shade_attrs_plain), 2.82 ms a 1080p frame.
//
// Bound on the card: bytes — a pixel's 4-byte triangle id in and its
// 16-byte RGBA f32 out, and a covered pixel's 64-byte attribute row and
// 4-byte depth in: 88 B a covered pixel, 182.5 MB (0.0545 ms at 3.35 TB/s)
// were all 1920×1080 pixels covered. The texel quads (a 128² checker's
// pyramid, 0.39 MB) and the frame's constants stay in L2 / L1.
//
// Design: one thread a pixel runs the whole plain composition in registers:
// the attribute row as four 16-byte loads; the texture geometry (size_hint),
// the mip clamped to [0, max_level] and rounded half to even, bilinear_index
// and one 16-byte quad fetch lerped as csrc/texel.cu lerps; the world
// position from the depth through the (P·V)⁻¹ that PyTorch inverted (its
// pointer, so both paths start from one matrix); shade_pbr (the directional
// light gated by dir_count, each of the P ∈ {0, 2, 4, 8} point-light rows
// gated by i < point_count, ambient); Reinhard + gamma, or linear HDR; one
// 16-byte store. Uncovered pixels read only their id and store the clear
// colour. Every constant (lights, camera position, max_level, the inverse)
// is read from device memory, so a captured frame graph replays the kernel
// with each frame's blob. Bands pass their first global row and the full
// frame's height.
//
// Numerics: -fmad=false keeps each product and sum rounded as PyTorch's
// separate elementwise launches round them, and each expression keeps the
// plain version's order: a 3-wide sum over the last axis is PyTorch's
// reduce order ((x + z) + y: two threads of a block row, the first holding x
// and z), a division by a Python float is a product with the f32 reciprocal
// (PyTorch's div by a CPU scalar), the world position a chain of FMAs in k
// order (cuBLAS's f32 product), pow, rsqrt and log2 the CUDA math library's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265359f;

// PyTorch's clamp_min / clamp on CUDA: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.sum(v, dim=-1) over 3 values
__device__ __forceinline__ float sum3(float x, float y, float z) {
  return (x + z) + y;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}

// shading._normalize: v · rsqrt(max(Σ v², 1e-8))
__device__ __forceinline__ V3 normalize(V3 v) {
  const float r = rsqrtf(clamp_min(sum3(v.x * v.x, v.y * v.y, v.z * v.z),
                                   1e-8f));
  return {v.x * r, v.y * r, v.z * r};
}

__device__ __forceinline__ float4 unpack(unsigned v) {
  return make_float4(static_cast<float>(v & 0xFFu),
                     static_cast<float>((v >> 8) & 0xFFu),
                     static_cast<float>((v >> 16) & 0xFFu),
                     static_cast<float>((v >> 24) & 0xFFu));
}

__device__ __forceinline__ float lerp2(float a, float b, float f) {
  return a * (1.0f - f) + b * f;
}

// torch.bitwise_right_shift on int32: shifts past 30 keep the sign alone
__device__ __forceinline__ int rshift(int a, int b) {
  return (b < 0 || b >= 31) ? a >> 31 : a >> b;
}

// torch.remainder on int32 (floor modulo)
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

struct Surface {
  V3 n, v, albedo, f0;
  float metallic, roughness;
};

// shading.evaluate_pbr_light: one light's contribution
__device__ __forceinline__ V3 pbr_light(const Surface& s, V3 l, V3 radiance) {
  const V3 h = normalize({s.v.x + l.x, s.v.y + l.y, s.v.z + l.z});
  // distribution_ggx
  const float a = s.roughness * s.roughness;
  const float a2 = a * a;
  const float ndoth = clamp_min(dot(s.n, h), 0.0f);
  const float dn = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
  const float ndf = a2 / (kPi * dn * dn);
  // geometry_smith
  const float ndotv = clamp_min(dot(s.n, s.v), 0.0f);
  const float ndotl = clamp_min(dot(s.n, l), 0.0f);
  const float r1 = s.roughness + 1.0f;
  const float k = (r1 * r1) * 0.125f;
  const float gv = ndotv / clamp_min(ndotv * (1.0f - k) + k, 1e-4f);
  const float gl = ndotl / clamp_min(ndotl * (1.0f - k) + k, 1e-4f);
  const float geom = gv * gl;
  // fresnel_schlick
  const float p5 = powf(clamp(1.0f - clamp_min(dot(h, s.v), 0.0f), 0.0f,
                              1.0f), 5.0f);
  const V3 fr = {s.f0.x + (1.0f - s.f0.x) * p5, s.f0.y + (1.0f - s.f0.y) * p5,
                 s.f0.z + (1.0f - s.f0.z) * p5};
  const float ng = ndf * geom;
  const float denominator = clamp_min(4.0f * ndotv * ndotl, 1e-4f);
  const float inv_pi = 1.0f / kPi;
  const float km = 1.0f - s.metallic;
  return {(((1.0f - fr.x) * km * s.albedo.x * inv_pi + ng * fr.x / denominator)
           * radiance.x) * ndotl,
          (((1.0f - fr.y) * km * s.albedo.y * inv_pi + ng * fr.y / denominator)
           * radiance.y) * ndotl,
          (((1.0f - fr.z) * km * s.albedo.z * inv_pi + ng * fr.z / denominator)
           * radiance.z) * ndotl};
}

struct Frame {
  const float4* attrs;        // (n_px, 4) float4: the (H, W, 16) rows
  const float* depth;
  const int* tri_id;
  const uint4* quads;
  const int* max_level;
  const float* vp_inv;        // (4, 4) row-major
  const float* cam_pos;       // (3,)
  const float* ambient;       // (4,)
  const float* dir_direction; // (3,)
  const float* dir_color;     // (4,)
  const int* dir_count;
  const float* point_pos;     // (n_point, 4)
  const float* point_color;   // (n_point, 4)
  const int* point_count;
  int n_point;
  float4 clear;
  float sx, sy;               // 2 / width, 2 / full_height
  int width, n_px, y_offset, tonemap;
  float4* out;
};

__global__ void __launch_bounds__(kThreads)
deferred_shade_kernel(const Frame f) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= f.n_px) return;
  const bool tm = f.tonemap != 0;
  if (__ldg(f.tri_id + p) < 0) {
    const float4 c = f.clear;
    f.out[p] = tm ? make_float4(clamp(c.x, 0.f, 1.f), clamp(c.y, 0.f, 1.f),
                                clamp(c.z, 0.f, 1.f), clamp(c.w, 0.f, 1.f))
                  : c;
    return;
  }
  const float4 a0 = __ldg(f.attrs + 4 * static_cast<size_t>(p));
  const float4 a1 = __ldg(f.attrs + 4 * static_cast<size_t>(p) + 1);
  const float4 a2 = __ldg(f.attrs + 4 * static_cast<size_t>(p) + 2);
  const float4 a3 = __ldg(f.attrs + 4 * static_cast<size_t>(p) + 3);
  // channels (ops/resolve.py): 0-2 normal, 3-4 uv, 5 mip, 6-9 colour
  // factor, 10 metallic, 11 roughness, 12 ambient, 13 base >> 8, 14-15 size

  // -- texture: size_hint, texel_index, bilinear_index, one quad fetch
  const int w0 = static_cast<int>(a3.z), h0 = static_cast<int>(a3.w);
  const int base8 = static_cast<int>(a3.y);
  int m = max(max(w0, h0), 1) - 1;
  m |= m >> 1;
  m |= m >> 2;
  m |= m >> 4;
  m |= m >> 8;
  m |= m >> 16;
  const int edge = m + 1;
  // torch.minimum(clamp_min(mip, 0), max_level): NaN passes through
  const float mip0 = clamp_min(a1.y, 0.0f);
  const float mip = isnan(mip0)
      ? mip0 : fminf(mip0, static_cast<float>(__ldg(f.max_level)));
  const int level = static_cast<int>(nearbyintf(mip));
  const int lw = max(rshift(w0, level), 1);
  const int lh = max(rshift(h0, level), 1);
  const int es = max(rshift(edge, level), 1);
  const int tail = static_cast<int>(log2f(static_cast<float>(max(edge, 1))));
  const int base = (base8 << 8) + ((edge * edge - es * es) * 4) / 3
                   + (edge - es) * 4 + min(level, tail);
  const float tx = a0.w * static_cast<float>(lw) - 0.5f;
  const float ty = a1.x * static_cast<float>(lh) - 0.5f;
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = tx - x0, fy = ty - y0;
  const int idx = base + floor_mod(static_cast<int>(y0), lh) * (es + 1)
                  + floor_mod(static_cast<int>(x0), lw);
  const uint4 q = __ldg(f.quads + idx);
  const float4 t00 = unpack(q.x), t10 = unpack(q.y);
  const float4 t01 = unpack(q.z), t11 = unpack(q.w);
  const float s255 = 1.0f / 255.0f;
  const float sr = (lerp2(t00.x, t10.x, fx) * (1.0f - fy)
                    + lerp2(t01.x, t11.x, fx) * fy) * s255;
  const float sg = (lerp2(t00.y, t10.y, fx) * (1.0f - fy)
                    + lerp2(t01.y, t11.y, fx) * fy) * s255;
  const float sb = (lerp2(t00.z, t10.z, fx) * (1.0f - fy)
                    + lerp2(t01.z, t11.z, fx) * fy) * s255;
  const float sa = (lerp2(t00.w, t10.w, fx) * (1.0f - fy)
                    + lerp2(t01.w, t11.w, fx) * fy) * s255;

  Surface s;
  s.albedo = {sr * a1.z, sg * a1.w, sb * a2.x};
  const float alpha = a2.y * sa;

  // -- world position: (P·V)⁻¹ · (ndc, 1), a chain of FMAs in k order
  const int x = p % f.width;
  const int y = p / f.width + f.y_offset;
  const float nx = (static_cast<float>(x) + 0.5f) * f.sx - 1.0f;
  const float ny = (static_cast<float>(y) + 0.5f) * f.sy - 1.0f;
  const float nz = __ldg(f.depth + p);
  float wh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* row = f.vp_inv + 4 * j;
    wh[j] = __fmaf_rn(1.0f, __ldg(row + 3),
                      __fmaf_rn(nz, __ldg(row + 2),
                                __fmaf_rn(ny, __ldg(row + 1),
                                          __fmul_rn(nx, __ldg(row)))));
  }
  const float ww = fabsf(wh[3]) < 1e-20f ? 1e-20f : wh[3];
  const V3 world = {wh[0] / ww, wh[1] / ww, wh[2] / ww};

  // -- shade_pbr
  s.metallic = clamp(a2.z, 0.0f, 1.0f);
  s.roughness = clamp(a2.w, 0.045f, 1.0f);
  const float amb_s = clamp(a3.x, 0.0f, 1.0f);
  s.n = normalize({a0.x, a0.y, a0.z});
  s.v = normalize({__ldg(f.cam_pos) - world.x, __ldg(f.cam_pos + 1) - world.y,
                   __ldg(f.cam_pos + 2) - world.z});
  const float km = 1.0f - s.metallic;
  s.f0 = {0.04f * km + s.albedo.x * s.metallic,
          0.04f * km + s.albedo.y * s.metallic,
          0.04f * km + s.albedo.z * s.metallic};

  const float dir_on = __ldg(f.dir_count) > 0 ? 1.0f : 0.0f;
  const V3 l_dir = normalize({-__ldg(f.dir_direction),
                              -__ldg(f.dir_direction + 1),
                              -__ldg(f.dir_direction + 2)});
  const float dw = __ldg(f.dir_color + 3);
  const V3 dl = pbr_light(s, l_dir, {__ldg(f.dir_color) * dw,
                                     __ldg(f.dir_color + 1) * dw,
                                     __ldg(f.dir_color + 2) * dw});
  V3 direct = {dir_on * dl.x, dir_on * dl.y, dir_on * dl.z};

  const int point_count = __ldg(f.point_count);
  for (int i = 0; i < f.n_point; ++i) {
    const float* pp = f.point_pos + 4 * i;
    const float* pc = f.point_color + 4 * i;
    const float on = i < point_count ? 1.0f : 0.0f;
    const V3 to = {__ldg(pp) - world.x, __ldg(pp + 1) - world.y,
                   __ldg(pp + 2) - world.z};
    const float dist = sqrtf(clamp_min(
        sum3(to.x * to.x, to.y * to.y, to.z * to.z), 1e-12f));
    const bool near_zero = dist <= 1e-4f;
    const float dd = near_zero ? 1.0f : dist;
    const float radius = clamp_min(__ldg(pp + 3), 1e-4f);
    const float nd = clamp(dist / radius, 0.0f, 1.0f);
    const float atten = (1.0f - nd) * (1.0f - nd);
    const float pw = __ldg(pc + 3);
    const V3 c = pbr_light(s, {to.x / dd, to.y / dd, to.z / dd},
                           {__ldg(pc) * pw * atten, __ldg(pc + 1) * pw * atten,
                            __ldg(pc + 2) * pw * atten});
    direct = {direct.x + on * (near_zero ? 0.0f : c.x),
              direct.y + on * (near_zero ? 0.0f : c.y),
              direct.z + on * (near_zero ? 0.0f : c.z)};
  }
  const float aw = __ldg(f.ambient + 3);
  const V3 lit = {__ldg(f.ambient) * aw * s.albedo.x * amb_s + direct.x,
                  __ldg(f.ambient + 1) * aw * s.albedo.y * amb_s + direct.y,
                  __ldg(f.ambient + 2) * aw * s.albedo.z * amb_s + direct.z};
  if (!tm) {
    f.out[p] = make_float4(lit.x, lit.y, lit.z, alpha);
    return;
  }
  // tonemap_reinhard_gamma, then the clamp to [0, 1]
  const float g = static_cast<float>(1.0 / 2.2);
  f.out[p] = make_float4(
      clamp(powf(clamp_min(lit.x / (lit.x + 1.0f), 0.0f), g), 0.f, 1.f),
      clamp(powf(clamp_min(lit.y / (lit.y + 1.0f), 0.0f), g), 0.f, 1.f),
      clamp(powf(clamp_min(lit.z / (lit.z + 1.0f), 0.0f), g), 0.f, 1.f),
      clamp(alpha, 0.f, 1.f));
}

}  // namespace

extern "C" int trident_deferred_shade(
    const void* attrs, const float* depth, const int* tri_id,
    const void* quads, const int* max_level, const float* vp_inv,
    const float* cam_pos, const float* ambient, const float* dir_direction,
    const float* dir_color, const int* dir_count, const float* point_pos,
    const float* point_color, const int* point_count, int n_point,
    float clear_r, float clear_g, float clear_b, float clear_a, float sx,
    float sy, int width, int height, int y_offset, int tonemap, void* out,
    cudaStream_t stream) {
  const int n_px = width * height;
  if (n_px > 0) {
    const Frame f{static_cast<const float4*>(attrs), depth, tri_id,
                  static_cast<const uint4*>(quads), max_level, vp_inv,
                  cam_pos, ambient, dir_direction, dir_color, dir_count,
                  point_pos, point_color, point_count, n_point,
                  make_float4(clear_r, clear_g, clear_b, clear_a), sx, sy,
                  width, n_px, y_offset, tonemap,
                  static_cast<float4*>(out)};
    deferred_shade_kernel<<<(n_px + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}
