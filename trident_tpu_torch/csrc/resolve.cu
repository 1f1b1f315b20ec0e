// Resolve kernel: each covered pixel's winning triangle id → the 16
// deferred-shading channels (rational normal and UV, mip level from the
// analytic UV derivatives, material constants, texture geometry).
//
// Replaces: trident_tpu/ops/resolve_pallas.py _resolve_kernel (reached via
// resolve_attrs_pallas, pallas_call at resolve_pallas.py:611).
//
// Bound on the card: bytes — 64 B of output per pixel plus one scattered
// column read per record row of the winner (neighbouring pixels mostly
// share a winner, so a warp touches few distinct columns).
//
// Design: one thread per pixel of the (H, W) frame. The winner's record is a
// direct load records[:, tri_id] from the (RW, T) column table; there is no
// pair sweep, no one-hot select and no split-bf16 planes (those existed for
// the TPU's matrix unit). Expression order follows
// resolve_pallas._eval_interpolants; with -fmad=false every op rounds like
// the plain version in ops/resolve.py. Uncovered pixels get zeros.

#include <cuda_runtime.h>

namespace {

// resolve-record rows (ops/planes.py RR_*)
constexpr int kG1 = 0, kNX = 3, kNY = 6, kNZ = 9, kU = 12, kV = 15;
constexpr int kCF = 18, kMet = 22, kRough = 23, kAmb = 24;
constexpr int kTsx = 26, kTsy = 27, kBase8 = 28;
constexpr int kChannels = 16;
constexpr int kThreads = 256;

// NaN-propagating max, as torch.maximum / jnp.maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ tri, const float* __restrict__ records,
               long long stride, int width, int n_px, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(p) * kChannels);
  const int tid = tri[p];
  if (tid < 0) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    o[0] = z; o[1] = z; o[2] = z; o[3] = z;
    return;
  }
  const float* rc = records + tid;
  auto row = [&](int j) { return __ldg(rc + j * stride); };
  const float pxf = static_cast<float>(p % width) + 0.5f;
  const float pyf = static_cast<float>(p / width) + 0.5f;
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

  o[0] = make_float4(nx, ny, nz, u);
  o[1] = make_float4(v, mip, row(kCF), row(kCF + 1));
  o[2] = make_float4(row(kCF + 2), row(kCF + 3), row(kMet), row(kRough));
  o[3] = make_float4(row(kAmb), row(kBase8), tsx, tsy);
}

}  // namespace

extern "C" int trident_resolve(const int* tri, const float* records,
                               long long stride, int width, int n_px,
                               float* out, cudaStream_t stream) {
  if (n_px > 0) {
    const int blocks = (n_px + kThreads - 1) / kThreads;
    resolve_kernel<<<blocks, kThreads, 0, stream>>>(tri, records, stride,
                                                   width, n_px, out);
  }
  return static_cast<int>(cudaGetLastError());
}
