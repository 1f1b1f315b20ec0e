// Split-plane select probe (trident_tpu_torch/tools_dev/diag_split_kernel.py):
// the resolve pass's winner select on three bf16 planes hi, mid, lo of an
// f32 record table. For each row r and output lane j,
//   part_k[r, j] = float(plane_k[r, off + win[j]])      k = 0, 1, 2
//   sum[r, j]    = (part_0 + part_1) + part_2
// where off = off0 + chunk[0] * n_win when a device chunk scalar is given
// (the dynamic offset of n_win-lane chunks), else off0. A column outside
// the row reads NaN.
//
// Replaces: trident_tpu's tools_dev/diag_split_kernel.py kernels, the
// pallas_calls at diag_split_kernel.py:83 (run_k1: stacked planes, static
// chunk slice, parts and sum), :126 (run_k2: stacked planes, chunk offset
// from a prefetched scalar) and :165 (run_k3: three separate plane inputs,
// the sum only).
//
// Bound on the card: launch and one global round trip; at the probe's
// shapes (rows <= 32, 256 lanes) it selects about 130 KB.
//
// Design: the TPU selects with a one-hot (256, 256) MXU product per plane;
// a one-hot product only selects, so on Hopper it is a load, exact by
// construction. One CTA per row and 256 output columns issues every global
// load it needs at once: each thread's win word, the chunk word, and the
// columns [lo, hi) of the three planes that the select can read, copied
// into shared memory with 16-byte loads (ragged ends element by element);
// lo, hi are the host's span: the static chunk's n_win columns when the
// offset is static (K1), the whole row when the chunk comes from the
// device (K2, K3). Then one __syncthreads and the select from shared
// memory, one output column a thread (a column inside the row but outside
// the span, which a win value outside [0, n_win) can name, is read from
// global memory), the sum in the probe's association (built with
// -fmad=false; no contraction is possible here anyway), and stores of 4
// bytes a thread, 128 contiguous bytes a warp (four columns a thread with
// float4 stores made each thread's selects serial, and was slower).
// Stacked planes (K1, K2) pass pointers one plane apart; separate planes
// (K3) pass their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxBytes = 48 * 1024;   // the default dynamic limit

// Shared-memory elements per plane for a span of `span` columns: whole
// 16-byte pieces from the piece holding column lo to the one holding hi-1.
__host__ __device__ constexpr int plane_pitch(int span) {
  return 8 * ((span + 7) / 8 + 1);
}

// Copy columns [lo, hi) of one row of each plane into its `pitch`-element
// region of `sp`, column c of plane k at sp[k * pitch + shift_k + c - lo]
// with shift_k (returned as x, y, z) the span start's offset in its
// 16-byte piece. Each thread issues its pieces' loads for all three planes
// before any store, so the copy is one round trip. kRagged is false when
// every plane's span starts and ends on a 16-byte boundary (the probe's
// planes; the host checks): each piece is one 16-byte load and every
// shift is 0. Otherwise a piece not wholly inside the span (at most the
// first and the last of a plane) is copied element by element.
template <bool kRagged>
__device__ __forceinline__ int3 stage_rows(const __nv_bfloat16* r0,
                                           const __nv_bfloat16* r1,
                                           const __nv_bfloat16* r2, int lo,
                                           int hi, int pitch,
                                           __nv_bfloat16* sp) {
  const __nv_bfloat16* const src[3] = {r0, r1, r2};
  uint4* dst = reinterpret_cast<uint4*>(sp);
  const int pitch16 = pitch / 8;
  if (!kRagged) {
    const int pieces = (hi - lo) >> 3;
    // not unrolled: unrolled, ptxas spilled a value the select reloads
    // from local memory after the barrier, one more round trip
#pragma unroll 1
    for (int p = threadIdx.x; p < pieces; p += kThreads) {
      uint4 v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[k] = __ldg(reinterpret_cast<const uint4*>(src[k] + lo) + p);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[k * pitch16 + p] = v[k];
    }
    return make_int3(0, 0, 0);
  }
  uintptr_t a[3], e[3], a16[3];
  int most = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = reinterpret_cast<uintptr_t>(src[k] + lo);
    e[k] = reinterpret_cast<uintptr_t>(src[k] + hi);
    a16[k] = a[k] & ~static_cast<uintptr_t>(15);
    most = max(most, static_cast<int>((e[k] - a16[k] + 15) >> 4));
  }
  for (int p = threadIdx.x; p < most; p += kThreads) {
    uint4 v[3];
    bool whole[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uintptr_t pa = a16[k] + 16 * static_cast<uintptr_t>(p);
      whole[k] = pa >= a[k] && pa + 16 <= e[k];
      if (whole[k]) v[k] = __ldg(reinterpret_cast<const uint4*>(pa));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (whole[k]) {
        dst[k * pitch16 + p] = v[k];
        continue;
      }
      const uintptr_t pa = a16[k] + 16 * static_cast<uintptr_t>(p);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uintptr_t ea = pa + 2 * i;
        if (ea >= a[k] && ea < e[k]) {
          sp[k * pitch + 8 * p + i] =
              *reinterpret_cast<const __nv_bfloat16*>(ea);
        }
      }
    }
  }
  return make_int3(static_cast<int>((a[0] - a16[0]) >> 1),
                   static_cast<int>((a[1] - a16[1]) >> 1),
                   static_cast<int>((a[2] - a16[2]) >> 1));
}

// The int32 values w with a <= w <= b, as a closed range (x > y if none).
__device__ __forceinline__ int2 w_range(long long a, long long b) {
  if (a > INT_MAX || b < INT_MIN || a > b) return make_int2(1, 0);
  return make_int2(static_cast<int>(max(a, static_cast<long long>(INT_MIN))),
                   static_cast<int>(min(b, static_cast<long long>(INT_MAX))));
}

template <bool kRagged>
__global__ void __launch_bounds__(kThreads)
split_select_kernel(const __nv_bfloat16* __restrict__ p0,
                    const __nv_bfloat16* __restrict__ p1,
                    const __nv_bfloat16* __restrict__ p2, int rows, int cols,
                    long long row_stride, int off0,
                    const int* __restrict__ chunk,
                    const int* __restrict__ win, int n_win, int lo, int hi,
                    float* __restrict__ parts, float* __restrict__ sum) {
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int pitch = plane_pitch(hi - lo);
  const int r = blockIdx.x;

  // every global load at once: win, chunk, the three planes' span
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const int w = j < n_win ? __ldg(win + j) : 0;
  const int c = chunk != nullptr ? __ldg(chunk) : 0;
  const int3 shift = stage_rows<kRagged>(p0 + r * row_stride,
                                         p1 + r * row_stride,
                                         p2 + r * row_stride, lo, hi, pitch,
                                         sp);
  __syncthreads();
  if (j >= n_win) return;

  // the column is base + w; the span's and the row's columns as closed
  // ranges of w, so that the per-column work stays in 32 bits (exact: an
  // index inside a range fits, and wraps back to it)
  const long long base = off0 + static_cast<long long>(c) * n_win;
  const int2 in_span = w_range(lo - base, hi - 1 - base);
  const int2 in_row = w_range(-base, cols - 1 - base);
  const unsigned ubase = static_cast<unsigned>(base);
  float v0, v1, v2;
  if (w >= in_span.x && w <= in_span.y) {
    const int i = static_cast<int>(static_cast<unsigned>(w) + ubase -
                                   static_cast<unsigned>(lo));
    v0 = __bfloat162float(sp[shift.x + i]);
    v1 = __bfloat162float(sp[pitch + shift.y + i]);
    v2 = __bfloat162float(sp[2 * pitch + shift.z + i]);
  } else if (w >= in_row.x && w <= in_row.y) {
    const long long at = r * row_stride +
                         static_cast<int>(static_cast<unsigned>(w) + ubase);
    v0 = __bfloat162float(p0[at]);
    v1 = __bfloat162float(p1[at]);
    v2 = __bfloat162float(p2[at]);
  } else {
    v0 = v1 = v2 = __int_as_float(0x7FC00000);                     // NaN
  }
  const int n = rows * n_win, o = r * n_win + j;
  if (parts != nullptr) {
    parts[o] = v0;
    parts[n + o] = v1;
    parts[2 * n + o] = v2;
  }
  sum[o] = (v0 + v1) + v2;
}

}  // namespace

// p0, p1, p2: (rows, cols) bf16 planes with row_stride elements between
// rows; win (n_win,) i32; chunk null or one i32 on the device; parts null
// or (3, rows, n_win) f32; sum (rows, n_win) f32;
// [lo, hi) the columns staged in shared memory, 0 <= lo <= hi <= cols,
// 3 * 2 * plane_pitch(hi - lo) bytes at most kSmemMaxBytes (the wrapper's
// split_span and split_smem_bytes).
extern "C" int trident_split_select(const __nv_bfloat16* p0,
                                    const __nv_bfloat16* p1,
                                    const __nv_bfloat16* p2, int rows,
                                    int cols, long long row_stride, int off0,
                                    const int* chunk, const int* win,
                                    int n_win, int lo, int hi, float* parts,
                                    float* sum, cudaStream_t stream) {
  const long long smem = 3LL * 2 * plane_pitch(hi - lo);
  if (rows < 0 || cols < 0 || n_win < 0 || row_stride < cols || lo < 0 ||
      lo > hi || hi > cols || smem > kSmemMaxBytes ||
      static_cast<long long>(rows) * n_win > 0x7FFFFFFF / 3 ||
      n_win > 65535LL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && n_win > 0) {
    const uintptr_t edges =
        reinterpret_cast<uintptr_t>(p0 + lo) |
        reinterpret_cast<uintptr_t>(p1 + lo) |
        reinterpret_cast<uintptr_t>(p2 + lo) |
        static_cast<uintptr_t>(2 * (hi - lo)) |
        static_cast<uintptr_t>(2 * row_stride);
    auto kernel = (edges & 15) != 0 ? split_select_kernel<true>
                                    : split_select_kernel<false>;
    const dim3 grid(rows, (n_win + kThreads - 1) / kThreads);
    kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
        p0, p1, p2, rows, cols, row_stride, off0, chunk, win, n_win, lo, hi,
        parts, sum);
  }
  return static_cast<int>(cudaGetLastError());
}
