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
// Bound on the card: launch overhead; at the probe's shapes (rows <= 32,
// 256 lanes) it moves about 130 KB.
//
// Design: the TPU selects with a one-hot (256, 256) MXU product per plane;
// a one-hot product only selects, so on Hopper it is a direct load, exact
// by construction: one thread per (r, j), the three bf16 loads widened to
// f32, the sum in the probe's association (built with -fmad=false, no
// contraction is possible here anyway). Stacked planes (K1, K2) pass
// pointers one plane apart; separate planes (K3) pass their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
split_select_kernel(const __nv_bfloat16* __restrict__ p0,
                    const __nv_bfloat16* __restrict__ p1,
                    const __nv_bfloat16* __restrict__ p2, int rows, int cols,
                    long long row_stride, int off0,
                    const int* __restrict__ chunk,
                    const int* __restrict__ win, int n_win,
                    float* __restrict__ parts, float* __restrict__ sum) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * n_win) return;
  const int r = i / n_win;
  const int j = i % n_win;
  const int col = off0 + (chunk != nullptr ? chunk[0] * n_win : 0) + win[j];
  float a = __int_as_float(0x7FC00000), b = a, c = a;   // NaN
  if (col >= 0 && col < cols) {
    const long long o = r * row_stride + col;
    a = __bfloat162float(p0[o]);
    b = __bfloat162float(p1[o]);
    c = __bfloat162float(p2[o]);
  }
  if (parts != nullptr) {
    const int n = rows * n_win;
    parts[i] = a;
    parts[n + i] = b;
    parts[2 * n + i] = c;
  }
  sum[i] = (a + b) + c;
}

}  // namespace

// p0, p1, p2: (rows, cols) bf16 planes with row_stride elements between
// rows; win (n_win,) i32; chunk null or one i32 on the device; parts null
// or (3, rows, n_win) f32; sum (rows, n_win) f32.
extern "C" int trident_split_select(const __nv_bfloat16* p0,
                                    const __nv_bfloat16* p1,
                                    const __nv_bfloat16* p2, int rows,
                                    int cols, long long row_stride, int off0,
                                    const int* chunk, const int* win,
                                    int n_win, float* parts, float* sum,
                                    cudaStream_t stream) {
  if (rows < 0 || cols < 0 || n_win < 0 || row_stride < cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = rows * n_win;
  if (n > 0) {
    split_select_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(p0, p1, p2, rows, cols, row_stride, off0,
                                    chunk, win, n_win, parts, sum);
  }
  return static_cast<int>(cudaGetLastError());
}
