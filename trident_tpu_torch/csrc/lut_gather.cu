// LUT gather probe (trident_tpu_torch/tools_dev/gather_probe.py): for
// n_tab tables of (rows, L) i32 and G chunks of (n, L) i32 row indices,
// out[g, k, r, l] = tab_k[idx[g, r, l], l] — take_along_axis(tab, idx,
// axis=0) per table and chunk; an index outside [0, rows) reads -1.
//
// Replaces: trident_tpu's tools_dev/gather_probe.py kernels, the
// pallas_calls at gather_probe.py:25 (lut_gather, kernel :19), :85
// (quad_gather, four tables, one idx) and :110 (lut_frame, a grid of 8 idx
// chunks over one 6144-row table).
//
// Bound on the card: bytes. Each idx word is read once, each output word
// written once, each table row read at most once from memory (the tables,
// 2-8 MB, stay in the 50 MB L2 across the random row picks).
//
// Design: the TPU probe asks whether Mosaic lowers an in-kernel gather at
// all; on Hopper a gather is a plain load. One thread per idx element:
// neighbouring threads take neighbouring lanes, so the idx loads and the
// output stores are 32-bit and coalesced, and the table reads of one warp
// fall on 32 lanes of the rows it picks (__ldg, read-only path). The thread
// reuses its index for every table.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const int* __restrict__ tabs, int n_tab, int rows, int lanes,
                  const int* __restrict__ idx, long long n_per_chunk,
                  long long total, int* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int l = static_cast<int>(i % lanes);
  const long long g = i / n_per_chunk;            // idx chunk
  const long long e = i - g * n_per_chunk;        // (r, l) within the chunk
  const int row = idx[i];
  const bool ok = row >= 0 && row < rows;
  const size_t tab_elems = static_cast<size_t>(rows) * lanes;
  for (int k = 0; k < n_tab; ++k) {
    const int v =
        ok ? __ldg(tabs + k * tab_elems + static_cast<size_t>(row) * lanes + l)
           : -1;
    out[(g * n_tab + k) * n_per_chunk + e] = v;
  }
}

}  // namespace

// tabs (n_tab, rows, lanes) i32; idx (chunks, n, lanes) i32 with
// n_per_chunk = n * lanes; out (chunks, n_tab, n, lanes) i32.
extern "C" int trident_lut_gather(const int* tabs, int n_tab, int rows,
                                  int lanes, const int* idx, int chunks,
                                  long long n_per_chunk, int* out,
                                  cudaStream_t stream) {
  if (n_tab <= 0 || rows <= 0 || lanes <= 0 || chunks < 0 ||
      n_per_chunk < 0 || n_per_chunk % lanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(chunks) * n_per_chunk;
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    lut_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        tabs, n_tab, rows, lanes, idx, n_per_chunk, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}
