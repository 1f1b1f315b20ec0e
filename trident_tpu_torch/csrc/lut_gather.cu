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
// written once, each table word read once (the tables, 2-8 MB, stay in the
// 50 MB L2 across the random row picks).
//
// Design. Output lane l only ever reads table column l, and a warp's
// loads of 32 random rows touch 32 sectors of 32 bytes for 4 useful bytes
// each, so the L2→SM traffic of a plain gather is 8x its words. Two paths,
// all index math in 32 bits (the wrapper keeps every offset below 2^31;
// pointers step by 64-bit products, never by a division):
//
//   direct  grid (quad blocks, G): each thread owns 4 consecutive lanes of
//           kDirectSteps idx rows (one int4 idx load per row), issues the
//           table loads of all its rows and of up to four tables before
//           its int4 stores.
//   staged  grid (L / 8 slabs, G * S row splits, n_tab): a CTA copies
//           lanes [8s, 8s + 8) of its table, all rows, into shared memory
//           (one 32-byte sector a row, 16-byte loads, rows * 32 bytes),
//           then serves its split of the chunk's rows from there: each
//           thread owns 4 lanes of kStagedSteps rows, one int4 idx load
//           and one int4 store each. Its first idx loads are in flight
//           while the slab loads. Word (row, c) of the slab sits at
//           row * 8 + (c ^ ((row >> 2) & 7)), which spreads each lane's
//           rows over all 32 banks for the random-row reads and leaves
//           the staging stores free of conflicts. S = ceil(kStagedCtas /
//           (L / 8 * n_tab * G)), at most ceil(n / kSlots), fills the
//           card; staging moves S * n_tab * G * rows * L * 4 bytes from L2
//           against the direct path's 8 * n_tab * G * n * L * 4.
//
// The rule (gather_probe.py::gather_path mirrors it): staged iff L % 8 == 0,
// the slab fits (rows * 32 <= kSlabMaxBytes) and the staged traffic is at
// most half the direct one, S * rows <= 4 * n; else direct.

#include <cuda_runtime.h>

namespace {

constexpr int kDirectThreads = 256;
constexpr int kDirectSteps = 2;               // idx rows (int4s) a thread owns
constexpr int kStagedThreads = 1024;
constexpr int kStagedSteps = 4;               // rows a thread serves per pass
constexpr int kSlab = 8;                      // lanes a staged CTA owns
constexpr int kSlots = kStagedThreads / 2;    // rows served side by side
constexpr int kStagedRows = kSlots * kStagedSteps;
constexpr int kStagedCtas = 128;
constexpr int kSlabMaxBytes = 227 * 1024;

__device__ __forceinline__ int4 ldg4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ int pick(const int* __restrict__ tab, int row,
                                    int rows, int lanes, int l) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(rows)
             ? __ldg(tab + row * lanes + l)
             : -1;
}

// KG tables at a time: 1 when there is one table, else 4.
template <int KG>
__global__ void __launch_bounds__(kDirectThreads)
lut_gather_direct(const int* __restrict__ tabs, int n_tab, int rows,
                  int lanes, const int* __restrict__ idx, int quads,
                  int* __restrict__ out) {
  const int g = blockIdx.y;
  const int words = 4 * quads;                         // n * lanes
  const int* idx_g = idx + static_cast<size_t>(g) * words;
  const int q0 = blockIdx.x * (kDirectThreads * kDirectSteps) + threadIdx.x;
  int4 id[kDirectSteps];
  int lane[kDirectSteps];
#pragma unroll
  for (int s = 0; s < kDirectSteps; ++s) {
    const int q = q0 + s * kDirectThreads;
    id[s] = q < quads ? ldg4(idx_g + 4 * q) : make_int4(-1, -1, -1, -1);
    lane[s] = static_cast<int>(static_cast<unsigned>(4 * q) %
                               static_cast<unsigned>(lanes));
  }
  const size_t tab_words = static_cast<size_t>(rows) * lanes;
  for (int k0 = 0; k0 < n_tab; k0 += KG) {
    int4 v[KG][kDirectSteps];
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (k0 + kk >= n_tab) break;
      const int* tab = tabs + (k0 + kk) * tab_words;
#pragma unroll
      for (int s = 0; s < kDirectSteps; ++s) {
        v[kk][s] = make_int4(pick(tab, id[s].x, rows, lanes, lane[s]),
                             pick(tab, id[s].y, rows, lanes, lane[s] + 1),
                             pick(tab, id[s].z, rows, lanes, lane[s] + 2),
                             pick(tab, id[s].w, rows, lanes, lane[s] + 3));
      }
    }
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      if (k0 + kk >= n_tab) break;
      int* out_gk = out + (static_cast<size_t>(g) * n_tab + k0 + kk) * words;
#pragma unroll
      for (int s = 0; s < kDirectSteps; ++s) {
        const int q = q0 + s * kDirectThreads;
        if (q < quads) *reinterpret_cast<int4*>(out_gk + 4 * q) = v[kk][s];
      }
    }
  }
}

__device__ __forceinline__ int slab_at(int row, int c) {
  return row * kSlab + (c ^ ((row >> 2) & (kSlab - 1)));
}

__device__ __forceinline__ int from_slab(const int* slab, int row, int rows,
                                         int c) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(rows)
             ? slab[slab_at(row, c)]
             : -1;
}

__global__ void __launch_bounds__(kStagedThreads, 1)
lut_gather_staged(const int* __restrict__ tabs, int n_tab, int rows,
                  int lanes, const int* __restrict__ idx, int n, int splits,
                  int* __restrict__ out) {
  extern __shared__ int slab[];                        // rows * kSlab words
  const int l0 = blockIdx.x * kSlab;
  const int g = blockIdx.y / splits;
  const int per = (n + splits - 1) / splits;
  const int r_begin = (blockIdx.y - g * splits) * per;
  const int r_end = min(n, r_begin + per);
  const int k = blockIdx.z;
  const int t = threadIdx.x;
  const int c0 = 4 * (t & 1);                          // lanes c0..c0+3
  const int slot = t >> 1;
  const int words = n * lanes;
  const int* idx_g = idx + static_cast<size_t>(g) * words + l0 + c0;
  int* out_gk = out + (static_cast<size_t>(g) * n_tab + k) * words + l0 + c0;

  int4 id[kStagedSteps];
  auto load_ids = [&](int r0) {
#pragma unroll
    for (int s = 0; s < kStagedSteps; ++s) {
      const int r = r0 + slot + s * kSlots;
      id[s] = r < r_end ? ldg4(idx_g + r * lanes) : make_int4(-1, -1, -1, -1);
    }
  };
  load_ids(r_begin);                       // in flight while the slab loads

  const int* tab = tabs + static_cast<size_t>(k) * rows * lanes + l0;
  constexpr int kStageBatch = 4;
  for (int p0 = t; p0 < 2 * rows; p0 += kStageBatch * kStagedThreads) {
    int4 v[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int p = p0 + b * kStagedThreads;           // (row, half) piece
      if (p < 2 * rows) v[b] = ldg4(tab + (p >> 1) * lanes + 4 * (p & 1));
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int p = p0 + b * kStagedThreads;
      if (p < 2 * rows) {
        const int row = p >> 1, c = 4 * (p & 1);
        slab[slab_at(row, c)] = v[b].x;
        slab[slab_at(row, c + 1)] = v[b].y;
        slab[slab_at(row, c + 2)] = v[b].z;
        slab[slab_at(row, c + 3)] = v[b].w;
      }
    }
  }
  __syncthreads();

  for (int r0 = r_begin; r0 < r_end; r0 += kStagedRows) {
    if (r0 != r_begin) load_ids(r0);
    int4 v[kStagedSteps];
#pragma unroll
    for (int s = 0; s < kStagedSteps; ++s) {
      v[s] = make_int4(from_slab(slab, id[s].x, rows, c0),
                       from_slab(slab, id[s].y, rows, c0 + 1),
                       from_slab(slab, id[s].z, rows, c0 + 2),
                       from_slab(slab, id[s].w, rows, c0 + 3));
    }
#pragma unroll
    for (int s = 0; s < kStagedSteps; ++s) {
      const int r = r0 + slot + s * kSlots;
      if (r < r_end) *reinterpret_cast<int4*>(out_gk + r * lanes) = v[s];
    }
  }
}

bool shape_ok(int n_tab, int rows, int lanes, int chunks, int n) {
  return n_tab > 0 && rows > 0 && lanes > 0 && lanes % 4 == 0 &&
         chunks >= 0 && chunks <= 65535 && n >= 0;
}

int staged_splits(int n_tab, int lanes, int chunks, int n) {
  const int ctas = (lanes / kSlab) * n_tab * chunks;
  const int most = (n + kSlots - 1) / kSlots;
  const int want = (kStagedCtas + ctas - 1) / ctas;
  return max(1, min(want, most));
}

bool staged_fits(int n_tab, int rows, int lanes) {
  return lanes % kSlab == 0 && n_tab <= 65535 &&
         static_cast<long long>(rows) * kSlab * 4 <= kSlabMaxBytes;
}

// The rule of the header.
bool use_staged(int n_tab, int rows, int lanes, int chunks, int n) {
  return staged_fits(n_tab, rows, lanes) &&
         static_cast<long long>(staged_splits(n_tab, lanes, chunks, n)) *
                 rows <= 4LL * n;
}

int launch_direct(const int* tabs, int n_tab, int rows, int lanes,
                  const int* idx, int chunks, int n, int* out,
                  cudaStream_t stream) {
  const int quads = n * (lanes / 4);
  const int per_cta = kDirectThreads * kDirectSteps;
  const dim3 grid((quads + per_cta - 1) / per_cta, chunks);
  if (n_tab == 1) {
    lut_gather_direct<1><<<grid, kDirectThreads, 0, stream>>>(
        tabs, n_tab, rows, lanes, idx, quads, out);
  } else {
    lut_gather_direct<4><<<grid, kDirectThreads, 0, stream>>>(
        tabs, n_tab, rows, lanes, idx, quads, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_staged(const int* tabs, int n_tab, int rows, int lanes,
                  const int* idx, int chunks, int n, int* out,
                  cudaStream_t stream) {
  static bool opted_in[64] = {};                       // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(lut_gather_staged,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSlabMaxBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev] = true;
  }
  const int splits = staged_splits(n_tab, lanes, chunks, n);
  const dim3 grid(lanes / kSlab, chunks * splits, n_tab);
  lut_gather_staged<<<grid, kStagedThreads, rows * kSlab * 4, stream>>>(
      tabs, n_tab, rows, lanes, idx, n, splits, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tabs (n_tab, rows, lanes) i32; idx (chunks, n, lanes) i32; out (chunks,
// n_tab, n, lanes) i32; bases 16-byte aligned, lanes % 4 == 0, rows * lanes
// and chunks * n_tab * n * lanes below 2^31 (the wrapper checks). The path
// follows the rule in the header.
extern "C" int trident_lut_gather(const int* tabs, int n_tab, int rows,
                                  int lanes, const int* idx, int chunks,
                                  int n, int* out, cudaStream_t stream) {
  if (!shape_ok(n_tab, rows, lanes, chunks, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  return use_staged(n_tab, rows, lanes, chunks, n)
             ? launch_staged(tabs, n_tab, rows, lanes, idx, chunks, n, out,
                             stream)
             : launch_direct(tabs, n_tab, rows, lanes, idx, chunks, n, out,
                             stream);
}

// One path whatever the rule says (staged: 1 or 0), for the A/B of the two
// paths on one shape; the staged path refuses a shape whose slab does not
// fit.
extern "C" int trident_lut_gather_path(const int* tabs, int n_tab, int rows,
                                       int lanes, const int* idx, int chunks,
                                       int n, int* out, int staged,
                                       cudaStream_t stream) {
  if (!shape_ok(n_tab, rows, lanes, chunks, n) ||
      (staged && !staged_fits(n_tab, rows, lanes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  return staged ? launch_staged(tabs, n_tab, rows, lanes, idx, chunks, n, out,
                                stream)
                : launch_direct(tabs, n_tab, rows, lanes, idx, chunks, n, out,
                                stream);
}
