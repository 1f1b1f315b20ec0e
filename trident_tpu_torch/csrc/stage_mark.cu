// Stage marks: one single-thread kernel at each stage boundary of the
// frame, writing the card's %globaltimer (ns) into a per-device ring, so
// that a replayed frame graph, whose kernels no host range can tell
// apart, still says when each of its stages started.
//
// The ring (utils/profiling.py::stage_ring) is int64: ring[0] counts
// frames, ring[1] says whether to stamp (the tracer is on), then
// RING_FRAMES rows of kSlots stamps. The `frame` mark advances the
// counter and, when stamping, clears its row and stamps slot 0; every
// other mark stamps its stage's slot in the counter's row. The counter
// and the switch live on the device, so marks captured once into a graph
// pick a new row in every replay and follow the tracer. Each stage is a
// `__global__` of its own, `stage_mark_<stage>`, so that a profiler trace
// can split device records by name alone, stamped or not.
//
// The timer is read only while stamping. The field's replayed frame
// starts a process 0.27 ms (3.7%) slower and speeds up within seconds; on
// an H100 with %globaltimer read in every frame it stayed slow through
// whole 14 s runs in 6 of 8 processes, without the read in 0 of 17.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kFrames = 64;   // RING_FRAMES
constexpr int kSlots = 16;                   // RING_SLOTS
constexpr int kSeqSlot = 15;                 // SEQ_SLOT
constexpr int kHeader = 2;                   // RING_HEADER

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(unsigned long long* ring, int stage) {
  if (!ring[1]) return;
  const unsigned long long seq = ring[0];
  ring[kHeader + (seq % kFrames) * kSlots + stage] = global_ns();
}

__global__ void stage_mark_frame(unsigned long long* ring) {
  const unsigned long long seq = ring[0] + 1;
  ring[0] = seq;
  if (!ring[1]) return;
  unsigned long long* row = ring + kHeader + (seq % kFrames) * kSlots;
  for (int i = 1; i < kSlots; ++i) row[i] = 0;
  row[kSeqSlot] = seq;
  row[0] = global_ns();
}

#define STAGE_MARK(name, slot)                                  \
  __global__ void stage_mark_##name(unsigned long long* ring) { \
    stamp(ring, slot);                                          \
  }

STAGE_MARK(geometry, 1)
STAGE_MARK(shadow, 2)
STAGE_MARK(binning, 3)
STAGE_MARK(visibility, 4)
STAGE_MARK(resolve, 5)
STAGE_MARK(shading, 6)
STAGE_MARK(post, 7)
STAGE_MARK(warp, 8)
STAGE_MARK(upscale, 9)
STAGE_MARK(end, 10)

#undef STAGE_MARK

}  // namespace

// stage: the index of utils/profiling.py::STAGES.
extern "C" int trident_stage_mark(int stage, unsigned long long* ring,
                                  cudaStream_t stream) {
  switch (stage) {
    case 0: stage_mark_frame<<<1, 1, 0, stream>>>(ring); break;
    case 1: stage_mark_geometry<<<1, 1, 0, stream>>>(ring); break;
    case 2: stage_mark_shadow<<<1, 1, 0, stream>>>(ring); break;
    case 3: stage_mark_binning<<<1, 1, 0, stream>>>(ring); break;
    case 4: stage_mark_visibility<<<1, 1, 0, stream>>>(ring); break;
    case 5: stage_mark_resolve<<<1, 1, 0, stream>>>(ring); break;
    case 6: stage_mark_shading<<<1, 1, 0, stream>>>(ring); break;
    case 7: stage_mark_post<<<1, 1, 0, stream>>>(ring); break;
    case 8: stage_mark_warp<<<1, 1, 0, stream>>>(ring); break;
    case 9: stage_mark_upscale<<<1, 1, 0, stream>>>(ring); break;
    case 10: stage_mark_end<<<1, 1, 0, stream>>>(ring); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
