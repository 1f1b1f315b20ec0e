"""One captured CUDA graph per frame key: the card's counterpart of the JAX
package's one jit per static frame shape (render_frame_bundled).

A graph bakes in the addresses of every tensor it reads, so its key holds
more than the JAX jit cache keys on: the bundle's shape, the frame size,
every static of render_frame, the kernel knobs, whether a previous frame
(`prev`) is warped in, the shape of the AI image, the versions of the
device-resident inputs (geometry, plan, textures, upscaler), the skybox
level's shape and version, and the custom shader's version. A new plan
or texture table is a new key; the JAX cache recompiles on shapes alone.

Each graph owns device buffers for the two blobs, for `prev` and for the
AI image (the interpolated frame that the display frame is mixed with; a
new one arrives every few frames, so it is an input, not a baked
address). A frame (`run`):

  1. the host blobs go into a pinned staging buffer of a small ring, one
     buffer per frame in flight, each guarded by a CUDA event so that it
     is not rewritten while its last copy may still run;
  2. `copy_(non_blocking=True)` moves them on the current stream (and
     `prev` and the AI image are copied device to device);
  3. the graph replays on the current stream;
  4. the outputs are cloned out of the graph's pool: frames in flight, the
     idle cache, `prev_state` and picking keep earlier outputs, which the
     next replay would overwrite.

`run_rows` is the device-throughput form (the counterpart of the JAX
bench's `lax.scan` over stacked frames): the blobs are row k of device
tensors uploaded once, copied device to device on the current stream,
and the graph's own outputs are returned, valid until its next replay.
No host-to-device copy, no synchronize.

A new key captures: one eager warm-up run on a side stream (the kernel
library loads, the allocator and cuDNN settle outside the capture), then
the capture, in the thread-local error mode: another thread's CUDA work
(the FrameGenerator's worker, on its own stream) neither fails nor
invalidates it. The launches that _build.LAUNCHES counts during the
capture, of the entry points in LISTED, are the graph's launch list;
replays count none (they launch one graph, not kernels), so each
FrameGraphs tallies the launches its captures recorded (`captured`) and
its replays ran (`replayed`). A capture or replay that fails raises:
there is no eager fallback on the card. At most `capacity` graphs are
kept, least recently used first out; an evicted graph's pool is freed.

The tracer (utils/profiling.py) times `run` and `run_rows` as the span
`submit`, with `submit.stage` (the pinned copy and the copies in),
`submit.capture` (a new key only), `submit.replay` and `submit.clone`;
the blocking waits as `wait.slot` (a staging slot's last copies) and
`wait.evict` (an evicted graph's last replay); `upload.bytes` counts the
blob bytes staged, `captures` and `evictions` are read from here, and
`run_rows` ticks a frame (`render_viewport` ticks `run`'s).
"""

from __future__ import annotations

import weakref
from collections import Counter, OrderedDict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops.kernel_knobs import KernelKnobs
from trident_tpu_torch.render.bundle import BundleShape
from trident_tpu_torch.render.types import FrameOutput
from trident_tpu_torch.utils.profiling import TRACER, stage_ring


# The entry points a capture lists (render-path kernels, without
# "trident_"): those whose device records benchmark/trace.py::
# KERNEL_RECORDS names, because its whole() holds every launch-list key to
# its own record pattern, and a key it lacks would make no traced stretch
# whole. So the geometry kernels (trident_skinned_*,
# trident_rigid_geometry), the shading kernel (trident_deferred_shade), the
# binning kernels (trident_bin_*) and the stage marks (trident_stage_mark)
# launch in captures but stay off the list until that table names them.
_RESOLVE_KERNELS = ("visibility_resolve", "resolve", "resolve_tiled")
LISTED = frozenset(
    ["texel", "texel_planar", "shadow_taps", "warp"]
    + [k + band for k in ("visibility", "visibility_depth", "visibility_ck")
       for band in ("", "_band")]
    + [k + vc + band + prec for k in _RESOLVE_KERNELS for vc in ("", "_vc")
       for band in ("", "_band") for prec in ("", "_bf16")])


def _listed_launches() -> Counter:
    return Counter({n: _build.LAUNCHES["trident_" + n] for n in LISTED})


def frame_key(shape: BundleShape, width: int, height: int, statics: dict,
              knobs: KernelKnobs, has_prev: bool, versions: tuple,
              ai_shape: tuple, sky: Optional[tuple] = None,
              shader_version: int = 0) -> tuple:
    """The graph key of a frame: everything a capture bakes in. `statics`
    are render_frame's static keyword arguments (vertex colours and the
    sampling mode among them), `versions` those of the device-resident
    inputs (geometry, plan, textures, upscaler), `ai_shape` the AI
    image's, `sky` the skybox level's (shape, chain version) or None, and
    `shader_version` the custom shader's (render/shader_hook.py)."""
    return (tuple(shape), int(width), int(height),
            tuple(sorted(statics.items())), knobs, bool(has_prev),
            tuple(versions), tuple(ai_shape), sky, int(shader_version))


# the FrameGraphs instances alive in this process
LIVE: "weakref.WeakSet" = weakref.WeakSet()


class FrameGraph(NamedTuple):
    """One captured frame: the graph, its input buffers and outputs."""

    graph: torch.cuda.CUDAGraph
    f32: torch.Tensor                 # the blobs' device buffers
    i32: torch.Tensor
    prev: Optional[Tuple[torch.Tensor, torch.Tensor]]
    ai: torch.Tensor                  # the AI image's buffer
    out: FrameOutput                  # outputs in the graph's pool
    launch_list: Dict[str, int]       # kernel launches per replay
    keep: tuple                       # the device-resident inputs it reads


class _Slot:
    """One pinned staging buffer pair and the event after its copies."""

    def __init__(self) -> None:
        self.f32: Optional[torch.Tensor] = None
        self.i32: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None


def _pinned(buf: Optional[torch.Tensor], n: int, dtype) -> torch.Tensor:
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
    return buf


class FrameGraphs:
    """The graph cache of one Renderer on one CUDA device. Every live
    instance is in LIVE (utils/profiling.py::compilation_stats sums their
    captures)."""

    def __init__(self, device, capacity: int = 4, staging: int = 3) -> None:
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"frame graphs need a CUDA device, not "
                             f"{self.device}")
        self.capacity = capacity
        self._graphs: "OrderedDict[tuple, FrameGraph]" = OrderedDict()
        self._ring = [_Slot() for _ in range(staging)]
        self._next = 0
        self.captures = 0
        self.evictions = 0
        self.replays = 0
        # kernel name → launches that captures recorded into graphs
        # (_build.LAUNCHES counts them, but nothing runs) / that replays ran
        self.captured: Counter = Counter()
        self.replayed: Counter = Counter()
        self.last_key: Optional[tuple] = None
        self.last_launches: Dict[str, int] = {}
        stage_ring(self.device)      # the stage marks' ring, before captures
        LIVE.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def graph(self, key: tuple) -> FrameGraph:
        """The graph captured for `key` (KeyError if none is kept)."""
        return self._graphs[key]

    def stage(self, g: FrameGraph, f32: np.ndarray, i32: np.ndarray) -> None:
        """Host blobs → pinned slot → the graph's buffers, on the current
        stream."""
        slot = self._ring[self._next]
        self._next = (self._next + 1) % len(self._ring)
        if slot.event is not None:
            with TRACER.span("wait.slot"):
                slot.event.synchronize()    # its last copies have run
        TRACER.count("upload.bytes", f32.nbytes + i32.nbytes)
        slot.f32 = _pinned(slot.f32, f32.size, torch.float32)
        slot.i32 = _pinned(slot.i32, i32.size, torch.int32)
        np.copyto(slot.f32[:f32.size].numpy(), f32)
        np.copyto(slot.i32[:i32.size].numpy(), i32)
        g.f32.copy_(slot.f32[:f32.size], non_blocking=True)
        g.i32.copy_(slot.i32[:i32.size], non_blocking=True)
        if slot.event is None:
            slot.event = torch.cuda.Event()
        slot.event.record()

    def _capture(self, fill: Callable, n_f32: int, n_i32: int, prev, ai,
                 frame_fn, keep: tuple) -> FrameGraph:
        dev = self.device
        bufs = FrameGraph(graph=torch.cuda.CUDAGraph(),
                          f32=torch.empty(n_f32, dtype=torch.float32,
                                          device=dev),
                          i32=torch.empty(n_i32, dtype=torch.int32,
                                          device=dev),
                          prev=(None if prev is None else
                                tuple(torch.empty_like(t) for t in prev)),
                          ai=torch.empty_like(ai), out=None, launch_list={},
                          keep=keep)
        fill(bufs)
        self._copy_in(bufs, prev, ai)
        # warm-up outside the capture: the kernel library loads, lazy
        # modules and cuDNN's algorithm choice settle
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            frame_fn(bufs.f32, bufs.i32, bufs.prev, bufs.ai)
        stream.wait_stream(side)
        before = _listed_launches()
        # thread_local: only this thread's unsafe calls end the capture;
        # the FrameGenerator's worker may run its convs on its own stream
        # meanwhile (the default, global, invalidates both)
        with torch.cuda.graph(bufs.graph, capture_error_mode="thread_local"):
            out = frame_fn(bufs.f32, bufs.i32, bufs.prev, bufs.ai)
        launches = dict(_listed_launches() - before)
        self.captured.update(launches)
        self.captures += 1
        return bufs._replace(out=out, launch_list=launches)

    @staticmethod
    def _copy_in(g: FrameGraph, prev, ai) -> None:
        """`prev` and the AI image → the graph's buffers, device to device
        on the current stream."""
        if prev is not None:
            for buf, t in zip(g.prev, prev):
                buf.copy_(t, non_blocking=True)
        g.ai.copy_(ai, non_blocking=True)

    def _evict(self, keep: int) -> None:
        """Free least recently used graphs until `keep` are left."""
        while len(self._graphs) > keep:
            _key, old = self._graphs.popitem(last=False)
            with TRACER.span("wait.evict"):
                torch.cuda.synchronize(self.device)  # its last replay ran
            self.evictions += 1
            old.graph.reset()
            del old
            torch.cuda.empty_cache()              # its pool

    def clear(self) -> None:
        """Free every graph and its pool."""
        self._evict(0)

    def _replay(self, key: tuple, fill: Callable, n_f32: int, n_i32: int,
                prev, ai, frame_fn, keep: tuple) -> FrameGraph:
        """Fill the graph of `key` (capturing it first if it is new) with
        fill(graph) for the blobs, `prev` and `ai`, and replay it."""
        span = TRACER.span
        g = self._graphs.get(key)
        if g is None:
            with span("submit.capture"):
                self._evict(self.capacity - 1)
                g = self._capture(fill, n_f32, n_i32, prev, ai, frame_fn,
                                  keep)
            self._graphs[key] = g
        else:
            self._graphs.move_to_end(key)
            with span("submit.stage"):
                fill(g)
                self._copy_in(g, prev, ai)
        with span("submit.replay"):
            g.graph.replay()
        self.replayed.update(g.launch_list)
        self.replays += 1
        self.last_key = key
        self.last_launches = dict(g.launch_list)
        return g

    def run(self, key: tuple, f32: np.ndarray, i32: np.ndarray, prev, ai,
            frame_fn, keep: tuple = ()) -> FrameOutput:
        """The frame for `key`: replay its graph (capturing it first if it
        is new) on host blobs `f32`, `i32`, on `prev` ((history,
        view·proj) device tensors or None) and on the AI image `ai` (a
        device tensor), and return clones of its outputs.
        `frame_fn(f32, i32, prev, ai)` computes the frame from device
        tensors (render_frame_bundled with everything else bound); `keep`
        holds the device-resident tensors it reads, alive while the graph
        is."""
        with TRACER.span("submit"):
            g = self._replay(key, lambda g: self.stage(g, f32, i32),
                             f32.size, i32.size, prev, ai, frame_fn, keep)
            with TRACER.span("submit.clone"):
                return FrameOutput(*(None if t is None else t.clone()
                                     for t in g.out))

    def run_rows(self, key: tuple, f32_rows: torch.Tensor,
                 i32_rows: torch.Tensor, k: int, prev, ai, frame_fn,
                 keep: tuple = ()) -> FrameOutput:
        """`run` on row k of the device tensors `f32_rows` (frames, n_f32)
        and `i32_rows` (frames, n_i32), copied device to device on the
        current stream, with no host-to-device copy and no synchronize.
        Returns the graph's own outputs, which its next replay
        overwrites; `prev` may be them (they are copied in first)."""
        def fill(g: FrameGraph) -> None:
            g.f32.copy_(f32_rows[k], non_blocking=True)
            g.i32.copy_(i32_rows[k], non_blocking=True)

        TRACER.frame()
        with TRACER.span("submit"):
            return self._replay(key, fill, f32_rows.shape[1],
                                i32_rows.shape[1], prev, ai, frame_fn,
                                keep).out
