#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trident_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. print the card (nvidia-smi name, power limit) and the torch build;
     require a CUDA device
  2. build the kernels from trident_tpu_torch/csrc (one nvcc per source,
     in parallel, timed)
  3. on the spheres1080_1m frame (1920×1080, 36×36 spheres ≈ 995k
     triangles, 128² checker — the bench.py default scene), hold each
     main-pass kernel against its plain PyTorch version on that frame's
     own intermediates, and time both (CUDA events, median of 10 after
     warm-up): visibility ids equal and depth bit-equal, resolve channels
     within RESOLVE_TOL, texel bit-equal; the share of (triangle, warp
     region) pairs the visibility kernel's region test keeps, per tile
     max / mean, and the card's SM clock, power and temperature before and
     after the timing window; K2's busy time over K1's in that window and
     K2 with the L2 flushed before each launch; the stage times, among
     them the record table's producer alone
  4. render that scene through the port's Renderer for 12 frames while
     rotating the entities as bench.py does: aux == [0, 0] every frame,
     every kernel's launch count rose, the frame is not all clear color;
     print the median frame time
  5. render the 256² cube of render_frame_entry() and hold it against the
     JAX package's frame (tests/goldens/torch_slice_cube256.npy) under the
     golden gate: < 0.2% of channel values off by > 3 LSB, mean < 0.35
  6. shadows1080 (bench.py's scene: 12×12 spheres before a backdrop, a
     shadow-casting sun, 1920×1080, a 1024² hard shadow map): on that
     frame's own light-pass bins, hold the depth-only visibility kernel
     against its plain version and against the colour kernel's depth (bit-
     equal, ±0 equal); hold the shadow-taps kernel against its plain
     version at 1 and 4 taps (bits equal); time each (the hard taps also
     with the L2 flushed before each launch) and the stages of the light
     pass and the shadowed shading, and print the light pass's kept share
     of (triangle, region) pairs; render 12 rotating frames and one
     PCF frame through the Renderer: aux [0, 0] on the main and the light
     pass, every kernel of the path launched, and > 1% of covered pixels
     shadowed
  7. ultra4k (36×36 spheres, 3840×2160, bloom): three frames through the
     Renderer, aux [0, 0], the frame time
  8. the post and shadow flavors of the golden-flavor scene at 128²
     (shadows hard and PCF at a 256² map, bloom, 2× supersampling) against
     the JAX package's frames tests/goldens/torch_slice_<flavor>.npy under
     the golden gate
  9. spheres1080_1m:ai (the spheres1080_1m scene with ai_upscale: a
     960×540 render, the shipped temporal upscaler, 1920×1080 out): on a
     frame after rotating the entities and orbiting the camera, hold the
     warp kernel against its plain version on that frame's own history
     and block indices (bit-equal over all 518,400 pixels) and time it
     beside the indexing call; on that frame's own 960×540 ids (540 rows
     end in a partial 32×8 block row) hold the resolve kernel against its
     plain version (within RESOLVE_TOL per channel) and the tiled resolve
     against it permuted; render 12 chained frames through the
     Renderer: aux [0, 0], the output and history shapes, the raster
     kernels launched every frame and the warp kernel every frame after
     the first; print the frame and stage times; then the two AI-upscaled
     128² frames of the golden-flavor scene against
     tests/goldens/torch_slice_ai_upscale.npy under the golden gate
 10. the kernel-knob frame (RenderConfig.kernel) at spheres1080_1m: on the
     frame's own intermediates hold the compact-bank visibility kernel
     (ckern) against K1 and its plain version (ids equal, depth bit-equal),
     the fused visibility + resolve kernel (fuse) against K1 + K2 (depth
     and ids bit-equal, attributes within RESOLVE_TOL), the tiled resolve
     against K2 permuted and the planar texel kernel against K3 (bit-
     equal); time each and the tiled shading stage beside
     deferred_shade_attrs; render 12 rotating frames each with
     {"ckern": True, "dynhit": False} and {"fuse": True, "tiled_shade":
     True}: aux [0, 0], each knob kernel launched once a frame, K1 and K2
     never under fuse, the ckern frame bit-equal to the default-knob
     frame and the tiled frame within the tiled-shading gate (max 2 LSB,
     < 0.2% of values over 1); one shadows1080 PCF frame with
     tiled_shade (aux [0, 0] on both passes, > 1% of covered pixels
     shadowed, the same gate against the default-knob frame); the three
     128² knob frames against tests/goldens/torch_slice_knobs_<name>.npy
     under the golden gate; the compact-bank kernel also at ck_bank 3
     and 16 and with pad pairs (nhit 0) inside tile ranges against its
     plain version; K1, K2, K1-CK, K-FUSE, tiled K2 and K1 + tiled K2
     timed in one window on the same bins, the card's clock sampled
     around it; the planar texel kernel also with the L2 flushed before
     each launch
 11. the tools_dev probes (trident_tpu_torch/tools_dev) on phase 3's
     spheres1080_1m bins: each kbench config (zero, dflt, full, nobranch,
     dual, probe, probe_tiny; zero/dflt/full also through the compact-bank
     kernel) bit-equal to its plain version and to the frame it must give
     (K1's for dflt and dual, K1's on full masks for nobranch, background
     for zero and the reset probes; K1 on full masks may differ from K1
     only by bbox-culled rounding hits, at most 1 pixel in 10,000); the
     LUT gather at the three probe shapes and a ragged one (3 chunks of
     2500 rows, indices outside the table) bit-equal to its plain version,
     numpy and torch.gather, through the path its rule picks and through
     each path forced (the direct / staged A/B, busy); the split select
     at rw 27 and 32 (K1/K2/K3 forms) bit-equal to its plain version and
     exact against host_parts, and with device chunks that push columns
     outside the row (NaN exactly there); each probe kernel's times and
     bound (the reset probes also with the L2 flushed before each launch),
     the host µs per call of the gather and split-select wrappers and
     their library calls (1000 back-to-back calls), and the launch floor
     (the busy time of a one-element add_); then the tools' own runs (kbench with
     and without ckern, its --bins and --sort legs, the gather and split
     probes) as this phase's main path, the card's clock sampled before
     and after kbench, and kbench's dflt through K1 beside its dflt
     through the compact-bank kernel
 12. the interactive frame loop (Renderer.render_viewport replays one
     captured CUDA graph per frame key, render/graphs.py): 12 rotating
     spheres1080_1m frames, each bit-equal to eager render_frame on the
     same inputs (color, depth, tri_id, aux [0, 0]), one capture, a
     profiling window of replays whose kernel records are K1, K2 and K3
     by name and count (the graph's launch list times the replays), the
     memory reserved before and after the capture; the interactive loop
     of bench.py:327-374 on 50 bundles packed ahead, eager
     render_frame_bundled against replays in one window with the card's
     clock sampled around it (device frame, busy, activities, idle, wall
     FPS, host µs per frame), the host-to-device copies per frame and the
     replay's host parts; host draw gathering, the per-record loops
     against the batched forms and the whole frame_bundle (bit-equal,
     alternating in one window, tools_dev/host_gather.py); draw_frame over
     viewport 0 and a 960×540 viewport 2 through a bound runtime camera
     (idle-cache hits with no replay, a transform change replays both,
     pick at the centre against the eager frame); replays bit-equal to
     eager on shadows1080 (hard, PCF; the light pass's aux [0, 0]),
     spheres1080_1m:ai (three chained frames: the first its own graph,
     then one graph with prev copied in), the fuse + tiled_shade frame
     and ultra4k; each cell's graph replayed alone (device frame, busy,
     activities, idle) in profiling windows whose kernel records must be
     the graph's launch list times the replays
 13. the port's bench (trident_tpu_torch/bench.py, bench_sweep.py) in
     process over all 11 entries: bench.py's five configs, each also
     :ai, and interp, at 30 frames; each JSON line printed as it comes,
     with bench.py's keys and aux [0, 0], no bench_error line, the card's
     clock sampled around the sweep; on spheres1080_1m the throughput
     mode's frames 0, 7, 14, 21 and 28 bit-equal to FrameGraphs.run on
     the same blobs; on every render entry the busy time of a window of
     its throughput replays, and its FPS at most 1.05 × 1000 / that busy
     time; the interpolation net from the port's npz on
     the card against itself on the CPU (within 1e-4); FrameGenerator on
     four 1920×1080 frames (an output within 10 s, its telemetry filled
     in); one spheres1080_1m frame with set_ai_frame(img, 0.5) through
     render_viewport bit-equal to eager render_frame, and a second AI
     frame that misses the idle cache and replays the same graph
 14. the forward frame's features at spheres1080_1m (the sphere mesh
     vertex-coloured 0.5 + 0.5·n, the gradient skybox at 256² faces with a
     128² and a 64² level, 64 animated sprites from a 2×2 atlas, trilinear
     sampling; tools_dev/scenes.py::build_feature_scene): on the frame's
     own ids and (T, 40) records the 40-wide resolve instances against
     their plain versions (K2-vc within RESOLVE_TOL, tiled K2-vc against
     K2-vc permuted, K-FUSE-vc against K1 + K2-vc with depth and ids
     bit-equal), the 32-wide K2 on phase 3's records against its plain
     version (bits counted), K2 and K2-vc timed in one window with their
     bounds and the card's clock around it, the stages ("records" and
     "shading" beside spheres1080_1m's); 12 rotating frames each through
     render_viewport with the default knobs, tiled_shade (bilinear) and
     fuse: each replay bit-equal to its eager frame, aux [0, 0], the vc
     instance launched once a frame and the 32-wide one never, the sky
     not the clear colour, the sprites covering pixels; device frame and
     busy times, memory reserved; then the 128² feature flavors
     (pallas_forward, vcolor, skybox, trilinear, nearest, sprite, mips,
     shader) against tests/goldens/torch_slice_<name>.npy under the
     golden gate
 15. the routes of the reference raster, the plane-gather frame and the
     indexed, skinned geometry path (phase_routes): the eight 128² PNG
     goldens (tests/goldens/scene_128.png and flavor_{shadows_pcf, ssaa,
     bloom, trilinear, skybox, sprite, f16_planes}.png, read without PIL)
     through render_viewport under the golden gate; the plane-gather
     frame (forward_shading=False) at spheres1080_1m with f16 and f32
     planes and at shadows1080 hard and PCF: K1 on its bins and K3 on its
     texel indices bit-equal to their plain versions, 12 rotating frames
     each with every replay bit-equal to eager render_frame, the f32-plane
     frame within the gate of the forward frame and the f16 one of the f32
     one (PSNR printed); the skinned tube crowd at 1080p (1,105,920
     triangles, 2,304 bones, tools_dev/scenes.py::skinned_scene): K2-vc
     and K2 on its records within RESOLVE_TOL of their plain versions, 12
     frames whose poses change, replays bit-equal to eager; a shadowed
     frame through the indexed light pass (1024² map) with K1b and K4
     bit-equal to their plain versions; the 128² skinned frames against
     tests/goldens/torch_slice_skinned{,_shadow}.npy; each new frame's
     replay alone (device, busy and idle time), and the stages of the
     three routes beside spheres1080_1m's forward stages in one window
Then it prints the kernels as one JSON line (each entry with
`route_launches`: its launches in each of phase 15's route runs), the
card line, and as the last line {"ok": true, "device": {...}}.

Since phase 12's slice the Renderer's frames on the card are graph
replays, which tick no kernel wrapper's launch count: a kernel's
`launches` (and every "launches" a phase prints) is how often it ran in
that phase's main-path run: its wrapper's count, less the launches the
run's captures recorded, plus those its replays ran (each Renderer's
`graphs.captured` and `graphs.replayed`, read by `drive`).

bound_ms is the least time the card could take for a kernel's work: the
larger of its bytes (each input read once, each output written once,
counted from this run's data) over 3.35 TB/s and its f32 operations over
67 TFLOP/s (H100 SXM data sheet; the card's power limit is printed
beside). The visibility kernels' operations are those their inputs need,
whatever the kernel's design: 22 per (triangle, pixel) inside each
triangle's bbox, clipped to its tile (vis_work; the region design's and
the full sweep's counts are printed beside).
The helpers it shares with the probe tools live in
trident_tpu_torch/tools_dev/timing.py and scenes.py.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from trident_tpu_torch.tools_dev.scenes import (  # noqa: E402
    FEATURE_FLAVORS,
    FEATURE_SPRITES,
    build_bench_scene,
    build_feature_scene,
    feature_scene,
    rotate,
)
from trident_tpu_torch.tools_dev.scenes import (  # noqa: E402
    golden_base_scene as base_scene,
)
from trident_tpu_torch.tools_dev.timing import (  # noqa: E402
    VIS_OPS_PER_PAIR,
    bound,
    cuda_ms,
    device_busy,
    graph_records,
    l2_flush,
    smi_sample,
)
from trident_tpu_torch.tools_dev.timing import card as card_line  # noqa: E402

GOLDENS = ROOT / "tests" / "goldens"
BENCH_GRID = 36
SHADOW_GRID = 12
RESOLVE_TOL = 1e-6       # max |kernel − plain| per channel (log2 may differ
                         # by an ulp between libms; everything else is exact)
GOLDEN_LSB, GOLDEN_FRAC, GOLDEN_MEAN = 3, 0.002, 0.35
# the golden-flavor scene's configs (tests/test_torch_frame.py FLAVORS)
FLAVORS = {
    "shadows_hard": dict(shadows=True, shadow_map_size=256),
    "shadows_pcf": dict(shadows=True, shadow_map_size=256, shadow_pcf=True),
    "bloom": dict(bloom=True, bloom_threshold=0.35, bloom_strength=0.8),
    "ssaa": dict(supersample=2),
}
# the knob flavors of the same scene (tests/test_torch_frame.py
# KNOB_FLAVORS)
KNOB_FLAVORS = {
    "fuse_tiled": dict(kernel={"fuse": True, "tiled_shade": True}),
    "ckern": dict(shadows=True, shadow_map_size=256,
                  kernel={"ckern": True, "dynhit": False}),
    "tiled_pcf": dict(shadows=True, shadow_map_size=256, shadow_pcf=True,
                      kernel={"tiled_shade": True}),
}
CKERN = {"ckern": True, "dynhit": False}
FUSE_TILED = {"fuse": True, "tiled_shade": True}
# the tiled-shading gate of tests/test_deferred_tiled.py:69-71 against the
# legacy shading path: max 2 LSB, fewer than 0.2% of values off by > 1
TILED_LSB, TILED_FRAC = 2, 0.002


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def print_stages(what: str, stages: dict, card: str) -> None:
    """Each stage alone: CUDA-event ms (median of 10) and device busy ms
    (torch.profiler)."""
    print(f"{what} (ms, events / device busy): " + ", ".join(
        f"{name} {cuda_ms(fn):.4f} / {device_busy(fn)[0]:.4f}"
        for name, fn in stages.items()) + f" ({card})", flush=True)


def golden_gate(frame: np.ndarray, ref: np.ndarray, what: str,
                against: str = "JAX reference") -> None:
    if frame.shape != ref.shape:
        fail(f"{what} frame shape {frame.shape} vs reference {ref.shape}")
    diff = np.abs(frame.astype(np.int32) - ref.astype(np.int32))
    frac, mean = float((diff > GOLDEN_LSB).mean()), float(diff.mean())
    print(f"{what} vs {against}: {frac:.6f} of values > {GOLDEN_LSB} "
          f"LSB, mean {mean:.6f}, max {int(diff.max())}", flush=True)
    if not (frac < GOLDEN_FRAC and mean < GOLDEN_MEAN):
        fail(f"{what} frame outside the golden gate")


class VisWork(NamedTuple):
    bytes: int        # each hit sub-block's records once, pairs, outputs
    ops: int          # 22 f32 ops per (triangle, pixel) in its tile's bbox
    region_ops: int   # the same over the pixels of kept 16×8 regions
    sweep_ops: int    # the same over every pixel of every hit sub-block
    kept: object      # (n_tiles,) kept (triangle, region) pairs per tile
    n_hit: int        # hit sub-blocks


def vis_work(bins, setup, ntx: int, n_tiles: int,
             out_bytes_per_px: int) -> VisWork:
    """The work of a visibility kernel on `bins` (triangle setup `setup`):
    every hit 16-triangle sub-block's 1 KB of records once, the pair lists,
    the outputs; 22 f32 ops per (triangle, pixel) pair that the inputs
    need, whatever the kernel's design — each triangle's pixels in its
    bbox, clipped to the tile (kbench.bbox_pixel_pairs). Beside it, the
    designs' own counts: region_ops over the 128 pixels of each (triangle,
    16×8 region) pair that the region test keeps (raster.region_kept),
    sweep_ops over every pixel of every hit sub-block."""
    import torch

    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.tools_dev.kbench import bbox_pixel_pairs

    n = int(bins.n_real)
    q = torch.arange(raster.NSUB, device=bins.pair_mask.device)
    hit = ((bins.pair_mask[:n, None] >> q) & 1) != 0
    n_hit = int(hit.sum())
    subs = (bins.pair_chunk[:n, None].long() * raster.NSUB + q)[hit]
    n_unique = int(torch.unique(subs).numel())
    bytes_moved = (n_unique * raster.SUB * raster.REC * 4 + n * 12
                   + (n_tiles + 1) * 4 + n_tiles * raster.TILE_PX
                   * out_bytes_per_px)
    kept = raster.region_kept(bins, ntx, n_tiles)
    region_px = raster.REGION_W * raster.REGION_H
    return VisWork(bytes_moved,
                   bbox_pixel_pairs(bins, setup, ntx) * VIS_OPS_PER_PAIR,
                   int(kept.sum()) * region_px * VIS_OPS_PER_PAIR,
                   n_hit * raster.SUB * raster.TILE_PX * VIS_OPS_PER_PAIR,
                   kept, n_hit)


def region_line(what: str, work: VisWork) -> None:
    """The region test's kept share of (triangle, region) pairs and its
    per-tile spread (max / mean over the tiles with any kept pair), and the
    operation counts: the inputs' (the bound's), the region design's and
    the sweep's."""
    from trident_tpu_torch.ops import raster

    tested = work.n_hit * raster.SUB * raster.N_REGIONS
    kept = work.kept
    n_kept = int(kept.sum())
    busy = kept[kept > 0].double()
    print(f"{what}: the region test keeps {n_kept} of {tested} (triangle, "
          f"16x8 region) pairs ({n_kept / max(tested, 1):.4f}); per tile "
          f"max {int(kept.max())} / mean {float(busy.mean()):.1f} over "
          f"{busy.numel()} tiles with work; ops {work.ops} (bbox pixels), "
          f"region_ops {work.region_ops}, sweep_ops {work.sweep_ops}",
          flush=True)


def cold_line(what: str, fn, b_ms: float, flush, card: str) -> None:
    """fn timed with the L2 flushed before each launch (flush(), outside
    the timed window), as a caller that ran other work first finds it, and
    its bound's share of that busy time. A kernel whose warm inputs stay in
    the 50 MB L2 across launches can otherwise beat its bytes bound."""
    cold = device_busy(fn, flush=flush)[0]
    print(f"{what} with the L2 flushed before each launch: "
          f"{cuda_ms(fn, flush=flush):.4f} ms events / {cold:.4f} ms busy, "
          f"bound {b_ms:.4f} ms ({b_ms / cold:.3f} of busy) ({card})",
          flush=True)


def phase_ai(dev, card: str, kernel_fns: dict, drive, results: dict) -> dict:
    """Phase 9, spheres1080_1m:ai: the warp kernel against its plain
    version, 12 upscaled frames through the Renderer, the stage times and
    the two 128² AI frames against the JAX package's; adds the warp to
    `kernel_fns` and `results` and returns the 12 frames' launch counts."""
    import torch

    from trident_tpu_torch.ai import upscaler as up
    from trident_tpu_torch.ops import raster, resolve, warp
    from trident_tpu_torch.ops.deferred import pack_rgba8
    from trident_tpu_torch.render.renderer import frame_geometry, render_frame

    kernel_fns["warp"] = warp.warp_fetch
    r, reg = build_bench_scene(BENCH_GRID, dev, ai=True)
    w, h = r.config.render.width, r.config.render.height
    net = r._upscale_params()

    # (a) the kernel on a moving-camera frame's own history and indices
    rotate(reg, 0)
    r.render_viewport()
    prev0 = r.prev_state
    rotate(reg, 1)
    r.editor_camera.orbit([0.0, 0.0, 0.0], 3.0, 2.0)
    out1 = r.render_viewport()
    torch.cuda.synchronize()
    hist, prev_vp = prev0
    cam = r.editor_camera.params(dev)
    d_half = out1.depth[::2, ::2].contiguous()
    by, bx, in_bounds, ok = up.warp_indices(
        hist, d_half, torch.linalg.inv(cam.proj @ cam.view), prev_vp, w, h)
    bym = torch.where(ok, by, -1).contiguous()
    bxm = torch.where(ok, bx, -1).contiguous()
    f_k = warp.warp_fetch(hist, bym, bxm)
    f_p = warp.warp_fetch_ref(hist, bym, bxm)
    torch.cuda.synchronize()
    n_px = bym.numel()
    bad = int((f_k.view(torch.int32) != f_p.view(torch.int32)).sum())
    if bad or tuple(f_k.shape) != (h // 2, w // 2, 12):
        fail(f"warp kernel disagrees on {bad} of {f_k.numel()} values "
             f"(shape {tuple(f_k.shape)})")
    n_valid = int(ok.sum())
    n_dropped = int((in_bounds & ~ok).sum())
    print(f"spheres1080_1m:ai warp: {n_px} pixels, {n_valid} valid, "
          f"{n_dropped} band-dropped, {int(in_bounds.sum())} in bounds; "
          "kernel bit-equal to its plain version", flush=True)
    if n_valid == 0:
        fail("the moving-camera frame warped no pixel")
    n_blocks = int(torch.unique((bym * (w // 2) + bxm)[ok]).numel())
    res = dict(
        route="cuda", source="trident_tpu_torch/csrc/warp.cu",
        replaces="trident_tpu/ops/warp_pallas.py:68",
        max_abs_err=float((f_k - f_p).abs().max()),
        ms=cuda_ms(lambda: warp.warp_fetch(hist, bym, bxm)),
        plain_ms=cuda_ms(lambda: warp.warp_fetch_ref(hist, bym, bxm)),
        # one PyTorch indexing call for the same fetch (no −1 mask, uint8)
        library_ms=cuda_ms(lambda: hist[bym.clamp(min=0),
                                        bxm.clamp(min=0)]))
    # per pixel the two i32 indices in and 12 f32 out; each fetched block's
    # 12 history bytes once
    res.update(zip(("bound_ms", "bound_by"),
                   bound(n_px * (8 + 48) + n_blocks * 12)))
    results["warp"] = res
    busy = [device_busy(fn)[0] for fn in (
        lambda: warp.warp_fetch(hist, bym, bxm),
        lambda: warp.warp_fetch_ref(hist, bym, bxm),
        lambda: hist[bym.clamp(min=0), bxm.clamp(min=0)])]
    print(f"warp: kernel {res['ms']:.4f} ms (device busy {busy[0]:.4f} ms), "
          f"plain {res['plain_ms']:.4f} ms (busy {busy[1]:.4f}), indexing "
          f"call {res['library_ms']:.4f} ms (busy {busy[2]:.4f}), bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {n_blocks} distinct "
          f"blocks) ({card})", flush=True)
    del f_k, f_p, by, bx, in_bounds, ok, out1

    # (a2) the resolve kernel on that frame's own 960×540 ids: 540 rows end
    # in a partial 32×8 block row (540 % 8 = 4), which phase 3's 1080 rows
    # never reach; the tiled resolve against it permuted on the same ids
    inp = r.frame_inputs()
    hw, hh = inp["width"], inp["height"]
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=hw, height=hh,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    bins = raster.build_bins(cs.setup, hw, hh, setup_cols=cs.cols.setup)
    ntx, nty = -(-hw // raster.TILE), -(-hh // raster.TILE)
    t_k = raster.visibility_tiles(bins, ntx, ntx * nty)[1]
    tri = raster.untile_frame(t_k, ntx, nty)[:hh, :hw].contiguous()
    a_k = resolve.resolve_attrs(tri, records)
    a_p = resolve.resolve_attrs_plain(tri, records)
    a_t = resolve.resolve_attrs_tiled(t_k, records, ntx)
    torch.cuda.synchronize()
    err_ch = (a_k - a_p).abs().reshape(-1, resolve.CHANNELS).amax(0)
    err_t = float((raster.untile_channels(a_t, ntx, nty)[:hh, :hw]
                   - a_k).abs().max())
    ragged = int((tri[hh - hh % 8:] >= 0).sum())
    if (bins.aux.tolist() != [0, 0]
            or tuple(a_k.shape) != (hh, hw, resolve.CHANNELS)
            or not bool(torch.isfinite(a_k).all())
            or not bool(torch.isfinite(a_t).all())
            or float(err_ch.max()) > RESOLVE_TOL
            or not err_t <= RESOLVE_TOL):
        fail(f"resolve at {hw}x{hh}: aux {bins.aux.tolist()}, shape "
             f"{tuple(a_k.shape)}, per-channel {err_ch.tolist()} against "
             f"its plain version, tiled vs K2 {err_t}")
    print(f"spheres1080_1m:ai resolve at {hw}x{hh}: per-channel max err "
          f"against its plain version {err_ch.tolist()}, tiled vs K2 "
          f"(permuted) {err_t}; {int((tri >= 0).sum())} covered pixels, "
          f"{ragged} in the last {hh % 8} rows (a partial 32x8 block row)",
          flush=True)
    del inp, cs, records, bins, t_k, tri, a_k, a_p, a_t

    # (b) 12 chained frames through the Renderer, the first without history
    clear = torch.round(torch.tensor(r.config.render.clear_color) * 255.0)
    frame_ms = []
    r.prev_state = None

    def ai_frames():
        out = None
        for k in range(12):
            rotate(reg, k)
            t0 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            # the replayed graph's launch list (replays tick no counter)
            ran = {n: r.graphs.last_launches.get(n, 0) for n in kernel_fns}
            if out.aux.tolist() != [0, 0]:
                fail(f"ai frame {k}: raster overflow aux {out.aux.tolist()}")
            if (tuple(out.color.shape) != (h, w, 4)
                    or out.color.dtype != torch.uint8
                    or tuple(out.history.shape) != (h // 2, w // 2, 12)
                    or out.history.dtype != torch.uint8):
                fail(f"ai frame {k}: color {tuple(out.color.shape)} "
                     f"{out.color.dtype}, history "
                     f"{tuple(out.history.shape)} {out.history.dtype}")
            if (min(ran[n] for n in ("visibility", "resolve", "texel")) < 1
                    or ran["warp"] != (0 if k == 0 else 1)):
                fail(f"ai frame {k}: kernel launches {ran}")
            if not bool((out.color.float().cpu() != clear).any()):
                fail(f"ai frame {k} is all clear color")
        return out

    out, launches9 = drive(ai_frames, ("visibility", "resolve", "texel",
                                       "warp"), (r,))
    wall = statistics.median(frame_ms[2:])
    inp = r.frame_inputs()
    dev_ms = cuda_ms(lambda: render_frame(**inp))
    busy_ms, n_launch = device_busy(lambda: render_frame(**inp))
    print(f"spheres1080_1m:ai frame: median {wall:.3f} ms wall per "
          f"render_viewport ({[round(t, 3) for t in frame_ms]}); "
          f"{dev_ms:.3f} ms render_frame device time, {busy_ms:.3f} ms of "
          f"it busy in {n_launch:.0f} device activities (idle "
          f"{1 - busy_ms / dev_ms:.3f}); launches {launches9} ({card})",
          flush=True)

    # where the upscaled frame's time goes, each stage on its own inputs
    half_inp = {k: v for k, v in inp.items()
                if k not in ("upscale_params", "prev")}
    half = render_frame(**half_inp)
    rgb = (half.color[..., :3].float() / 255.0).contiguous()
    alpha = half.color[..., 3:4].float() / 255.0
    d_half = half.depth
    temporal = up.temporal_from_prev(net, inp["prev"], d_half, inp["camera"],
                                     w, h)
    x = up._assemble_inputs(net, rgb, temporal, d_half)
    blocks = net(x)

    def d2s_pack():
        frame = torch.cat([up.depth_to_space(blocks),
                           alpha.repeat_interleave(2, 0).repeat_interleave(
                               2, 1)], dim=-1)
        return pack_rgba8(torch.clamp(frame, 0.0, 1.0)), up.blocks_to_u8(
            blocks)

    print_stages("spheres1080_1m:ai stages", {
        "half_frame": lambda: render_frame(**half_inp),
        "warp": lambda: up.temporal_from_prev(net, inp["prev"], d_half,
                                              inp["camera"], w, h),
        "net": lambda: net(up._assemble_inputs(net, rgb, temporal, d_half)),
        "d2s_pack": d2s_pack,
    }, card)
    del r, reg, inp, half_inp, half, out, hist, prev0, temporal, x, blocks
    torch.cuda.empty_cache()

    # (c) the two 128² AI frames against the JAX package's
    ref = np.load(GOLDENS / "torch_slice_ai_upscale.npy")
    r = base_scene(dev, ai_upscale=True)
    for k in range(2):
        if k:
            r.editor_camera.orbit([0.0, 0.0, 0.0], 6.0, 4.0)
        fr = r.render_viewport()
        if fr.aux.tolist() != [0, 0] or fr.history is None:
            fail(f"ai flavor frame {k}: aux {fr.aux.tolist()}")
        golden_gate(fr.color.cpu().numpy(), ref[k], f"ai_upscale frame {k}")
    return launches9


def tiled_gate(frame, ref, what: str) -> None:
    """A tiled-shading frame against the legacy path's frame of the same
    scene and view (uint8 RGBA on the card): max TILED_LSB, fewer than
    TILED_FRAC of values off by more than 1."""
    diff = (frame.int() - ref.int()).abs()
    mx, frac = int(diff.max()), float((diff > 1).float().mean())
    print(f"{what} vs the default-knob frame: max {mx} LSB, {frac:.6f} of "
          "values > 1", flush=True)
    if mx > TILED_LSB or not frac < TILED_FRAC:
        fail(f"{what} outside the tiled-shading gate")


def phase_knobs(dev, card: str, kernel_fns: dict, drive, results: dict):
    """Phase 10, the kernel-knob frame at spheres1080_1m: the four knob
    kernels against their plain versions and the default kernels they
    stand in for, their times and bounds, K1 against K1-CK on the same
    bins, 12 frames each of CKERN and FUSE_TILED through the Renderer, one
    shadows1080 PCF frame with tiled_shade and the 128² knob goldens; adds
    the knob kernels to `kernel_fns` and `results` and returns the
    main-path launch counts."""
    import torch

    from trident_tpu_torch.ops import deferred_tiled as dtl
    from trident_tpu_torch.ops import raster, resolve, texel
    from trident_tpu_torch.ops.deferred import (
        deferred_shade_attrs,
        texel_lookup,
        world_positions,
    )
    from trident_tpu_torch.ops.planes import RR_WIDTH
    from trident_tpu_torch.ops.shadow import shadow_factor
    from trident_tpu_torch.render.renderer import (
        _visibility_and_shade,
        frame_geometry,
        render_frame,
        shadow_params,
    )
    from trident_tpu_torch.render.types import GBuffer

    kernel_fns.update(visibility_ck=raster.visibility_ck_tiles,
                      visibility_resolve=resolve.fused_visibility_resolve,
                      resolve_tiled=resolve.resolve_attrs_tiled,
                      texel_planar=texel.sample_bilinear_planar)
    bank = 8                                  # the JAX default ck_bank

    # (a) each knob kernel on the spheres1080_1m frame's intermediates
    r, reg = build_bench_scene(BENCH_GRID, dev)
    rotate(reg, 0)
    r.editor_camera.set_viewport_size(1920, 1080)
    inp = r.frame_inputs()
    w, h = inp["width"], inp["height"]
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    n_tiles = ntx * nty
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup,
                             ck_bank=bank)
    if bins.aux.tolist() != [0, 0]:
        fail(f"ckern binning overflow on the bench frame: aux "
             f"{bins.aux.tolist()}")
    n_live = int(bins.nhit.sum())
    print(f"knobs: {int(bins.n_real)} pairs of {bins.banks.shape[0]} "
          f"compact-bank slots ({bins.banks.numel() * 4 / 2**20:.1f} MiB), "
          f"{n_live} hit sub-blocks", flush=True)

    def same_bits(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    d1, t1 = raster.visibility_tiles(bins, ntx, n_tiles)
    dc, tc = raster.visibility_ck_tiles(bins, ntx, n_tiles, bank)
    dcp, tcp = raster.visibility_ck_tiles_plain(bins, ntx, n_tiles, bank)
    torch.cuda.synchronize()
    bad = [int((tc != t1).sum()), same_bits(dc, d1), int((tc != tcp).sum()),
           same_bits(dc, dcp)]
    if any(bad):
        fail(f"compact-bank kernel disagrees: ids/depths {bad[:2]} vs K1, "
             f"{bad[2:]} vs its plain version")
    print("visibility_ck: ids and depths bit-equal to K1 and to its plain "
          f"version over {n_tiles * raster.TILE_PX} tile pixels", flush=True)
    # the kernel's schedule does not depend on ck_bank; pad pairs (nhit 0)
    # inside tile ranges issue no copy and no wait
    n_real = int(bins.n_real)
    p_idx = torch.arange(bins.nhit.shape[0], device=dev)
    padded = bins._replace(nhit=torch.where(
        (p_idx % 7 == 3) & (p_idx < n_real), 0, bins.nhit))
    cases = {f"ck_bank {b}": (raster.build_bins(
        cs.setup, w, h, setup_cols=cs.cols.setup, ck_bank=b), b, True)
        for b in (3, 16)}
    cases["pad pairs"] = (padded, bank, False)
    for what, (b, b_bank, like_k1) in cases.items():
        dk, tk = raster.visibility_ck_tiles(b, ntx, n_tiles, b_bank)
        dp, tp = raster.visibility_ck_tiles_plain(b, ntx, n_tiles, b_bank)
        torch.cuda.synchronize()
        bad = [int((tk != tp).sum()), same_bits(dk, dp)] + (
            [int((tk != t1).sum()), same_bits(dk, d1)] if like_k1 else [])
        if any(bad):
            fail(f"compact-bank kernel ({what}) disagrees: ids/depths "
                 f"{bad[:2]} vs its plain version, {bad[2:]} vs K1")
    del cases, padded, p_idx, dk, tk, dp, tp
    print("visibility_ck at ck_bank 3 and 16 bit-equal to K1 and to its "
          "plain version, and with every 7th pair a pad pair (nhit 0) "
          "bit-equal to its plain version", flush=True)

    tri = raster.untile_frame(t1, ntx, nty)[:h, :w].contiguous()
    a2 = resolve.resolve_attrs(tri, records)

    def vs_k2(a_t):
        """Tile-layout attributes against K2's (H, W, 16) image: the frame
        region (the tile layout also resolves the last tile row's padding
        pixels, which the frame crops)."""
        return float((raster.untile_channels(a_t, ntx, nty)[:h, :w]
                      - a2).abs().max())

    df, tf, af = resolve.fused_visibility_resolve(bins, records, ntx, n_tiles)
    dfp, tfp, afp = resolve.fused_visibility_resolve_plain(bins, records, ntx,
                                                           n_tiles)
    at = resolve.resolve_attrs_tiled(t1, records, ntx)
    atp = resolve.resolve_attrs_tiled_plain(t1, records, ntx)
    torch.cuda.synchronize()
    bad = [int((tf != t1).sum()), same_bits(df, d1), int((tf != tfp).sum()),
           same_bits(df, dfp)]
    err = {"fused vs K2": vs_k2(af),
           "fused vs plain": float((af - afp).abs().max()),
           "fused vs tiled": float((af - at).abs().max()),
           "tiled vs K2": vs_k2(at),
           "tiled vs plain": float((at - atp).abs().max())}
    finite = bool(torch.isfinite(af).all()) and bool(torch.isfinite(at).all())
    if any(bad) or not finite or max(err.values()) > RESOLVE_TOL:
        fail(f"fused/tiled resolve disagree: ids/depths {bad}, attrs {err}, "
             f"finite {finite}")
    print(f"visibility_resolve: depth and ids bit-equal to K1 and to its "
          f"plain version; attribute max errors {err}", flush=True)

    covered_t = t1 >= 0
    idx, fx, fy = texel_lookup(at.permute(0, 2, 1), covered_t,
                               inp["textures"].max_level)
    q = inp["textures"].quads
    xp = texel.sample_bilinear_planar(q, idx, fx, fy)
    xpp = texel.sample_bilinear_planar_plain(q, idx, fx, fy)
    x3 = texel.sample_bilinear(q, idx, fx, fy).permute(0, 2, 1)
    torch.cuda.synchronize()
    bad = [same_bits(xp, x3), same_bits(xp, xpp)]
    if any(bad):
        fail(f"planar texel kernel disagrees on {bad[0]} values with K3, "
             f"{bad[1]} with its plain version")
    print("texel_planar: bit-equal to K3 (permuted) and to its plain version",
          flush=True)

    # bounds, from this frame's data: the live bank slots (1 KB each) once,
    # nhit, tile_start and the outputs; the operations the inputs need, as
    # vis_work counts them for K1 (the same function on the same bins)
    vis = vis_work(bins, cs.setup, ntx, n_tiles, 8)
    n_px_t = n_tiles * raster.TILE_PX
    bytes_ck = (n_live * raster.SUB * raster.REC * 4
                + bins.nhit.numel() * 4 + (n_tiles + 1) * 4 + n_px_t * 8)
    n_winners = int(torch.unique(t1[t1 >= 0]).numel())
    res_bytes = n_winners * RR_WIDTH * 4 + n_px_t * 4 * (1 + 16)
    n_quads = int(torch.unique(idx[idx >= 0]).numel())
    work = {
        "visibility_ck": (
            bound(bytes_ck, vis.ops),
            "trident_tpu_torch/csrc/visibility_ck.cu",
            "trident_tpu/ops/raster_pallas.py:1239",
            float((dc - d1).abs().max()),
            lambda: raster.visibility_ck_tiles(bins, ntx, n_tiles, bank),
            lambda: raster.visibility_ck_tiles_plain(bins, ntx, n_tiles,
                                                     bank)),
        "visibility_resolve": (
            bound(vis.bytes + n_px_t * 64 + n_winners * RR_WIDTH * 4,
                  vis.ops),
            "trident_tpu_torch/csrc/visibility_resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:281", err["fused vs K2"],
            lambda: resolve.fused_visibility_resolve(bins, records, ntx,
                                                     n_tiles),
            lambda: resolve.fused_visibility_resolve_plain(bins, records, ntx,
                                                           n_tiles)),
        "resolve_tiled": (
            bound(res_bytes), "trident_tpu_torch/csrc/resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:412",
            err["tiled vs K2"],
            lambda: resolve.resolve_attrs_tiled(t1, records, ntx),
            lambda: resolve.resolve_attrs_tiled_plain(t1, records, ntx)),
        "texel_planar": (
            bound(n_px_t * (12 + 16) + n_quads * 16),
            "trident_tpu_torch/csrc/texel.cu",
            "trident_tpu/ops/texel_pallas.py:216",
            float((xp - x3).abs().max()),
            lambda: texel.sample_bilinear_planar(q, idx, fx, fy),
            lambda: texel.sample_bilinear_planar_plain(q, idx, fx, fy)),
    }
    for name, ((b_ms, b_by), src, repl, err_, fn, plain) in work.items():
        res = dict(route="cuda", source=src, replaces=repl, max_abs_err=err_,
                   ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        results[name] = res
        print(f"{name}: kernel {res['ms']:.4f} ms (device busy "
              f"{device_busy(fn)[0]:.4f} ms), plain {res['plain_ms']:.4f} ms,"
              f" bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)
    cold_line("texel_planar", work["texel_planar"][4],
              results["texel_planar"]["bound_ms"], l2_flush(dev), card)

    # one window: K1, K2, K1-CK, K-FUSE, tiled K2 and K1 + tiled K2 on the
    # same bins, events / busy each, the card's clock sampled before and
    # after (busy readings drift between windows, so designs compare side
    # by side)
    window = {
        "K1": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "K2": lambda: resolve.resolve_attrs(tri, records),
        "K1-CK": lambda: raster.visibility_ck_tiles(bins, ntx, n_tiles, bank),
        "K-FUSE": lambda: resolve.fused_visibility_resolve(
            bins, records, ntx, n_tiles),
        "tiled K2": lambda: resolve.resolve_attrs_tiled(t1, records, ntx),
        "K1 + tiled K2": lambda: resolve.resolve_attrs_tiled(
            raster.visibility_tiles(bins, ntx, n_tiles)[1], records, ntx),
    }
    smi_before = smi_sample()
    times = {k: (cuda_ms(fn), device_busy(fn)[0]) for k, fn in window.items()}
    smi_after = smi_sample()
    busy = {k: b for k, (_e, b) in times.items()}
    print("knob kernels in one window on the same bins, ms events / busy: "
          + ", ".join(f"{k} {e:.4f} / {b:.4f}" for k, (e, b) in times.items())
          + f"; K2 / K1 busy {busy['K2'] / busy['K1']:.3f}, "
          f"K1-CK / K1 busy {busy['K1-CK'] / busy['K1']:.3f}, K-FUSE / "
          f"(K1 + tiled K2) busy {busy['K-FUSE'] / busy['K1 + tiled K2']:.3f}"
          f"; both visibility kernels evaluate the same {int(vis.kept.sum())} "
          f"kept (triangle, region) pairs; card {smi_before} -> {smi_after} "
          f"({card})", flush=True)

    # the tiled shading stage beside deferred_shade_attrs, on this frame;
    # the knob Renderers render `reg`'s scene
    r_ck, _ = build_bench_scene(BENCH_GRID, dev, kernel=CKERN, reg=reg)
    r_ft, _ = build_bench_scene(BENCH_GRID, dev, kernel=FUSE_TILED, reg=reg)
    gbuf = GBuffer(tri_id=tri, depth=raster.untile_frame(
        d1, ntx, nty)[:h, :w].contiguous(), aux=bins.aux)
    shade_kw = dict(textures=inp["textures"], camera=inp["camera"],
                    lights=inp["lights"])
    print_stages("knob stages at spheres1080_1m", {
        "binning_ckern": lambda: raster.build_bins(
            cs.setup, w, h, setup_cols=cs.cols.setup, ck_bank=bank),
        "binning": lambda: raster.build_bins(cs.setup, w, h,
                                             setup_cols=cs.cols.setup),
        "shading": lambda: deferred_shade_attrs(
            gbuf, a2, width=w, height=h, clear_color=inp["clear_color"],
            **shade_kw),
        "shading_tiled": lambda: dtl.shade_attrs_tiled(
            t1, d1, at, width=w, height=h, **shade_kw),
        "visibility_and_shade": lambda: _visibility_and_shade(
            cs.setup, cs.cols.setup, records, width=w, height=h,
            clear_color=inp["clear_color"], **shade_kw),
        "visibility_and_shade_ckern": lambda: _visibility_and_shade(
            cs.setup, cs.cols.setup, records, width=w, height=h,
            clear_color=inp["clear_color"], knobs=r_ck.knobs, **shade_kw),
        "visibility_and_shade_fuse_tiled": lambda: _visibility_and_shade(
            cs.setup, cs.cols.setup, records, width=w, height=h,
            clear_color=inp["clear_color"], knobs=r_ft.knobs, **shade_kw),
    }, card)
    del cs, records, bins, d1, t1, dc, tc, dcp, tcp, tri, a2, df, tf, vis
    del af, dfp, tfp, afp, at, atp, idx, fx, fy, xp, xpp, x3, gbuf, work
    torch.cuda.empty_cache()

    # (b) 12 frames each of CKERN and FUSE_TILED, beside the default knobs
    frame_ms = {"default": [], "ckern": [], "fuse_tiled": []}
    expect = {"ckern": {"visibility_ck": 1, "visibility": 0, "resolve": 1,
                        "texel": 1},
              "fuse_tiled": {"visibility_resolve": 1, "texel_planar": 1,
                             "visibility": 0, "resolve": 0,
                             "resolve_tiled": 0, "texel": 0}}
    knob_r = {"ckern": r_ck, "fuse_tiled": r_ft}
    # (c)'s shadows1080 PCF frame with and without tiled_shade
    rs, sreg = build_bench_scene(SHADOW_GRID, dev, "shadows1080")
    rt, _ = build_bench_scene(SHADOW_GRID, dev, "shadows1080",
                              kernel={"tiled_shade": True}, reg=sreg)

    def timed(rr):
        t0 = time.perf_counter()
        out = rr.render_viewport()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def knob_frames():
        for k in range(12):
            rotate(reg, k)
            ref, ms = timed(r)
            frame_ms["default"].append(ms)
            for name, rr in knob_r.items():
                out, ms = timed(rr)
                frame_ms[name].append(ms)
                ran = {n: rr.graphs.last_launches.get(n, 0)
                       for n in expect[name]}
                if ran != expect[name]:
                    fail(f"{name} frame {k}: launches {ran}, expected "
                         f"{expect[name]}")
                if out.aux.tolist() != [0, 0]:
                    fail(f"{name} frame {k}: aux {out.aux.tolist()}")
                if (out.tri_id != ref.tri_id).any() or same_bits(
                        out.depth, ref.depth):
                    fail(f"{name} frame {k}: ids or depths differ from the "
                         "default-knob frame")
                if name == "ckern":
                    if (out.color != ref.color).any():
                        fail(f"ckern frame {k} differs from the default-knob "
                             "frame")
                else:
                    tiled_gate(out.color, ref.color, f"fuse_tiled frame {k}")

        # (c) one shadows1080 PCF frame with tiled_shade
        rotate(sreg, 0)
        for rr in (rs, rt):
            rr.config.render.shadow_pcf = True
        ref, _ms = timed(rs)
        out, pcf_ms = timed(rt)
        ran = {n: rt.graphs.last_launches.get(n, 0) for n in kernel_fns}
        if (out.aux.tolist() != [0, 0] or out.shadow_aux.tolist() != [0, 0]
                or ran["resolve_tiled"] != 1 or ran["texel_planar"] != 1
                or ran["shadow_taps"] != 1):
            fail(f"shadows1080 tiled PCF frame: aux {out.aux.tolist()}, "
                 f"light pass {out.shadow_aux.tolist()}, launches {ran}")
        tiled_gate(out.color, ref.color, "shadows1080 tiled PCF frame")
        sinp = rt.frame_inputs()
        shadow, _aux = shadow_params(
            sinp["plan"], sinp["params"], sinp["tri_draw"], sinp["corner_t"],
            sinp["light_camera"], sinp["shadow_size"], 2e-3,
            draw_stride=sinp["draw_stride"], real_draws=sinp["real_draws"])
        cov = out.tri_id >= 0
        factor = shadow_factor(shadow, world_positions(
            out.depth, sinp["camera"], out.depth.shape[1],
            out.depth.shape[0]), pcf=True)[..., 0]
        shadowed = float((factor[cov] < 1.0).float().mean())
        print(f"shadows1080 tiled PCF frame: {pcf_ms:.3f} ms wall, "
              f"{shadowed:.4f} of {int(cov.sum())} covered pixels shadowed",
              flush=True)
        if not shadowed > 0.01:
            fail("the shadows1080 tiled PCF frame has no shadow")

    _none, launches10 = drive(knob_frames, ("visibility_ck",
                                            "visibility_resolve",
                                            "resolve_tiled", "texel_planar"),
                              (r, r_ck, r_ft, rs, rt))
    for name, ms in frame_ms.items():
        print(f"spheres1080_1m {name} frames: median "
              f"{statistics.median(ms[2:]):.3f} ms wall per render_viewport "
              f"({[round(t, 3) for t in ms]}) ({card})", flush=True)
    for name, rr in (("default", r), *knob_r.items()):
        kinp = rr.frame_inputs()
        dev_ms = cuda_ms(lambda: render_frame(**kinp))
        busy_ms, n_launch = device_busy(lambda: render_frame(**kinp))
        print(f"spheres1080_1m {name} render_frame: {dev_ms:.3f} ms device "
              f"time, {busy_ms:.3f} ms busy in {n_launch:.0f} device "
              f"activities (idle {1 - busy_ms / dev_ms:.3f}) ({card})",
              flush=True)
    print(f"knob frames' launches {launches10}", flush=True)
    del r, reg, r_ck, r_ft, rs, rt, sreg, knob_r, inp, kinp
    torch.cuda.empty_cache()

    # (d) the 128² knob frames against the JAX package's
    for name, kw in KNOB_FLAVORS.items():
        fr = base_scene(dev, **kw).render_viewport()
        aux = [fr.aux.tolist()] + ([fr.shadow_aux.tolist()]
                                   if fr.shadow_aux is not None else [])
        if any(a != [0, 0] for a in aux):
            fail(f"knob flavor {name} aux {aux}")
        golden_gate(fr.color.cpu().numpy(),
                    np.load(GOLDENS / f"torch_slice_knobs_{name}.npy"),
                    f"knobs {name}")
    return launches10


PROBE_SRC = "trident_tpu_torch/csrc/visibility_probe.cu"
HOST_CALLS = 1000


def sass_calls(needle: str) -> dict:
    """For each kernel of the built library whose name holds `needle`, its
    CALL instructions in cuobjdump's SASS (a 64-bit integer division is
    a call to a runtime routine; a 32-bit one is inline)."""
    from trident_tpu_torch import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    calls, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if needle in name:
                calls[name] = 0
        elif name in calls and " CALL" in line:
            calls[name] += 1
    return calls


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs per call of `calls` back-to-back fn() calls, one synchronize
    at the end (after a few warm-up calls)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_line(what: str, fn, lib_name, lib_fn, card: str) -> None:
    """The host µs per call of a probe wrapper and, if named, its library
    call."""
    text = f"{what}: {host_us(fn):.2f} µs"
    if lib_name is not None:
        text += f", {lib_name} {host_us(lib_fn):.2f} µs"
    print(f"host per call ({HOST_CALLS} back-to-back calls, one synchronize)"
          f", {text} ({card})", flush=True)


def phase_probes(dev, card: str, kernel_fns: dict, drive, results: dict,
                 cs, records, bins, w: int, h: int) -> dict:
    """Phase 11, the tools_dev probes at spheres1080_1m on phase 3's bins:
    the visibility probes (dense, dual, reset) and K1 / K1-CK on doctored
    masks against their plain versions and K1's frame, the gather at the
    three probe shapes and a ragged one against its plain version, numpy
    and torch.gather (both paths, and their A/B), the split select at rw 27
    and 32 against its plain version and host_parts and with chunks past
    the row; their times, bounds, host µs per call and the launch floor;
    then the tools' own runs (kbench's configs with
    and without ckern, its --bins and --sort legs, the gather and split
    probes) as the main path, with kbench's dflt through K1 against its
    dflt through K1-CK. Adds the probe kernels to `kernel_fns` and
    `results` and returns the main path's launch counts."""
    import torch

    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.ops.planes import RR_WIDTH
    from trident_tpu_torch.tools_dev import diag_split_kernel as dsk
    from trident_tpu_torch.tools_dev import gather_probe as gp
    from trident_tpu_torch.tools_dev import kbench as kb

    kernel_fns.update(visibility_dense=kb.visibility_dense,
                      visibility_dual=kb.visibility_dual,
                      visibility_reset=kb.visibility_reset,
                      lut_gather=gp.lut_gather,
                      split_select=dsk.split_select)
    ntx = -(-w // raster.TILE)
    n_tiles = ntx * -(-h // raster.TILE)
    n_real = int(bins.n_real)

    def same_bits(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    # (a) the visibility probes and the doctored-mask configs: each kernel
    # against its plain version, then against the frame it must give: K1's
    # (dflt, dual), K1's on full masks (full, nobranch) or background (zero,
    # probe, probe_tiny); K1 on full masks differs from K1 only by the
    # rounding hits that the binner's bbox cull drops
    d1, t1 = raster.visibility_tiles(bins, ntx, n_tiles)
    full = kb.doctored(bins, "full")
    dfull, tfull = raster.visibility_tiles(full, ntx, n_tiles)
    n_diff, n_bad = kb.bbox_culled_hits(cs.setup, dfull, tfull, d1, t1, ntx)
    if n_bad or n_diff > n_tiles * raster.TILE_PX // 10000:
        fail(f"K1 on full masks differs from K1 in {n_diff} pixels, {n_bad} "
             "of them not a bbox-culled rounding hit")
    bg = kb.visibility_reset_plain(bins, n_tiles)
    expect = {"zero": bg, "probe": bg, "probe_tiny": bg, "dflt": (d1, t1),
              "dual": (d1, t1), "full": (dfull, tfull),
              "nobranch": (dfull, tfull)}
    ckb = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup,
                            ck_bank=kb.CK_BANK)
    runs = [(kind, bins, 0) for kind in kb.CONFIGS] + [
        (kind, ckb, kb.CK_BANK) for kind in ("zero", "dflt", "full")]
    for kind, b, ck in runs:
        dk, tk = kb.config_fn(b, kind, ntx, n_tiles, ck)()
        dp, tp = kb.config_fn(b, kind, ntx, n_tiles, ck, plain=True)()
        ed, et = expect[kind]
        torch.cuda.synchronize()
        bad = [int((tk != tp).sum()), same_bits(dk, dp),
               int((tk != et).sum()), same_bits(dk, ed)]
        if any(bad):
            fail(f"kbench {kind}{' (ckern)' if ck else ''}: ids/depths "
                 f"{bad[:2]} off its plain version, {bad[2:]} off the "
                 "expected frame")
    print(f"visibility probes at spheres1080_1m ({n_real} pairs, "
          f"{kb.hit_total(bins)} hit sub-blocks): every config bit-equal "
          "to its plain version; dflt and dual bit-equal to K1, nobranch "
          "(and ckern full) to K1 on full masks, which differs from K1 in "
          f"{n_diff} of {n_tiles * raster.TILE_PX} pixels, each a "
          "bbox-culled rounding hit; zero, probe and probe_tiny background",
          flush=True)

    # bounds from this run's data: the evaluated sub-blocks as vis_work
    # counts them; dual adds each touched chunk's 32 KB strip once; reset
    # fetches each touched chunk's block once
    n_chunks_hit = int(torch.unique(bins.pair_chunk[:n_real]).numel())
    walk_bytes = n_real * 8 + (n_tiles + 1) * 4 + n_tiles * raster.TILE_PX * 8
    table2 = kb.dual_table(bins)
    probe_tab, probe_blk = kb.probe_table(bins, False)
    tiny_tab, tiny_blk = kb.probe_table(bins, True)
    vis = vis_work(bins, cs.setup, ntx, n_tiles, 8)
    vis_full = vis_work(full, cs.setup, ntx, n_tiles, 8)
    work = {
        "visibility_dense": (
            bound(vis_full.bytes, vis_full.ops), "tools_dev/kbench.py:117",
            lambda: kb.visibility_dense(bins, ntx, n_tiles),
            lambda: raster.visibility_tiles_plain(bins, ntx, n_tiles,
                                                  dense=True), 3),
        "visibility_dual": (
            bound(vis.bytes + n_chunks_hit * RR_WIDTH * raster.CHUNK * 4,
                  vis.ops),
            "tools_dev/kbench.py:180",
            lambda: kb.visibility_dual(bins, table2, ntx, n_tiles),
            lambda: kb.visibility_dual_plain(bins, table2, ntx, n_tiles), 3),
        "visibility_reset": (
            bound(walk_bytes + n_chunks_hit * probe_blk * 4),
            "tools_dev/kbench.py:357",
            lambda: kb.visibility_reset(bins, probe_tab, probe_blk, n_tiles),
            lambda: kb.visibility_reset_plain(bins, n_tiles), 10),
    }
    for name, ((b_ms, b_by), repl, fn, plain, reps) in work.items():
        res = dict(route="cuda", source=PROBE_SRC, replaces=repl,
                   max_abs_err=0.0, ms=cuda_ms(fn),
                   plain_ms=cuda_ms(plain, reps=reps, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        results[name] = res
        print(f"{name}: kernel {res['ms']:.4f} ms (device busy "
              f"{device_busy(fn)[0]:.4f} ms), plain {res['plain_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)

    def tiny():
        return kb.visibility_reset(bins, tiny_tab, tiny_blk, n_tiles)

    def probe():
        return kb.visibility_reset(bins, probe_tab, probe_blk, n_tiles)

    t_ms, t_by = bound(walk_bytes + n_chunks_hit * tiny_blk * 4)
    print(f"visibility_reset (probe_tiny, 4 KB blocks): kernel "
          f"{cuda_ms(tiny):.4f} ms (device busy {device_busy(tiny)[0]:.4f} "
          f"ms), bound {t_ms:.4f} ms ({t_by}); streamed per pair: records "
          f"{n_real * probe_blk * 4 / 1e6:.1f} MB, tiny "
          f"{n_real * tiny_blk * 4 / 1e6:.1f} MB, dual strips "
          f"{n_real * RR_WIDTH * raster.CHUNK * 4 / 1e6:.1f} MB ({card})",
          flush=True)
    flush = l2_flush(dev)
    cold_line("visibility_reset (probe)", probe,
              results["visibility_reset"]["bound_ms"], flush, card)
    cold_line("visibility_reset (probe_tiny)", tiny, t_ms, flush, card)
    del d1, t1, dfull, tfull, bg, expect, full, table2, tiny_tab, flush
    torch.cuda.empty_cache()

    # (b) the gather at the three probe shapes and a ragged one: the rule's
    # path against its plain version, numpy and torch.gather (on clamped
    # indices, -1 outside the table), then each path forced, in one window
    # of alternating readings
    calls = sass_calls("lut_gather")
    if len(calls) < 3 or any(calls.values()):
        fail(f"lut_gather's kernels in SASS (CALL instructions): {calls}")
    print(f"lut_gather: {len(calls)} kernels in the library's SASS, none "
          "with a CALL (no 64-bit division routine)", flush=True)
    gather_cases = dict(gp.cases(gp.make_inputs()), ragged=gp.ragged_case())
    for name, (tab, idx) in gather_cases.items():
        t = torch.from_numpy(tab).to(dev)
        i = torch.from_numpy(idx).to(dev)
        k, rows, lanes = t.shape
        ok = (i >= 0) & (i < rows)
        i64 = i.clamp(0, rows - 1).long()
        got = gp.lut_gather(t, i)
        plain = gp.lut_gather_plain(t, i)
        lib = torch.where(ok[:, None], gp.library_gather(t, i64).view(
            k, *i.shape).transpose(0, 1), -1)
        forced = [gp.lut_gather_path(t, i, staged) for staged in (False,
                                                                   True)]
        torch.cuda.synchronize()
        bad = [int((got != plain).sum()), int((got != lib).sum()),
               int((got.cpu().numpy() != gp.numpy_reference(tab, idx)).sum()),
               *[int((f != plain).sum()) for f in forced]]
        shape = (i.shape[0], k, *i.shape[1:])
        if any(bad) or tuple(got.shape) != shape:
            fail(f"lut_gather {name}: {bad} values off its plain version, "
                 f"torch.gather, numpy, the direct and the staged path "
                 f"(shape {tuple(got.shape)})")
        path = gp.gather_path(k, rows, lanes, i.shape[0], i.shape[1])
        ab = [device_busy(lambda staged=staged: gp.lut_gather_path(
            t, i, staged))[0] for staged in (False, True, True, False)]
        print(f"lut_gather {name} ({tuple(t.shape)} tables, "
              f"{tuple(i.shape)} idx): the rule's {path} path, the direct "
              f"and the staged path bit-equal to the plain version, numpy "
              f"and torch.gather; busy A/B direct / staged / staged / direct "
              f"{' / '.join(f'{b:.4f}' for b in ab)} ms (staged splits "
              f"{gp.staged_splits(k, lanes, *i.shape[:2])}) ({card})",
              flush=True)
        if name == "ragged":
            continue
        b_ms, b_by = bound(4 * (t.numel() + i.numel() + got.numel()))
        ms = cuda_ms(lambda: gp.lut_gather(t, i))
        lib_ms = cuda_ms(lambda: gp.library_gather(t, i64))
        plain_ms = cuda_ms(lambda: gp.lut_gather_plain(t, i))
        busy = [device_busy(fn)[0] for fn in (
            lambda: gp.lut_gather(t, i), lambda: gp.library_gather(t, i64))]
        print(f"lut_gather {name}: kernel {ms:.4f} ms (device busy "
              f"{busy[0]:.4f}), torch.gather {lib_ms:.4f} ms (busy "
              f"{busy[1]:.4f}; kernel / torch.gather busy "
              f"{busy[0] / busy[1]:.3f}), plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        if name == "lut_gather":
            host_line("lut_gather (lut_gather shape)", lambda: gp.lut_gather(
                t, i), "torch.gather", lambda: gp.library_gather(t, i64),
                card)
        if name == "lut_frame":
            results["lut_gather"] = dict(
                route="cuda", source="trident_tpu_torch/csrc/lut_gather.cu",
                replaces="tools_dev/gather_probe.py:110", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)
    del t, i, i64, ok, got, plain, lib, forced
    torch.cuda.empty_cache()

    # (c) the split select, K1/K2/K3 at rw 27 and 32, and with device chunks
    # that push columns outside the row
    for rw in dsk.RWS:
        planes, oh = dsk.make_inputs(rw)
        want = dsk.host_parts(planes, oh)
        for form in dsk.FORMS:
            args = dsk.form_inputs(form, planes, oh, dev)
            pk, sk = dsk.split_select(**args)
            pp, sp = dsk.split_select_plain(**args)
            torch.cuda.synchronize()
            bad = same_bits(sk, sp) + (same_bits(pk, pp) if args["parts"]
                                       else 0)
            got = ([pk[k].cpu().numpy() for k in range(3)]
                   if args["parts"] else []) + [sk.cpu().numpy()]
            ref = (want if args["parts"] else []) + [
                want[0] + want[1] + want[2]]
            err = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
            if bad or not err == 0.0:
                fail(f"split_select {form} rw={rw}: {bad} values off its "
                     f"plain version, max error {err} against host_parts")
    print("split_select: K1/K2/K3 at rw 27 and 32 bit-equal to the plain "
          "version, max error 0 against host_parts", flush=True)
    cols = planes.shape[2]
    for form in ("K2", "K3"):
        for c_val, off in ((3, 200), (4, 0), (-1, 100)):
            args = dict(dsk.form_inputs(form, planes, oh, dev), off=off)
            args["chunk"].fill_(c_val)
            pk, sk = dsk.split_select(**args)
            pp, sp = dsk.split_select_plain(**args)
            col = args["win"].long() + off + c_val * dsk.C
            outside = ((col < 0) | (col >= cols)).expand_as(sk)
            torch.cuda.synchronize()
            bad = same_bits(sk, sp) + (same_bits(pk, pp) if args["parts"]
                                       else 0)
            if bad or not outside.any() or not torch.equal(
                    torch.isnan(sk), outside):
                fail(f"split_select {form} chunk {c_val} off {off}: {bad} "
                     "values off its plain version, or NaN not exactly "
                     "outside the row")
    # planes whose rows start off a 16-byte boundary (the ragged staging)
    ragged = planes.to(dev)[:, :, 3:1001]
    for form in ("K1", "K2"):
        args = dict(dsk.form_inputs(form, planes, oh, dev), planes=ragged,
                    off=5)
        pk, sk = dsk.split_select(**args)
        pp, sp = dsk.split_select_plain(**args)
        torch.cuda.synchronize()
        bad = same_bits(sk, sp) + same_bits(pk, pp)
        if bad:
            fail(f"split_select {form} on planes starting at column 3: {bad} "
                 "values off its plain version")
    print("split_select: K2/K3 with device chunks 3, 4, -1 (columns outside "
          "the row) bit-equal to the plain version, NaN exactly outside the "
          "row; K1/K2 on planes starting at column 3 (ragged staging) "
          "bit-equal", flush=True)
    # each form's times at rw 32; the library call is one PyTorch indexing
    # call selecting the same lanes of the stacked planes (bf16, no sum),
    # which K3's separate planes have no counterpart of
    n_sel = planes.shape[1] * dsk.C
    for form, line in (("K1", 83), ("K2", 126), ("K3", 165)):
        args = dsk.form_inputs(form, planes, oh, dev)
        sel = args["win"].long() + args["off"] + (
            0 if args["chunk"] is None else dsk.C)
        n_out = (4 if args["parts"] else 1) * n_sel

        def select(args=args):
            return dsk.split_select(**args)

        def index_call(args=args, sel=sel):
            return args["planes"][:, :, sel]

        b_ms, b_by = bound(dsk.C * 4 + n_sel * 3 * 2 + n_out * 4)
        lib = form != "K3"
        res = dict(
            route="cuda", source="trident_tpu_torch/csrc/split_select.cu",
            replaces=f"tools_dev/diag_split_kernel.py:{line}",
            max_abs_err=0.0, ms=cuda_ms(select),
            plain_ms=cuda_ms(lambda args=args: dsk.split_select_plain(
                **args)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(index_call) if lib else None)
        if form == "K1":
            results["split_select"] = res
        lo, hi = dsk.split_span(cols, args["off"], dsk.C,
                                args["chunk"] is not None)
        print(f"split_select ({form}, rw 32): kernel {res['ms']:.4f} ms "
              f"(device busy {device_busy(select)[0]:.5f} ms), plain "
              f"{res['plain_ms']:.4f} ms, indexing call "
              + (f"{res['library_ms']:.4f} ms (busy "
                 f"{device_busy(index_call)[0]:.5f})" if lib else "none")
              + f", bound {b_ms:.4f} ms ({b_by}); stages columns [{lo}, "
              f"{hi}): {3 * 2 * (hi - lo) * planes.shape[1]} bytes read for "
              f"{3 * 2 * n_sel} selected ({card})", flush=True)
        host_line(f"split_select ({form})", select,
                  "the indexing call" if lib else None, index_call, card)
    one = torch.zeros(1, device=dev)
    print(f"launch floor (one 1-element add_, device busy): "
          f"{device_busy(lambda: one.add_(1))[0]:.5f} ms ({card})",
          flush=True)

    # (d) the tools' own runs: the main path of this phase
    def probes():
        print(f"card before kbench: {smi_sample()}", flush=True)
        kb.report_bins(bins)
        k1 = kb.run(bins, ntx, n_tiles, kb.CONFIGS, card_line=card)
        print("kbench --kernel ckern:", flush=True)
        kb.report_bins(ckb)
        ck = kb.run(ckb, ntx, n_tiles, kb.CONFIGS, ck_bank=kb.CK_BANK,
                    card_line=card)
        print(f"card after kbench: {smi_sample()}", flush=True)
        (k1_ms, k1_busy), (ck_ms, ck_busy) = k1["dflt"], ck["dflt"]
        print(f"kbench dflt, K1 against K1-CK (one bulk copy per pair, "
              f"double-buffered), ms events / busy: K1 {k1_ms:.4f} / "
              f"{k1_busy:.4f}, "
              f"K1-CK {ck_ms:.4f} / {ck_busy:.4f} (busy ratio "
              f"{ck_busy / k1_busy:.2f}) ({card})", flush=True)
        kb.bins_leg(cs, w, h, card_line=card)
        kb.sort_leg(dev, card_line=card)
        gp.run(dev, card_line=card)
        return dsk.run(dev)

    worst, launches11 = drive(probes, (
        "visibility", "visibility_ck", "visibility_dense", "visibility_dual",
        "visibility_reset", "lut_gather", "split_select"))
    if not worst == 0.0:
        fail(f"the split probe's max error is {worst}, not 0")
    print(f"probe tools' launches {launches11}", flush=True)
    return launches11


FRAME_FIELDS = ("color", "depth", "tri_id", "aux", "shadow_aux", "history",
                "view_proj")
LOOP_FRAMES = 50          # frames of each mode in phase 12's interactive loop


def differing(a, b) -> list:
    """The FrameOutput fields in which `a` and `b` differ in any bit (a
    field None on one side only differs)."""
    import torch

    bad = []
    for f in FRAME_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None and y is None:
            continue
        if (x is None or y is None or x.shape != y.shape
                or x.dtype != y.dtype):
            bad.append(f)
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if bool((x != y).any()):
            bad.append(f)
    return bad


def same_as_eager(out, inp, what: str, aux_fields=("aux",)) -> None:
    """A replayed frame against eager render_frame on its inputs, bit for
    bit, with aux [0, 0] on each of `aux_fields`."""
    from trident_tpu_torch.render.renderer import render_frame

    bad = differing(out, render_frame(**inp))
    aux = {f: getattr(out, f).tolist() for f in aux_fields}
    if bad or any(a != [0, 0] for a in aux.values()):
        fail(f"{what}: the replay differs from eager render_frame in {bad}, "
             f"aux {aux}")


def replay_check(r, what: str, expect, aux_fields=("aux",)) -> None:
    """One frame of Renderer `r` through render_viewport (a graph replay
    whose launch list must be `expect`) against eager render_frame on the
    same inputs (same_as_eager)."""
    ctx = r.viewports[0]
    r.editor_camera.set_viewport_size(ctx.width, ctx.height)
    inp = r.frame_inputs()
    out = r.render_viewport()
    if r.graphs.last_launches != expect:
        fail(f"{what}: the replayed graph's launch list "
             f"{r.graphs.last_launches}, expected {expect}")
    same_as_eager(out, inp, what, aux_fields)


def held_records(fn, launches: dict, what: str, reps: int = 5) -> dict:
    """The render-path kernels' records in a profiling window of `reps`
    fn() calls, each one replay of a graph with launch list `launches`;
    fails unless they are the list times the replays."""
    recs = graph_records(fn, launches, reps)
    if recs != {n: c * reps for n, c in launches.items()}:
        fail(f"{what}: a window of {reps} replays holds kernel records "
             f"{recs}, expected {reps} x {launches}")
    return recs


def replay_line(r, what: str, card: str) -> None:
    """The device time of the graph `r` replayed last, its replay alone
    (no staging, no clones): CUDA events, busy and activities in a window
    held to its launch list, idle share; fails unless a window's kernel
    records are the launch list times the replays."""
    g = r.graphs.graph(r.graphs.last_key)
    held_records(g.graph.replay, g.launches, what)
    dev_ms = cuda_ms(g.graph.replay)
    busy, acts = device_busy(g.graph.replay, launch_list=g.launches)
    if busy != busy:
        fail(f"{what}: no profiling window of its replays was whole")
    print(f"{what}, its graph replayed alone: device frame {dev_ms:.4f} ms "
          f"(CUDA events), busy {busy:.4f} ms in {acts:.0f} device "
          f"activities, idle {1 - busy / dev_ms:.4f}; kernel records "
          f"{g.launches} per replay ({card})", flush=True)


def phase_frame_loop(dev, card: str, drive) -> None:
    """Phase 12, the interactive frame loop: Renderer.render_viewport
    replays one captured CUDA graph per frame key. (a) 12 rotating
    spheres1080_1m frames bit-equal to eager render_frame, one capture,
    the replay windows' kernel records against the graph's launch list;
    (b) the interactive loop, eager render_frame_bundled against replays
    on bundles packed ahead, one window, and host draw gathering, loops
    against batched against frame_bundle; (c) draw_frame over two viewports, the idle-frame
    cache and pick; (d) replays bit-equal to eager on shadows1080 (hard,
    PCF), spheres1080_1m:ai (three chained frames), the fuse +
    tiled_shade frame and ultra4k. Each cell's graph is also timed
    replayed alone."""
    import torch

    from trident_tpu_torch.ecs.components import (
        CameraComponent,
        TransformComponent,
    )
    from trident_tpu_torch.render.renderer import render_frame
    from trident_tpu_torch.tools_dev.host_gather import gather_ab
    from trident_tpu_torch.tools_dev.timing import uploads_per_call

    main_list = {"visibility": 1, "resolve": 1, "texel": 1}
    # (a) spheres1080_1m: 12 replays bit-equal to eager, one capture
    r, reg = build_bench_scene(BENCH_GRID, dev)
    w, h = r.config.render.width, r.config.render.height
    rotate(reg, 0)
    r.editor_camera.set_viewport_size(w, h)
    render_frame(**r.frame_inputs())      # the eager frame's working set
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved(dev)
    reserved1, wall = [], []

    def frames():
        done = []
        for k in range(12):
            rotate(reg, k)
            inp = r.frame_inputs()
            t0 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            if r.graphs.last_launches != main_list:
                fail(f"spheres1080_1m frame {k}: the replayed graph's "
                     f"launch list {r.graphs.last_launches}")
            done.append((out, inp))
            if k == 0:
                reserved1.append(torch.cuda.memory_reserved(dev))
        return done

    done, runs = drive(frames, tuple(main_list), (r,))
    for k, (out, inp) in enumerate(done):    # the eager frames, undriven
        same_as_eager(out, inp, f"spheres1080_1m frame {k}")
    del done
    reserved1 = reserved1[0]
    if r.graphs.captures != 1 or r.graphs.replays != 12:
        fail(f"spheres1080_1m: {r.graphs.captures} captures and "
             f"{r.graphs.replays} replays for 12 frames")
    print(f"frame loop: 12 spheres1080_1m replays bit-equal to eager "
          f"render_frame (color, depth, tri_id, aux [0, 0]); 1 capture, "
          f"launch list {r.graphs.last_launches}, kernel runs "
          f"{ {n: c for n, c in runs.items() if c} }; memory_reserved "
          f"{reserved0 / 2**20:.1f} MiB before the capture, "
          f"{reserved1 / 2**20:.1f} MiB after; median "
          f"{statistics.median(wall[2:]):.3f} ms wall per render_viewport "
          f"(host state, pack, replay) ({card})", flush=True)
    step = [12]

    def replay_frame():
        rotate(reg, step[0])
        step[0] += 1
        return r.render_viewport()

    reps = 5
    recs = held_records(replay_frame, main_list, "spheres1080_1m", reps)
    print(f"frame loop: a window of {reps} replays holds kernel records "
          f"{recs} ({reps} x the launch list)", flush=True)

    # (b) the interactive loop (bench.py:327-374): bundles packed ahead
    # (Renderer.frame_bundle: the blobs, the graph key, the eager frame)
    bundles = []
    for k in range(LOOP_FRAMES):
        rotate(reg, k)
        bundles.append(r.frame_bundle())
    key = bundles[0].key
    if any(fb.key != key for fb in bundles):
        fail("interactive loop: the rotating frames' graph keys differ")

    def eager(k):
        fb = bundles[k % LOOP_FRAMES]
        return fb.frame_fn(
            torch.from_numpy(fb.f32).to(dev, non_blocking=True),
            torch.from_numpy(fb.i32).to(dev, non_blocking=True), None, fb.ai)

    def replay(k):
        fb = bundles[k % LOOP_FRAMES]
        return r.graphs.run(fb.key, fb.f32, fb.i32, None, fb.ai, fb.frame_fn,
                            keep=fb.keep)

    for k in range(0, LOOP_FRAMES, 7):
        if differing(eager(k), replay(k)):
            fail(f"interactive loop: bundle {k}'s replay differs from its "
                 "eager frame")
    if r.graphs.captures != 1:
        fail(f"interactive loop: {r.graphs.captures} captures")
    modes = {"eager": eager, "replay": replay}
    stats = {}
    print(f"card before the interactive loop: {smi_sample()}", flush=True)
    for name, fn in modes.items():
        host = []
        for k in range(LOOP_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(LOOP_FRAMES):
            fn(k)
        torch.cuda.synchronize()
        fps = LOOP_FRAMES / (time.perf_counter() - t0)
        i = iter(range(10 ** 6))
        dev_ms = cuda_ms(lambda: fn(next(i)))
        busy, acts = device_busy(lambda: fn(next(i)), launch_list=(
            main_list if name == "replay" else None))
        if name == "replay" and busy != busy:
            fail("interactive loop: no profiling window of the replays "
                 "was whole")
        stats[name] = (dev_ms, busy, acts, fps, statistics.median(host))
    print(f"card after the interactive loop: {smi_sample()}", flush=True)
    # the replay's host share, each part alone on an idle card: staging
    # (pinned copy + two uploads), the graph launch, the output clones
    g = r.graphs.graph(key)
    f32, i32 = bundles[0].f32, bundles[0].i32
    parts = {"staging": lambda: r.graphs.stage(g, f32, i32),
             "graph launch": g.graph.replay,
             "clones": lambda: [t.clone() for t in g.out if t is not None]}
    clone_busy = device_busy(parts["clones"])
    split = {}
    for part, fn in parts.items():
        host = []
        for _k in range(LOOP_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e6)
        split[part] = statistics.median(host)
    torch.cuda.synchronize()
    # host-to-device copies per frame: the eager Renderer path of phases
    # 4-11 before this loop (frame_inputs uploads each array, then
    # render_frame), the eager bundle, the replay
    rotate(reg, 0)
    ups = {"frame_inputs + render_frame": uploads_per_call(
               lambda: render_frame(**r.frame_inputs())),
           "eager bundle": uploads_per_call(lambda: eager(0)),
           "replay": uploads_per_call(lambda: replay(0),
                                      launch_list=main_list)}
    if ups["replay"] != ups["replay"]:
        fail("interactive loop: no profiling window of a replay's uploads "
             "was whole")
    print("interactive loop: host-to-device copies per frame " + ", ".join(
        f"{n} {u:.1f}" for n, u in ups.items()) + "; replay host us, each "
          "part alone: " + ", ".join(f"{n} {v:.1f}" for n, v in split.items())
          + f"; the clones' device busy {clone_busy[0]:.4f} ms in "
          f"{clone_busy[1]:.0f} copies ({card})", flush=True)
    for name, (dev_ms, busy, acts, fps, host) in stats.items():
        print(f"interactive loop, {name} (spheres1080_1m, {LOOP_FRAMES} "
              f"frames of bundles packed ahead): device frame {dev_ms:.4f} "
              f"ms (CUDA events), busy {busy:.4f} ms in {acts:.0f} device "
              f"activities, idle {1 - busy / dev_ms:.4f}; wall "
              f"{fps:.3f} FPS chained; host {host:.1f} us per frame, the "
              f"two blob uploads included ({card})", flush=True)
    if r.graphs.captures != 1:
        fail(f"interactive loop: {r.graphs.captures} captures")
    replay_line(r, "spheres1080_1m", card)

    # host draw gathering: the per-record loops against the batched
    # forms, bit-equal, and the whole frame_bundle, alternating in one
    # window (tools_dev/host_gather.py)
    rotate(reg, 3)
    host = gather_ab(r, pairs=10)
    print(f"host draw gathering at spheres1080_1m "
          f"({len(bundles[0].state.draws)} entities), bit-equal, medians of "
          f"20 each alternating loop, batch, bundle, bundle, batch, loop in "
          f"one window: per-record loops {host['loop']:.3f} ms, batched "
          f"{host['batch']:.3f} ms, the whole frame_bundle (the batched "
          f"forms, plan, lights, packing) {host['frame_bundle']:.3f} ms "
          f"({card})", flush=True)

    # (c) draw_frame over viewport 0 (editor camera) and viewport 2 (a
    # bound runtime camera), the idle-frame cache, pick
    cam_e = reg.create()
    ct = reg.add(cam_e, TransformComponent())
    ct.position = np.array([0.0, 0.0, BENCH_GRID * 1.1 + 2], np.float32)
    reg.add(cam_e, CameraComponent(primary=True))
    if not r.bind_runtime_camera(reg):
        fail("bind_runtime_camera found no camera")
    r.set_viewport(r.GAME_VIEWPORT, 960, 540)
    rotate(reg, 0)
    r.draw_frame()
    torch.cuda.synchronize()
    ctx0, ctx2 = r.viewports[0], r.viewports[r.GAME_VIEWPORT]
    o0, o2 = ctx0.last_frame, ctx2.last_frame
    if (tuple(o0.color.shape) != (h, w, 4)
            or tuple(o2.color.shape) != (540, 960, 4)
            or o0.aux.tolist() != [0, 0] or o2.aux.tolist() != [0, 0]):
        fail(f"draw_frame: viewport 0 {tuple(o0.color.shape)} aux "
             f"{o0.aux.tolist()}, viewport 2 {tuple(o2.color.shape)} aux "
             f"{o2.aux.tolist()}")
    replays = r.graphs.replays
    out = r.draw_frame()
    if (out is not o0 or ctx2.last_frame is not o2
            or r.graphs.replays != replays):
        fail("draw_frame with nothing moved did not reuse both viewports' "
             "frames from the idle cache")
    rotate(reg, 1)
    out = r.draw_frame()
    torch.cuda.synchronize()
    if (out is o0 or ctx2.last_frame is o2
            or r.graphs.replays != replays + 2):
        fail("a transform change did not invalidate the idle cache")
    r.editor_camera.set_viewport_size(w, h)
    inp = r.frame_inputs()
    ref = render_frame(**inp)
    if differing(out, ref):
        fail(f"draw_frame's viewport 0 differs from eager render_frame in "
             f"{differing(out, ref)}")
    tri = int(ref.tri_id[h // 2, w // 2])
    draws = r.frame_bundle().state.draws
    want = (-1 if tri < 0 else
            int(draws.entity[int(inp["tri_draw"][tri])]))
    got = r.pick(w // 2, h // 2, 0)
    if tri < 0 or got != want:
        fail(f"pick at the centre of viewport 0: {got}, the eager frame's "
             f"tri_id {tri} maps to {want}")
    # a one-graph cache and new frame keys (another static): each
    # viewport's capture evicts the graphs kept (their pools freed)
    r.graphs.capacity = 1
    r.config.render.shadow_pcf = True
    caps, reserved2 = r.graphs.captures, torch.cuda.memory_reserved(dev)
    out = r.draw_frame()
    inp = r.frame_inputs()
    same_as_eager(out, inp, "draw_frame with a one-graph cache")
    torch.cuda.synchronize()
    if r.graphs.captures != caps + 2 or len(r.graphs) != 1:
        fail(f"a one-graph cache: {r.graphs.captures - caps} captures for "
             f"two viewports, {len(r.graphs)} graphs kept")
    print(f"frame loop: with a one-graph cache and new frame keys "
          f"draw_frame evicts the kept graphs and captures each viewport's, "
          f"viewport 0 bit-equal to eager; "
          f"memory_reserved {reserved2 / 2**20:.1f} MiB before, "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB after "
          f"({card})", flush=True)
    r.graphs.capacity = 4
    r.config.render.shadow_pcf = False
    print(f"frame loop: draw_frame over viewports 0 ({w}x{h}) and 2 (960x540, "
          f"runtime camera): idle-cache hits with no replay, a transform "
          f"change replays both; pick at the centre names entity {got} as "
          f"the eager frame does; {r.graphs.captures} captures, "
          f"{r.graphs.replays} replays, {r.timing.stats().sample_count} "
          f"timed frames ({card})", flush=True)
    del r, reg, bundles, inp, ref, out, o0, o2, ctx0, ctx2, draws, g
    torch.cuda.empty_cache()

    # (d) the other paths, replays bit-equal to eager
    r, reg = build_bench_scene(SHADOW_GRID, dev, "shadows1080")
    for k, pcf in enumerate((False, True)):
        r.config.render.shadow_pcf = pcf
        rotate(reg, k)
        replay_check(r, f"shadows1080 {'PCF' if pcf else 'hard'} frame",
                     {"visibility_depth": 1, "visibility": 1, "resolve": 1,
                      "texel": 1, "shadow_taps": 1},
                     aux_fields=("aux", "shadow_aux"))
    print(f"frame loop: shadows1080 hard and PCF replays bit-equal to eager, "
          f"aux [0, 0] on both passes; {r.graphs.captures} captures",
          flush=True)
    replay_line(r, "shadows1080 PCF", card)
    del r, reg
    torch.cuda.empty_cache()

    r, reg = build_bench_scene(BENCH_GRID, dev, ai=True)
    caps = []
    for k in range(3):
        rotate(reg, k)
        if k:
            r.editor_camera.orbit([0.0, 0.0, 0.0], 3.0, 2.0)
        replay_check(r, f"spheres1080_1m:ai frame {k}",
                     {**main_list, **({"warp": 1} if k else {})})
        caps.append(r.graphs.captures)
    if caps != [1, 2, 2]:
        fail(f"spheres1080_1m:ai: captures after each frame {caps}, "
             "expected [1, 2, 2]")
    print("frame loop: three chained spheres1080_1m:ai replays bit-equal to "
          "eager (history and view-proj too); frames 2 and 3 replay one "
          "graph with prev copied in", flush=True)
    replay_line(r, "spheres1080_1m:ai", card)
    del r, reg
    torch.cuda.empty_cache()

    r, reg = build_bench_scene(BENCH_GRID, dev, kernel=FUSE_TILED)
    rotate(reg, 0)
    replay_check(r, "spheres1080_1m fuse + tiled_shade frame",
                 {"visibility_resolve": 1, "texel_planar": 1})
    print("frame loop: the fuse + tiled_shade replay bit-equal to eager",
          flush=True)
    replay_line(r, "spheres1080_1m fuse + tiled_shade", card)
    del r, reg
    torch.cuda.empty_cache()

    r, reg = build_bench_scene(BENCH_GRID, dev, "ultra4k")
    rotate(reg, 0)
    replay_check(r, "ultra4k frame", main_list)
    print("frame loop: the ultra4k (bloom) replay bit-equal to eager",
          flush=True)
    replay_line(r, "ultra4k", card)
    del r, reg
    torch.cuda.empty_cache()


# phase 13: the port's bench, bench.py's every config in both timed modes
# (trident_tpu_torch/bench_sweep.py), and the interpolation net's path
BENCH_ENTRIES = (["cube512", "spheres1080", "spheres1080_1m", "ultra4k",
                  "shadows1080"]
                 + [f"{c}:ai" for c in ("cube512", "spheres1080",
                                        "spheres1080_1m", "ultra4k",
                                        "shadows1080")] + ["interp"])
BENCH_ITERS = 30
# bench.py's JSON line (bench.py:448-460) and its render lines' extra
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
BENCH_EXTRA = ("mpix_per_s", "triangles", "interactive_fps",
               "interactive_runs", "interactive_agreed", "raster", "aux",
               "backend")
THROUGHPUT_HELD = (0, 7, 14, 21, 28)  # throughput frames held to `run`
BUSY_SLACK = 1.05        # throughput FPS ≤ this × 1000 / busy ms
INTERP_TOL = 1e-4        # the net on the card against itself on the CPU
FRAMEGEN_WAIT_S = 10.0


def bench_line_faults(line: dict) -> list:
    """What a bench JSON line lacks or gets wrong: a bench_error, a key of
    bench.py's line, a key of its extra, aux other than [0, 0]."""
    faults = []
    if line.get("metric", "").startswith("bench_error"):
        return [f"error {line.get('extra')}"]
    faults += [f"no {k}" for k in BENCH_KEYS if k not in line]
    extra = line.get("extra", {})
    if line.get("metric") == "interp_infer_256":
        return faults + [f"no extra.{k}" for k in (
            "psnr_db_vs_middle_frame", "iters", "checkpoint", "backend")
            if k not in extra]
    want = BENCH_EXTRA + (("psnr_vs_native_db",)
                          if "_ai_" in line.get("metric", "") else ())
    faults += [f"no extra.{k}" for k in want if k not in extra]
    if extra.get("aux") != [0, 0]:
        faults.append(f"aux {extra.get('aux')}")
    return faults


def throughput_held(b) -> None:
    """A config's throughput mode (FrameGraphs.run_rows on device rows)
    held bit-equal to FrameGraphs.run on the same blobs at frames
    THROUGHPUT_HELD."""
    from trident_tpu_torch.render.types import FrameOutput

    for k in THROUGHPUT_HELD:
        dev_out = FrameOutput(*(None if t is None else t.clone()
                                for t in b.device_frame(k, b.prev0)))
        bad = differing(dev_out, b.interactive_frame(k, b.prev0))
        if bad:
            fail(f"bench {b.config}: throughput frame {k} differs from "
                 f"FrameGraphs.run on the same blobs in {bad}")


def throughput_busy(b, entry: str) -> tuple:
    """(busy ms, device activities) per frame of a config's throughput
    replays, in a profiling window held to the graph's launch list."""
    g = b.r.graphs.graph(b.bundles[0].key)
    step = iter(range(10 ** 6))
    busy, acts = device_busy(
        lambda: b.device_frame(next(step) % b.iters, b.prev0),
        launch_list=g.launches)
    if busy != busy:
        fail(f"bench {entry}: no profiling window of the throughput "
             "replays was whole")
    return busy, acts


def phase_bench(dev, card: str, drive) -> dict:
    """Phase 13: (a) the port's bench sweep in-process over BENCH_ENTRIES
    (every bench.py config, each also :ai, and interp): every line has
    bench.py's keys and aux [0, 0], no bench_error; on spheres1080_1m the
    throughput frames bit-equal to FrameGraphs.run; on every render entry
    the busy time of its throughput replays, its FPS within BUSY_SLACK of
    1000 / busy; (b) the interpolation net on the card
    against itself on the CPU; (c) FrameGenerator on four 1920×1080
    frames; (d) the AI-frame blend through render_viewport, bit-equal to
    eager, a new AI image replayed without a capture, and the idle cache
    missed. Returns the sweep's kernel runs."""
    from collections import Counter
    from types import SimpleNamespace

    import torch

    from trident_tpu_torch.ai.frame_generator import FrameGenerator
    from trident_tpu_torch.ai.model import (
        DEFAULT_WEIGHTS,
        load_frame_generator,
        unet_flops,
    )
    from trident_tpu_torch.bench import settings_from_env
    from trident_tpu_torch.bench_sweep import sweep

    # (a) the sweep: each entry's graph captures and replays are tallied
    # when its measurement ends (before the spheres1080_1m checks replay)
    tally = SimpleNamespace(graphs=SimpleNamespace(captured=Counter(),
                                                   replayed=Counter()))
    busy = {}

    def on_bench(entry, b):
        tally.graphs.captured.update(b.r.graphs.captured)
        tally.graphs.replayed.update(b.r.graphs.replayed)
        if entry == "spheres1080_1m":
            throughput_held(b)
        busy[entry] = throughput_busy(b, entry)

    settings = dict(settings_from_env(), iters=BENCH_ITERS)
    print(f"card before the bench sweep: {smi_sample()}", flush=True)
    t0 = time.perf_counter()
    lines, runs = drive(lambda: sweep(BENCH_ENTRIES, dev, on_bench, settings),
                        ("visibility", "resolve", "texel", "visibility_depth",
                         "shadow_taps", "warp"), (tally,))
    sweep_s = time.perf_counter() - t0
    print(f"card after the bench sweep: {smi_sample()}", flush=True)
    for entry, line in zip(BENCH_ENTRIES, lines):
        faults = bench_line_faults(line)
        if faults:
            fail(f"bench {entry}: {faults}")
    fps = {e: ln["value"] for e, ln in zip(BENCH_ENTRIES, lines)}
    if set(busy) != set(BENCH_ENTRIES) - {"interp"}:
        fail(f"bench: the throughput windows ran for {sorted(busy)} only")
    # a bench that reads faster than the card's busy time allows has a
    # wrong timing window
    for entry, (b_ms, acts) in busy.items():
        ceiling = BUSY_SLACK * 1000.0 / b_ms
        if fps[entry] > ceiling:
            fail(f"bench {entry}: throughput {fps[entry]} FPS exceeds "
                 f"{BUSY_SLACK} x 1000 / busy = {ceiling:.2f}")
        print(f"bench {entry}: throughput replays busy {b_ms:.4f} ms per "
              f"frame in {acts:.0f} device activities, {fps[entry]} FPS "
              f"(idle {1 - b_ms * fps[entry] / 1000:.4f}) <= {ceiling:.2f} "
              f"({BUSY_SLACK} x 1000 / busy) ({card})", flush=True)
    print(f"bench sweep: {len(lines)} lines with bench.py's keys, aux [0, 0], "
          f"no bench_error; spheres1080_1m's throughput frames "
          f"{list(THROUGHPUT_HELD)} bit-equal to FrameGraphs.run on the same "
          f"blobs; {sweep_s:.1f} s wall; kernel runs "
          f"{dict((n, c) for n, c in runs.items() if c)} ({card})",
          flush=True)

    # (b) the interpolation net on the card against itself on the CPU
    net_c, bc = load_frame_generator(device=dev)
    net_h, _bc = load_frame_generator(device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 6, 256, 256), np.float32))
    with torch.inference_mode():
        err = float((net_c(x.to(dev)).cpu() - net_h(x)).abs().max())
    if not err <= INTERP_TOL:
        fail(f"interpolation net on the card vs the CPU: max err {err}")
    # one inference alone: CUDA events, and its busy time (the net runs
    # eagerly, one launch a layer)
    x_c = x.to(dev)
    with torch.inference_mode():
        one_ms = cuda_ms(lambda: net_c(x_c))
        one_busy, one_acts = device_busy(lambda: net_c(x_c))
    interp_ms = lines[BENCH_ENTRIES.index("interp")]["value"]
    # the input pair and the output read and written once, every weight
    # and running statistic read once
    n_values = sum(t.numel() for t in net_c.state_dict().values()
                   if t.is_floating_point())
    flops = unet_flops(bc, 256, 256)
    b_ms, b_by = bound(4 * ((6 + 3) * 256 * 256 + n_values), flops)
    print(f"interpolation net (base {bc}, {DEFAULT_WEIGHTS.name}) on the "
          f"card vs the CPU at 256x256: max err {err:.3g} (tolerance "
          f"{INTERP_TOL}); interp {interp_ms} ms a frame against its bound "
          f"{b_ms:.4f} ms ({flops / 1e9:.4f} GFLOP, {b_by}), "
          f"{b_ms / interp_ms:.3f} of it; one inference alone "
          f"{one_ms:.4f} ms (CUDA events), busy {one_busy:.4f} ms in "
          f"{one_acts:.0f} device activities (idle "
          f"{1 - one_busy / one_ms:.4f}) ({card})", flush=True)

    # (c) FrameGenerator: four 1920x1080 frames, pairs on the worker
    gen = FrameGenerator(device=dev)
    if not gen.initialise(DEFAULT_WEIGHTS):
        fail("FrameGenerator.initialise did not start")
    rng = np.random.default_rng(1)
    jobs = [gen.process_frame(rng.random((1080, 1920, 3), np.float32))
            for _ in range(4)]
    t0, got = time.perf_counter(), None
    while got is None and time.perf_counter() - t0 < FRAMEGEN_WAIT_S:
        got = gen.try_consume_output()
        time.sleep(0.005)
    gen.shutdown()
    st = gen.stats
    if (got is None or got[1].shape != (256, 256, 3)
            or not np.isfinite(got[1]).all() or st.completed_count < 1
            or not st.last_inference_ms > 0
            or not st.average_inference_ms > 0):
        fail(f"FrameGenerator: jobs {jobs}, output "
             f"{None if got is None else got[1].shape}, stats {st}")
    print(f"FrameGenerator: jobs {jobs} from four 1920x1080 frames; job "
          f"{got[0]} done in {st.last_inference_ms:.3f} ms host time "
          f"(resize, upload, net, readback; the worker's first run) "
          f"({card})", flush=True)

    # (d) the AI-frame blend on the graph path
    r, reg = build_bench_scene(BENCH_GRID, dev)
    w, h = r.config.render.width, r.config.render.height
    rotate(reg, 0)
    plain = r.render_viewport()
    main_list = {"visibility": 1, "resolve": 1, "texel": 1}
    r.set_ai_frame(rng.random((h, w, 3), np.float32), 0.5)
    caps = r.graphs.captures
    replay_check(r, "spheres1080_1m with an AI frame at blend 0.5",
                 main_list)
    blended = r.viewports[0].last_frame
    if r.graphs.captures != caps + 1 or not bool(
            (blended.color != plain.color).any()):
        fail("the AI frame: no capture for its shape, or the frame did not "
             "change")
    r.set_ai_frame(rng.random((h, w, 3), np.float32), 0.5)
    replays = r.graphs.replays
    replay_check(r, "spheres1080_1m with a second AI frame", main_list)
    again = r.viewports[0].last_frame
    if (r.graphs.captures != caps + 1 or r.graphs.replays != replays + 1
            or again is blended):
        fail(f"a second AI frame: {r.graphs.captures - caps - 1} new "
             f"captures, {r.graphs.replays - replays} replays, idle-cache "
             f"hit {again is blended}")
    print("AI blend: spheres1080_1m with set_ai_frame(img, 0.5) bit-equal "
          "to eager render_frame; a second AI frame missed the idle cache "
          "and replayed the same graph (no capture)", flush=True)
    del r, reg, plain, blended, again
    torch.cuda.empty_cache()
    return runs


# phase 14: the forward frame's features at spheres1080_1m: vertex colours
# (the three 40-wide resolve instances), the skybox, trilinear sampling,
# animated sprites; and the 128² feature flavors
FEATURE_FRAMES = 12
SPRITE_FPS = 0.25         # time.elapsed step per frame (sprites animate)
RESOLVE_KERNELS = ("resolve_kernel", "resolve_vc_kernel",
                   "resolve_tiled_kernel", "resolve_tiled_vc_kernel",
                   "visibility_resolve_kernel", "visibility_resolve_vc_kernel")


def phase_features(dev, card: str, kernel_fns: dict, drive, results: dict,
                   bench) -> dict:
    """Phase 14: (a) on the feature frame's own ids and (T, 40) records,
    K2-vc against its plain version, tiled K2-vc against K2-vc permuted
    and its plain version, K-FUSE-vc against K1 + K2-vc and its plain
    version; on spheres1080_1m's (T, 32) records (`bench`, phase 3's
    (cs, records, bins)) the 32-wide K2 against its plain version, bit for
    bit; K2 and K2-vc timed in one window with the card's clock around
    it, and the stages beside spheres1080_1m's; (b) 12 rotating frames
    each through render_viewport with the default knobs (trilinear),
    tiled_shade (bilinear) and fuse: each replay bit-equal to its eager
    frame, aux [0, 0], the vc instance launched once a frame and the
    32-wide one never, the sky not the clear colour, the sprites covering
    pixels; (c) the 128² feature flavors against the JAX package's
    frames. Adds the vc kernels to `kernel_fns` and `results` and returns
    the main-path launch counts."""
    import tempfile

    import torch

    from trident_tpu_torch.ops import deferred, planes, raster, resolve
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        render_frame,
    )
    from trident_tpu_torch.render.types import GBuffer

    kernel_fns.update(resolve_vc=resolve.resolve_attrs_vc,
                      resolve_tiled_vc=resolve.resolve_attrs_tiled_vc,
                      visibility_resolve_vc=resolve.fused_visibility_resolve_vc)

    # (a) the kernels on the feature frame's own intermediates
    r, reg = build_feature_scene(BENCH_GRID, dev)
    rotate(reg, 0)
    r.editor_camera.set_viewport_size(1920, 1080)
    inp = r.frame_inputs()
    if not inp["vertex_colors"] or inp["sampling"] != "trilinear" \
            or inp["skybox"] is None or inp["draw_stride"] != 0:
        fail(f"the feature scene's frame inputs: vertex_colors "
             f"{inp['vertex_colors']}, sampling {inp['sampling']}, skybox "
             f"{inp['skybox'] is not None}, draw_stride "
             f"{inp['draw_stride']}")
    w, h = inp["width"], inp["height"]
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    n_tiles = ntx * nty
    geo_kw = dict(width=w, height=h, draw_stride=0, real_draws=0)
    geo_args = (inp["plan"], inp["tri_draw"], inp["params"],
                inp["shade_table"], inp["camera"], inp["textures"],
                inp["corner_t"])
    cs, records = frame_geometry(*geo_args, vertex_colors=True, **geo_kw)
    n_tri = int(inp["plan"].tri_valid.sum())
    print(f"features: {n_tri} triangles ({BENCH_GRID ** 2} vertex-coloured "
          f"spheres, {FEATURE_SPRITES ** 2} sprites), records "
          f"{tuple(records.shape)}, skybox level "
          f"{tuple(inp['skybox'].faces.shape)}, {w}x{h}", flush=True)
    if tuple(records.shape) != (inp["corner_t"].shape[1],
                                planes.RR_WIDTH_VCOLOR):
        fail(f"the vertex-colour records are {tuple(records.shape)}")
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    if bins.aux.tolist() != [0, 0]:
        fail(f"binning overflow on the feature frame: aux "
             f"{bins.aux.tolist()}")
    d1, t1 = raster.visibility_tiles(bins, ntx, n_tiles)
    tri = raster.untile_frame(t1, ntx, nty)[:h, :w].contiguous()
    a_k = resolve.resolve_attrs_vc(tri, records)
    a_p = resolve.resolve_attrs_plain(tri, records)
    at = resolve.resolve_attrs_tiled_vc(t1, records, ntx)
    atp = resolve.resolve_attrs_tiled_plain(t1, records, ntx)
    df, tf, af = resolve.fused_visibility_resolve_vc(bins, records, ntx,
                                                     n_tiles)
    dfp, tfp, afp = resolve.fused_visibility_resolve_plain(bins, records, ntx,
                                                           n_tiles)
    torch.cuda.synchronize()

    def same_bits(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    def vs_k2(a_t):
        return float((raster.untile_channels(a_t, ntx, nty)[:h, :w]
                      - a_k).abs().max())

    err_ch = (a_k - a_p).abs().reshape(-1, resolve.CHANNELS).amax(0)
    vc_ch = slice(resolve.CH_CF, resolve.CH_CF + 3)
    err = {"K2-vc vs plain": float(err_ch.max()),
           "tiled K2-vc vs K2-vc": vs_k2(at),
           "tiled K2-vc vs plain": float((at - atp).abs().max()),
           "K-FUSE-vc vs K2-vc": vs_k2(af),
           "K-FUSE-vc vs plain": float((af - afp).abs().max())}
    bad = [int((tf != t1).sum()), same_bits(df, d1), int((tf != tfp).sum()),
           same_bits(df, dfp)]
    finite = all(bool(torch.isfinite(a).all()) for a in (a_k, at, af))
    cf = a_k[tri >= 0][:, vc_ch]
    print(f"resolve_vc per-channel max err vs plain: {err_ch.tolist()}; "
          f"colour factor rgb spread {cf.std(0).tolist()}", flush=True)
    if any(bad) or not finite or max(err.values()) > RESOLVE_TOL \
            or float(cf.std(0).min()) < 0.01:
        fail(f"vc kernels disagree: K-FUSE-vc ids/depths {bad} vs K1 and "
             f"plain, attrs {err}, finite {finite}, colour spread "
             f"{cf.std(0).tolist()}")
    print(f"vc kernels: K-FUSE-vc depth and ids bit-equal to K1 and to its "
          f"plain version; attribute max errors {err}", flush=True)

    # the 32-wide K2 on spheres1080_1m's own records, bit for bit
    cs32, rec32, bins32 = bench
    _d32, t32 = raster.visibility_tiles(bins32, ntx, n_tiles)
    tri32 = raster.untile_frame(t32, ntx, nty)[:h, :w].contiguous()
    k32 = resolve.resolve_attrs(tri32, rec32)
    p32 = resolve.resolve_attrs_plain(tri32, rec32)
    torch.cuda.synchronize()
    bits32 = same_bits(k32, p32)
    err32 = float((k32 - p32).abs().max())
    print(f"resolve (32-wide) on spheres1080_1m's records: {bits32} values "
          f"differ in any bit from its plain version (max err {err32})",
          flush=True)
    if err32 > RESOLVE_TOL:
        fail(f"the 32-wide resolve kernel disagrees: max err {err32}")

    # what the compiler made of the resolve instances: registers and
    # spills of each, and the SASS digest of each (a 32-wide kernel's
    # digest equal to the previous build's is the same code)
    from trident_tpu_torch import _build
    from trident_tpu_torch.tools_dev import kernel_sass

    for line in kernel_sass.resource_usage(["resolve.cu",
                                            "visibility_resolve.cu"]):
        print(f"ptxas {line}", flush=True)
    for name, (n_ins, digest) in sorted(kernel_sass.sass_digests(
            _build.build(), RESOLVE_KERNELS).items()):
        print(f"sass {name}: {n_ins} instructions, sha256 {digest}",
              flush=True)

    # bounds from this frame's data: ids and 64 B of attributes per pixel,
    # one 160-byte row per distinct winner; K-FUSE-vc adds K1's work
    vis = vis_work(bins, cs.setup, ntx, n_tiles, 8)
    n_winners = int(torch.unique(tri[tri >= 0]).numel())
    n_px_t = n_tiles * raster.TILE_PX
    row_vc = planes.RR_WIDTH_VCOLOR * 4
    work = {
        "resolve_vc": (
            bound(w * h * (4 + 4 * resolve.CHANNELS) + n_winners * row_vc),
            "trident_tpu_torch/csrc/resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:412", err["K2-vc vs plain"],
            lambda: resolve.resolve_attrs_vc(tri, records),
            lambda: resolve.resolve_attrs_plain(tri, records)),
        "resolve_tiled_vc": (
            bound(n_px_t * 4 * (1 + resolve.CHANNELS) + n_winners * row_vc),
            "trident_tpu_torch/csrc/resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:412",
            err["tiled K2-vc vs K2-vc"],
            lambda: resolve.resolve_attrs_tiled_vc(t1, records, ntx),
            lambda: resolve.resolve_attrs_tiled_plain(t1, records, ntx)),
        "visibility_resolve_vc": (
            bound(vis.bytes + n_px_t * 4 * resolve.CHANNELS
                  + n_winners * row_vc, vis.ops),
            "trident_tpu_torch/csrc/visibility_resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:281",
            err["K-FUSE-vc vs K2-vc"],
            lambda: resolve.fused_visibility_resolve_vc(bins, records, ntx,
                                                        n_tiles),
            lambda: resolve.fused_visibility_resolve_plain(bins, records, ntx,
                                                           n_tiles)),
    }
    for name, ((b_ms, b_by), src, repl, err_, fn, plain) in work.items():
        res = dict(route="cuda", source=src, replaces=repl, max_abs_err=err_,
                   ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None)
        results[name] = res
        print(f"{name}: kernel {res['ms']:.4f} ms, plain "
              f"{res['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
              f"({card})", flush=True)
    n_win32 = int(torch.unique(tri32[tri32 >= 0]).numel())
    b32 = bound(w * h * (4 + 4 * resolve.CHANNELS)
                + n_win32 * planes.RR_WIDTH * 4)[0]
    # the same frame's geometry without colours: the 32-wide instances on
    # this frame's own ids, so that a vc / 32-wide ratio is the row width
    # alone
    _cs, rec_f32 = frame_geometry(*geo_args, **geo_kw)
    del _cs
    window = {
        "K2": lambda: resolve.resolve_attrs(tri32, rec32),
        "K2 (this frame)": lambda: resolve.resolve_attrs(tri, rec_f32),
        "K2-vc": lambda: resolve.resolve_attrs_vc(tri, records),
        "K1": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "tiled K2 (this frame)": lambda: resolve.resolve_attrs_tiled(
            t1, rec_f32, ntx),
        "tiled K2-vc": lambda: resolve.resolve_attrs_tiled_vc(t1, records,
                                                              ntx),
        "K-FUSE (this frame)": lambda: resolve.fused_visibility_resolve(
            bins, rec_f32, ntx, n_tiles),
        "K-FUSE-vc": lambda: resolve.fused_visibility_resolve_vc(
            bins, records, ntx, n_tiles),
    }
    smi_before = smi_sample()
    times = {k: (cuda_ms(fn), device_busy(fn)[0]) for k, fn in window.items()}
    smi_after = smi_sample()
    busy = {k: b for k, (_e, b) in times.items()}
    print("K2 and the vc kernels in one window, ms events / busy: "
          + ", ".join(f"{k} {e:.4f} / {b:.4f}" for k, (e, b) in times.items())
          + f"; K2-vc / K2 busy {busy['K2-vc'] / busy['K2']:.3f} "
          f"(on this frame's ids {busy['K2-vc'] / busy['K2 (this frame)']:.3f}"
          f", tiled {busy['tiled K2-vc'] / busy['tiled K2 (this frame)']:.3f}"
          f", K-FUSE {busy['K-FUSE-vc'] / busy['K-FUSE (this frame)']:.3f})"
          f"; bounds K2 "
          f"{b32:.4f} ms ({n_win32} winners x 128 B), K2-vc "
          f"{results['resolve_vc']['bound_ms']:.4f} ms ({n_winners} winners "
          f"x 160 B); K2 at {b32 / busy['K2']:.3f} and K2-vc at "
          f"{results['resolve_vc']['bound_ms'] / busy['K2-vc']:.3f} of their "
          f"bounds; K-FUSE-vc / (K1 + tiled K2-vc) busy "
          f"{busy['K-FUSE-vc'] / (busy['K1'] + busy['tiled K2-vc']):.3f}; "
          f"card {smi_before} -> {smi_after} ({card})", flush=True)

    # the stages of the feature frame beside spheres1080_1m's
    gbuf = GBuffer(tri_id=tri, depth=raster.untile_frame(
        d1, ntx, nty)[:h, :w].contiguous(), aux=bins.aux)
    shade_kw = dict(textures=inp["textures"], camera=inp["camera"],
                    lights=inp["lights"], width=w, height=h,
                    clear_color=inp["clear_color"])
    a32 = resolve.resolve_attrs(tri32, rec32)
    gbuf32 = GBuffer(tri_id=tri32, depth=gbuf.depth, aux=bins32.aux)
    print_stages("feature stages (spheres1080_1m's beside)", {
        "geometry": lambda: frame_geometry(*geo_args, vertex_colors=True,
                                           **geo_kw),
        "records": lambda: planes.build_resolve_cols_planar(cs.cols),
        "records_spheres1080_1m": lambda: planes.build_resolve_cols_planar(
            cs32.cols),
        "binning": lambda: raster.build_bins(cs.setup, w, h,
                                             setup_cols=cs.cols.setup),
        "visibility": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "resolve": lambda: resolve.resolve_attrs_vc(tri, records),
        "background": lambda: deferred._background(
            inp["camera"], inp["skybox"], w, h, inp["clear_color"], dev),
        "shading": lambda: deferred.deferred_shade_attrs(
            gbuf, a_k, skybox=inp["skybox"], sampling="trilinear",
            **shade_kw),
        "shading_spheres1080_1m": lambda: deferred.deferred_shade_attrs(
            gbuf32, a32, **shade_kw),
    }, card)
    del cs, records, bins, d1, t1, tri, a_k, a_p, at, atp, df, tf, af, dfp
    del tfp, afp, t32, tri32, k32, p32, a32, gbuf, gbuf32, work, vis, inp
    del rec_f32, window
    torch.cuda.empty_cache()

    # (b) 12 frames each through render_viewport: default knobs
    # (trilinear), tiled_shade with bilinear sampling, fuse
    tiled_r, _ = build_feature_scene(BENCH_GRID, dev, sampling="bilinear",
                                     kernel={"tiled_shade": True}, reg=reg)
    fuse_r, _ = build_feature_scene(BENCH_GRID, dev, kernel={"fuse": True},
                                    reg=reg)
    runs = {"default": (r, {"visibility": 1, "resolve_vc": 1, "texel": 2}),
            "tiled_shade": (tiled_r, {"visibility": 1, "resolve_tiled_vc": 1,
                                      "texel_planar": 1}),
            "fuse": (fuse_r, {"visibility_resolve_vc": 1, "texel": 2})}
    n_mesh = BENCH_GRID ** 2
    clear = torch.round(torch.tensor(r.config.render.clear_color, device=dev)
                        * 255.0).to(torch.uint8)
    frame_ms = {name: [] for name in runs}
    held = []

    def feature_frames():
        for k in range(FEATURE_FRAMES):
            rotate(reg, k)
            for name, (rr, expect) in runs.items():
                rr.time.elapsed = k * SPRITE_FPS
                ctx = rr.viewports[0]
                rr.editor_camera.set_viewport_size(ctx.width, ctx.height)
                kinp = rr.frame_inputs()
                t0 = time.perf_counter()
                out = rr.render_viewport()
                torch.cuda.synchronize()
                frame_ms[name].append((time.perf_counter() - t0) * 1e3)
                if rr.graphs.last_launches != expect:
                    fail(f"features {name} frame {k}: the graph's launch "
                         f"list {rr.graphs.last_launches}, expected {expect}")
                held.append((f"features {name} frame {k}", out, kinp,
                             rr._last_tri_draw))
        return out

    _out, launches14 = drive(feature_frames, ("resolve_vc",
                                              "resolve_tiled_vc",
                                              "visibility_resolve_vc"),
                             tuple(rr for rr, _e in runs.values()))
    sky_share, sprite_px = [], []
    for what, out, kinp, tri_draw in held:
        same_as_eager(out, kinp, what)        # and aux [0, 0]
        sky = out.tri_id < 0
        not_clear = (out.color[..., :3] != clear[:3]).any(-1)
        share = float(not_clear[sky].float().mean())
        n_sprite = int(((out.tri_id >= 0)
                        & (tri_draw[out.tri_id.clamp_min(0).long()]
                           >= n_mesh)).sum())
        if not share > 0.99 or n_sprite < 1000:
            fail(f"{what}: {share:.4f} of {int(sky.sum())} sky pixels not "
                 f"the clear colour, {n_sprite} sprite pixels")
        sky_share.append(share)
        sprite_px.append(n_sprite)
    print(f"feature frames: replays bit-equal to eager, aux [0, 0]; sky "
          f"pixels not the clear colour min share {min(sky_share):.4f}; "
          f"sprite pixels {min(sprite_px)} .. {max(sprite_px)}; launches "
          f"{launches14}", flush=True)
    del held
    for name, (rr, _e) in runs.items():
        kinp = rr.frame_inputs()
        dev_ms = cuda_ms(lambda: render_frame(**kinp))
        busy_ms, n_launch = device_busy(lambda: render_frame(**kinp))
        print(f"features {name}: median "
              f"{statistics.median(frame_ms[name][2:]):.3f} ms wall per "
              f"render_viewport; render_frame {dev_ms:.3f} ms device time, "
              f"{busy_ms:.3f} ms busy in {n_launch:.0f} device activities "
              f"(idle {1 - busy_ms / dev_ms:.3f}) ({card})", flush=True)
        replay_line(rr, f"features {name}", card)
    print(f"features: memory reserved "
          f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.3f} GiB, max "
          f"allocated {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
          f"GiB ({card})", flush=True)
    del r, reg, tiled_r, fuse_r, runs, kinp
    torch.cuda.empty_cache()

    # (c) the 128² feature flavors against the JAX package's frames
    with tempfile.TemporaryDirectory() as td:
        for name in FEATURE_FLAVORS:
            fr = feature_scene(name, dev,
                               shader_path=Path(td) / "shader.py") \
                .render_viewport()
            aux = [fr.aux.tolist()] + ([fr.shadow_aux.tolist()]
                                       if fr.shadow_aux is not None else [])
            if any(a != [0, 0] for a in aux):
                fail(f"feature flavor {name} aux {aux}")
            golden_gate(fr.color.cpu().numpy(),
                        np.load(GOLDENS / f"torch_slice_{name}.npy"),
                        f"feature {name}")
    return launches14


# phase 15: the reference raster, the plane-gather frame (f16 / f32
# planes) and the indexed, skinned geometry path
ROUTE_FRAMES = 12


def psnr(a, b) -> float:
    """PSNR in dB of two RGBA8 frames' rgb (inf when equal)."""
    import math

    d = float((a[..., :3].float() - b[..., :3].float()).pow(2).mean())
    return math.inf if d == 0 else 10.0 * math.log10(255.0 ** 2 / d)


def png_golden(name: str) -> Path:
    return GOLDENS / (f"{name}.png" if name == "scene_128"
                      else f"flavor_{name}.png")


def frame_inputs_at(r) -> dict:
    """render_frame's inputs of viewport 0 as render_viewport sizes its
    camera."""
    ctx = r.viewports[0]
    r.editor_camera.set_viewport_size(ctx.width, ctx.height)
    return r.frame_inputs()


def phase_routes(dev, card: str, kernel_fns: dict, drive, bench) -> dict:
    """Phase 15: the three frame routes of this slice on the card.
    (a) the eight 128² PNG goldens (scene_128, flavor_{shadows_pcf, ssaa,
    bloom, trilinear, skybox, sprite} on the reference raster, flavor_
    f16_planes on the binned raster with f16 planes) through
    render_viewport against their PNGs under the golden gate, aux [0, 0];
    (b) the plane-gather frame (forward_shading=False) at spheres1080_1m
    with f16 and f32 planes and at shadows1080 (f16 and f32 hard, f16
    PCF): K1 on the frame's own bins and K3 on its own texel indices
    against their plain versions, bit for bit; 12 rotating frames of each
    through render_viewport, every replay bit-equal to eager
    render_frame, aux [0, 0] (the light pass's too); the f32-plane frame
    against the forward frame of the same scene and the f16 frame
    against the f32 one under the golden gate, PSNR printed; (c) the
    skinned tube crowd at 1080p (144 tubes, 1,105,920 triangles, 2,304
    bones): K2-vc on its records and K2 on its 32-wide records against
    their plain versions within RESOLVE_TOL; 12 frames whose poses
    change, replays bit-equal to eager, aux [0, 0]; one shadowed frame
    (a 1024² map through the indexed light pass): K1b on its light-pass
    bins and K4 on its taps against their plain versions, bit for bit,
    the replay bit-equal to eager; the 128² skinned frames against
    tests/goldens/torch_slice_skinned{,_shadow}.npy; (d) each new frame's
    graph replayed alone (device time, busy time, idle share), and the
    stages of the three routes beside spheres1080_1m's forward stages
    (`bench`, phase 3's (cs, records, bins)) in one window. Returns the
    launch counts of each route's run, by route."""
    import torch

    from trident_tpu_torch.io.image import read_png
    from trident_tpu_torch.ops import (
        deferred,
        planes,
        raster,
        resolve,
        shadow_taps,
        texel,
    )
    from trident_tpu_torch.ops.corner import indexed_corner_stage
    from trident_tpu_torch.ops.shadow import tap_indices
    from trident_tpu_torch.ops.vertex import triangle_setup_cols, vertex_stage
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        plane_geometry,
        plane_visibility,
        shadow_params,
    )
    from trident_tpu_torch.render.types import GBuffer
    from trident_tpu_torch.tools_dev.scenes import (
        PLANE_CONFIGS,
        PNG_GOLDENS,
        SKINNED_128,
        build_plane_scene,
        png_scene,
        pose_skinned,
        skinned_scene,
    )

    launches = {}
    w, h = 1920, 1080
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    n_tiles = ntx * nty

    def same_bits(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    # (a) the PNG goldens on the reference raster and the f16 planes
    png_rs = {name: png_scene(name, dev) for name in PNG_GOLDENS}

    def png_frames():
        return {name: rr.render_viewport() for name, rr in png_rs.items()}

    outs, launches["png"] = drive(png_frames, ("visibility", "texel",
                                               "shadow_taps"),
                                  tuple(png_rs.values()))
    for name, out in outs.items():
        aux = [out.aux.tolist()] + ([out.shadow_aux.tolist()]
                                    if out.shadow_aux is not None else [])
        if any(a != [0, 0] for a in aux):
            fail(f"PNG golden {name}: aux {aux}")
        golden_gate(out.color.cpu().numpy(), read_png(png_golden(name)),
                    name, png_golden(name).name)
    print(f"PNG goldens: {len(outs)} frames ({', '.join(outs)}) within the "
          f"golden gate of their PNGs, aux [0, 0]; launches "
          f"{launches['png']}", flush=True)
    del png_rs, outs

    # (b) the plane-gather frame at spheres1080_1m and shadows1080
    plane_rs, regs = {}, {}
    for name in PLANE_CONFIGS:
        base = PLANE_CONFIGS[name][0]
        rr, regs[base] = build_plane_scene(name, dev, reg=regs.get(base))
        plane_rs[name] = rr
    fwd_rs = {base: build_bench_scene(BENCH_GRID if base == "spheres1080_1m"
                                      else SHADOW_GRID, dev, base,
                                      reg=regs[base])[0]
              for base in regs}
    for reg in regs.values():
        rotate(reg, 0)
    for name in ("spheres1080_1m:planes_f32", "shadows1080:planes_f16"):
        rr = plane_rs[name]
        inp = frame_inputs_at(rr)
        cs, pl = plane_geometry(
            inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["corner_t"], width=w, height=h,
            plane_f16=inp["plane_f16"], draw_stride=inp["draw_stride"],
            real_draws=inp["real_draws"])
        bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
        d_k, t_k = raster.visibility_tiles(bins, ntx, n_tiles)
        d_p, t_p = raster.visibility_tiles_plain(bins, ntx, n_tiles)
        gbuf = plane_visibility(cs.setup, cs.cols.setup, w, h, "pallas")
        covered = gbuf.tri_id >= 0
        _n, uv, mip, hint, *_rest = deferred.plane_attributes(
            gbuf, pl, inp["textures"], w, h)
        idx, fx, fy = deferred.texel_index(uv, mip, hint, covered,
                                           inp["textures"].max_level)
        q = inp["textures"].quads
        x_k = texel.sample_bilinear(q, idx, fx, fy)
        x_p = texel.sample_bilinear_plain(q, idx, fx, fy)
        torch.cuda.synchronize()
        bad = [int((t_k != t_p).sum()), same_bits(d_k, d_p),
               same_bits(x_k, x_p)]
        if any(bad) or bins.aux.tolist() != [0, 0]:
            fail(f"{name}: K1 vs plain {bad[:2]} ids / depths, K3 vs plain "
                 f"{bad[2]} values, aux {bins.aux.tolist()}")
        print(f"{name}: {int(inp['plan'].tri_valid.sum())} triangles, "
              f"planes {tuple(pl.table_a.shape)} {pl.table_a.dtype}; K1 on "
              f"its {int(bins.n_real)} pairs and K3 on its "
              f"{int(covered.sum())} covered pixels' indices bit-equal to "
              f"their plain versions", flush=True)
        del cs, pl, bins, d_k, t_k, d_p, t_p, gbuf, x_k, x_p, idx, fx, fy
        del uv, mip, hint, _rest
    torch.cuda.empty_cache()

    plane_held = []

    def plane_frames():
        for k in range(ROUTE_FRAMES):
            for reg in regs.values():
                rotate(reg, k)
            for name, rr in plane_rs.items():
                kinp = frame_inputs_at(rr)
                out = rr.render_viewport()
                plane_held.append((f"{name} frame {k}", out, kinp,
                                   rr.config.render.shadows))

    _none, launches["planes"] = drive(
        plane_frames, ("visibility", "visibility_depth", "texel",
                       "shadow_taps"), tuple(plane_rs.values()))
    for what, out, kinp, shadows in plane_held:
        same_as_eager(out, kinp, what,
                      ("aux", "shadow_aux") if shadows else ("aux",))
    last = {what.split(" frame")[0]: out for what, out, _i, _s in plane_held
            if what.endswith(f"frame {ROUTE_FRAMES - 1}")}
    del plane_held
    print(f"plane-gather frames: {ROUTE_FRAMES} of each of "
          f"{', '.join(plane_rs)}, replays bit-equal to eager render_frame, "
          f"aux [0, 0] (and the light pass's); launches "
          f"{launches['planes']}", flush=True)
    for base, fr in fwd_rs.items():
        fwd = fr.render_viewport().color.cpu().numpy()
        f32 = last[f"{base}:planes_f32"].color
        f16 = last[f"{base}:planes_f16"].color
        golden_gate(f32.cpu().numpy(), fwd, f"{base} f32-plane frame",
                    "the forward frame")
        golden_gate(f16.cpu().numpy(), f32.cpu().numpy(),
                    f"{base} f16-plane frame", "the f32-plane frame")
        print(f"{base} frame {ROUTE_FRAMES - 1}: the f32-plane frame within "
              f"the golden gate of the forward frame (PSNR "
              f"{psnr(f32, torch.from_numpy(fwd).to(dev)):.3f} dB), the f16 "
              f"one within it of the f32 one (PSNR {psnr(f16, f32):.3f} dB)",
              flush=True)
    for name, rr in plane_rs.items():
        replay_line(rr, name, card)
    sph_inp = frame_inputs_at(plane_rs["spheres1080_1m:planes_f16"])
    del plane_rs, fwd_rs, last
    torch.cuda.empty_cache()

    # (c) the skinned crowd at 1080p
    sk_r, sk_reg = skinned_scene(dev)
    inp = frame_inputs_at(sk_r)
    if inp["corner_t"] is not None or not inp["skinned"] \
            or not inp["vertex_colors"] or inp["draw_stride"] != 0:
        fail(f"the skinned frame's inputs: corner table "
             f"{inp['corner_t'] is not None}, skinned {inp['skinned']}, "
             f"vertex colours {inp['vertex_colors']}, draw_stride "
             f"{inp['draw_stride']}")
    sk_geo = dict(width=w, height=h, geometry=inp["geometry"],
                  palette=inp["palette"], skinned=True)
    sk_args = (inp["plan"], inp["tri_draw"], inp["params"],
               inp["shade_table"], inp["camera"], inp["textures"], None)
    cs, rec40 = frame_geometry(*sk_args, vertex_colors=True, **sk_geo)
    _cs32, rec32 = frame_geometry(*sk_args, **sk_geo)
    del _cs32
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    _d, t_k = raster.visibility_tiles(bins, ntx, n_tiles)
    tri = raster.untile_frame(t_k, ntx, nty)[:h, :w].contiguous()
    err = {}
    for what, rec, fn in (("K2-vc", rec40, resolve.resolve_attrs_vc),
                          ("K2", rec32, resolve.resolve_attrs)):
        a_k, a_p = fn(tri, rec), resolve.resolve_attrs_plain(tri, rec)
        torch.cuda.synchronize()
        err[what] = float((a_k - a_p).abs().max())
        if not bool(torch.isfinite(a_k).all()) or err[what] > RESOLVE_TOL:
            fail(f"skinned frame: {what} disagrees with its plain version "
                 f"by {err[what]}")
    n_tri = int(inp["plan"].tri_valid.sum())
    print(f"skinned: {n_tri} triangles, palette "
          f"{tuple(inp['palette'].shape)}, records {tuple(rec40.shape)} and "
          f"{tuple(rec32.shape)}, {int((tri >= 0).sum())} covered pixels, "
          f"bins aux {bins.aux.tolist()}; K2-vc and K2 on its records vs "
          f"plain, max err {err}", flush=True)
    if bins.aux.tolist() != [0, 0]:
        fail(f"binning overflow on the skinned frame: {bins.aux.tolist()}")
    sk_stage = dict(inp=inp, cs=cs, rec40=rec40, tri=tri,
                    gbuf=GBuffer(tri_id=tri, depth=raster.untile_frame(
                        _d, ntx, nty)[:h, :w].contiguous(), aux=bins.aux))
    del bins, t_k, rec32

    sk_held = []

    def skinned_frames():
        for k in range(ROUTE_FRAMES):
            pose_skinned(sk_reg, k)
            kinp = frame_inputs_at(sk_r)
            sk_held.append((f"skinned frame {k}", sk_r.render_viewport(),
                            kinp))

    _none, launches["skinned"] = drive(
        skinned_frames, ("visibility", "resolve_vc", "texel"), (sk_r,))
    for what, out, kinp in sk_held:
        same_as_eager(out, kinp, what)
    moved = [int((a[1].color != b[1].color).any(-1).sum())
             for a, b in zip(sk_held, sk_held[1:])]
    if min(moved) < 1000:
        fail(f"skinned frames: pixels changed between poses {moved}")
    del sk_held
    print(f"skinned frames: {ROUTE_FRAMES} poses, replays bit-equal to eager"
          f" render_frame, aux [0, 0]; pixels changed between poses "
          f"{min(moved)} .. {max(moved)}; launches {launches['skinned']}",
          flush=True)
    replay_line(sk_r, "skinned", card)

    # the shadowed crowd: the indexed light pass's kernels, then its frame
    sh_r, _sh_reg = skinned_scene(dev, shadows=True)
    sinp = frame_inputs_at(sh_r)
    s, lcam = sinp["shadow_size"], sinp["light_camera"]
    verts = vertex_stage(sinp["geometry"], sinp["plan"], sinp["params"],
                         lcam, sinp["palette"], skinned=True)
    lsetup, lcols = triangle_setup_cols(verts.clip, sinp["plan"].tri_vtx,
                                        sinp["plan"].tri_valid, s, s)
    lbins = raster.build_bins(lsetup, s, s, setup_cols=lcols)
    lntx = -(-s // raster.TILE)
    dd_k = raster.visibility_depth_tiles(lbins, lntx, lntx * lntx)
    dd_p = raster.visibility_tiles_plain(lbins, lntx, lntx * lntx,
                                         depth_only=True)
    shadow, _saux = shadow_params(
        sinp["plan"], sinp["params"], sinp["tri_draw"], None, lcam, s, 2e-3,
        geometry=sinp["geometry"], palette=sinp["palette"], skinned=True)
    scs, srec = frame_geometry(
        sinp["plan"], sinp["tri_draw"], sinp["params"], sinp["shade_table"],
        sinp["camera"], sinp["textures"], None, vertex_colors=True,
        width=w, height=h, geometry=sinp["geometry"],
        palette=sinp["palette"], skinned=True)
    sgbuf = raster.visibility(scs.setup, w, h, setup_cols=scs.cols.setup)
    world = deferred.world_positions(sgbuf.depth, sinp["camera"], w, h)
    bad_taps = {}
    for pcf in (False, True):
        ti = tap_indices(shadow, world, pcf)
        b_k = shadow_taps.shadow_tap_bits(shadow.depth, *ti)
        b_p = shadow_taps.shadow_tap_bits_plain(shadow.depth, *ti)
        torch.cuda.synchronize()
        bad_taps["pcf" if pcf else "hard"] = int((b_k != b_p).sum())
    bad_depth = same_bits(dd_k, dd_p)
    map_dk = raster.untile_frame(dd_k, lntx, lntx)[:s, :s]
    if bad_depth or any(bad_taps.values()) or lbins.aux.tolist() != [0, 0] \
            or not torch.equal(map_dk, shadow.depth):
        fail(f"skinned light pass: K1b vs plain {bad_depth} depths, K4 vs "
             f"plain {bad_taps} taps, aux {lbins.aux.tolist()}, map equal "
             f"to the light pass's {torch.equal(map_dk, shadow.depth)}")
    print(f"skinned light pass at {s}²: {int(lbins.n_real)} pairs, "
          f"{int((dd_k < 1.0).sum())} map texels covered; K1b and K4 (hard "
          f"and PCF) bit-equal to their plain versions", flush=True)
    del verts, lsetup, lcols, lbins, dd_k, dd_p, map_dk, scs, srec, sgbuf
    del world, shadow

    def shadow_frame():
        return sh_r.render_viewport()

    sh_out, launches["skinned_shadow"] = drive(
        shadow_frame, ("visibility", "visibility_depth", "resolve_vc",
                       "texel", "shadow_taps"), (sh_r,))
    same_as_eager(sh_out, sinp, "skinned shadowed frame",
                  ("aux", "shadow_aux"))
    print(f"skinned shadowed frame: replay bit-equal to eager, aux [0, 0] "
          f"(and the light pass's); launches {launches['skinned_shadow']}",
          flush=True)
    replay_line(sh_r, "skinned shadowed", card)
    del sh_r, sinp, sh_out
    for shadows in (False, True):
        gr, _g = skinned_scene(dev, shadows=shadows, **SKINNED_128)
        out = gr.render_viewport()
        aux = [out.aux.tolist()] + ([out.shadow_aux.tolist()]
                                    if shadows else [])
        if any(a != [0, 0] for a in aux):
            fail(f"128² skinned frame aux {aux}")
        golden_gate(out.color.cpu().numpy(), np.load(
            GOLDENS / f"torch_slice_skinned{'_shadow' if shadows else ''}"
            ".npy"), f"skinned{' shadowed' if shadows else ''} 128²")

    # (d) the stages of the three routes beside spheres1080_1m's forward
    # stages, in one window
    fcs, frec, fbins = bench
    _fd, ft = raster.visibility_tiles(fbins, ntx, n_tiles)
    ftri = raster.untile_frame(ft, ntx, nty)[:h, :w].contiguous()
    fgbuf = GBuffer(tri_id=ftri, depth=raster.untile_frame(
        _fd, ntx, nty)[:h, :w].contiguous(), aux=fbins.aux)
    fattrs = resolve.resolve_attrs(ftri, frec)
    pcs, pl16 = plane_geometry(
        sph_inp["plan"], sph_inp["tri_draw"], sph_inp["params"],
        sph_inp["shade_table"], sph_inp["camera"], sph_inp["corner_t"],
        width=w, height=h, plane_f16=True,
        draw_stride=sph_inp["draw_stride"], real_draws=sph_inp["real_draws"])
    pl32 = planes.build_planes_cols(pcs.cols, pcs.setup.bbox,
                                    sph_inp["tri_draw"],
                                    sph_inp["shade_table"])
    pgbuf = plane_visibility(pcs.setup, pcs.cols.setup, w, h, "pallas")
    sk = sk_stage
    ski = sk["inp"]
    sk_verts = vertex_stage(ski["geometry"], ski["plan"], ski["params"],
                            ski["camera"], ski["palette"], skinned=True)
    sk_attrs = resolve.resolve_attrs_vc(sk["tri"], sk["rec40"])
    shade_kw = dict(textures=sph_inp["textures"], camera=sph_inp["camera"],
                    lights=sph_inp["lights"], width=w, height=h,
                    clear_color=sph_inp["clear_color"])
    sph_geo = (sph_inp["plan"], sph_inp["tri_draw"], sph_inp["params"],
               sph_inp["shade_table"], sph_inp["camera"])
    sph_stride = dict(draw_stride=sph_inp["draw_stride"],
                      real_draws=sph_inp["real_draws"])
    print_stages("route stages (spheres1080_1m forward, planes; skinned)", {
        "forward_geometry": lambda: frame_geometry(
            *sph_geo, sph_inp["textures"], sph_inp["corner_t"], width=w,
            height=h, **sph_stride),
        "forward_records": lambda: planes.build_resolve_cols_planar(
            fcs.cols),
        "forward_resolve": lambda: resolve.resolve_attrs(ftri, frec),
        "forward_shading": lambda: deferred.deferred_shade_attrs(
            fgbuf, fattrs, **shade_kw),
        "planes_geometry_f16": lambda: plane_geometry(
            *sph_geo, sph_inp["corner_t"], width=w, height=h,
            plane_f16=True, **sph_stride),
        "planes_f16": lambda: planes.build_planes_cols(
            pcs.cols, pcs.setup.bbox, sph_inp["tri_draw"],
            sph_inp["shade_table"], f16=True),
        "planes_f32": lambda: planes.build_planes_cols(
            pcs.cols, pcs.setup.bbox, sph_inp["tri_draw"],
            sph_inp["shade_table"]),
        "planes_visibility": lambda: plane_visibility(
            pcs.setup, pcs.cols.setup, w, h, "pallas"),
        "deferred_shade_f16": lambda: deferred.deferred_shade(
            pgbuf, pl16, **shade_kw),
        "deferred_shade_f32": lambda: deferred.deferred_shade(
            pgbuf, pl32, **shade_kw),
        "skinned_vertex_stage": lambda: vertex_stage(
            ski["geometry"], ski["plan"], ski["params"], ski["camera"],
            ski["palette"], skinned=True),
        "skinned_corners_setup": lambda: indexed_corner_stage(
            sk_verts.packed, ski["plan"].tri_vtx, ski["plan"].tri_valid, w,
            h, vertex_colors=True),
        "skinned_records": lambda: planes.build_resolve_cols_planar(
            sk["cs"].cols),
        "skinned_resolve_vc": lambda: resolve.resolve_attrs_vc(
            sk["tri"], sk["rec40"]),
        "skinned_shading": lambda: deferred.deferred_shade_attrs(
            sk["gbuf"], sk_attrs, textures=ski["textures"],
            camera=ski["camera"], lights=ski["lights"], width=w, height=h,
            clear_color=ski["clear_color"]),
    }, card)
    del sk_stage, sk, ski, sk_verts, sk_attrs, pcs, pl16, pl32, pgbuf
    del fgbuf, fattrs, ftri, ft, _fd, sk_r, sk_reg, inp, cs, rec40, tri
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    # -- phase 1: the card ---------------------------------------------------
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, RuntimeError) as exc:
        fail(f"nvidia-smi did not run: {exc}")
    print(f"card: {card}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)

    # -- phase 2: build ------------------------------------------------------
    from trident_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"(nvcc {_build.build_seconds} s; library {_build.BUILD_DIR})",
          flush=True)

    from trident_tpu_torch.ops import raster, resolve, shadow_taps, texel
    from trident_tpu_torch.ops import planes
    from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage
    from trident_tpu_torch.ops.deferred import (
        deferred_shade_attrs,
        texel_lookup,
        world_positions,
    )
    from trident_tpu_torch.ops.shadow import shadow_factor, tap_indices
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        render_frame,
        render_frame_entry,
        shadow_params,
    )
    from trident_tpu_torch.render.types import GBuffer

    kernel_fns = {"visibility": raster.visibility_tiles,
                  "visibility_depth": raster.visibility_depth_tiles,
                  "resolve": resolve.resolve_attrs,
                  "texel": texel.sample_bilinear,
                  "shadow_taps": shadow_taps.shadow_tap_bits}

    def drive(path, needed, renderers=()):
        """Run `path` with every launch count set to 0 just before; the
        counts just after, failing if a kernel in `needed` never ran. A
        count is the kernel's runs: its wrapper's launches, less those the
        graph captures of `renderers` (every Renderer whose frames `path`
        renders) recorded, plus those their replays ran."""
        for fn in kernel_fns.values():
            fn.launches = 0
        for rr in renderers:
            rr.graphs.captured.clear()
            rr.graphs.replayed.clear()
        out = path()
        torch.cuda.synchronize()
        counts = {name: fn.launches
                  - sum(rr.graphs.captured[name] for rr in renderers)
                  + sum(rr.graphs.replayed[name] for rr in renderers)
                  for name, fn in kernel_fns.items()}
        for name in needed:
            if counts[name] < 1:
                fail(f"the main path never launched the {name} kernel")
        return out, counts

    # -- phase 3: each kernel against its plain version -----------------------
    r, reg = build_bench_scene(BENCH_GRID, dev)
    rotate(reg, 0)
    r.editor_camera.set_viewport_size(1920, 1080)
    inp = r.frame_inputs()
    w, h = inp["width"], inp["height"]
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    n_tri = int(inp["plan"].tri_valid.sum())
    print(f"scene: {n_tri} triangles, {w}x{h}, draw_stride "
          f"{inp['draw_stride']}", flush=True)
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    n_tiles = ntx * nty
    if bins.aux.tolist() != [0, 0]:
        fail(f"binning overflow on the bench frame: aux {bins.aux.tolist()}")
    print(f"bins: {int(bins.n_real)} pairs", flush=True)

    results = {}
    d_k, t_k = raster.visibility_tiles(bins, ntx, n_tiles)
    d_p, t_p = raster.visibility_tiles_plain(bins, ntx, n_tiles)
    torch.cuda.synchronize()
    bad_id = int((t_k != t_p).sum())
    bad_depth = int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())
    if bad_id or bad_depth:
        fail(f"visibility kernel disagrees: {bad_id} ids, {bad_depth} depths")
    vis = vis_work(bins, cs.setup, ntx, n_tiles, 8)
    region_line("visibility at spheres1080_1m", vis)
    print(f"card before phase 3's timing: {smi_sample()}", flush=True)
    results["visibility"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/visibility.cu",
        replaces="trident_tpu/ops/raster_pallas.py:943",
        max_abs_err=float((d_k - d_p).abs().max()),
        ms=cuda_ms(lambda: raster.visibility_tiles(bins, ntx, n_tiles)),
        plain_ms=cuda_ms(
            lambda: raster.visibility_tiles_plain(bins, ntx, n_tiles)),
        library_ms=None)
    results["visibility"].update(zip(("bound_ms", "bound_by"), bound(
        vis.bytes, vis.ops)))
    covered = int((t_k >= 0).sum())
    print(f"visibility: {covered} covered pixels", flush=True)

    tri = raster.untile_frame(t_k, ntx, nty)[:h, :w].contiguous()
    a_k = resolve.resolve_attrs(tri, records)
    a_p = resolve.resolve_attrs_plain(tri, records)
    err_ch = (a_k - a_p).abs().reshape(-1, resolve.CHANNELS).amax(0)
    if not bool(torch.isfinite(a_k).all()) or float(err_ch.max()) > RESOLVE_TOL:
        fail(f"resolve kernel disagrees: per-channel {err_ch.tolist()}")
    print(f"resolve per-channel max err: {err_ch.tolist()}", flush=True)
    n_winners = int(torch.unique(tri[tri >= 0]).numel())
    results["resolve"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/resolve.cu",
        replaces="trident_tpu/ops/resolve_pallas.py:412",
        max_abs_err=float(err_ch.max()),
        ms=cuda_ms(lambda: resolve.resolve_attrs(tri, records)),
        plain_ms=cuda_ms(lambda: resolve.resolve_attrs_plain(tri, records)),
        library_ms=None)
    results["resolve"].update(zip(("bound_ms", "bound_by"), bound(
        w * h * (4 + 4 * resolve.CHANNELS)
        + n_winners * planes.RR_WIDTH * 4)))

    q = inp["textures"].quads
    idx, fx, fy = texel_lookup(a_k, tri >= 0, inp["textures"].max_level)
    x_k = texel.sample_bilinear(q, idx, fx, fy)
    x_p = texel.sample_bilinear_plain(q, idx, fx, fy)
    bad_tx = int((x_k.view(torch.int32) != x_p.view(torch.int32)).sum())
    if bad_tx:
        fail(f"texel kernel disagrees on {bad_tx} values")
    n_quads = int(torch.unique(idx[idx >= 0]).numel())
    results["texel"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/texel.cu",
        replaces="trident_tpu/ops/texel_pallas.py:118",
        max_abs_err=float((x_k - x_p).abs().max()),
        ms=cuda_ms(lambda: texel.sample_bilinear(q, idx, fx, fy)),
        plain_ms=cuda_ms(lambda: texel.sample_bilinear_plain(q, idx, fx, fy)),
        library_ms=None)
    results["texel"].update(zip(("bound_ms", "bound_by"), bound(
        w * h * (12 + 16) + n_quads * 16)))
    busy = {"visibility": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
            "resolve": lambda: resolve.resolve_attrs(tri, records),
            "texel": lambda: texel.sample_bilinear(q, idx, fx, fy)}
    busy_ms = {}
    for name, res in results.items():
        busy_ms[name] = device_busy(busy[name])[0]
        print(f"{name}: kernel {res['ms']:.4f} ms (device busy "
              f"{busy_ms[name]:.4f} ms), plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}) ({card})", flush=True)
    print(f"card after phase 3's timing: {smi_sample()}", flush=True)
    print(f"resolve (K2) / visibility (K1) busy in that window: "
          f"{busy_ms['resolve'] / busy_ms['visibility']:.3f}; K2 at "
          f"{results['resolve']['bound_ms'] / busy_ms['resolve']:.3f} of its "
          f"bound; {n_winners} distinct winners, {covered} covered pixels "
          f"({card})", flush=True)
    # the (T, 32) table (127 MB here) outgrows the 50 MB L2: warm and
    # flushed readings of K2 should agree
    cold_line("resolve", busy["resolve"], results["resolve"]["bound_ms"],
              l2_flush(dev), card)

    # where the frame's device time goes: each stage of render_frame alone,
    # on this frame's intermediates
    gbuf = GBuffer(tri_id=tri, depth=raster.untile_frame(
        d_k, ntx, nty)[:h, :w].contiguous(), aux=bins.aux)
    stages = {
        "geometry": lambda: frame_geometry(
            inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["textures"], inp["corner_t"], width=w,
            height=h, draw_stride=inp["draw_stride"],
            real_draws=inp["real_draws"]),
        # the (T, 32) record table alone, as frame_geometry builds it
        "records": lambda: planes.build_resolve_cols_planar(cs.cols),
        "binning": lambda: raster.build_bins(cs.setup, w, h,
                                             setup_cols=cs.cols.setup),
        "visibility": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "untile": lambda: (raster.untile_frame(t_k, ntx, nty)[:h, :w]
                           .contiguous(),
                           raster.untile_frame(d_k, ntx, nty)[:h, :w]
                           .contiguous()),
        "resolve": lambda: resolve.resolve_attrs(tri, records),
        "shading": lambda: deferred_shade_attrs(
            gbuf, a_k, inp["textures"], inp["camera"], inp["lights"], w, h,
            clear_color=inp["clear_color"]),
    }
    print_stages("stages", stages, card)

    # -- phase 4: the main path through the Renderer --------------------------
    frame_ms, host_ms = [], []

    def spheres_frames():
        out = None
        for k in range(12):
            rotate(reg, k)
            t0 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if out.aux.tolist() != [0, 0]:
                fail(f"frame {k}: raster overflow aux {out.aux.tolist()}")
            # the host share of the same frame: its draw gathering alone,
            # on the transforms just rendered (frame_inputs launches no
            # kernel)
            t0 = time.perf_counter()
            r.frame_inputs()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    out, launches4 = drive(spheres_frames, ("visibility", "resolve", "texel"),
                           (r,))
    color = out.color
    if tuple(color.shape) != (1080, 1920, 4) or color.dtype != torch.uint8:
        fail(f"frame shape {tuple(color.shape)} {color.dtype}")
    clear = torch.round(torch.tensor(r.config.render.clear_color) * 255.0)
    n_fg = int((color.float().cpu() != clear).any(-1).sum())
    if n_fg == 0:
        fail("the frame is all clear color")
    wall = statistics.median(frame_ms[2:])
    dev_ms = cuda_ms(lambda: render_frame(**inp))
    busy_ms, n_launch = device_busy(lambda: render_frame(**inp))
    print(f"frame: median {wall:.3f} ms wall per render_viewport, of which "
          f"{statistics.median(host_ms[2:]):.3f} ms host draw gathering "
          f"(frame_inputs); {dev_ms:.3f} ms render_frame device time, "
          f"{busy_ms:.3f} ms of it busy in {n_launch:.0f} device "
          f"activities (idle {1 - busy_ms / dev_ms:.3f}); {n_fg} non-clear "
          f"pixels, launches {launches4} ({card})", flush=True)
    bench = (cs, records, bins)              # phase 11 reuses them
    del r, reg, inp, cs, records, bins, d_k, t_k, d_p, t_p, tri, a_k, a_p
    del gbuf, idx, fx, fy, x_k, x_p, stages, vis
    torch.cuda.empty_cache()

    # -- phase 5: the cube against the JAX package's frame --------------------
    cube = render_frame_entry(dev).cpu().numpy()
    golden_gate(cube, np.load(GOLDENS / "torch_slice_cube256.npy"), "cube")

    # -- phase 6: shadows1080 -------------------------------------------------
    r, reg = build_bench_scene(SHADOW_GRID, dev, "shadows1080")
    rotate(reg, 0)
    r.editor_camera.set_viewport_size(1920, 1080)
    inp = r.frame_inputs()
    s = inp["shadow_size"]
    lcam = inp["light_camera"]
    stride = dict(draw_stride=inp["draw_stride"],
                  real_draws=inp["real_draws"])
    n_tri = int(inp["plan"].tri_valid.sum())
    print(f"shadows1080: {n_tri} triangles (plan "
          f"{inp['plan'].tri_valid.shape[0]}), {w}x{h}, map {s}², "
          f"draw_stride {inp['draw_stride']}", flush=True)

    def light_geometry():
        rows = build_draw_rows(inp["params"], lcam, s, s)
        return corner_stage(inp["corner_t"], rows, inp["tri_draw"],
                            inp["plan"].tri_valid, s, s, **stride)

    lcs = light_geometry()
    lbins = raster.build_bins(lcs.setup, s, s, setup_cols=lcs.cols.setup)
    if lbins.aux.tolist() != [0, 0]:
        fail(f"light-pass binning overflow: aux {lbins.aux.tolist()}")
    lntx = -(-s // raster.TILE)
    ln_tiles = lntx * lntx
    dd_k = raster.visibility_depth_tiles(lbins, lntx, ln_tiles)
    dd_p = raster.visibility_tiles_plain(lbins, lntx, ln_tiles,
                                         depth_only=True)
    dc_k, _tc = raster.visibility_tiles(lbins, lntx, ln_tiles)
    torch.cuda.synchronize()
    bad_p, bad_c = int((dd_k != dd_p).sum()), int((dd_k != dc_k).sum())
    if bad_p or bad_c:
        fail(f"depth-only kernel disagrees: {bad_p} depths with its plain "
             f"version, {bad_c} with the colour kernel's")
    print(f"light pass: {int(lbins.n_real)} pairs, "
          f"{int((dd_k < 1.0).sum())} map texels covered", flush=True)
    results["visibility_depth"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/visibility.cu",
        replaces="trident_tpu/ops/raster_pallas.py:1149",
        max_abs_err=float((dd_k - dd_p).abs().max()),
        ms=cuda_ms(lambda: raster.visibility_depth_tiles(lbins, lntx,
                                                         ln_tiles)),
        plain_ms=cuda_ms(lambda: raster.visibility_tiles_plain(
            lbins, lntx, ln_tiles, depth_only=True)),
        colour_ms=cuda_ms(lambda: raster.visibility_tiles(lbins, lntx,
                                                          ln_tiles)),
        library_ms=None)
    lvis = vis_work(lbins, lcs.setup, lntx, ln_tiles, 4)
    region_line(f"light pass at {s}x{s}", lvis)
    results["visibility_depth"].update(zip(("bound_ms", "bound_by"), bound(
        lvis.bytes, lvis.ops)))
    del dd_p, dc_k, _tc, lvis

    shadow, _saux = shadow_params(inp["plan"], inp["params"],
                                  inp["tri_draw"], inp["corner_t"], lcam, s,
                                  2e-3, **stride)
    cs, records = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        **stride)
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    d_k, t_k = raster.visibility_tiles(bins, ntx, n_tiles)
    gbuf = GBuffer(tri_id=raster.untile_frame(t_k, ntx, nty)[:h, :w]
                   .contiguous(), depth=raster.untile_frame(
                       d_k, ntx, nty)[:h, :w].contiguous(), aux=bins.aux)
    world = world_positions(gbuf.depth, inp["camera"], w, h)
    map_bits = shadow.depth.view(torch.int32)
    lib_busy = {}
    for pcf, key in ((False, "shadow_taps"), (True, "shadow_taps_pcf")):
        ti = tap_indices(shadow, world, pcf)
        b_k = shadow_taps.shadow_tap_bits(shadow.depth, *ti)
        b_p = shadow_taps.shadow_tap_bits_plain(shadow.depth, *ti)
        torch.cuda.synchronize()
        bad = int((b_k != b_p).sum())
        if bad:
            fail(f"shadow-taps kernel ({'PCF' if pcf else 'hard'}) disagrees "
                 f"on {bad} taps")
        # taps (y0,x0)[, (y0,x1), (y1,x0), (y1,x1)] as index pairs into ti
        pairs = [(0, 1)] if not pcf else [(0, 1), (0, 3), (2, 1), (2, 3)]
        ys = torch.stack([ti[a].clamp_min(0).long() for a, _b in pairs])
        xs = torch.stack([ti[b].clamp_min(0).long() for _a, b in pairs])
        results[key] = dict(
            route="cuda", source="trident_tpu_torch/csrc/shadow_taps.cu",
            replaces="trident_tpu/ops/shadow_pallas.py:80",
            max_abs_err=float((b_k - b_p).abs().max()),
            ms=cuda_ms(lambda: shadow_taps.shadow_tap_bits(shadow.depth,
                                                           *ti)),
            plain_ms=cuda_ms(lambda: shadow_taps.shadow_tap_bits_plain(
                shadow.depth, *ti)),
            # one PyTorch indexing call for the same fetch (no −1 mask)
            library_ms=cuda_ms(lambda: map_bits[ys, xs]))
        # per pixel: the i32 indices in, one i32 per tap out; the map once
        results[key].update(zip(("bound_ms", "bound_by"), bound(
            w * h * 4 * (len(ti) + len(pairs)) + s * s * 4)))
        lib_busy[key] = device_busy(lambda: map_bits[ys, xs])[0]
    busy = {"visibility_depth": lambda: raster.visibility_depth_tiles(
        lbins, lntx, ln_tiles)}
    for pcf, key in ((False, "shadow_taps"), (True, "shadow_taps_pcf")):
        ti = tap_indices(shadow, world, pcf)
        busy[key] = (lambda ti=ti: shadow_taps.shadow_tap_bits(shadow.depth,
                                                               *ti))
    cold_line("shadow_taps (hard)", busy["shadow_taps"],
              results["shadow_taps"]["bound_ms"], l2_flush(dev), card)
    for name in ("visibility_depth", "shadow_taps", "shadow_taps_pcf"):
        res = results[name]
        print(f"{name}: kernel {res['ms']:.4f} ms (device busy "
              f"{device_busy(busy[name])[0]:.4f} ms), plain "
              f"{res['plain_ms']:.4f} ms, library {res['library_ms']} ms"
              + (f" (busy {lib_busy[name]:.4f})" if name in lib_busy else "")
              + f", "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})"
              + (f", colour kernel on the same bins {res['colour_ms']:.4f}"
                 " ms" if "colour_ms" in res else "") + f" ({card})",
              flush=True)

    attrs = resolve.resolve_attrs(gbuf.tri_id, records)

    def shade(sh, pcf=False):
        return deferred_shade_attrs(
            gbuf, attrs, inp["textures"], inp["camera"], inp["lights"], w, h,
            clear_color=inp["clear_color"], shadow=sh, shadow_pcf=pcf)

    lstages = {
        "light_geometry": light_geometry,
        "light_binning": lambda: raster.build_bins(
            lcs.setup, s, s, setup_cols=lcs.cols.setup),
        "light_visibility": lambda: raster.visibility_depth_tiles(
            lbins, lntx, ln_tiles),
        "light_untile": lambda: raster.untile_frame(dd_k, lntx, lntx)
        .contiguous(),
        "geometry": lambda: frame_geometry(
            inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["textures"], inp["corner_t"], width=w,
            height=h, **stride),
        "binning": lambda: raster.build_bins(cs.setup, w, h,
                                             setup_cols=cs.cols.setup),
        "visibility": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "resolve": lambda: resolve.resolve_attrs(gbuf.tri_id, records),
        "shadow_factor": lambda: shadow_factor(shadow, world),
        "shading_shadowed": lambda: shade(shadow),
        "shading_pcf": lambda: shade(shadow, True),
        "shading_unshadowed": lambda: shade(None),
    }
    print_stages("shadows1080 stages", lstages, card)
    del lstages, lcs, lbins, dd_k, cs, records, bins, d_k, t_k, world, attrs

    frame_ms, host_ms = [], []

    def shadow_frames():
        out = None
        for k in range(12):
            rotate(reg, k)
            t0 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if out.aux.tolist() != [0, 0] or out.shadow_aux.tolist() != [0, 0]:
                fail(f"shadows1080 frame {k}: aux {out.aux.tolist()}, light "
                     f"pass aux {out.shadow_aux.tolist()}")
            t0 = time.perf_counter()
            r.frame_inputs()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        r.config.render.shadow_pcf = True
        t0 = time.perf_counter()
        pcf_out = r.render_viewport()
        torch.cuda.synchronize()
        pcf_ms = (time.perf_counter() - t0) * 1e3
        r.config.render.shadow_pcf = False
        if (pcf_out.aux.tolist() != [0, 0]
                or pcf_out.shadow_aux.tolist() != [0, 0]):
            fail(f"shadows1080 PCF frame: aux {pcf_out.aux.tolist()}, light "
                 f"pass aux {pcf_out.shadow_aux.tolist()}")
        return out, pcf_ms

    (out, pcf_ms), launches6 = drive(shadow_frames, kernel_fns, (r,))
    # the last hard frame's shadow factor: the share of its covered pixels
    # in shadow
    inp = r.frame_inputs()
    shadow, _saux = shadow_params(inp["plan"], inp["params"],
                                  inp["tri_draw"], inp["corner_t"],
                                  inp["light_camera"], s, 2e-3, **stride)
    covered_px = out.tri_id >= 0
    factor = shadow_factor(shadow, world_positions(
        out.depth, inp["camera"], w, h))[..., 0]
    shadowed = float((factor[covered_px] < 1.0).float().mean())
    print(f"shadows1080: {shadowed:.4f} of {int(covered_px.sum())} covered "
          "pixels shadowed", flush=True)
    if not shadowed > 0.01:
        fail("the shadows1080 frame has no shadow")
    wall = statistics.median(frame_ms[2:])
    dev_ms = cuda_ms(lambda: render_frame(**inp))
    busy_ms, n_launch = device_busy(lambda: render_frame(**inp))
    print(f"shadows1080 frame: median {wall:.3f} ms wall per render_viewport,"
          f" of which {statistics.median(host_ms[2:]):.3f} ms host draw "
          f"gathering (frame_inputs); {dev_ms:.3f} ms render_frame device "
          f"time, {busy_ms:.3f} ms of it busy in {n_launch:.0f} device "
          f"activities (idle {1 - busy_ms / dev_ms:.3f}); PCF frame "
          f"{pcf_ms:.3f} ms wall; launches {launches6} ({card})", flush=True)
    del r, reg, inp, shadow, out, factor
    torch.cuda.empty_cache()

    # -- phase 7: ultra4k (bloom) --------------------------------------------
    r, reg = build_bench_scene(BENCH_GRID, dev, "ultra4k")
    frame_ms = []

    def ultra_frames():
        out = None
        for k in range(3):
            rotate(reg, k)
            t0 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if out.aux.tolist() != [0, 0]:
                fail(f"ultra4k frame {k}: raster overflow aux "
                     f"{out.aux.tolist()}")
        return out

    out, launches7 = drive(ultra_frames, ("visibility", "resolve", "texel"),
                           (r,))
    if tuple(out.color.shape) != (2160, 3840, 4):
        fail(f"ultra4k frame shape {tuple(out.color.shape)}")
    inp = r.frame_inputs()
    dev_ms = cuda_ms(lambda: render_frame(**inp), reps=3, warmup=1)
    busy_ms, n_launch = device_busy(lambda: render_frame(**inp), reps=3)
    print(f"ultra4k frame: {[round(t, 3) for t in frame_ms]} ms wall per "
          f"render_viewport, {dev_ms:.3f} ms render_frame device time, "
          f"{busy_ms:.3f} ms of it busy in {n_launch:.0f} device activities "
          f"(idle {1 - busy_ms / dev_ms:.3f}), launches {launches7} "
          f"({card})", flush=True)
    del r, reg, inp, out
    torch.cuda.empty_cache()

    # -- phase 8: post and shadow flavors against the JAX package -------------
    for name, kw in FLAVORS.items():
        fr = base_scene(dev, **kw).render_viewport()
        aux = [fr.aux.tolist()] + ([fr.shadow_aux.tolist()]
                                   if fr.shadow_aux is not None else [])
        if any(a != [0, 0] for a in aux):
            fail(f"{name} frame aux {aux}")
        golden_gate(fr.color.cpu().numpy(),
                    np.load(GOLDENS / f"torch_slice_{name}.npy"), name)

    # -- phase 9: spheres1080_1m:ai ------------------------------------------
    launches9 = phase_ai(dev, card, kernel_fns, drive, results)

    # -- phase 10: the kernel-knob frame --------------------------------------
    launches10 = phase_knobs(dev, card, kernel_fns, drive, results)

    # -- phase 11: the tools_dev probes ---------------------------------------
    launches11 = phase_probes(dev, card, kernel_fns, drive, results, *bench,
                              w=1920, h=1080)

    # -- phase 12: the interactive frame loop ----------------------------------
    phase_frame_loop(dev, card, drive)

    # -- phase 13: the port's bench and the interpolation net -----------------
    launches13 = phase_bench(dev, card, drive)
    print(f"bench sweep's launches {launches13}", flush=True)

    # -- phase 14: the forward frame's features --------------------------------
    launches14 = phase_features(dev, card, kernel_fns, drive, results, bench)

    # -- phase 15: the reference raster, planes and the skinned path --------
    launches15 = phase_routes(dev, card, kernel_fns, drive, bench)
    print(f"route launches {launches15}", flush=True)
    del bench
    torch.cuda.empty_cache()

    # launches: each kernel's count in the main-path run of the frame it
    # was held on (phase 4 for the main pass, phase 6 for the shadow pass,
    # phase 9 for the warp, phase 10 for the knob kernels, phase 11 for
    # the probes, phase 14 for the vertex-colour instances)
    launches = {**launches4, "visibility_depth": launches6["visibility_depth"],
                "shadow_taps": launches6["shadow_taps"],
                "warp": launches9["warp"],
                **{n: launches10[n] for n in (
                    "visibility_ck", "visibility_resolve", "resolve_tiled",
                    "texel_planar")},
                **{n: launches11[n] for n in (
                    "visibility_dense", "visibility_dual", "visibility_reset",
                    "lut_gather", "split_select")},
                **{n: launches14[n] for n in (
                    "resolve_vc", "resolve_tiled_vc",
                    "visibility_resolve_vc")}}
    kernels = []
    for name in kernel_fns:
        res = {k: v for k, v in results[name].items() if k != "colour_ms"}
        # the launches of each of phase 15's route runs beside
        kernels.append(dict(name=name, launches=launches[name], **res,
                            route_launches={route: counts.get(name, 0)
                                            for route, counts in
                                            launches15.items()}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
