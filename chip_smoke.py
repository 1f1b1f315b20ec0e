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
     the visibility and resolve kernels' launch counts rose (the texel
     kernel's did not: the shading kernel of phase 23 fetches the
     texels), the frame is not all clear color;
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
     indexed, skinned geometry path (phase_routes): the nine 128² PNG
     goldens (tests/goldens/scene_128.png and flavor_{shadows_pcf, ssaa,
     bloom, trilinear, skybox, sprite, f16_planes, skinned}.png, read
     without PIL; skinned's rig imported, played and posed through a
     Scene) through render_viewport under the golden gate; the plane-gather
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
 16. the loaded crowd (phase_loaded): one skinned tube written as a .glb
     (tools_dev/scenes.py::write_tube_gltf: 7,680 triangles, 16 joints,
     a 24-key looping clip), load_model and import_model_entities timed,
     144 entities of it in a played Scene (loaded_crowd: 1,105,920
     triangles, 2,304 bones, each at its own speed); 60 frames of
     Scene.update(1/60) + render_viewport (wall and update ms, median and
     p90); in one window Scene.update with the sampler on the card
     against AnimationSystem.update with it on the CPU, frame_bundle and
     each sampler alone; the graph replayed alone; every frame's 2,304
     palettes against the AnimationPlayer (3e-5), the CPU sampler (1e-5)
     and tube_bone_matrices of the interpolated key bends (1e-4); every
     replay bit-equal to eager, aux [0, 0]; 12 frames against
     skinned_scene posed with those matrices under the golden gate; K1,
     K2-vc, K3 on the route's inputs and, on one shadowed loaded frame,
     K1b and K4 against their plain versions
 17. the remaining importers (phase_imported): (a) the tube also as
     binary FBX and as COLLADA (write_tube_fbx, write_tube_dae), each
     loaded into the 144-tube crowd under a KTX2 cube-map skybox and its
     mip chain (load_skybox_mips, held against the levels written), 60
     frames each at the .glb crowd's clip times: palettes within 1e-5 of
     the .glb crowd's, frames in its golden gate (the share > 3 LSB
     printed), replays bit-equal to eager, aux [0, 0]; every 12th frame
     again with the .glb palettes fed in, and skinned_scene given them
     (the silhouette split); K1, K2-vc, K2, K3 on each route's inputs,
     K1b and K4 on a shadowed crowd of each; load_model and
     import_model_entities ms per format; (b) spheres1080_1m's field as
     one .obj (995,328 triangles) through the native loader (the native
     path required; median of 3) and once through load_obj, the two
     ModelData bit-equal; the field scene from the .obj, a .ktx2 checker
     with file mips and six PNG sky faces, 12 frames bit-equal to the
     same scene from arrays in memory (the slot and the sky hold the
     decoded files); (c) a 128² frame textured from an .svg under a KTX1
     cube map, bit-equal to the scene from the decoded arrays
 18. the banded frame (phase_bands; parallel/framebuffer.py), n bands on
     this one card through Renderer.render_viewport(devices=[card] * n)
     (render_frame_banded_bundled), at 1920×1024 (1024 rows split into
     whole 32-row tiles for 2, 4 and 8 bands; the scenes keep their
     triangles, textures, lights and maps): (a) spheres1080_1m's field at
     n = 2, 4, 8, (b) shadows1080 over 8 bands with its 1024² map banded
     over 8, hard and PCF (the bundled frame against render_frame_banded
     and its host-to-device copies per frame), (c) the ckern, fuse and
     tiled_shade knobs on the field over 4, (d) the skinned crowd over 4
     (default, fuse, tiled_shade) and the field's f16 plane-gather frame
     over 2, (e) the field's :ai frame (960×512 → 1920×1024 over 2, two
     frames, the second warping the first): every frame bit-equal to the
     one-device frame (colour, depth, ids) with every band's aux [0, 0],
     each :ai frame to the one-device half-size frame upscaled by the V1
     path; (f) the Renderer with bands=2 warns on one card and renders
     bit-equal to bands=1 (across two cards where there are two); each of
     the nine band kernel instances against its plain version on a band
     with a nonzero offset, and at offset 0 bit-equal to its offset-free
     instance on the one-device frame's inputs, both timed in one window
     (K1 and K2 also on every band of the field's 4); (g) the field's
     frame at n = 1, 2, 4, 8: device ms (CUDA events), busy, wall, and
     each band's binning, visibility and resolve busy
 19. training (phase_training): (a) the 2× upscaler's trainer
     (trident_tpu_torch/scripts/train_upscaler.py) at full width: its
     three pools render 48 --temporal --depth pairs at 256² (the main
     path, K1, K2 and K3 on every pool, K1b and K4 on the shadowed one;
     ms a pair), 200 Adam steps of the 32-channel, 17-input net at batch
     8 (ms a step by CUDA events against 3 × the forward's f32 FLOPs over
     67 TFLOP/s; val PSNR of net and bilinear before and after, not
     gated), the saved checkpoint through a cube512:ai Renderer's
     ai.upscaler_path (two 512² frames, aux [0, 0]); (b) the interpolation
     net: 24 orbit frames of a pool scene at 256² written as PNG, train()
     for 2 epochs at 32 channels and batch 4 (each epoch's line),
     validate_checkpoint OK, train_step ms against 3 × unet_flops, and
     FrameGenerator.initialise(checkpoint dir) with one inference; (c)
     one train_step on the card against the same step on the CPU (same
     init and batch), in f32 and in f64: each loss within 1e-4
     relative; in f64 every gradient within rtol 1e-3 / atol 1e-6 (the
     f32 gradients' differences printed beside the CPU's own f32 step
     against its f64 step: float32 summation order and the ReLU / L1
     kinks it moves put both beyond that tolerance at 256²); (d)
     run_dryrun(8): eight processes on the
     card (gloo on its CUDA tensors, NCCL refusing two ranks on one
     device), the dp×tp and explicit-collective steps' lines and their
     1e-4 check, then the banded frame over the eight
 20. the application shell (phase_shell): (a) an Application at
     1920×1080 over spheres1080_1m's field, a Layer that spins it and
     queues two lines of text (sizes 13 and 16), the interpolation net
     from assets/frame_generator_128.npz at its 66 ms cadence, the
     dataset recorder and a Y4M session: 120 frames of app.run with
     present() after each, the median and p90 host ms of the frame,
     update, render (draw_frame) and _post_frame and present, then the
     same loop with every consumer off and render_viewport alone; the AI
     outputs consumed and blended (a blended frame against blend 0), the
     recorder's pairs, the encoder's submitted / encoded / dropped, and
     K1, K2, K3's launches in the loop (`app_loop`); (b) the Y4M file's
     size and its first frame's planes against rgb_to_yuv420 of the first
     frame submitted; (c) present() against composite_overlay of the
     read-back frame and the overlay, alpha under each line; (d) hot
     reload: a rewritten PNG changes only its entity's pixels, a
     rewritten shader module reloads, a broken model re-import is FAILED
     and keeps the old geometry; (g) AllocationTracker's device bytes, a
     Profiler trace naming the port's kernels, compilation_stats against
     the captures; (e) tests/test_facade.py's sequence through
     RenderCommand; (f) render_demo (4 frames, shadows, bloom, Y4M) and
     profile_stages --scale small as subprocesses, the viewer on
     127.0.0.1 (page, a frame PNG decoded to the presented frame, the
     entities, /api/state)
 21. every kernel knob the JAX package accepts (phase_knob_set): (a) the
     twelve bf16 instances (resolve_prec="bf16": K2, tiled K2 and K-FUSE,
     each 32- and 40-wide, offset-free on spheres1080_1m's own ids, bins
     and (T, 32) / (T, 40) records, the band ones on band 2 of 4 of phase
     18's 1920×1024 field), each bit-equal to its exact instance on the
     bf16-rounded table, its ids and depths bit-equal to its plain version
     and its attributes within RESOLVE_TOL of it, the pixels it moves off
     the exact instance, event and busy ms of both in one window; (f)
     kbench's bins through the indexed path (vertex_stage,
     triangle_setup_cols): K1 on them bit-equal to its plain version, the
     ids and depths off K1 on the corner-stage bins counted, and the
     drift of the frame through the indexed path from the corner-stage
     frame printed; then the main path: spheres1080_1m at
     1920×1024 and the 128² vertex-coloured cube under resolve_prec
     "bf16" alone, with tiled_shade and with fuse, replays bit-equal to
     eager and each frame over 2 bands of this card bit-equal to the
     one-device frame (every bf16 instance launched); spheres1080_1m:ai
     with the V2 defaults, upscale_v2=False (V1: the next frame warps the
     RGBA8 frame), upscale_dtype="bf16" and warp_mxu=False, two chained
     frames each (the second after the camera moves) bit-equal to eager;
     one frame of the 128² golden base scene (shadows, a 256² map) under
     each knob the card runs as a no-op, bit-equal to the default frame,
     and under tiled_shade and three routing limits (texel_max_pix,
     texel_max_q, texel_mxu), each taking the route the JAX gate names;
     (a') each bf16 spheres frame's pixels off the exact frame; (b) the
     V1 and V2 frames' graphs replayed alone; (c) the net at 960×540 in
     bf16 against f32 (PSNR over 40 dB, busy and event ms in one window),
     the bf16-conv frame's PSNR against the f32 frame; (d) on the
     windowless-warp Renderer's moving-camera frame, K8 on the windowless
     indices bit-equal to its plain version and the pixels whose validity
     differs from the windowed warp
 22. the skinned indexed geometry's kernel pair (phase_skinned_geometry,
     csrc/skinned_geometry.cu) on phase 16's loaded crowd at 1920×1080:
     bit-equal to its plain version with 40- and 32-wide records, the
     call and each kernel timed beside its bound and the plain version;
     each kernel's launches (_build.LAUNCHES) in 8 crowd frames (two runs
     a capture, none a replay) and 4 spheres1080_1m frames (none)
 23. the shading kernel (phase_deferred_shade, csrc/deferred_shade.cu)
     against the plain composition on both benchmark configurations'
     1920×1080 shading inputs (spheres1080_1m's field, the loaded crowd):
     the largest f32 difference and the uint8 pixels that differ (at most
     1 LSB on under 0.1% of the covered pixels), the call, the kernel and
     the plain composition timed beside the kernel's bound; its launches
     (_build.LAUNCHES) in 8 crowd and 4 field frames (two runs a capture,
     none a replay), the texel kernel none
 24. the binning kernels (phase_bin_tiles, csrc/bin_tiles.cu) against
     build_bins_plain on both benchmark configurations' 1920×1080 setups
     (spheres1080_1m's field, the loaded crowd's padded bucket): every
     field of the Bins bit-equal; the call (its four kernels, the cumsums
     and the sort), each kernel and the plain version timed beside the
     stage's byte bound; the entry points' launches (_build.LAUNCHES) in 8
     crowd and 4 field frames (two runs a capture, none a replay)
 25. the rigid geometry kernel (phase_rigid_geometry,
     csrc/rigid_geometry.cu) against rigid_geometry_plain on
     spheres1080_1m's field at 1920×1080 and 960×540, under the uniform
     layout and the tri_draw gather, 32- and 40-wide records: the setup,
     its columns and the records bit-equal; the call, the kernel and the
     plain version timed beside the kernel's byte bound, phase 22's
     skinned triangle kernel beside (the tail they share); its launches
     (_build.LAUNCHES) in 4 field frames (two runs a capture, none a
     replay) and 8 crowd frames (none)
Then it prints the kernels as one JSON line, phase 22's numbers beside
them under `skinned_geometry`, phase 23's under `deferred_shade`,
phase 24's under `bin_tiles` and phase 25's under `rigid_geometry` (each
kernel entry with
`route_launches`: its launches in each of phase 15's, 16's and 17's
route runs, in phase 19's pair rendering, `train_pairs`, and in phase
20's application loop, `app_loop`; a band
instance also its `offset_free_ms` and `offset0_ms`,
the offset-free and the band instance at offset 0 timed in one window; a
bf16 instance its exact instance's `exact_ms` and `exact_busy_ms` timed
in one window with its own `busy_ms`, and `pixels_off_exact`),
the card line, and as the last line {"ok": true, "device":
{...}}.

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
import os
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


def phase_ai(dev, card: str, kernel_names: list, drive, results: dict) -> dict:
    """Phase 9, spheres1080_1m:ai: the warp kernel against its plain
    version, 12 upscaled frames through the Renderer, the stage times and
    the two 128² AI frames against the JAX package's; adds the warp to
    `kernel_names` and `results` and returns the 12 frames' launch counts."""
    import torch

    from trident_tpu_torch.ai import upscaler as up
    from trident_tpu_torch.ops import raster, resolve, warp
    from trident_tpu_torch.ops.deferred import pack_rgba8
    from trident_tpu_torch.render.renderer import frame_geometry, render_frame

    kernel_names.append("warp")
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
            ran = {n: r.graphs.last_launches.get(n, 0) for n in kernel_names}
            if out.aux.tolist() != [0, 0]:
                fail(f"ai frame {k}: raster overflow aux {out.aux.tolist()}")
            if (tuple(out.color.shape) != (h, w, 4)
                    or out.color.dtype != torch.uint8
                    or tuple(out.history.shape) != (h // 2, w // 2, 12)
                    or out.history.dtype != torch.uint8):
                fail(f"ai frame {k}: color {tuple(out.color.shape)} "
                     f"{out.color.dtype}, history "
                     f"{tuple(out.history.shape)} {out.history.dtype}")
            if (min(ran[n] for n in ("visibility", "resolve")) < 1
                    or ran["warp"] != (0 if k == 0 else 1)):
                fail(f"ai frame {k}: kernel launches {ran}")
            if not bool((out.color.float().cpu() != clear).any()):
                fail(f"ai frame {k} is all clear color")
        return out

    out, launches9 = drive(ai_frames, ("visibility", "resolve", "warp"),
                           (r,))
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


def phase_knobs(dev, card: str, kernel_names: list, drive, results: dict):
    """Phase 10, the kernel-knob frame at spheres1080_1m: the four knob
    kernels against their plain versions and the default kernels they
    stand in for, their times and bounds, K1 against K1-CK on the same
    bins, 12 frames each of CKERN and FUSE_TILED through the Renderer, one
    shadows1080 PCF frame with tiled_shade and the 128² knob goldens; adds
    the knob kernels to `kernel_names` and `results` and returns the
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

    kernel_names.extend(("visibility_ck", "visibility_resolve",
                         "resolve_tiled", "texel_planar"))
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
                        "texel": 0},
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
        ran = {n: rt.graphs.last_launches.get(n, 0) for n in kernel_names}
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


def phase_probes(dev, card: str, kernel_names: list, drive, results: dict,
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
    dflt through K1-CK. Adds the probe kernels to `kernel_names` and
    `results` and returns the main path's launch counts."""
    import torch

    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.ops.planes import RR_WIDTH
    from trident_tpu_torch.tools_dev import diag_split_kernel as dsk
    from trident_tpu_torch.tools_dev import gather_probe as gp
    from trident_tpu_torch.tools_dev import kbench as kb

    kernel_names.extend(("visibility_dense", "visibility_dual",
                         "visibility_reset", "lut_gather", "split_select"))
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
    held_records(g.graph.replay, g.launch_list, what)
    dev_ms = cuda_ms(g.graph.replay)
    busy, acts = device_busy(g.graph.replay, launch_list=g.launch_list)
    if busy != busy:
        fail(f"{what}: no profiling window of its replays was whole")
    print(f"{what}, its graph replayed alone: device frame {dev_ms:.4f} ms "
          f"(CUDA events), busy {busy:.4f} ms in {acts:.0f} device "
          f"activities, idle {1 - busy / dev_ms:.4f}; kernel records "
          f"{g.launch_list} per replay ({card})", flush=True)


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

    main_list = {"visibility": 1, "resolve": 1}
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
        launch_list=g.launch_list)
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
    main_list = {"visibility": 1, "resolve": 1}
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


def phase_features(dev, card: str, kernel_names: list, drive, results: dict,
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
    frames. Adds the vc kernels to `kernel_names` and `results` and returns
    the main-path launch counts."""
    import tempfile

    import torch

    from trident_tpu_torch.ops import deferred, planes, raster, resolve
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        render_frame,
    )
    from trident_tpu_torch.render.types import GBuffer

    kernel_names.extend(("resolve_vc", "resolve_tiled_vc",
                         "visibility_resolve_vc"))

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
    a_k = resolve.resolve_attrs(tri, records)
    a_p = resolve.resolve_attrs_plain(tri, records)
    at = resolve.resolve_attrs_tiled(t1, records, ntx)
    atp = resolve.resolve_attrs_tiled_plain(t1, records, ntx)
    df, tf, af = resolve.fused_visibility_resolve(bins, records, ntx,
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
            lambda: resolve.resolve_attrs(tri, records),
            lambda: resolve.resolve_attrs_plain(tri, records)),
        "resolve_tiled_vc": (
            bound(n_px_t * 4 * (1 + resolve.CHANNELS) + n_winners * row_vc),
            "trident_tpu_torch/csrc/resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:412",
            err["tiled K2-vc vs K2-vc"],
            lambda: resolve.resolve_attrs_tiled(t1, records, ntx),
            lambda: resolve.resolve_attrs_tiled_plain(t1, records, ntx)),
        "visibility_resolve_vc": (
            bound(vis.bytes + n_px_t * 4 * resolve.CHANNELS
                  + n_winners * row_vc, vis.ops),
            "trident_tpu_torch/csrc/visibility_resolve.cu",
            "trident_tpu/ops/resolve_pallas.py:281",
            err["K-FUSE-vc vs K2-vc"],
            lambda: resolve.fused_visibility_resolve(bins, records, ntx,
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
        "K2-vc": lambda: resolve.resolve_attrs(tri, records),
        "K1": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "tiled K2 (this frame)": lambda: resolve.resolve_attrs_tiled(
            t1, rec_f32, ntx),
        "tiled K2-vc": lambda: resolve.resolve_attrs_tiled(t1, records,
                                                              ntx),
        "K-FUSE (this frame)": lambda: resolve.fused_visibility_resolve(
            bins, rec_f32, ntx, n_tiles),
        "K-FUSE-vc": lambda: resolve.fused_visibility_resolve(
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
    pcols = plain_corner_stage(inp, vertex_colors=True, **geo_kw).cols
    print_stages("feature stages (spheres1080_1m's beside)", {
        "geometry": lambda: frame_geometry(*geo_args, vertex_colors=True,
                                           **geo_kw),
        "records": lambda: planes.build_resolve_cols_planar(pcols),
        "records_spheres1080_1m": lambda: planes.build_resolve_cols_planar(
            cs32.cols),
        "binning": lambda: raster.build_bins(cs.setup, w, h,
                                             setup_cols=cs.cols.setup),
        "visibility": lambda: raster.visibility_tiles(bins, ntx, n_tiles),
        "resolve": lambda: resolve.resolve_attrs(tri, records),
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


def plain_corner_stage(inp: dict, **kw):
    """The corner path's plain corner stage output on render_frame inputs
    `inp` (ops/rigid.py::rigid_geometry_plain's): the full corner columns
    the records' producer reads, where the kernel route hands on the
    setup's alone. `kw` overrides the size, the layout or
    vertex_colors."""
    from trident_tpu_torch.ops.rigid import rigid_geometry_plain
    from trident_tpu_torch.render.renderer import shading_consts

    geo = dict(width=inp["width"], height=inp["height"],
               draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    geo.update(kw)
    consts = shading_consts(inp["params"], inp["shade_table"],
                            inp["textures"])
    return rigid_geometry_plain(inp["plan"], inp["tri_draw"], inp["params"],
                                inp["camera"], consts, inp["corner_t"],
                                **geo)[0]


def skinned_kernels(inp, what: str, w: int, h: int) -> dict:
    """A skinned frame's kernels on its own inputs (`inp`, frame_inputs of
    a frame that takes the indexed path with vertex colours): K1 on its
    bins (ids equal, depth bit-equal), K2-vc and K2 on its 40- and 32-wide
    records (within RESOLVE_TOL) and K3 on its texel indices (bit-equal)
    against their plain versions; fails on a mismatch or an overflow.
    Returns its intermediates: inp, cs, rec40, tri and gbuf."""
    import torch

    from trident_tpu_torch.ops import raster, resolve, texel
    from trident_tpu_torch.ops.deferred import texel_lookup
    from trident_tpu_torch.render.renderer import frame_geometry
    from trident_tpu_torch.render.types import GBuffer

    if inp["corner_t"] is not None or not inp["skinned"] \
            or not inp["vertex_colors"] or inp["draw_stride"] != 0:
        fail(f"{what} frame's inputs: corner table "
             f"{inp['corner_t'] is not None}, skinned {inp['skinned']}, "
             f"vertex colours {inp['vertex_colors']}, draw_stride "
             f"{inp['draw_stride']}")
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    geo = dict(width=w, height=h, geometry=inp["geometry"],
               palette=inp["palette"], skinned=True)
    args = (inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["textures"], None)
    cs, rec40 = frame_geometry(*args, vertex_colors=True, **geo)
    _cs32, rec32 = frame_geometry(*args, **geo)
    del _cs32
    bins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    if bins.aux.tolist() != [0, 0]:
        fail(f"binning overflow on the {what} frame: {bins.aux.tolist()}")
    d_k, t_k = raster.visibility_tiles(bins, ntx, ntx * nty)
    d_p, t_p = raster.visibility_tiles_plain(bins, ntx, ntx * nty)
    bad_vis = [int((t_k != t_p).sum()),
               int((d_k.view(torch.int32) != d_p.view(torch.int32)).sum())]
    tri = raster.untile_frame(t_k, ntx, nty)[:h, :w].contiguous()
    err = {}
    for name, rec, fn in (("K2-vc", rec40, resolve.resolve_attrs),
                          ("K2", rec32, resolve.resolve_attrs)):
        a_k, a_p = fn(tri, rec), resolve.resolve_attrs_plain(tri, rec)
        torch.cuda.synchronize()
        err[name] = float((a_k - a_p).abs().max())
        if not bool(torch.isfinite(a_k).all()) or err[name] > RESOLVE_TOL:
            fail(f"{what} frame: {name} disagrees with its plain version "
                 f"by {err[name]}")
    a_vc = resolve.resolve_attrs(tri, rec40)
    q = inp["textures"].quads
    idx, fx, fy = texel_lookup(a_vc, tri >= 0, inp["textures"].max_level)
    x_k = texel.sample_bilinear(q, idx, fx, fy)
    x_p = texel.sample_bilinear_plain(q, idx, fx, fy)
    bad_tx = int((x_k.view(torch.int32) != x_p.view(torch.int32)).sum())
    if any(bad_vis) or bad_tx:
        fail(f"{what} frame: K1 vs plain {bad_vis} ids / depths, K3 vs "
             f"plain {bad_tx} values")
    print(f"{what}: {int(inp['plan'].tri_valid.sum())} triangles, palette "
          f"{tuple(inp['palette'].shape)}, records {tuple(rec40.shape)} and "
          f"{tuple(rec32.shape)}, {int((tri >= 0).sum())} covered pixels, "
          f"{int(bins.n_real)} pairs, bins aux {bins.aux.tolist()}; K1 and "
          f"K3 bit-equal to their plain versions, K2-vc and K2 max err "
          f"{err}", flush=True)
    return dict(inp=inp, cs=cs, rec40=rec40, tri=tri, gbuf=GBuffer(
        tri_id=tri, depth=raster.untile_frame(d_k, ntx, nty)[:h, :w]
        .contiguous(), aux=bins.aux))


def skinned_light_pass(sinp, what: str, w: int, h: int) -> None:
    """A shadowed skinned frame's indexed light pass on its own inputs
    (`sinp`): K1b on the light-pass bins and K4 on the frame's hard and
    PCF taps against their plain versions, bit for bit, and the map equal
    to shadow_params' map; fails otherwise."""
    import torch

    from trident_tpu_torch.ops import deferred, raster, shadow_taps
    from trident_tpu_torch.ops.shadow import tap_indices
    from trident_tpu_torch.ops.vertex import triangle_setup_cols, vertex_stage
    from trident_tpu_torch.render.renderer import frame_geometry, shadow_params

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
    scs, _srec = frame_geometry(
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
    bad_depth = int((dd_k.view(torch.int32) != dd_p.view(torch.int32)).sum())
    map_dk = raster.untile_frame(dd_k, lntx, lntx)[:s, :s]
    if bad_depth or any(bad_taps.values()) or lbins.aux.tolist() != [0, 0] \
            or not torch.equal(map_dk, shadow.depth):
        fail(f"{what} light pass: K1b vs plain {bad_depth} depths, K4 vs "
             f"plain {bad_taps} taps, aux {lbins.aux.tolist()}, map equal "
             f"to the light pass's {torch.equal(map_dk, shadow.depth)}")
    print(f"{what} light pass at {s}²: {int(lbins.n_real)} pairs, "
          f"{int((dd_k < 1.0).sum())} map texels covered; K1b and K4 (hard "
          f"and PCF) bit-equal to their plain versions", flush=True)


def phase_routes(dev, card: str, kernel_names: list, drive, bench) -> dict:
    """Phase 15: the routes of the reference raster, the plane-gather
    frame and the indexed, skinned geometry path on the card.
    (a) the nine 128² PNG goldens (scene_128, flavor_{shadows_pcf, ssaa,
    bloom, trilinear, skybox, sprite, skinned} on the reference raster,
    flavor_f16_planes on the binned raster with f16 planes) through
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
    bones): K1, K2-vc, K2 and K3 on its own inputs against their plain
    versions (skinned_kernels); 12 frames whose poses
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
    from trident_tpu_torch.ops import deferred, planes, raster, resolve, texel
    from trident_tpu_torch.ops.corner import indexed_corner_stage
    from trident_tpu_torch.ops.vertex import vertex_stage
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        plane_geometry,
        plane_visibility,
        shading_consts,
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
    sk_stage = skinned_kernels(frame_inputs_at(sk_r), "skinned", w, h)
    inp, cs, rec40, tri = (sk_stage[k] for k in ("inp", "cs", "rec40", "tri"))

    sk_held = []

    def skinned_frames():
        for k in range(ROUTE_FRAMES):
            pose_skinned(sk_reg, k)
            kinp = frame_inputs_at(sk_r)
            sk_held.append((f"skinned frame {k}", sk_r.render_viewport(),
                            kinp))

    _none, launches["skinned"] = drive(
        skinned_frames, ("visibility", "resolve_vc"), (sk_r,))
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
    skinned_light_pass(sinp, "skinned", w, h)

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
    sk_attrs = resolve.resolve_attrs(sk["tri"], sk["rec40"])
    # the plain composition's corner columns (the kernel pair hands on the
    # setup's alone), with the records' shading consts
    sk_consts = shading_consts(ski["params"], ski["shade_table"],
                               ski["textures"])
    sk_cols = indexed_corner_stage(
        sk_verts.packed, ski["plan"].tri_vtx, ski["plan"].tri_valid, w, h,
        consts=sk_consts[ski["tri_draw"].long()], vertex_colors=True).cols
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
            sk_cols),
        "skinned_resolve_vc": lambda: resolve.resolve_attrs(
            sk["tri"], sk["rec40"]),
        "skinned_shading": lambda: deferred.deferred_shade_attrs(
            sk["gbuf"], sk_attrs, textures=ski["textures"],
            camera=ski["camera"], lights=ski["lights"], width=w, height=h,
            clear_color=ski["clear_color"]),
    }, card)
    del sk_stage, sk, ski, sk_verts, sk_attrs, sk_consts, sk_cols, pcs, pl16
    del pl32, pgbuf
    del fgbuf, fattrs, ftri, ft, _fd, sk_r, sk_reg, inp, cs, rec40, tri
    torch.cuda.empty_cache()
    return launches


# phase 16: a glTF crowd loaded, played and animated by the Scene
LOADED_FRAMES = 60
LOADED_HELD_EVERY = 5      # frames held against the posed crowd: 12 of 60
PALETTE_PLAYER_TOL = 3e-5  # tests/test_anim_batch.py:79
PALETTE_CPU_TOL = 1e-5     # the card's sampler against the CPU's
PALETTE_BEND_TOL = 1e-4    # against tube_bone_matrices (f64, cast to f32)


def spread(xs) -> str:
    """'median / p90' of a list of ms (p90: the nearest rank)."""
    xs = sorted(xs)
    p90 = xs[min(len(xs) - 1, int(np.ceil(0.9 * len(xs))) - 1)]
    return f"{statistics.median(xs):.4f} / {p90:.4f}"


def phase_loaded(dev, card: str, drive) -> dict:
    """Phase 16: the skinned tube crowd loaded and animated as a game
    drives it. write_tube_gltf's .glb (one tube of 7,680 triangles, 16
    joints, a 24-key looping clip) read by load_model and imported once
    through import_model_entities into a Scene, 144 entities sharing its
    mesh (tools_dev/scenes.py::loaded_crowd: 1,105,920 triangles, 2,304
    bones), played: (a) 60 frames of Scene.update(1/60) (the
    AnimationSystem's batched sampler on the card) + render_viewport,
    wall and update ms; then in one window Scene.update against
    AnimationSystem.update on the CPU's sampler on the same registry,
    frame_bundle, and each sampler alone; the graph replayed alone; (b)
    every frame's 144 palettes against the port's AnimationPlayer (3e-5),
    the CPU sampler (1e-5) and tube_bone_matrices of the interpolated key
    bends (1e-4); (c) every replay bit-equal to eager render_frame, aux
    [0, 0], and 12 of the frames against skinned_scene posed with those
    tube_bone_matrices under the golden gate; (d) K1, K2-vc, K3 on the
    route's own inputs and, on one shadowed loaded frame, K1b and K4
    against their plain versions. Returns the launch counts of the loaded
    frames and of the shadowed one."""
    import os
    import tempfile

    import torch

    from trident_tpu_torch.anim.batch import BatchedClipSampler
    from trident_tpu_torch.anim.player import AnimationPlayer
    from trident_tpu_torch.anim.service import AnimationAssetService
    from trident_tpu_torch.anim.system import AnimationSystem
    from trident_tpu_torch.assets.model_loader import load_model
    from trident_tpu_torch.ecs.components import AnimationComponent
    from trident_tpu_torch.tools_dev.scenes import (
        loaded_crowd,
        skinned_scene,
        tube_bend_at,
        tube_bone_matrices,
        write_tube_gltf,
    )

    launches = {}
    td = tempfile.TemporaryDirectory()
    path = write_tube_gltf(Path(td.name) / "tube.glb")
    load_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        data = load_model(path)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    mesh, clip = data.meshes[0], data.clips[0]
    crowd = loaded_crowd(dev, path)
    scene, r = crowd.scene, crowd.renderer
    w, h = r.config.render.width, r.config.render.height
    rt = scene.runtime_registry
    anims = [rt.get(e, AnimationComponent) for e in crowd.entities]
    print(f"loaded crowd: {os.path.getsize(path)} byte .glb, "
          f"{mesh.triangle_count} triangles, {len(data.skeleton)} joints, "
          f"clip {clip.name!r} {clip.duration} s of "
          f"{len(clip.channels[0].rotation_times)} keys; load_model "
          f"{load_ms[0]:.3f} ms first, {statistics.median(load_ms):.3f} "
          f"median of 5; import_model_entities {crowd.import_ms:.3f} ms; "
          f"{len(anims)} tubes, "
          f"{len(anims) * mesh.triangle_count} triangles ({card})",
          flush=True)

    # (a) the frame loop, as a game runs it
    held, upd_ms, wall_ms = [], [], []

    def loaded_frames():
        for k in range(LOADED_FRAMES):
            t0 = time.perf_counter()
            scene.update(1 / 60)
            t1 = time.perf_counter()
            kinp = frame_inputs_at(r)
            t2 = time.perf_counter()
            out = r.render_viewport()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            upd_ms.append((t1 - t0) * 1e3)
            wall_ms.append((t1 - t0 + t3 - t2) * 1e3)
            held.append((k, out, kinp, np.array([a.time for a in anims]),
                         np.stack([a.bone_matrices for a in anims])))

    _none, launches["loaded"] = drive(
        loaded_frames, ("visibility", "resolve_vc"), (r,))
    print(f"loaded crowd, {LOADED_FRAMES} frames (median / p90 ms): wall "
          f"{spread(wall_ms)} (Scene.update + render_viewport + "
          f"synchronize), Scene.update {spread(upd_ms)}; "
          f"{r.graphs.captures} graph capture(s), {r.graphs.replays} "
          f"replays; launches {launches['loaded']} ({card})", flush=True)

    skeleton = AnimationAssetService.get().acquire_skeleton(path)
    clip = AnimationAssetService.get().acquire_animation_library(path)[0]
    samplers = {"card": BatchedClipSampler(clip, skeleton, dev),
                "cpu": BatchedClipSampler(clip, skeleton, "cpu")}
    times = np.array([a.time for a in anims], np.float32)
    placed = {"card": [], "cpu": [], "bundle": [], "card_sampler": [],
              "cpu_sampler": []}
    for _ in range(LOADED_FRAMES):
        t0 = time.perf_counter()
        scene.update(1 / 60)
        t1 = time.perf_counter()
        AnimationSystem.update(rt, 1 / 60, device="cpu")
        t2 = time.perf_counter()
        r.frame_bundle()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        samplers["card"](times)
        t4 = time.perf_counter()
        samplers["cpu"](times)
        t5 = time.perf_counter()
        for key, a, b in (("card", t0, t1), ("cpu", t1, t2),
                          ("bundle", t2, t3), ("card_sampler", t3, t4),
                          ("cpu_sampler", t4, t5)):
            placed[key].append((b - a) * 1e3)
    print(f"loaded crowd, one window of {LOADED_FRAMES} alternations "
          f"(median / p90 ms): Scene.update, sampler on the card "
          f"{spread(placed['card'])}; AnimationSystem.update, sampler on "
          f"the CPU {spread(placed['cpu'])}; frame_bundle "
          f"{spread(placed['bundle'])}; the sampler alone on "
          f"{len(times)} times: card {spread(placed['card_sampler'])}, CPU "
          f"{spread(placed['cpu_sampler'])} ({card})", flush=True)
    g = r.graphs.graph(r.graphs.last_key)
    replay_ms = []
    for _ in range(LOADED_FRAMES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.graph.replay()
        end.record()
        end.synchronize()
        replay_ms.append(start.elapsed_time(end))
    print(f"loaded crowd, its graph replayed alone {LOADED_FRAMES} times: "
          f"{spread(replay_ms)} ms median / p90 (CUDA events) ({card})",
          flush=True)
    replay_line(r, "loaded crowd", card)

    # (b) every frame's palettes
    player = AnimationPlayer(skeleton)
    player.set_clip(clip)
    err = {"player": 0.0, "cpu": 0.0, "bend": 0.0}
    for k, _out, _inp, ts, pals in held:
        cpu = samplers["cpu"](ts)
        err["cpu"] = max(err["cpu"], float(np.abs(pals - cpu).max()))
        for t, pal, bend in zip(ts, pals, tube_bend_at(ts)):
            err["player"] = max(err["player"], float(np.abs(
                pal - player.evaluate_at(float(t))).max()))
            err["bend"] = max(err["bend"], float(np.abs(
                pal - tube_bone_matrices(bend)).max()))
    if err["player"] > PALETTE_PLAYER_TOL or err["cpu"] > PALETTE_CPU_TOL \
            or err["bend"] > PALETTE_BEND_TOL:
        fail(f"loaded crowd palettes: max err {err}")
    print(f"loaded crowd palettes, {LOADED_FRAMES} frames x {len(anims)} "
          f"tubes: the card's sampler against the player max err "
          f"{err['player']:.3g} (<= {PALETTE_PLAYER_TOL}), against the "
          f"CPU's {err['cpu']:.3g} (<= {PALETTE_CPU_TOL}), against "
          f"tube_bone_matrices {err['bend']:.3g} (<= {PALETTE_BEND_TOL})",
          flush=True)

    # (c) replays against eager, and against the posed crowd
    for k, out, kinp, _t, _p in held:
        same_as_eager(out, kinp, f"loaded frame {k}")
    moved = [int((a[1].color != b[1].color).any(-1).sum())
             for a, b in zip(held, held[1:])]
    if min(moved) < 1000:
        fail(f"loaded frames: pixels changed between frames {moved}")
    ref_r, ref_reg = skinned_scene(dev)
    ref_anims = [a for _e, (a,) in ref_reg.view(AnimationComponent)]
    gate = []
    for k, out, _inp, ts, _p in held[::LOADED_HELD_EVERY]:
        for a, bend in zip(ref_anims, tube_bend_at(ts)):
            a.bone_matrices = tube_bone_matrices(bend)
        ref = ref_r.render_viewport()
        if ref.aux.tolist() != [0, 0]:
            fail(f"posed crowd frame {k}: aux {ref.aux.tolist()}")
        golden_gate(out.color.cpu().numpy(), ref.color.cpu().numpy(),
                    f"loaded frame {k}", "the posed crowd")
        gate.append(k)
    print(f"loaded frames: {LOADED_FRAMES} replays bit-equal to eager "
          f"render_frame, aux [0, 0]; pixels changed between frames "
          f"{min(moved)} .. {max(moved)}; frames {gate} within the golden "
          f"gate of skinned_scene posed by tube_bone_matrices", flush=True)
    inp = held[-1][2]
    del held, ref_r, ref_reg, ref_anims
    torch.cuda.empty_cache()

    # (d) the route's kernels, then one shadowed loaded frame
    skinned_kernels(inp, "loaded crowd", w, h)
    del inp
    sh = loaded_crowd(dev, path, shadows=True)
    sh.scene.update(1 / 60)
    sinp = frame_inputs_at(sh.renderer)
    skinned_light_pass(sinp, "loaded crowd", w, h)
    sh_out, launches["loaded_shadow"] = drive(
        sh.renderer.render_viewport, ("visibility", "visibility_depth",
                                      "resolve_vc", "texel", "shadow_taps"),
        (sh.renderer,))
    same_as_eager(sh_out, sinp, "loaded shadowed frame",
                  ("aux", "shadow_aux"))
    print(f"loaded shadowed frame: replay bit-equal to eager, aux [0, 0] "
          f"(and the light pass's); launches {launches['loaded_shadow']}",
          flush=True)
    replay_line(sh.renderer, "loaded crowd shadowed", card)
    del sh, sinp, sh_out, crowd, scene, r, rt, anims, samplers
    td.cleanup()
    torch.cuda.empty_cache()
    return launches


# phase 17: the remaining importers on the card
IMPORT_FORMATS = ("glb", "fbx", "dae")
IMPORTED_SPLIT_EVERY = 12  # frames whose split is rendered: 5 of 60
PALETTE_FORMAT_TOL = 1e-5  # a format's palettes against the .glb crowd's
FIELD_FRAMES = 12


def gate_device(frame, ref, what: str, against: str) -> tuple:
    """golden_gate on the card: (share of values > GOLDEN_LSB off, mean,
    max) of two RGBA8 frames; fails outside the gate."""
    diff = (frame.int() - ref.int()).abs()
    frac = float((diff > GOLDEN_LSB).float().mean())
    mean, peak = float(diff.float().mean()), int(diff.max())
    if not (frac < GOLDEN_FRAC and mean < GOLDEN_MEAN):
        fail(f"{what} vs {against}: {frac:.6f} of values > {GOLDEN_LSB} "
             f"LSB, mean {mean:.6f}, max {peak}: outside the golden gate")
    return frac, mean, peak


def same_frames(a, b, what: str) -> None:
    """Two frames bit for bit (color, depth, tri_id) with aux [0, 0]."""
    bad = differing(a, b)
    if bad or a.aux.tolist() != [0, 0] or b.aux.tolist() != [0, 0]:
        fail(f"{what}: frames differ in {bad}, aux {a.aux.tolist()} / "
             f"{b.aux.tolist()}")


def phase_imported(dev, card: str, drive) -> dict:
    """Phase 17: the remaining importers on the card, each scene through
    load_model / import_model_entities / Scene.update /
    render_viewport at full width. (a) write_tube_gltf's tube also as
    binary FBX and as COLLADA (tools_dev/scenes.py::write_tube_fbx,
    write_tube_dae), each loaded into loaded_crowd (144 entities,
    1,105,920 triangles) under a KTX2 cube-map skybox with its mip chain
    (load_skybox_mips, held against the levels written: not the
    fallback); 60 frames each, at the same clip times: palettes against
    the .glb crowd's within PALETTE_FORMAT_TOL, frames within the golden
    gate of the .glb crowd's, every replay bit-equal to eager, aux [0, 0];
    every 12th frame rendered again with the .glb crowd's palettes fed in
    (mesh differences alone), and skinned_scene given the same palettes
    against the .glb frame; K1, K2-vc, K2 and K3 on each route's inputs
    and, on one shadowed crowd of each, K1b and K4 against their plain
    versions; load_model and import_model_entities ms per format. (b)
    spheres1080_1m's field as one .obj (995,328 triangles) through the
    native loader (timed, median of 3; the native path must be taken) and
    once through load_obj (timed): the two ModelData bit-equal; the field
    scene from the .obj, its checker from a .ktx2 with file mips and its
    skybox from six PNG faces, against the same scene from the arrays in
    memory: the texture slot and the sky hold the decoded files, and 12
    frames (the field turning) bit-equal. (c) a 128² frame of a 2 × 2
    field textured from an .svg under a KTX1 cube map against the same
    scene from the decoded arrays, bit-equal. Returns the launch counts
    of each route run."""
    import os
    import tempfile

    import torch

    from trident_tpu_torch.assets.model_loader import load_model, load_obj
    from trident_tpu_torch.assets.native import get_lib, load_obj_native
    from trident_tpu_torch.assets.skybox import load_skybox_mips
    from trident_tpu_torch.ecs.components import (
        AnimationComponent,
        TransformComponent,
    )
    from trident_tpu_torch.io.svg import rasterize_svg
    from trident_tpu_torch.tools_dev import scenes

    launches = {}
    td = tempfile.TemporaryDirectory()
    d = Path(td.name)

    # (a) the tube as .glb, .fbx and .dae, each a crowd under a KTX2 sky
    writers = {"glb": scenes.write_tube_gltf, "fbx": scenes.write_tube_fbx,
               "dae": scenes.write_tube_dae}
    paths = {fmt: writers[fmt](d / f"tube.{fmt}") for fmt in IMPORT_FORMATS}
    sky_path = scenes.write_sky_ktx2(d / "sky.ktx2")
    sky = load_skybox_mips(sky_path)
    want_sky = scenes.sky_arrays(scenes.sky_levels_u8())
    if len(sky) != len(want_sky) or any(
            not np.array_equal(a, b) for a, b in zip(sky, want_sky)):
        fail(f"the KTX2 skybox loaded {len(sky)} levels that are not the "
             f"{len(want_sky)} written (the solid fallback?)")
    load_ms, crowds, sizes = {}, {}, {}
    for fmt in IMPORT_FORMATS:
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            data = load_model(paths[fmt])
            ms.append((time.perf_counter() - t0) * 1e3)
        load_ms[fmt] = statistics.median(ms)
        sizes[fmt] = (os.path.getsize(paths[fmt]),
                      data.meshes[0].triangle_count)
        crowds[fmt] = scenes.loaded_crowd(dev, paths[fmt])
        crowds[fmt].renderer.set_skybox(sky[0], mips=sky[1:])
    print("imported crowds: " + "; ".join(
        f".{fmt} {sizes[fmt][0]} bytes, {sizes[fmt][1]} triangles, "
        f"load_model {load_ms[fmt]:.3f} ms median of 3, "
        f"import_model_entities {crowds[fmt].import_ms:.3f} ms"
        for fmt in IMPORT_FORMATS)
        + f"; KTX2 sky {len(sky)} levels from {sky[0].shape[1]}² ({card})",
        flush=True)
    r0 = crowds["glb"].renderer
    w, h = r0.config.render.width, r0.config.render.height
    held = {}
    for fmt in IMPORT_FORMATS:
        c, frames, wall = crowds[fmt], [], []
        rt = c.scene.runtime_registry
        anims = [rt.get(e, AnimationComponent) for e in c.entities]

        def imported_frames(c=c, frames=frames, wall=wall, anims=anims):
            for _k in range(LOADED_FRAMES):
                t0 = time.perf_counter()
                c.scene.update(1 / 60)
                t1 = time.perf_counter()
                kinp = frame_inputs_at(c.renderer)
                t2 = time.perf_counter()
                out = c.renderer.render_viewport()
                torch.cuda.synchronize()
                wall.append((t1 - t0 + time.perf_counter() - t2) * 1e3)
                frames.append((out, kinp, np.array([a.time for a in anims]),
                               np.stack([a.bone_matrices for a in anims])))

        _none, launches[f"imported_{fmt}"] = drive(
            imported_frames, ("visibility", "resolve_vc", "texel"),
            (c.renderer,))
        held[fmt] = frames
        print(f"imported .{fmt} crowd, {LOADED_FRAMES} frames: wall "
              f"{spread(wall)} ms median / p90 (Scene.update + "
              f"render_viewport + synchronize); launches "
              f"{launches[f'imported_{fmt}']} ({card})", flush=True)
    for fmt in IMPORT_FORMATS:
        for k, (out, kinp, _t, _p) in enumerate(held[fmt]):
            same_as_eager(out, kinp, f"imported .{fmt} frame {k}")
    for fmt in ("fbx", "dae"):
        err, shares, peaks = 0.0, [], []
        for k, ((out, _i, ts, pals), (gout, _gi, gts, gpals)) in enumerate(
                zip(held[fmt], held["glb"])):
            if not np.array_equal(ts, gts):
                fail(f".{fmt} crowd frame {k}: clip times differ from the "
                     f".glb crowd's")
            err = max(err, float(np.abs(pals - gpals).max()))
            frac, _mean, peak = gate_device(out.color, gout.color,
                                            f".{fmt} frame {k}", ".glb frame")
            shares.append(frac)
            peaks.append(peak)
        if err > PALETTE_FORMAT_TOL:
            fail(f".{fmt} crowd palettes: max err {err} against the .glb "
                 f"crowd's (> {PALETTE_FORMAT_TOL})")
        print(f"imported .{fmt} crowd against the .glb crowd, "
              f"{LOADED_FRAMES} frames at the same clip times: palettes max "
              f"err {err:.3g} (<= {PALETTE_FORMAT_TOL}); frames in the "
              f"golden gate, share of values > {GOLDEN_LSB} LSB "
              f"{min(shares):.6f} .. {max(shares):.6f}, max "
              f"{min(peaks)} .. {max(peaks)} LSB; every replay bit-equal "
              f"to eager render_frame, aux [0, 0]", flush=True)

    # the silhouette split: each crowd given the .glb crowd's palettes
    ref_r, ref_reg = scenes.skinned_scene(dev)
    ref_r.set_skybox(sky[0], mips=sky[1:])
    ref_anims = [a for _e, (a,) in ref_reg.view(AnimationComponent)]
    for k in range(0, LOADED_FRAMES, IMPORTED_SPLIT_EVERY):
        gout, _gi, _gt, gpals = held["glb"][k]
        parts = []
        for fmt in ("fbx", "dae"):
            c = crowds[fmt]
            rt = c.scene.runtime_registry
            for e, pal in zip(c.entities, gpals):
                rt.get(e, AnimationComponent).bone_matrices = pal
            out = c.renderer.render_viewport()
            diff = (out.color.int() - gout.color.int()).abs()
            parts.append(f".{fmt} {int((diff > 0).sum())} values off, "
                         f"{int((diff > GOLDEN_LSB).sum())} > {GOLDEN_LSB} "
                         f"LSB, max {int(diff.max())}")
        for a, pal in zip(ref_anims, gpals):
            a.bone_matrices = pal
        ref = ref_r.render_viewport()
        if ref.aux.tolist() != [0, 0]:
            fail(f"posed crowd given frame {k}'s palettes: aux "
                 f"{ref.aux.tolist()}")
        diff = (ref.color.int() - gout.color.int()).abs()
        parts.append(f"skinned_scene {int((diff > 0).sum())} values off, "
                     f"{int((diff > GOLDEN_LSB).sum())} > {GOLDEN_LSB} LSB, "
                     f"max {int(diff.max())}")
        print(f"silhouette split, .glb frame {k} against the same palettes "
              f"fed to: " + "; ".join(parts), flush=True)
    del ref_r, ref_reg, ref_anims
    for fmt in ("fbx", "dae"):
        replay_line(crowds[fmt].renderer, f"imported .{fmt} crowd", card)
        skinned_kernels(held[fmt][-1][1], f"imported .{fmt} crowd", w, h)
    del held, crowds
    torch.cuda.empty_cache()
    for fmt in ("fbx", "dae"):
        sh = scenes.loaded_crowd(dev, paths[fmt], shadows=True)
        sh.renderer.set_skybox(sky[0], mips=sky[1:])
        sh.scene.update(1 / 60)
        sinp = frame_inputs_at(sh.renderer)
        skinned_light_pass(sinp, f"imported .{fmt} crowd", w, h)
        sh_out, launches[f"imported_{fmt}_shadow"] = drive(
            sh.renderer.render_viewport,
            ("visibility", "visibility_depth", "resolve_vc", "texel",
             "shadow_taps"), (sh.renderer,))
        same_as_eager(sh_out, sinp, f"imported .{fmt} shadowed frame",
                      ("aux", "shadow_aux"))
        print(f"imported .{fmt} shadowed frame: replay bit-equal to eager, "
              f"aux [0, 0] (and the light pass's); launches "
              f"{launches[f'imported_{fmt}_shadow']}", flush=True)
        del sh, sinp, sh_out
    torch.cuda.empty_cache()

    # (b) spheres1080_1m from files
    t0 = time.perf_counter()
    obj = scenes.write_field_obj(d, "checker.ktx2")
    write_s = time.perf_counter() - t0
    tex = scenes.write_checker_ktx2(d / "checker.ktx2")
    os.mkdir(d / "sky")
    scenes.write_sky_faces(d / "sky")
    if get_lib() is None:
        fail("the native OBJ loader did not build (g++): load_model would "
             "take the Python parser")
    native_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        nat = load_obj_native(obj)
        native_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    py = load_obj(obj)
    python_ms = (time.perf_counter() - t0) * 1e3
    bad = [f for f in ("positions", "normals", "tangents", "bitangents",
                       "uvs", "colors", "indices", "bone_indices",
                       "bone_weights")
           if getattr(nat.meshes[0], f).tobytes()
           != getattr(py.meshes[0], f).tobytes()]
    if len(nat.meshes) != 1 or len(py.meshes) != 1 or bad \
            or [vars(m) for m in nat.materials] \
            != [vars(m) for m in py.materials] \
            or [(t.path, t.name) for t in nat.textures] \
            != [(t.path, t.name) for t in py.textures]:
        fail(f"field .obj: native and Python ModelData differ in {bad} "
             f"(or in meshes, materials, textures)")
    print(f"field .obj: {os.path.getsize(obj)} bytes, "
          f"{nat.meshes[0].vertex_count} vertices, "
          f"{nat.meshes[0].triangle_count} triangles, written in "
          f"{write_s:.3f} s; native loader {statistics.median(native_ms):.3f}"
          f" ms median of 3 ({', '.join(f'{x:.3f}' for x in native_ms)}), "
          f"Python load_obj {python_ms:.3f} ms once; the two ModelData "
          f"bit-equal ({card})", flush=True)
    del nat, py
    files = scenes.FieldFiles(obj, tex, str(d / "sky"))
    ra, rega, slot_a = scenes.field_scene(dev, files=files)
    rgba, mips = scenes.checker_file()
    rb, regb, slot_b = scenes.field_scene(
        dev, texture=(rgba, mips), sky=scenes.sky_arrays(
            [scenes.sky_levels_u8()[0]]))
    fa = ra.textures
    if slot_a != slot_b or slot_a == 0 \
            or not np.array_equal(fa._images[slot_a], rgba) \
            or len(fa._mips[slot_a] or []) != len(mips) \
            or any(not np.array_equal(x, y)
                   for x, y in zip(fa._mips[slot_a], mips)):
        fail(f"field texture slot {slot_a} does not hold the decoded "
             f".ktx2 and its {len(mips)} file mips (the in-memory scene's "
             f"slot {slot_b})")
    if len(ra._skybox_chain) != 1 or not torch.equal(
            ra._skybox_chain[0].cpu(),
            torch.from_numpy(scenes.sky_arrays(
                [scenes.sky_levels_u8()[0]])[0])):
        fail("field skybox: the PNG faces did not load (the fallback?)")
    ents = {"files": [e for e, _t in rega.view(TransformComponent)],
            "memory": [e for e, _t in regb.view(TransformComponent)]}
    pairs, field_ms = [], {"files": [], "memory": []}

    def field_frames():
        for k in range(FIELD_FRAMES):
            for key, r, reg in (("files", ra, rega), ("memory", rb, regb)):
                for e in ents[key]:
                    reg.get(e, TransformComponent).rotation = np.array(
                        [0.0, 3.0 * k, 0.0], np.float32)
                t0 = time.perf_counter()
                out = r.render_viewport()
                torch.cuda.synchronize()
                field_ms[key].append((time.perf_counter() - t0) * 1e3)
                pairs.append((key, k, out))

    _none, launches["imported_field"] = drive(
        field_frames, ("visibility", "resolve", "texel"), (ra, rb))
    for (_ka, k, out_a), (_kb, _k, out_b) in zip(pairs[0::2], pairs[1::2]):
        same_frames(out_a, out_b, f"field frame {k}, files against memory")
    covered = int((pairs[0][2].tri_id >= 0).sum())
    print(f"field from files: texture slot {slot_a} holds the decoded .ktx2 "
          f"and its {len(mips)} file mips, the sky the PNG faces; "
          f"{FIELD_FRAMES} frames bit-equal to the in-memory scene's "
          f"({covered} covered pixels in frame 0); render_viewport + "
          f"synchronize {spread(field_ms['files'])} ms median / p90 "
          f"(memory {spread(field_ms['memory'])}); launches "
          f"{launches['imported_field']} ({card})", flush=True)
    del ra, rb, rega, regb, pairs
    torch.cuda.empty_cache()

    # (c) an SVG texture under a KTX1 cube map, 128²
    svg = d / "texture.svg"
    svg.write_text(scenes.SVG_TEXTURE)
    small = d / "small"
    os.mkdir(small)
    obj = scenes.write_field_obj(small, str(svg), grid=2)
    levels = scenes.sky_levels_u8(64)
    ktx1 = scenes.write_ktx1_cubemap(d / "sky.ktx", levels)
    files = scenes.FieldFiles(obj, str(svg), ktx1)
    svg_rgba = rasterize_svg(scenes.SVG_TEXTURE)
    ra, _rega, slot_a = scenes.field_scene(dev, grid=2, width=128,
                                           height=128, files=files)
    rb, _regb, _slot_b = scenes.field_scene(
        dev, grid=2, width=128, height=128, texture=(svg_rgba, None),
        sky=scenes.sky_arrays(levels))
    want = scenes.sky_arrays(levels)
    if slot_a == 0 or not np.array_equal(ra.textures._images[slot_a],
                                         svg_rgba):
        fail("svg texture: the slot does not hold the rasterized .svg")
    if len(ra._skybox_chain) != len(want) or any(
            not torch.equal(a.cpu(), torch.from_numpy(b))
            for a, b in zip(ra._skybox_chain, want)):
        fail("KTX1 skybox: the levels are not the file's (the fallback?)")
    outs = {}

    def svg_frames():
        outs["files"] = ra.render_viewport()
        outs["memory"] = rb.render_viewport()

    _none, launches["imported_svg"] = drive(
        svg_frames, ("visibility", "resolve", "texel"), (ra, rb))
    same_frames(outs["files"], outs["memory"], "svg + KTX1 frame")
    print(f"svg + KTX1 frame at 128²: the slot holds the rasterized "
          f"{svg_rgba.shape[1]}x{svg_rgba.shape[0]} .svg, the sky the "
          f"{len(want)} KTX1 levels; bit-equal to the in-memory scene "
          f"({int((outs['files'].tri_id >= 0).sum())} covered pixels); "
          f"launches {launches['imported_svg']}", flush=True)
    del ra, rb, outs
    td.cleanup()
    torch.cuda.empty_cache()
    return launches


# phase 18: the banded frame (parallel/framebuffer.py): n bands on one
# card, every band kernel instance through its band branch, at 1920×1024
# (1024 rows are 32 whole tiles, so they split into 2, 4 or 8 bands; the
# 1080 of the bench's scenes do not, and the Renderer renders those on one
# device)
BAND_W, BAND_H = 1920, 1024
BAND_NS = (2, 4, 8)
# each band instance: (CUDA source, the TPU kernel's band-offset line)
BAND_KERNELS = {
    "visibility_band": ("visibility.cu", "raster_pallas.py:993"),
    "visibility_depth_band": ("visibility.cu", "raster_pallas.py:993"),
    "visibility_ck_band": ("visibility_ck.cu", "raster_pallas.py:1255"),
    "resolve_band": ("resolve.cu", "resolve_pallas.py:430"),
    "resolve_tiled_band": ("resolve.cu", "resolve_pallas.py:430"),
    "resolve_vc_band": ("resolve.cu", "resolve_pallas.py:430"),
    "resolve_tiled_vc_band": ("resolve.cu", "resolve_pallas.py:430"),
    "visibility_resolve_band": ("visibility_resolve.cu",
                                "resolve_pallas.py:294"),
    "visibility_resolve_vc_band": ("visibility_resolve.cu",
                                   "resolve_pallas.py:294"),
}


class BandCase(NamedTuple):
    """One band instance's check: `band()` and `plain()` on a band's
    inputs (tile offset ≠ 0), `free()` and `band0()` the offset-free and
    the band instance (offset 0) on the one-device frame's inputs, its
    bound (bytes, ops) on the band's inputs, and whether its output is
    attributes (held within RESOLVE_TOL; ids and depths bit for bit)."""

    band: object
    plain: object
    free: object
    band0: object
    work: tuple
    attrs: bool


def _flat(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _bit_diffs(a, b) -> int:
    import torch

    return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
               for x, y in zip(_flat(a), _flat(b)))


def sized(r, w: int = BAND_W, h: int = BAND_H):
    """Renderer `r` with viewport 0 and the editor camera at w × h."""
    r.set_viewport(0, w, h)
    r.editor_camera.set_viewport_size(w, h)
    return r


def band_geometry(inp: dict):
    """(corner stage output, records) of the one-device frame of `inp`."""
    from trident_tpu_torch.render.renderer import frame_geometry

    return frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"],
        width=inp["width"], height=inp["height"],
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"],
        vertex_colors=inp["vertex_colors"], geometry=inp["geometry"],
        palette=inp["palette"], skinned=inp["skinned"])


def band_cases(setup, cols, records, w: int, h: int, n: int, b: int,
               names) -> dict:
    """BandCase of each band instance in `names` on band b of n of the
    frame with full-frame setup (setup, cols) and resolve `records`, and
    on the one-device frame's own inputs."""
    import torch

    from trident_tpu_torch.ops import raster, resolve
    from trident_tpu_torch.ops.vertex import band_slice_setup

    bh = h // n
    y0, ty = b * bh, b * bh // raster.TILE
    ntx = w // raster.TILE
    nt_b, nt = ntx * (bh // raster.TILE), ntx * (h // raster.TILE)
    s_band = band_slice_setup(setup, y0, bh, cull=False)
    ck = any("_ck_" in x for x in names)
    bins = raster.build_bins(s_band, w, bh, setup_cols=cols,
                             ck_bank=8 if ck else 0)
    full = raster.build_bins(setup, w, h, setup_cols=cols,
                             ck_bank=8 if ck else 0)
    for bb in (bins, full):
        if bb.aux.tolist() != [0, 0]:
            fail(f"band binning overflow: aux {bb.aux.tolist()}")
    _d, t_b = raster.visibility_tiles(bins, ntx, nt_b, tile_y_offset=ty)
    _d, t_f = raster.visibility_tiles(full, ntx, nt)
    tri_b = raster.untile_frame(t_b, ntx, bh // raster.TILE).contiguous()
    tri_f = raster.untile_frame(t_f, ntx, h // raster.TILE).contiguous()
    vis = vis_work(bins, s_band, ntx, nt_b, 8)
    row = records.shape[1] * 4
    n_win = int(torch.unique(t_b[t_b >= 0]).numel())
    px_t = nt_b * raster.TILE_PX
    res_bytes = px_t * 4 * (1 + resolve.CHANNELS) + n_win * row
    cases = {
        "visibility_band": lambda: BandCase(
            lambda: raster.visibility_tiles(bins, ntx, nt_b, tile_y_offset=ty),
            lambda: raster.visibility_tiles_plain(bins, ntx, nt_b,
                                                  tile_y_offset=ty),
            lambda: raster.visibility_tiles(full, ntx, nt),
            lambda: raster.visibility_tiles(full, ntx, nt, tile_y_offset=0),
            (vis.bytes, vis.ops), False),
        "visibility_depth_band": lambda: BandCase(
            lambda: raster.visibility_depth_tiles(bins, ntx, nt_b, ty),
            lambda: raster.visibility_tiles_plain(
                bins, ntx, nt_b, depth_only=True, tile_y_offset=ty),
            lambda: raster.visibility_depth_tiles(full, ntx, nt),
            lambda: raster.visibility_depth_tiles(full, ntx, nt, 0),
            (vis.bytes - px_t * 4, vis.ops), False),
        "visibility_ck_band": lambda: BandCase(
            lambda: raster.visibility_ck_tiles(bins, ntx, nt_b, 8, ty),
            lambda: raster.visibility_ck_tiles_plain(bins, ntx, nt_b, 8,
                                                     tile_y_offset=ty),
            lambda: raster.visibility_ck_tiles(full, ntx, nt, 8),
            lambda: raster.visibility_ck_tiles(full, ntx, nt, 8, 0),
            (int(bins.nhit.sum()) * raster.SUB * raster.REC * 4
             + bins.nhit.numel() * 4 + (nt_b + 1) * 4 + px_t * 8, vis.ops),
            False),
        "resolve_band": lambda: BandCase(
            lambda: resolve.resolve_attrs(tri_b, records, y0),
            lambda: resolve.resolve_attrs_plain(tri_b, records, y0),
            lambda: resolve.resolve_attrs(tri_f, records),
            lambda: resolve.resolve_attrs(tri_f, records, 0),
            (w * bh * 4 * (1 + resolve.CHANNELS) + n_win * row, 0), True),
        "resolve_vc_band": lambda: BandCase(
            lambda: resolve.resolve_attrs(tri_b, records, y0),
            lambda: resolve.resolve_attrs_plain(tri_b, records, y0),
            lambda: resolve.resolve_attrs(tri_f, records),
            lambda: resolve.resolve_attrs(tri_f, records, 0),
            (w * bh * 4 * (1 + resolve.CHANNELS) + n_win * row, 0), True),
        "resolve_tiled_band": lambda: BandCase(
            lambda: resolve.resolve_attrs_tiled(t_b, records, ntx, ty),
            lambda: resolve.resolve_attrs_tiled_plain(t_b, records, ntx, ty),
            lambda: resolve.resolve_attrs_tiled(t_f, records, ntx),
            lambda: resolve.resolve_attrs_tiled(t_f, records, ntx, 0),
            (res_bytes, 0), True),
        "resolve_tiled_vc_band": lambda: BandCase(
            lambda: resolve.resolve_attrs_tiled(t_b, records, ntx, ty),
            lambda: resolve.resolve_attrs_tiled_plain(t_b, records, ntx, ty),
            lambda: resolve.resolve_attrs_tiled(t_f, records, ntx),
            lambda: resolve.resolve_attrs_tiled(t_f, records, ntx, 0),
            (res_bytes, 0), True),
        "visibility_resolve_band": lambda: BandCase(
            lambda: resolve.fused_visibility_resolve(bins, records, ntx,
                                                     nt_b, ty),
            lambda: resolve.fused_visibility_resolve_plain(bins, records,
                                                           ntx, nt_b, ty),
            lambda: resolve.fused_visibility_resolve(full, records, ntx, nt),
            lambda: resolve.fused_visibility_resolve(full, records, ntx,
                                                     nt, 0),
            (vis.bytes + px_t * 4 * resolve.CHANNELS + n_win * row, vis.ops),
            True),
        "visibility_resolve_vc_band": lambda: BandCase(
            lambda: resolve.fused_visibility_resolve(
                bins, records, ntx, nt_b, ty),
            lambda: resolve.fused_visibility_resolve_plain(bins, records,
                                                           ntx, nt_b, ty),
            lambda: resolve.fused_visibility_resolve(full, records, ntx,
                                                     nt),
            lambda: resolve.fused_visibility_resolve(
                full, records, ntx, nt, 0),
            (vis.bytes + px_t * 4 * resolve.CHANNELS + n_win * row, vis.ops),
            True),
    }
    return {name: cases[name]() for name in names}


def hold_band_case(name: str, case: BandCase, results: dict,
                   card: str) -> None:
    """Band instance `name` against its plain version on its band's
    inputs (ids and depths bit-equal, attributes within RESOLVE_TOL), and
    at offset 0 against its offset-free instance on the one-device frame's
    inputs, bit for bit; its times, and both instances' in one window
    (offset-free, band, band, offset-free); its results entry."""
    import torch

    k, p = case.band(), case.plain()
    torch.cuda.synchronize()
    k, p = _flat(k), _flat(p)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(k, p))
    ids_depths = k[:2] if case.attrs and len(k) == 3 else (
        [] if case.attrs else k)
    bad = _bit_diffs(tuple(ids_depths), tuple(p[:len(ids_depths)]))
    attrs = k[-1] if case.attrs else None
    if bad or (case.attrs and (err > RESOLVE_TOL
                               or not bool(torch.isfinite(attrs).all()))):
        fail(f"{name} disagrees with its plain version: {bad} id/depth "
             f"values, max err {err}")
    free, band0 = case.free(), case.band0()
    torch.cuda.synchronize()
    bad0 = _bit_diffs(free, band0)
    if bad0:
        fail(f"{name} at offset 0 differs from the offset-free instance in "
             f"{bad0} values")
    t = [cuda_ms(fn) for fn in (case.free, case.band0, case.band0,
                                case.free)]
    b_ms, b_by = bound(*case.work)
    src, repl = BAND_KERNELS[name]
    results[name] = dict(
        route="cuda", source=f"trident_tpu_torch/csrc/{src}",
        replaces=f"trident_tpu/ops/{repl}", max_abs_err=err,
        ms=cuda_ms(case.band), plain_ms=cuda_ms(case.plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        offset_free_ms=(t[0] + t[3]) / 2, offset0_ms=(t[1] + t[2]) / 2)
    res = results[name]
    print(f"{name}: on its band max err {err} vs plain; at offset 0 "
          f"bit-equal to the offset-free instance; kernel {res['ms']:.4f} ms"
          f" (busy {device_busy(case.band)[0]:.4f}), plain "
          f"{res['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); one "
          f"window offset-free / offset-0 band {t[0]:.4f} {t[1]:.4f} "
          f"{t[2]:.4f} {t[3]:.4f} ms, ratio "
          f"{res['offset0_ms'] / res['offset_free_ms']:.4f} ({card})",
          flush=True)


def band_stage_busy(setup, cols, records, w: int, h: int, n: int) -> list:
    """Per band of n: (binning, visibility, resolve) device busy ms of the
    field's band b (n = 1: the one-device frame's stages, offset-free)."""
    from trident_tpu_torch.ops import raster, resolve
    from trident_tpu_torch.ops.vertex import band_slice_setup

    bh = h // n
    ntx, nty = w // raster.TILE, bh // raster.TILE
    out = []
    for b in range(n):
        y0 = b * bh
        ty = None if n == 1 else y0 // raster.TILE

        def binning(y0=y0):
            s = (setup if n == 1
                 else band_slice_setup(setup, y0, bh, cull=False))
            return raster.build_bins(s, w, bh, setup_cols=cols)

        bins = binning()
        _d, t = raster.visibility_tiles(bins, ntx, ntx * nty,
                                        tile_y_offset=ty)
        tri = raster.untile_frame(t, ntx, nty).contiguous()
        yo = None if n == 1 else y0
        out.append(tuple(round(device_busy(fn, reps=3)[0], 4) for fn in (
            binning,
            lambda bins=bins, ty=ty: raster.visibility_tiles(
                bins, ntx, ntx * nty, tile_y_offset=ty),
            lambda tri=tri, yo=yo: resolve.resolve_attrs(tri, records, yo))))
    return out


class _WarnLog:
    """Collects the port Renderer's warnings (its logger does not
    propagate)."""

    def __init__(self):
        import logging

        self.messages = []
        outer = self

        class H(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = H(logging.WARNING)
        self.log = logging.getLogger("trident.renderer_torch")

    def __enter__(self):
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)


def phase_bands(dev, card: str, kernel_names: list, drive,
                results: dict) -> dict:
    """Phase 18 (module docstring): the banded frame on [dev] * n bands at
    1920×1024, held bit for bit to the one-device frame; the band kernel
    instances against their plain versions and their offset-free
    instances; the Renderer's bands; banded times. Returns the main
    path's launch counts."""
    import torch

    from trident_tpu_torch.ops.kernel_knobs import KernelKnobs
    from trident_tpu_torch.parallel.framebuffer import render_frame_banded
    from trident_tpu_torch.render.renderer import render_frame
    from trident_tpu_torch.tools_dev.banded import (
        banded_kwargs,
        frame_diffs,
        one_device_v1,
    )
    from trident_tpu_torch.tools_dev.scenes import (
        build_plane_scene,
        skinned_scene,
    )
    from trident_tpu_torch.tools_dev.timing import uploads_per_call

    t18 = time.perf_counter()
    kernel_names.extend(BAND_KERNELS)
    r, reg = build_bench_scene(BENCH_GRID, dev)
    rotate(reg, 0)
    sized(r)
    rs, sreg = build_bench_scene(SHADOW_GRID, dev, "shadows1080")
    rotate(sreg, 0)
    sized(rs)
    rp, _reg = build_plane_scene("spheres1080_1m:planes_f16", dev, reg=reg)
    sized(rp)
    rk, _kreg = skinned_scene(dev, height=BAND_H)
    sized(rk)
    ra, _areg = build_bench_scene(BENCH_GRID, dev, ai=True, reg=reg)
    sized(ra)
    knob_sets = {"ckern": CKERN, "fuse": {"fuse": True},
                 "tiled_shade": {"tiled_shade": True}}
    knobs = {k: KernelKnobs.from_config(v) for k, v in knob_sets.items()}
    bands = lambda n: [dev] * n                       # noqa: E731
    ai_prev, ai_inp = [], []
    r_knobs, rk_knobs = r.knobs, rk.knobs

    # the main path: every banded frame through Renderer.render_viewport
    # (render_frame_banded_bundled), every count set to 0 just before
    def banded_frames():
        outs = {}
        for n in BAND_NS:                                     # (a)
            outs[f"field/{n}"] = r.render_viewport(devices=bands(n))
        outs["planes_f16/2"] = rp.render_viewport(devices=bands(2))
        for name, k in knobs.items():                         # (c)
            r.knobs = k
            outs[f"{name}/4"] = r.render_viewport(devices=bands(4))
        r.knobs = r_knobs
        outs["shadows/8"] = rs.render_viewport(devices=bands(8))  # (b)
        rs.config.render.shadow_pcf = True
        outs["shadows_pcf/8"] = rs.render_viewport(devices=bands(8))
        rs.config.render.shadow_pcf = False
        for name in ("default", "fuse", "tiled_shade"):       # (d)
            rk.knobs = knobs.get(name, rk_knobs)
            outs[f"skinned_{name}/4"] = rk.render_viewport(devices=bands(4))
        rk.knobs = rk_knobs
        for k in range(2):                                    # (e)
            if k:
                rotate(reg, 1)
                ra.editor_camera.orbit([0, 0, 0], 6.0, 4.0)
            ai_prev.append(ra.prev_state)
            outs[f"ai{k}/2"] = ra.render_viewport(devices=bands(2))
            # the frame's inputs as it rendered them (no kernel launches)
            ai_inp.append(ra.frame_inputs())
        rotate(reg, 0)
        return outs

    outs, launches = drive(banded_frames, tuple(BAND_KERNELS))
    print(f"banded frames' launches "
          f"{ {k: v for k, v in launches.items() if v} } ({card})",
          flush=True)

    # each against the one-device frame of the same inputs
    def held(name, out, one, n):
        diffs = frame_diffs(out, one)
        aux = out.aux.tolist()
        saux = [] if out.shadow_aux is None else out.shadow_aux.tolist()
        if diffs or any(aux) or any(saux) or len(aux) != 2 * n:
            bh = out.tri_id.shape[0] // n
            per_band = [int((out.tri_id[b * bh:(b + 1) * bh]
                             != one.tri_id[b * bh:(b + 1) * bh]).sum())
                        for b in range(n)]
            fail(f"banded {name}: differs in {diffs} from the one-device "
                 f"frame (ids per band {per_band}); band aux {aux}, light "
                 f"pass aux {saux}")

    finp = r.frame_inputs()
    one = render_frame(**finp)
    for n in BAND_NS:
        held(f"field n={n}", outs[f"field/{n}"], one, n)
    print(f"banded field (spheres1080_1m at {BAND_W}x{BAND_H}, "
          f"{int(finp['plan'].tri_valid.sum())} triangles): n = {BAND_NS} "
          f"bit-equal to the one-device frame (colour, depth, ids), every "
          f"band's aux [0, 0]", flush=True)
    culled_cut_line(finp, one, card)
    held("planes_f16", outs["planes_f16/2"],
         render_frame(**rp.frame_inputs()), 2)
    for name, k in knobs.items():
        r.knobs = k
        held(name, outs[f"{name}/4"], render_frame(**r.frame_inputs()), 4)
    r.knobs = r_knobs
    print(f"banded knob frames (ckern, fuse, tiled_shade; 4 bands) and the "
          f"f16 plane-gather frame (2 bands) bit-equal to the one-device "
          f"frames", flush=True)
    one_s = render_frame(**rs.frame_inputs())
    held("shadows", outs["shadows/8"], one_s, 8)
    rs.config.render.shadow_pcf = True
    held("shadows_pcf", outs["shadows_pcf/8"],
         render_frame(**rs.frame_inputs()), 8)
    # the bundled frame against the unbundled one on the same inputs, and
    # its host-to-device uploads per frame
    sinp = rs.frame_inputs()
    unbundled = render_frame_banded(bands(8), **banded_kwargs(sinp))
    if frame_diffs(outs["shadows_pcf/8"], unbundled):
        fail("the bundled banded frame differs from render_frame_banded")
    uploads = uploads_per_call(lambda: rs.render_viewport(devices=bands(8)))
    rs.config.render.shadow_pcf = False
    covered = int((outs["shadows/8"].tri_id >= 0).sum())
    if uploads != 2 and uploads == uploads:
        fail(f"the bundled banded frame made {uploads} uploads a frame")
    print(f"banded render OK: 8 bands (pallas+shadows), covered "
          f"px={covered}; the 1024² light pass banded too, hard and PCF "
          f"({card})", flush=True)
    print(f"bundled banded OK: 8 bands, 2-blob uploads (measured "
          f"{uploads} host-to-device copies a frame)", flush=True)
    for name in ("default", "fuse", "tiled_shade"):
        rk.knobs = knobs.get(name, rk_knobs)
        kinp = rk.frame_inputs()
        held(f"skinned {name}", outs[f"skinned_{name}/4"],
             render_frame(**kinp), 4)
    rk.knobs = rk_knobs
    print(f"banded skinned crowd ({int(kinp['plan'].tri_valid.sum())} "
          f"triangles, vertex colours {kinp['vertex_colors']}, the indexed "
          f"path split over vertices; default, fuse, tiled_shade; 4 bands) "
          f"bit-equal to the one-device frames", flush=True)
    # (e) each :ai frame is the one-device half-size frame upscaled by V1
    for k in range(2):
        color, depth = one_device_v1(ai_inp[k], ai_prev[k])
        out = outs[f"ai{k}/2"]
        if (not torch.equal(out.color, color) or tuple(out.color.shape)
                != (BAND_H, BAND_W, 4) or any(out.aux.tolist())
                or not torch.equal(out.depth.view(torch.int32),
                                   depth.view(torch.int32))):
            fail(f"banded :ai frame {k} differs from the one-device "
                 f"half-size frame upscaled by V1")
        if (ai_prev[k] is None) != (k == 0):
            fail("the second :ai frame had no history to warp")
    print(f"banded ai_upscale OK: {BAND_W // 2}x{BAND_H // 2}->"
          f"{BAND_W}x{BAND_H} over 2 bands (two frames, the second warping "
          f"the first's RGBA8 frame through warp_previous; each bit-equal "
          f"to the one-device half-size frame through apply_upscaler)",
          flush=True)
    del outs, unbundled, one, one_s, ai_inp, ai_prev

    # (f) the Renderer's bands on this machine's cards
    with _WarnLog() as wl:
        r.config.render.bands = 2
        ctx = r.viewports[0]
        ctx.last_sig = None
        warned = r.render_viewport()
        r.config.render.bands = 1
        ctx.last_sig = None
        single = r.render_viewport()
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        if not any("but only" in m for m in wl.messages):
            fail(f"bands=2 on {n_cards} card did not warn: {wl.messages}")
        if frame_diffs(warned, single):
            fail("bands=2 on one card differs from bands=1")
        print(f"Renderer bands=2 on {n_cards} card: warned "
              f"({wl.messages[-1]!r}) and rendered bit-equal to bands=1; "
              f"the two-card run is skipped: this machine has {n_cards} "
              f"card", flush=True)
    else:
        r.config.render.bands = 2
        two = r.render_viewport()
        r.config.render.bands = 1
        if frame_diffs(two, single) or two.aux.numel() != 4:
            fail("bands=2 across two cards differs from bands=1")
        print(f"Renderer bands=2 across cuda:0 and cuda:1 bit-equal to "
              f"bands=1 ({n_cards} cards)", flush=True)

    # the band instances against their plain versions and, at offset 0,
    # their offset-free instances
    fcs, frec = band_geometry(finp)
    for name, case in band_cases(fcs.setup, fcs.cols.setup, frec, BAND_W,
                                 BAND_H, 4, 3, (
                                     "visibility_band", "visibility_ck_band",
                                     "resolve_band", "resolve_tiled_band",
                                     "visibility_resolve_band")).items():
        hold_band_case(name, case, results, card)
    for b in range(4):          # K1 and K2 on every band of the field's 4
        for name, case in band_cases(fcs.setup, fcs.cols.setup, frec, BAND_W,
                                     BAND_H, 4, b, ("visibility_band",
                                                    "resolve_band")).items():
            k, p = case.band(), case.plain()
            torch.cuda.synchronize()
            e = max(float((x - y).abs().max()) for x, y in zip(
                _flat(k), _flat(p)))
            if (not case.attrs and _bit_diffs(k, p)) or e > RESOLVE_TOL:
                fail(f"{name} on band {b} of 4 disagrees: max err {e}")
    print("visibility_band and resolve_band on each of the field's 4 bands "
          "equal to their plain versions", flush=True)
    sinp = rs.frame_inputs()
    lcam, s = sinp["light_camera"], sinp["shadow_size"]
    lcs = corner_stage_for(sinp, lcam, s)
    hold_band_case("visibility_depth_band", band_cases(   # a middle band
        lcs.setup, lcs.cols.setup, frec, s, s, 8, 4,
        ("visibility_depth_band",))["visibility_depth_band"], results, card)
    kinp = rk.frame_inputs()
    kcs, krec = band_geometry(kinp)
    for name, case in band_cases(kcs.setup, kcs.cols.setup, krec, BAND_W,
                                 BAND_H, 4, 3, (
                                     "resolve_vc_band",
                                     "resolve_tiled_vc_band",
                                     "visibility_resolve_vc_band")).items():
        hold_band_case(name, case, results, card)
    del kcs, krec

    # (g) times: the field's frame at n = 1 (the one-device frame), 2, 4, 8;
    # the geometry on the one-device frame's uniform-instancing broadcast
    # path against the draw-row gather that the banded frame's slices take
    geo = {name: device_busy(lambda kw=kw: band_geometry({**finp, **kw}),
                             reps=3)[0]
           for name, kw in (("broadcast", {}), ("gather", dict(
               draw_stride=0, real_draws=0)))}
    print(f"banded field geometry busy: the one-device broadcast path "
          f"{geo['broadcast']:.4f} ms, the banded frame's gather path "
          f"{geo['gather']:.4f} ms (the path of its slices, run on the "
          f"whole plan) ({card})",
          flush=True)
    for n in (1,) + BAND_NS:
        fn = ((lambda: render_frame(**finp)) if n == 1 else
              (lambda n=n: render_frame_banded(bands(n),
                                               **banded_kwargs(finp))))
        dev_ms = cuda_ms(fn, reps=5, warmup=1)
        busy_ms, acts = device_busy(fn, reps=2)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        stages = band_stage_busy(fcs.setup, fcs.cols.setup, frec, BAND_W,
                                 BAND_H, n)
        print(f"banded field n={n}: frame {dev_ms:.3f} ms device (CUDA "
              f"events), {busy_ms:.3f} ms busy in {acts:.0f} activities, "
              f"wall median {statistics.median(walls):.3f} ms; per band "
              f"(binning, visibility, resolve) busy ms {stages} ({card})",
              flush=True)
    r.config.render.bands = 1
    del r, reg, rs, sreg, rp, rk, ra, fcs, frec, finp, lcs
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s ({card})", flush=True)
    return launches


def culled_cut_line(inp: dict, one, card: str) -> None:
    """How many of the field's pixels the JAX package's band cut (culled:
    band_slice_setup(cull=True), the triangles that miss the band
    invalid) would change at n = 2, 4, 8 against the one-device frame's
    ids, band by band through K1's band instance; the banded frame's cut
    (cull=False) changes none (held above)."""
    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.ops.vertex import band_slice_setup

    fcs, _rec = band_geometry(inp)
    ntx = BAND_W // raster.TILE
    counts = {}
    for n in BAND_NS:
        bh = BAND_H // n
        bad = []
        for b in range(n):
            bins = raster.build_bins(
                band_slice_setup(fcs.setup, b * bh, bh), BAND_W, bh,
                setup_cols=fcs.cols.setup)
            _d, t = raster.visibility_tiles(
                bins, ntx, ntx * (bh // raster.TILE),
                tile_y_offset=b * bh // raster.TILE)
            tri = raster.untile_frame(t, ntx, bh // raster.TILE)
            bad.append(int((tri != one.tri_id[b * bh:(b + 1) * bh]).sum()))
        counts[n] = bad
    print(f"the culled band cut (the JAX band_slice_setup) would change "
          f"ids per band {counts} of the one-device frame; the banded "
          f"frame's cut keeps every triangle valid ({card})", flush=True)


def corner_stage_for(inp: dict, cam, size: int):
    """The light pass's corner stage of frame inputs `inp` at camera
    `cam` on a size² map (phase 6's light_geometry)."""
    from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage

    rows = build_draw_rows(inp["params"], cam, size, size)
    return corner_stage(inp["corner_t"], rows, inp["tri_draw"],
                        inp["plan"].tri_valid, size, size,
                        draw_stride=inp["draw_stride"],
                        real_draws=inp["real_draws"])


# phase 19: training — the 2× upscaler's and the interpolation net's
# trainers on rendered data, a train step on the card against the CPU,
# and the multi-device dry run
TRAIN_RES = 256            # the upscaler trainer's --res
TRAIN_PAIRS = 48           # --pairs (--temporal --depth: 17 input channels)
TRAIN_STEPS = 200          # --steps
TRAIN_BATCH = 8            # --batch
TRAIN_CHANNELS = 32        # --channels
INTERP_FRAMES = 24         # orbit frames rendered for the interpolation net
INTERP_RES = 256
INTERP_CHANNELS = 32
INTERP_BATCH = 4
DRYRUN_N = 8               # run_dryrun's ranks (processes) on the card
STEP_LOSS_RTOL = 1e-4      # a train step on the card against the CPU
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-3, 1e-6
PAIR_KERNELS = ("visibility", "resolve", "texel", "visibility_depth",
                "shadow_taps")


def phase_training(dev, card: str, drive) -> dict:
    """Phase 19 (module docstring). Returns {"train_pairs": the kernels'
    launches while the upscaler trainer rendered its pairs}."""
    import shutil

    import torch

    from trident_tpu_torch.ai import train as tr
    from trident_tpu_torch.ai import upscaler as up
    from trident_tpu_torch.ai.dataset import TripletDataset
    from trident_tpu_torch.ai.frame_generator import FrameGenerator
    from trident_tpu_torch.ai.model import unet_flops
    from trident_tpu_torch.ai.validate import validate_checkpoint
    from trident_tpu_torch.io.image import save_png
    from trident_tpu_torch.parallel.dryrun import run_dryrun
    from trident_tpu_torch.scripts import train_upscaler as tu
    from trident_tpu_torch.tools_dev.timing import F32_OPS_PER_S

    t19 = time.perf_counter()
    work = ROOT / "build" / "phase19"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # (a) the upscaler trainer at full width; its main path is the pairs'
    # rendering (K1, K2, K3 on every pool, K1b and K4 on the shadowed one)
    pools = tu.build_pools(TRAIN_RES, 0, dev)
    t0 = time.perf_counter()
    datasets, counts = drive(
        lambda: tu.render_datasets([TRAIN_RES], TRAIN_PAIRS, 0,
                                   temporal=True, depth=True, device=dev,
                                   pools={TRAIN_RES: pools}),
        PAIR_KERNELS, [p[0] for p in pools])
    pair_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_PAIRS
    tr_in, _tr_tg, v_in, _v_tg, _res = datasets[0]
    if tr_in.shape[-1] != 17 or not torch.isfinite(tr_in).all():
        fail(f"train_upscaler inputs {tuple(tr_in.shape)}")
    print(f"train_upscaler pairs: {TRAIN_PAIRS} (--temporal --depth, 17 "
          f"channels) at {TRAIN_RES}² over {len(pools)} pools, {pair_ms:.3f} "
          f"ms a pair (wall: three frames, the warp, the first frame of "
          f"each key captured); launches "
          f"{ {k: v for k, v in counts.items() if v} } ({card})", flush=True)
    net = up.init_upscaler(torch.Generator().manual_seed(0), TRAIN_CHANNELS,
                           in_channels=17, device=dev)
    net_before, base_before, _ = tu.eval_all(net, datasets)
    fit = tu.fit(net, datasets, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                 lr=2e-3, edge_weight=0.25, seed=0,
                 out=str(work / "upscaler"))
    if not (np.isfinite(fit["net_psnr"]) and np.isfinite(fit["best"])):
        fail(f"train_upscaler diverged: {fit}")
    h = TRAIN_RES // 2
    step_bound = 3 * up.upscaler_flops(TRAIN_CHANNELS, 17, h, h) \
        * TRAIN_BATCH / F32_OPS_PER_S * 1e3
    print(f"train_upscaler steps: {TRAIN_STEPS} at batch {TRAIN_BATCH} "
          f"({h}² inputs), {fit['step_ms']:.4f} ms a step (CUDA events, "
          f"median), f32 bound {step_bound:.4f} ms (3 × the forward's conv "
          f"FLOPs over 67 TFLOP/s): {step_bound / fit['step_ms']:.3f} of "
          f"it; val PSNR net {net_before:.4f} → {fit['net_psnr']:.4f} dB, "
          f"bilinear {base_before:.4f} → {fit['bilinear_psnr']:.4f} dB "
          f"({len(v_in)} held-out pairs) ({card})", flush=True)
    loaded, bc = up.load_upscaler(work / "upscaler", dev)
    r2, _reg2 = build_bench_scene(0, dev, "cube512", ai=True,
                                  upscaler_path=str(work / "upscaler"))
    f0 = r2.render_viewport()
    r2.editor_camera.orbit([0, 0, 0], 6.0, 4.0)
    f1 = r2.render_viewport()
    torch.cuda.synchronize()
    if (bc, up.upscaler_in_channels(loaded)) != (TRAIN_CHANNELS, 17) \
            or any(tuple(f.color.shape) != (512, 512, 4) or any(
                f.aux.tolist()) for f in (f0, f1)) \
            or not bool((f1.tri_id >= 0).any()):
        fail(f"the trained checkpoint's 2× frame: {bc} channels, "
             f"{up.upscaler_in_channels(loaded)} inputs, frames "
             f"{[tuple(f.color.shape) for f in (f0, f1)]}, aux "
             f"{[f.aux.tolist() for f in (f0, f1)]}")
    print(f"trained upscaler checkpoint ({bc} channels, "
          f"{up.upscaler_in_channels(loaded)} inputs) through a Renderer's "
          f"ai.upscaler_path: two 2× frames at 512² (cube512:ai, the second "
          f"warping the first's history), aux [0, 0] ({card})", flush=True)
    del datasets, pools, r2, f0, f1, net, loaded
    torch.cuda.empty_cache()

    # (b) the interpolation net on frames the port renders
    pool = tu.build_pool(INTERP_RES, 11, device=dev, **tu.POOL_SPECS[0])
    tgt = tu.randomize(*pool[:5], *pool[5])
    frames = work / "frames"
    frames.mkdir()
    for k in range(INTERP_FRAMES):
        pool[0].editor_camera.orbit(tgt, 2.0, 0.0)
        save_png(frames / f"frame_{k:04d}.png",
                 pool[0].render_viewport().color.cpu().numpy())
    cfg = tr.TrainConfig(source=str(frames), resolution=(INTERP_RES,) * 2,
                         base_channels=INTERP_CHANNELS,
                         batch_size=INTERP_BATCH, epochs=2,
                         checkpoint_dir=str(work / "framegen"),
                         log_path=str(work / "framegen.jsonl"))
    t0 = time.perf_counter()
    summary = tr.train(cfg, device=dev)
    train_s = time.perf_counter() - t0
    records = [json.loads(line) for line in
               (work / "framegen.jsonl").read_text().splitlines()]
    if len(records) != 2 or not all(np.isfinite(r["train_l1"])
                                    for r in records):
        fail(f"train(): {records}")
    for rec in records:
        print(f"interpolation net epoch {rec['epoch']}: {rec['seconds']:.3f} "
              f"s, train L1 {rec['train_l1']:.4f}, val L1 "
              f"{rec['val_l1']:.4f}, val PSNR {rec['val_psnr']:.2f} dB, "
              f"SSIM {rec['val_ssim']:.4f} ({card})", flush=True)
    res = validate_checkpoint(cfg.checkpoint_dir, cfg.resolution,
                              INTERP_CHANNELS, device=dev)
    print(("OK: " if res.ok else "FAIL: ") + res.message, flush=True)
    if not res.ok:
        fail("validate_checkpoint failed on train()'s checkpoint")
    ds = TripletDataset(cfg.source, cfg.resolution)
    x_np, y_np = next(ds.batches(range(len(ds)), INTERP_BATCH))
    nchw = lambda a, d: torch.from_numpy(a).to(d).permute(  # noqa: E731
        0, 3, 1, 2).contiguous()
    state = tr.create_state(cfg, device=dev)
    x, y = nchw(x_np, dev), nchw(y_np, dev)
    step_ms = cuda_ms(lambda: tr.train_step(state, x, y), reps=10)
    unet_bound = 3 * unet_flops(INTERP_CHANNELS, *cfg.resolution) \
        * INTERP_BATCH / F32_OPS_PER_S * 1e3
    print(f"interpolation net: {len(ds)} triplets of {INTERP_FRAMES} orbit "
          f"frames at {INTERP_RES}², train() {train_s:.2f} s for 2 epochs "
          f"(best val PSNR {summary['best_psnr']:.2f} dB); train_step "
          f"{step_ms:.4f} ms at batch {INTERP_BATCH} (CUDA events, median "
          f"of 10), f32 bound {unet_bound:.4f} ms (3 × unet_flops): "
          f"{unet_bound / step_ms:.3f} of it ({card})", flush=True)
    gen = FrameGenerator(resolution=cfg.resolution, device=dev)
    if not gen.initialise(cfg.checkpoint_dir):
        fail("FrameGenerator.initialise(checkpoint dir) did not start")
    for a in (x_np[0, ..., :3], x_np[0, ..., 3:]):
        gen.process_frame(a)
    t0, got = time.perf_counter(), None
    while got is None and time.perf_counter() - t0 < FRAMEGEN_WAIT_S:
        got = gen.try_consume_output()
        time.sleep(0.005)
    gen.shutdown()
    if got is None or got[1].shape != (INTERP_RES, INTERP_RES, 3) \
            or not np.isfinite(got[1]).all():
        fail("FrameGenerator on train()'s checkpoint gave no frame")
    print(f"FrameGenerator.initialise({cfg.checkpoint_dir}) (through "
          f"latest.json): one inference in "
          f"{gen.stats.last_inference_ms:.3f} ms host time ({card})",
          flush=True)

    # (c) one train step on the card against the same step on the CPU:
    # same init, same batch, in f32 (the trainer's) and in f64. The f32
    # gradients differ by float32 summation order and the ReLU / L1 kinks
    # it moves (the CPU's own f32 step is as far from its f64 step), so
    # the gradients are held at STEP_GRAD_RTOL / ATOL in f64; f32 holds
    # the loss and prints its gradient differences
    def step(device, dtype):
        st = tr.create_state(cfg, device=device)
        st.model.to(dtype)
        _s, loss, _o = tr.train_step(st, nchw(x_np, device).to(dtype),
                                     nchw(y_np, device).to(dtype))
        return float(loss), {n: p.grad.double().cpu()
                             for n, p in st.model.named_parameters()}

    def outside(a, b):
        """(values of a outside the tolerance around b, max |a − b|)."""
        n_out = sum(int(((a[k] - b[k]).abs() > STEP_GRAD_ATOL
                         + STEP_GRAD_RTOL * b[k].abs()).sum()) for k in b)
        return n_out, max(float((a[k] - b[k]).abs().max()) for k in b)

    steps = {(side, bits): step(d, {32: torch.float32,
                                    64: torch.float64}[bits])
             for side, d in (("cpu", "cpu"), ("card", dev))
             for bits in (32, 64)}
    for bits in (32, 64):
        (l_cpu, g_cpu), (l_card, g_card) = steps["cpu", bits], \
            steps["card", bits]
        if not np.isfinite(l_card) \
                or abs(l_card - l_cpu) > STEP_LOSS_RTOL * abs(l_cpu):
            fail(f"train step f{bits} card vs CPU: loss {l_card} vs {l_cpu}")
        n_out, worst = outside(g_card, g_cpu)
        if bits == 64 and n_out:
            fail(f"train step f64 card vs CPU: {n_out} gradient values "
                 f"outside rtol {STEP_GRAD_RTOL} / atol {STEP_GRAD_ATOL} "
                 f"(max |diff| {worst:.3e})")
        print(f"train step card vs CPU, f{bits} (same init and batch): loss "
              f"{l_card:.9f} vs {l_cpu:.9f}; {n_out} gradient values "
              f"outside rtol {STEP_GRAD_RTOL} / atol {STEP_GRAD_ATOL}, max "
              f"|diff| {worst:.3e} ({card})", flush=True)
    n_out, worst = outside(steps["cpu", 32][1], steps["cpu", 64][1])
    print(f"the CPU's f32 step against its f64 step: {n_out} gradient values "
          f"outside that tolerance, max |diff| {worst:.3e}", flush=True)
    del state, x, y, steps
    torch.cuda.empty_cache()

    # (d) the multi-device dry run: DRYRUN_N processes on this card's
    # devices (cuda:(rank % count)), then the banded frame over them
    t0 = time.perf_counter()
    run_dryrun(DRYRUN_N, device=dev)
    print(f"run_dryrun({DRYRUN_N}): {time.perf_counter() - t0:.1f} s "
          f"({DRYRUN_N} processes) ({card})", flush=True)
    print(f"phase 19: {time.perf_counter() - t19:.1f} s ({card})",
          flush=True)
    return {"train_pairs": counts}


SHELL_FRAMES = 120         # frames of each application loop (phase 20)
SHELL_W, SHELL_H = 1920, 1080
SHELL_TEXT = ((13, 6, 6), (16, 6, 26))   # (size, x, y) of the layer's lines
DEMO_FRAMES = 4


def ms_line(xs) -> str:
    """median / p90 of a list of ms."""
    a = np.asarray(xs, np.float64)
    return f"{np.median(a):.3f} / {np.percentile(a, 90):.3f}"


def reload_events(app) -> list:
    """app.process_reload_events() → (file name, kind, status) of each
    event it handled."""
    seen = []
    pop = app.file_watcher.pop_pending

    def spy():
        e = pop()
        if e is not None:
            seen.append(e)
        return e

    app.file_watcher.pop_pending = spy
    try:
        app.process_reload_events()
    finally:
        app.file_watcher.pop_pending = pop
    return sorted((Path(e.path).name, e.kind.name, e.status.name)
                  for e in seen)


def entity_map(r, out) -> np.ndarray:
    """The entity that drew each pixel of `out` (−1: background)."""
    tri = out.tri_id.cpu().numpy()
    tri_draw = r._last_tri_draw.cpu().numpy()
    ents = np.asarray(r._last_draws.entity)
    emap = np.full(tri.shape, -1, np.int64)
    hit = tri >= 0
    emap[hit] = ents[tri_draw[tri[hit]]]
    return emap


def touch(path: Path, data, mtime: float) -> None:
    from trident_tpu_torch.io.image import save_png

    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, np.ndarray):
        save_png(path, data)
    else:
        path.write_text(data)
    os.utime(path, (mtime, mtime))


def run_script(args, cwd: Path, what: str) -> str:
    """`python -m <args>` in a subprocess; its stdout, failing on a non-zero
    exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}: {proc.stderr[-2000:]}")
    print(f"{what}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return proc.stdout


def phase_shell(dev, card: str, drive) -> dict:
    """Phase 20 (module docstring). Returns {"app_loop": the kernels'
    launches in the application loop}."""
    import gc
    import re
    import shutil

    import torch

    from trident_tpu_torch.ai.model import DEFAULT_WEIGHTS
    from trident_tpu_torch.app import Application, Layer
    from trident_tpu_torch.core.alloc import AllocationTracker
    from trident_tpu_torch.core.config import (
        AiConfig, CaptureConfig, EngineConfig, RenderConfig,
    )
    from trident_tpu_torch.ecs.components import TextureComponent
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import checkerboard, load_rgba8
    from trident_tpu_torch.io.text_overlay import composite_overlay
    from trident_tpu_torch.io.video import rgb_to_yuv420
    from trident_tpu_torch.tools_dev.scenes import populate_field
    from trident_tpu_torch.tools_dev.timing import KERNEL_RECORDS
    from trident_tpu_torch.utils import Profiler, compilation_stats

    t20 = time.perf_counter()
    work = ROOT / "build" / "phase20"
    shutil.rmtree(work, ignore_errors=True)
    (work / "Assets").mkdir(parents=True)

    # (a) the application loop at full size: spheres1080_1m's field, a
    # layer that spins it and queues two lines of text, the interpolation
    # net at its 66 ms cadence, the dataset recorder and a Y4M session
    W, H = SHELL_W, SHELL_H
    cfg = EngineConfig(
        render=RenderConfig(width=W, height=H),
        ai=AiConfig(enabled=True, model_path=str(DEFAULT_WEIGHTS)),
        capture=CaptureConfig(dataset_enabled=True,
                              dataset_dir=str(work / "dataset"),
                              perf_dir=str(work / "perf")),
        assets_root=str(work / "Assets"), log_file=None)
    app = Application(cfg, device=dev)
    r, reg = app.renderer, app.scene.editor_registry
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    field = populate_field(reg, BENCH_GRID,
                           r.ensure_primitive(PrimitiveType.SPHERE), slot)
    r.editor_camera.set_position([0, 0, BENCH_GRID * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])

    class ShellLayer(Layer):
        """Spins the field each update (as bench.py rotates it) and queues
        the two overlay lines each render."""

        def __init__(self):
            self.k, self.spin = 0, True

        def update(self, app, dt):
            if self.spin:
                rotate(reg, self.k)
                self.k += 1

        def render(self, app):
            (s0, x0, y0), (s1, x1, y1) = SHELL_TEXT
            app.renderer.queue_text(0, f"frame {self.k}  "
                                    f"{app.renderer.stats_triangles} tris",
                                    x0, y0, (1, 1, 0, 1), s0)
            app.renderer.queue_text(0, "trident_tpu_torch shell", x1, y1,
                                    (0.6, 0.9, 1, 0.85), s1)

    layer = ShellLayer()
    app.push_layer(layer)
    if not app.frame_generator.stats.enabled:
        fail("the FrameGenerator did not initialise from "
             f"{DEFAULT_WEIGHTS}")
    if not app.video_encoder.begin_session(str(work / "shell.y4m"), W, H):
        fail("the Y4M session did not begin")
    first_sent = []
    submit = app.video_encoder.submit_frame

    def keep_first(frame):
        ok = submit(frame)
        if ok and not first_sent:
            first_sent.append(np.array(frame[..., :3]))
        return ok

    app.video_encoder.submit_frame = keep_first

    # each part's host time: the instance attributes wrap the methods the
    # loop calls (no synchronize added: draw_frame returns after the
    # replay's launch, and _post_frame's readback waits for the card)
    split = {k: [] for k in ("frame", "update", "render", "draw_frame",
                             "_post_frame", "present")}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    app.update = timed("update", app.update)
    app.render = timed("render", app.render)
    r.draw_frame = timed("draw_frame", r.draw_frame)
    app._post_frame = timed("_post_frame", app._post_frame)
    present = timed("present", r.present)
    blended = []

    def loop(frames: int):
        for v in split.values():
            v.clear()
        t_prev = [time.perf_counter()]

        def on_frame(k, out):
            present()
            blended.append(r.ai_blend > 0)
            now = time.perf_counter()
            split["frame"].append((now - t_prev[0]) * 1e3)
            t_prev[0] = now

        app.run(frames, on_frame=on_frame)
        torch.cuda.synchronize()
        return {k: list(v) for k, v in split.items()}

    full, launches = drive(lambda: loop(SHELL_FRAMES),
                           ("visibility", "resolve"), (r,))
    stats = app.frame_generator.stats
    if stats.completed_count < 1 or not any(blended):
        fail(f"no AI output reached the frame: {stats.completed_count} "
             f"consumed, {sum(blended)} frames blended")
    # a blended frame against the same frame at blend 0
    with_ai = r.read_frame()
    r.set_ai_frame(None, 0.0)
    without = r.read_frame()
    n_diff = int((with_ai != without).any(-1).sum())
    if not n_diff:
        fail("the blended frame equals the blend-0 frame")
    app.frame_generator.shutdown()
    app.dataset_recorder.stop()
    enc = app.video_encoder
    y4m = Path(enc.end_session())
    names = sorted(p.name for p in (work / "dataset").glob("*.npy"))
    inputs = {n.split("_")[1] for n in names if n.endswith("_input.npy")}
    outputs = {n.split("_")[1] for n in names if n.endswith("_output.npy")}
    print(f"app loop AI: {stats.completed_count} outputs consumed, "
          f"{sum(blended)} of {len(blended)} frames blended at "
          f"{cfg.ai.blend}, last inference {stats.last_inference_ms:.3f} ms "
          f"(mean {stats.average_inference_ms:.3f}); the blended frame "
          f"differs from blend 0 at {n_diff} pixels; recorder: "
          f"{len(inputs)} input frames, {len(inputs & outputs)} pairs "
          f"written; encoder: {enc.frames_submitted} submitted, "
          f"{enc.frames_encoded} encoded, {enc.frames_dropped} dropped "
          f"({card})", flush=True)

    # the same loop with every consumer off (no readback in _post_frame)
    # and render_viewport alone, in the same window
    free = loop(SHELL_FRAMES)
    layer_k = layer.k
    alone = []
    for k in range(SHELL_FRAMES):
        rotate(reg, layer_k + k)
        t0 = time.perf_counter()
        r.render_viewport()
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    for what, sp in (("app loop (AI, recorder, Y4M on)", full),
                     ("app loop, consumers off", free)):
        print(f"{what}, {W}x{H} spheres1080_1m field + text, "
              f"{SHELL_FRAMES} frames, median / p90 ms: frame "
              f"{ms_line(sp['frame'])}, update {ms_line(sp['update'])}, "
              f"render {ms_line(sp['render'])} (draw_frame "
              f"{ms_line(sp['draw_frame'])}), _post_frame "
              f"{ms_line(sp['_post_frame'])}, present "
              f"{ms_line(sp['present'])} ({card})", flush=True)
    print(f"render_viewport alone (+ synchronize), {SHELL_FRAMES} frames: "
          f"{ms_line(alone)} ms median / p90 ({card})", flush=True)
    print(f"app loop launches (route_launches app_loop): {launches}",
          flush=True)
    if min(launches[n] for n in ("visibility", "resolve")) < SHELL_FRAMES:
        fail(f"the app loop replayed fewer than one frame a loop frame: "
             f"{launches}")

    # (b) the Y4M file: its size, and its first frame's planes
    header = f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C420\n".encode()
    frame_bytes = W * H * 3 // 2
    size = y4m.stat().st_size
    if size != len(header) + enc.frames_encoded * (6 + frame_bytes):
        fail(f"{y4m}: {size} bytes for {enc.frames_encoded} frames")
    with open(y4m, "rb") as f:
        if f.read(len(header)) != header or f.read(6) != b"FRAME\n":
            fail(f"{y4m}: header or frame marker wrong")
        planes = np.frombuffer(f.read(frame_bytes), np.uint8)
    y, u, v = rgb_to_yuv420(first_sent[0])
    if not (planes == np.concatenate([y.ravel(), u.ravel(), v.ravel()])).all():
        fail("the first Y4M frame is not the first frame submitted")
    print(f"Y4M: {size} bytes = header + {enc.frames_encoded} × (6 + "
          f"{frame_bytes}); frame 0's Y, U, V planes equal rgb_to_yuv420 "
          "of the first frame submitted", flush=True)
    y4m.unlink()

    # (c) text: present() against the overlay composited by hand
    layer.spin = False
    layer.render(app)
    overlay = r.text.render_overlay(0, W, H)
    want = composite_overlay(r.read_frame(), overlay)
    got = r.present()
    if not (got == want).all() or r.text.has_text(0):
        fail("present() is not composite_overlay(read_frame(), overlay) "
             "or did not consume the queue")
    for size_px, x, yy in SHELL_TEXT:
        if not overlay[yy:yy + size_px + 4, x:x + 10 * size_px, 3].any():
            fail(f"no overlay alpha under the size-{size_px} line")
    print(f"text: present() equals the composited overlay "
          f"({int((overlay[..., 3] > 0).sum())} overlay pixels)",
          flush=True)

    # (d) hot reload through the watched Assets directories
    assets = work / "Assets"
    tex = assets / "Textures" / "t.png"
    touch(tex, np.full((16, 16, 4), (220, 40, 40, 255), np.uint8), 1000.0)
    shader = assets / "Shaders" / "unlit.py"
    body = ("def shade(world, normal, albedo, metallic, roughness,\n"
            "          ambient_strength, camera_pos, lights,\n"
            "          dir_shadow=None):\n    return albedo * {k}\n")
    touch(shader, body.format(k=1.0), 1000.0)
    obj = assets / "Models" / "tri.obj"
    touch(obj, "v 0 0 6\nv 1 0 6\nv 0 1 6\nf 1 2 3\n", 1000.0)
    target = field[len(field) // 2 + BENCH_GRID // 2]
    reg.get(target, TextureComponent).path = str(tex)
    reg.get(target, TextureComponent).slot = r.acquire_texture(
        str(tex), load_rgba8(str(tex)))
    if not app.import_assets([str(obj)]):
        fail("the model import made no entity")
    time.sleep(0.6)
    reload_events(app)                         # the new files' baseline
    out0 = r.render_viewport()
    frame0, emap = out0.color.cpu().numpy().copy(), entity_map(r, out0)
    touch(tex, np.full((16, 16, 4), (30, 220, 60, 255), np.uint8), 2000.0)
    time.sleep(0.6)
    ev = reload_events(app)
    frame1 = r.render_viewport().color.cpu().numpy()
    changed = (frame1 != frame0).any(-1)
    if ev != [("t.png", "TEXTURE", "SUCCESS")] or not changed.any() \
            or (emap[changed] != target).any():
        fail(f"texture reload: events {ev}, {int(changed.sum())} pixels "
             f"changed, {int((emap[changed] != target).sum())} of them off "
             "the entity that uses it")
    if not r.set_custom_shader(str(shader)):
        fail(f"set_custom_shader: {r.shader_hook.last_error}")
    frame2 = r.render_viewport().color.cpu().numpy()
    meshes = [m.positions.copy() for m in r.geometry.meshes]
    touch(shader, body.format(k=0.5), 3000.0)
    touch(obj, "", 3000.0)                      # a broken re-import
    time.sleep(0.6)
    ev2 = reload_events(app)
    frame3 = r.render_viewport().color.cpu().numpy()
    kept = all((m.positions == p).all() for m, p in
               zip(r.geometry.meshes, meshes))
    if ev2 != [("tri.obj", "MODEL", "FAILED"),
               ("unlit.py", "SHADER", "SUCCESS")] or not kept \
            or not (frame3 != frame2).any():
        fail(f"shader / model reload: events {ev2}, old geometry kept "
             f"{kept}, frame changed {(frame3 != frame2).any()}")
    r.clear_custom_shader()
    print(f"hot reload: texture {ev} ({int(changed.sum())} pixels changed, "
          f"all on its entity), then {ev2} (the old geometry kept)",
          flush=True)

    # (g) telemetry: device bytes, a trace with the port's kernels, and
    # the graph captures counted
    tracker = AllocationTracker(device=dev)
    tracker.begin_frame()
    app.run(1)
    tracker.end_frame()
    am = tracker.stats()
    if am.device_bytes_in_use <= 0:
        fail(f"AllocationTracker read {am.device_bytes_in_use} device bytes")
    prof = Profiler(str(work / "traces"))
    prof.start()
    layer.spin = True
    app.run(3)
    torch.cuda.synchronize()
    trace = prof.stop()
    events = json.loads(Path(trace).read_text())["traceEvents"]
    kernel_names = {e.get("name", "") for e in events
                    if e.get("cat") == "kernel"}
    found = sorted(n for n, pat in KERNEL_RECORDS.items()
                   if any(re.search(pat, k) for k in kernel_names))
    if not found:
        fail(f"the trace {trace} names none of the port's kernels "
             f"({len(kernel_names)} kernel names)")
    gc.collect()            # dead caches leave LIVE now, not mid-window
    c0, g0 = compilation_stats().render_frame_variants, r.graphs.captures
    r.set_viewport(2, 960, 540)
    app.run(1)
    c1, g1 = compilation_stats().render_frame_variants, r.graphs.captures
    if c1 - c0 != g1 - g0 or g1 == g0:
        fail(f"compilation_stats moved {c1 - c0}, the captures {g1 - g0}")
    print(f"telemetry: {am.device_bytes_in_use} device bytes in use "
          f"(peak {am.device_peak_bytes}); the trace "
          f"({os.path.getsize(trace)} bytes) names {found}; a new viewport "
          f"captured {g1 - g0} graph(s), compilation_stats moved "
          f"{c1 - c0} to {c1}", flush=True)
    app.shutdown()
    del app, r, reg
    torch.cuda.empty_cache()
    shell_tools(dev, card, work)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20: {time.perf_counter() - t20:.1f} s ({card})",
          flush=True)
    return {"app_loop": launches}


def shell_tools(dev, card: str, work: Path) -> None:
    """Phase 20 (e) and (f): the facade's sequence, the scripts and the
    viewer, with `work` as their working directory."""
    import threading
    import urllib.request

    from trident_tpu_torch.core.config import (
        CaptureConfig, EngineConfig, RenderConfig,
    )
    from trident_tpu_torch.ecs.components import (
        MeshComponent, TransformComponent,
    )
    from trident_tpu_torch.geometry.primitives import PrimitiveType
    from trident_tpu_torch.io.image import decode_rgba
    from trident_tpu_torch.render.command import RenderCommand as RC
    from trident_tpu_torch.scripts import viewer

    # (e) tests/test_facade.py's sequence through RenderCommand
    RC.init(EngineConfig(render=RenderConfig(width=64, height=64,
                                             use_pallas=False),
                         capture=CaptureConfig(perf_dir=str(work / "perf")),
                         assets_root=str(work / "Assets"), log_file=None),
            device=dev)
    freg = RC.get_registry()
    e = freg.create()
    freg.add(e, TransformComponent())
    freg.add(e, MeshComponent(
        mesh_index=RC.renderer().ensure_primitive(PrimitiveType.CUBE)))
    RC.set_editor_camera([0, 0, 3], target=[0, 0, 0])
    RC.queue_text(0, "hi", 2, 2)
    RC.begin_performance_capture()
    RC.draw_frame()
    img = RC.get_viewport_texture(0)
    csv = RC.end_performance_capture()
    picked = RC.pick_entity(32, 32)
    m = RC.get_world_transform(e)
    m[0, 3] = 2.5
    RC.set_world_transform(e, m)
    pos = freg.get(e, TransformComponent).position
    back = RC.get_world_transform(e)
    if (img.shape != (64, 64, 4) or not (csv or "").endswith(".csv")
            or RC.get_frame_timing_stats().sample_count < 1
            or picked != e or abs(float(pos[0]) - 2.5) > 1e-4
            or np.abs(back - m).max() > 1e-6
            or RC.get_ai_debug_stats().enabled):
        fail(f"the facade sequence: image {img.shape}, csv {csv}, pick "
             f"{picked} (want {e}), position {pos}")
    RC.set_ai_blend_strength(0.4)
    blend = RC.app().config.ai.blend
    RC.shutdown()
    print(f"facade: the test_facade sequence on the card (pick {picked}, "
          f"world matrix round trip {float(np.abs(back - m).max()):.1e}, "
          f"blend {blend})", flush=True)

    # (f) the scripts: render_demo and profile_stages as subprocesses, the
    # viewer in process on 127.0.0.1
    out = run_script(["trident_tpu_torch.scripts.render_demo", "--frames",
                      str(DEMO_FRAMES), "--shadows", "--bloom", "--video",
                      str(work / "demo.y4m"), "--out", str(work / "demo")],
                     work, "render_demo")
    pngs = sorted((work / "demo").glob("frame_*.png"))
    demo_y4m = work / "demo.y4m"
    want_size = (len(b"YUV4MPEG2 W640 H480 F30:1 Ip A1:1 C420\n")
                 + DEMO_FRAMES * (6 + 640 * 480 * 3 // 2))
    if len(pngs) != DEMO_FRAMES or not demo_y4m.is_file() \
            or demo_y4m.stat().st_size != want_size:
        fail(f"render_demo wrote {len(pngs)} PNGs and "
             f"{demo_y4m.stat().st_size if demo_y4m.is_file() else 0} "
             f"bytes of Y4M:\n{out[-1000:]}")
    out = run_script(["trident_tpu_torch.scripts.profile_stages", "--scale",
                      "small"], work, "profile_stages --scale small")
    stages = ["vertex", "setup", "bins", "visibility(incl bins)", "planes",
              "deferred[bilinear]", "deferred[nearest]", "resolve records",
              "vis+records+resolve", "deferred_attrs[bilinear]",
              "corner stage (geom+setup+attrs)"]
    stages += [f"FULL[{n}]" for n in ("gather", "forward", "forward+corner",
                                       "forward+corner+stride")]
    stages += [f"ABLATE[{s}]" for s in ("draw_rows", "corner", "geom", "bins",
                                         "vis", "resolve_tiled", "resolve")]
    missing = [s for s in stages if f"  {s}: " not in out]
    if missing or "DONE" not in out:
        fail(f"profile_stages printed no line for {missing}")
    for line in out.splitlines():
        if "ABLATE" in line or "FULL" in line:
            print(f"profile_stages {line.strip()} ({card})", flush=True)

    class Args:
        width, height, model, scene, shadows = 512, 512, [], None, False

    vapp = viewer.build_app(Args, device=dev)
    srv = viewer.ViewerServer(vapp, "127.0.0.1", 0)
    serve = threading.Thread(target=srv.serve_forever, daemon=True)
    serve.start()
    base = f"http://127.0.0.1:{srv.port}"
    page = urllib.request.urlopen(base + "/", timeout=60).read()
    png = urllib.request.urlopen(base + "/api/frame?vp=1", timeout=120).read()
    with srv.lock:
        shown = vapp.renderer.read_frame(viewport_id=srv._last_vp)
    ents = json.loads(urllib.request.urlopen(base + "/api/entities",
                                             timeout=60).read())
    state = json.loads(urllib.request.urlopen(base + "/api/state",
                                              timeout=60).read())
    srv.shutdown()
    serve.join(timeout=10)
    vapp.shutdown()
    frame = decode_rgba(png)
    tags = {x["tag"] for x in ents["entities"]}
    if (b"trident_tpu viewer" not in page or frame is None
            or not (frame == shown).all() or not {"cube", "sphere"} <= tags
            or state["width"] != 512 or state["triangles"] <= 0):
        fail(f"viewer: page {len(page)} bytes, frame equal "
             f"{frame is not None and (frame == shown).all()}, tags {tags}, "
             f"state {state}")
    print(f"viewer: GET / ({len(page)} bytes), /api/frame ({len(png)} bytes "
          f"of PNG, decoded equal to the presented 512x512 frame), "
          f"/api/entities {sorted(tags)}, /api/state {state['triangles']} "
          f"triangles; shut down", flush=True)


# -- phase 21: every kernel knob ------------------------------------------
KNOB_BAND_N, KNOB_BAND_B = 4, 2          # (a)'s band: band 2 of the field's 4
# each bf16 instance: (CUDA source, the exact instance it rounds)
BF16_KERNELS = {
    "resolve_bf16": ("resolve.cu", "resolve"),
    "resolve_vc_bf16": ("resolve.cu", "resolve_vc"),
    "resolve_tiled_bf16": ("resolve.cu", "resolve_tiled"),
    "resolve_tiled_vc_bf16": ("resolve.cu", "resolve_tiled_vc"),
    "visibility_resolve_bf16": ("visibility_resolve.cu",
                                "visibility_resolve"),
    "visibility_resolve_vc_bf16": ("visibility_resolve.cu",
                                   "visibility_resolve_vc"),
    "resolve_band_bf16": ("resolve.cu", "resolve_band"),
    "resolve_vc_band_bf16": ("resolve.cu", "resolve_vc_band"),
    "resolve_tiled_band_bf16": ("resolve.cu", "resolve_tiled_band"),
    "resolve_tiled_vc_band_bf16": ("resolve.cu", "resolve_tiled_vc_band"),
    "visibility_resolve_band_bf16": ("visibility_resolve.cu",
                                     "visibility_resolve_band"),
    "visibility_resolve_vc_band_bf16": ("visibility_resolve.cu",
                                        "visibility_resolve_vc_band"),
}
BF16_REPLACES = "trident_tpu/ops/resolve_pallas.py:133"   # the raw bf16 pass
# the bf16 knob sets of the main path: suffix → kernel dict
BF16_SETS = {"": {"resolve_prec": "bf16"},
             "_tiled": {"resolve_prec": "bf16", "tiled_shade": True},
             "_fuse": {"resolve_prec": "bf16", "fuse": True}}
# one non-default value of each knob the card runs as a no-op (e)
NOOP_KNOBS = (
    {"tile_h": 16}, {"tile_w": 64}, {"chunk": 128}, {"sub": 32},
    {"span0": 3}, {"max_global": 1}, {"sort_pad": True},
    {"exact_bins": True}, {"cover_gate": True},
    {"qgate": True, "dynhit": False}, {"recpad": True},
    {"rect": True, "dynhit": False}, {"treset": False}, {"dynhit": False},
    {"acc": False, "dynhit": False}, {"zskip": True, "zorder": True},
    {"pair_budget": 4096}, {"planar": False}, {"resolve_skip": True},
    {"resolve_half": True}, {"resolve_compact": True},
    {"resolve_prec": "fp32"}, {"resolve_tr": False}, {"texel_mxu": False},
    {"texel_slab": 256}, {"texel_br": 16}, {"texel_bc": 128},
    {"shadow_mxu": False})
BF16_PSNR_MIN = 40.0       # tests/test_upscaler.py:368-389's bound


class Bf16Case(NamedTuple):
    """One bf16 instance's check: `bf16()` the instance, `rounded()` its
    exact instance on the bf16-rounded table (the same arithmetic:
    bit-equal), `plain()` the plain version on that table, `exact()` the
    exact instance on the table as it is; its bound (bytes, ops)."""

    bf16: object
    rounded: object
    plain: object
    exact: object
    work: tuple


def bf16_cases(setup, cols, rec32, rec40, w: int, h: int,
               band=None) -> dict:
    """Bf16Case of each instance of BF16_KERNELS of one form: the
    offset-free ones on the w × h frame's ids and bins, or with `band` =
    (n, b) the band ones on band b of n of it (band_slice_setup,
    cull=False, as the banded frame cuts)."""
    import torch

    from trident_tpu_torch.ops import raster, resolve
    from trident_tpu_torch.ops.vertex import band_slice_setup

    ntx = -(-w // raster.TILE)
    key, y0, off = "", None, None
    if band is not None:
        n, b = band
        h //= n
        key, y0, off = "_band", b * h, b * h // raster.TILE
        setup = band_slice_setup(setup, y0, h, cull=False)
    nt = ntx * -(-h // raster.TILE)
    bins = raster.build_bins(setup, w, h, setup_cols=cols)
    if bins.aux.tolist() != [0, 0]:
        fail(f"bf16 cases: binning overflow {bins.aux.tolist()}")
    _d, t = raster.visibility_tiles(bins, ntx, nt, tile_y_offset=off)
    tri = raster.untile_frame(t, ntx, -(-h // raster.TILE))[:h, :w] \
        .contiguous()
    vis = vis_work(bins, setup, ntx, nt, 8)
    n_win = int(torch.unique(t[t >= 0]).numel())
    px = nt * raster.TILE_PX
    cases = {}
    for vc, rec in (("", rec32), ("_vc", rec40)):
        rr = resolve.bf16_records(rec)
        row = rec.shape[1] * 4
        cases[f"resolve{vc}{key}_bf16"] = Bf16Case(
            lambda rec=rec: resolve.resolve_attrs(tri, rec, y0, prec="bf16"),
            lambda rr=rr: resolve.resolve_attrs(tri, rr, y0),
            lambda rr=rr: resolve.resolve_attrs_plain(tri, rr, y0 or 0),
            lambda rec=rec: resolve.resolve_attrs(tri, rec, y0),
            (w * h * 4 * (1 + resolve.CHANNELS) + n_win * row, 0))
        cases[f"resolve_tiled{vc}{key}_bf16"] = Bf16Case(
            lambda rec=rec: resolve.resolve_attrs_tiled(t, rec, ntx, off,
                                                        prec="bf16"),
            lambda rr=rr: resolve.resolve_attrs_tiled(t, rr, ntx, off),
            lambda rr=rr: resolve.resolve_attrs_tiled_plain(t, rr, ntx,
                                                            off or 0),
            lambda rec=rec: resolve.resolve_attrs_tiled(t, rec, ntx, off),
            (px * 4 * (1 + resolve.CHANNELS) + n_win * row, 0))
        cases[f"visibility_resolve{vc}{key}_bf16"] = Bf16Case(
            lambda rec=rec: resolve.fused_visibility_resolve(
                bins, rec, ntx, nt, off, prec="bf16"),
            lambda rr=rr: resolve.fused_visibility_resolve(bins, rr, ntx, nt,
                                                           off),
            lambda rr=rr: resolve.fused_visibility_resolve_plain(
                bins, rr, ntx, nt, off or 0),
            lambda rec=rec: resolve.fused_visibility_resolve(bins, rec, ntx,
                                                             nt, off),
            (vis.bytes + px * 4 * resolve.CHANNELS + n_win * row, vis.ops))
    return cases


def hold_bf16_case(name: str, case: Bf16Case, results: dict,
                   card: str) -> None:
    """A bf16 instance bit-equal to its exact instance on the bf16-rounded
    table, its ids and depths (fused) bit-equal to its plain version and
    its attributes within RESOLVE_TOL of it; the pixels whose attributes
    differ from the exact instance's on the table as it is; event and busy
    ms of the bf16 and the exact instance in one window; its results
    entry."""
    import torch

    k, e, p, x = (_flat(f()) for f in (case.bf16, case.rounded, case.plain,
                                       case.exact))
    torch.cuda.synchronize()
    bits = _bit_diffs(tuple(k), tuple(e))
    ids = _bit_diffs(tuple(k[:-1]), tuple(p[:-1]))
    err = float((k[-1] - p[-1]).abs().max())
    if bits or ids or err > RESOLVE_TOL or not bool(
            torch.isfinite(k[-1]).all()):
        fail(f"{name}: {bits} values off its exact instance on the rounded "
             f"table, {ids} ids / depths off its plain version, attributes "
             f"max err {err}")
    ch = -1 if k[-1].shape[-1] == 16 else 1      # (H, W, 16) or tiled
    off = int((k[-1] != x[-1]).any(dim=ch).sum())
    fns = (case.exact, case.bf16, case.bf16, case.exact)
    t = [cuda_ms(fn) for fn in fns]
    busy = [device_busy(fn)[0] for fn in fns]
    b_ms, b_by = bound(*case.work)
    src, exact = BF16_KERNELS[name]
    results[name] = dict(
        route="cuda", source=f"trident_tpu_torch/csrc/{src}",
        replaces=BF16_REPLACES, max_abs_err=err, ms=(t[1] + t[2]) / 2,
        plain_ms=cuda_ms(case.plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=None, exact_ms=(t[0] + t[3]) / 2,
        busy_ms=(busy[1] + busy[2]) / 2, exact_busy_ms=(busy[0] + busy[3]) / 2,
        pixels_off_exact=off)
    res = results[name]
    print(f"{name}: bit-equal to {exact} on the bf16-rounded table, max err "
          f"{err} vs plain; {off} pixels off {exact} on the table as it is; "
          f"one window exact / bf16 / bf16 / exact, events "
          f"{' '.join(f'{v:.4f}' for v in t)} ms, busy "
          f"{' '.join(f'{v:.4f}' for v in busy)} ms; plain "
          f"{res['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({card})",
          flush=True)


SKGEO_REPS = 5            # profiled calls a kernel's busy time averages
# the kernel pair's entry points, vertices' then triangles'
SKINNED_ENTRIES = ("trident_skinned_vertices", "trident_skinned_triangles")


def phase_skinned_geometry(dev, card: str) -> dict:
    """Phase 22: the skinned indexed geometry's kernel pair
    (csrc/skinned_geometry.cu, ops/indexed.py::indexed_geometry) on the
    loaded crowd's own frame (phase 16's loaded_crowd, posed by one
    Scene.update: 1,048,576 vertices and 2,097,152 triangles in the plan's
    buckets, 2,304 bones) at 1920×1080, 40- and 32-wide records: the setup,
    its columns and the records bit-equal to indexed_geometry_plain; the
    call (CUDA events, median of 10) and each kernel's busy time
    (torch.profiler, mean of 5) beside its bound (each input read once,
    each output written once) and the plain version's time; then the
    crowd's frame graph captured and replayed: each kernel's entry point
    counts (_build.LAUNCHES) two runs a capture (its eager warm-up and the
    capture) and none a replay, and spheres1080_1m's frames count none.
    Returns the phase's numbers."""
    import tempfile

    import torch

    from trident_tpu_torch import _build
    from trident_tpu_torch.ops import indexed
    from trident_tpu_torch.render.renderer import shading_consts
    from trident_tpu_torch.tools_dev import timing
    from trident_tpu_torch.tools_dev.scenes import (
        loaded_crowd,
        write_tube_gltf,
    )

    td = tempfile.TemporaryDirectory()
    crowd = loaded_crowd(dev, write_tube_gltf(Path(td.name) / "tube.glb"))
    scene, r = crowd.scene, crowd.renderer
    scene.update(1 / 60)
    inp = frame_inputs_at(r)
    plan, w, h = inp["plan"], inp["width"], inp["height"]
    if not inp["skinned"] or inp["corner_t"] is not None:
        fail(f"loaded crowd: skinned {inp['skinned']}, corner table "
             f"{inp['corner_t'] is not None}")
    consts = shading_consts(inp["params"], inp["shade_table"],
                            inp["textures"])
    args = (plan, inp["tri_draw"], inp["params"], inp["camera"], consts,
            inp["geometry"], inp["palette"])
    tv, t = plan.vtx_src.shape[0], plan.tri_vtx.shape[0]
    out = dict(vertices=tv, triangles=t, bones=int(
        inp["params"].bone_count.clamp_min(0).sum()))

    def bits(a):
        return a.contiguous().view(torch.int32) if a.dtype == \
            torch.float32 else a

    for rw, vc in ((40, True), (32, False)):
        kw = dict(width=w, height=h, skinned=True, vertex_colors=vc)
        cs, rec = indexed.indexed_geometry(*args, **kw)
        ref, rec_p = indexed.indexed_geometry_plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = [("records", rec, rec_p)] + [
            (f"setup.{f}", getattr(cs.setup, f), getattr(ref.setup, f))
            for f in ("edge", "z", "w", "bbox", "valid")] + [
            (f"cols.setup.{f}[{i}]", a, b) for f in ("e", "z", "w")
            for i, (a, b) in enumerate(zip(getattr(cs.cols.setup, f),
                                           getattr(ref.cols.setup, f)))]
        bad = {name: int((bits(a) != bits(b)).sum()) for name, a, b in pairs}
        bad = {k: v for k, v in bad.items() if v}
        if bad:
            fail(f"skinned geometry ({rw} wide): the kernel pair differs "
                 f"from its plain version in {bad}")
        g = inp["geometry"]
        inputs_v = (plan.vtx_src.nbytes + plan.vtx_draw.nbytes
                    + g.attr_table.nbytes + g.bone_indices.nbytes
                    + g.bone_weights.nbytes + inp["palette"].nbytes)
        packed_bytes = tv * 16 * 4
        outputs_t = (indexed.SETUP_ROWS * t * 4 + cs.setup.bbox.nbytes
                     + cs.setup.valid.nbytes + rec.nbytes)
        inputs_t = (plan.tri_vtx.nbytes + plan.tri_valid.nbytes
                    + inp["tri_draw"].nbytes + packed_bytes)
        bounds = {"skinned_vertex_kernel": timing.bound(
                      inputs_v + packed_bytes),
                  f"skinned_triangle_kernel<{rw}>": timing.bound(
                      inputs_t + outputs_t)}

        def call(kw=kw):
            return indexed.indexed_geometry(*args, **kw)

        def plain(kw=kw):
            return indexed.indexed_geometry_plain(*args, **kw)

        events = timing._device_events(call, SKGEO_REPS)
        busy = {}
        for e in events or ():
            for name in bounds:
                if name in e.name:
                    busy[name] = busy.get(name, 0.0) \
                        + e.time_range.elapsed_us() / SKGEO_REPS / 1e3
        res = dict(ms=cuda_ms(call), busy_ms=device_busy(call)[0],
                   plain_ms=cuda_ms(plain), plain_busy_ms=device_busy(plain)[0],
                   kernels={n: dict(busy_ms=busy.get(n, float("nan")),
                                    bound_ms=b[0], bound_by=b[1],
                                    share=b[0] / busy.get(n, float("nan")))
                            for n, b in bounds.items()})
        out[f"records{rw}"] = res
        print(f"skinned geometry, {rw}-wide records ({tv} vertices, {t} "
              f"triangles, {out['bones']} bones): bit-equal to the plain "
              f"version; call {res['ms']:.4f} ms events / "
              f"{res['busy_ms']:.4f} ms busy, plain {res['plain_ms']:.4f} / "
              f"{res['plain_busy_ms']:.4f} ms; " + ", ".join(
                  f"{n} {k['busy_ms']:.4f} ms busy, bound "
                  f"{k['bound_ms']:.4f} ms ({k['bound_by']}), share "
                  f"{100 * k['share']:.1f}%"
                  for n, k in res["kernels"].items()) + f" ({card})",
              flush=True)
        del cs, rec, ref, rec_p, pairs
    torch.cuda.empty_cache()

    # the mechanism in the frame loop: the kernel path runs at each
    # capture, and the replays run its kernels without Python
    def pair_counts(frames, step, rr) -> dict:
        before = [_build.LAUNCHES[n] for n in SKINNED_ENTRIES]
        for k in range(frames):
            step(k)
            rr.render_viewport()
        torch.cuda.synchronize()
        return dict(vertices=_build.LAUNCHES[SKINNED_ENTRIES[0]] - before[0],
                    triangles=_build.LAUNCHES[SKINNED_ENTRIES[1]] - before[1],
                    captures=rr.graphs.captures)

    crowd_counts = pair_counts(8, lambda k: scene.update(1 / 60), r)
    del scene, r, crowd
    torch.cuda.empty_cache()
    fr, freg = build_bench_scene(BENCH_GRID, dev)
    field_counts = pair_counts(4, lambda k: rotate(freg, k), fr)
    runs = 2 * crowd_counts["captures"]     # each capture's warm-up, itself
    if crowd_counts["vertices"] != runs or crowd_counts["triangles"] != runs \
            or field_counts["vertices"] or field_counts["triangles"]:
        fail(f"skinned geometry's counts: crowd {crowd_counts}, field "
             f"{field_counts}")
    out.update(crowd_frames=crowd_counts, field_frames=field_counts)
    print(f"skinned geometry in the frame loop: 8 crowd frames {crowd_counts}"
          f", 4 spheres1080_1m frames {field_counts} ({card})", flush=True)
    del fr, freg
    torch.cuda.empty_cache()
    return out


# the shading kernel's bytes: every pixel's id in and RGBA f32 out, and a
# covered pixel's attribute row and depth in
SHADE_BYTES_PX, SHADE_BYTES_COVERED = 4 + 16, 64 + 4
SHADE_LSB_SHARE = 1e-3      # differing uint8 pixels over covered, at most


def shading_inputs(r) -> tuple:
    """(args, kwargs) of the deferred_shade_attrs call in Renderer `r`'s
    eager render_frame at its viewport's size."""
    import torch

    from trident_tpu_torch.render import renderer as rmod

    caught, real = [], rmod.deferred_shade_attrs

    def catch(*args, **kw):
        caught.append((args, kw))
        return real(*args, **kw)

    rmod.deferred_shade_attrs = catch
    try:
        rmod.render_frame(**frame_inputs_at(r))
    finally:
        rmod.deferred_shade_attrs = real
    torch.cuda.synchronize()
    return caught[-1]


def phase_deferred_shade(dev, card: str) -> dict:
    """Phase 23: the shading kernel (csrc/deferred_shade.cu,
    ops/deferred.py::shade_attrs_kernel) against the plain composition
    (deferred_shade_attrs_plain) on the shading inputs of both benchmark
    configurations' 1920×1080 frames (spheres1080_1m's field, phase 16's
    loaded crowd posed by one Scene.update): the largest f32 difference,
    the uint8 pixels that differ (fails past 1 LSB or SHADE_LSB_SHARE of
    the covered pixels); the call and the plain composition timed (CUDA
    events, median of 10; busy, torch.profiler, mean of 5), the kernel's
    own busy time beside its bound (SHADE_BYTES_PX a pixel and
    SHADE_BYTES_COVERED more a covered one: an uncovered pixel reads only
    its id), and beside the dense bound, every pixel's 88 bytes; then the
    frame loop: the kernel's entry point counts (_build.LAUNCHES) two runs
    a capture (its eager warm-up and the capture) and none a replay, in 8
    crowd and 4 field frames, and the texel kernel never launches there.
    Returns the phase's numbers."""
    import tempfile

    import torch

    from trident_tpu_torch import _build
    from trident_tpu_torch.ops import deferred
    from trident_tpu_torch.tools_dev import timing
    from trident_tpu_torch.tools_dev.scenes import (
        loaded_crowd,
        write_tube_gltf,
    )

    td = tempfile.TemporaryDirectory()
    crowd = loaded_crowd(dev, write_tube_gltf(Path(td.name) / "tube.glb"))
    crowd.scene.update(1 / 60)
    field, freg = build_bench_scene(BENCH_GRID, dev)
    rotate(freg, 0)
    out = {}
    for name, r in (("field", field), ("crowd", crowd.renderer)):
        args, kw = shading_inputs(r)
        if not deferred.shades_by_kernel(
                args[1], kw["sampling"], kw["shader_fn"], kw["skybox"],
                kw["shadow"]):
            fail(f"deferred shade: the {name} frame does not take the "
                 f"kernel route")
        gbuf, h, w = args[0], args[6], args[5]

        def call(args=args, kw=kw):
            return deferred.deferred_shade_attrs(*args, **kw)

        def plain(args=args, kw=kw):
            return deferred.deferred_shade_attrs_plain(*args, **kw)

        k_out, p_out = call(), plain()
        torch.cuda.synchronize()
        covered = int((gbuf.tri_id >= 0).sum())
        lsb = (deferred.pack_rgba8(k_out).int()
               - deferred.pack_rgba8(p_out).int()).abs().amax(-1)
        diff = dict(f32=float((k_out - p_out).abs().max()),
                    bits=int((k_out.view(torch.int32)
                              != p_out.view(torch.int32)).sum()),
                    u8_pixels=int((lsb > 0).sum()), lsb=int(lsb.max()),
                    covered=covered)
        diff["u8_share"] = diff["u8_pixels"] / max(covered, 1)
        if diff["lsb"] > 1 or diff["u8_share"] >= SHADE_LSB_SHARE:
            fail(f"deferred shade ({name}): the kernel's frame is off the "
                 f"plain composition's: {diff}")
        events = timing._device_events(call, SKGEO_REPS)
        kbusy = (sum(e.time_range.elapsed_us() for e in events
                     if "deferred_shade_kernel" in e.name) / SKGEO_REPS / 1e3
                 if events else float("nan"))
        b_ms, b_by = timing.bound(SHADE_BYTES_PX * w * h
                                  + SHADE_BYTES_COVERED * covered)
        dense_ms = timing.bound((SHADE_BYTES_PX + SHADE_BYTES_COVERED)
                                * w * h)[0]
        res = dict(diff=diff, ms=cuda_ms(call), busy_ms=device_busy(call)[0],
                   kernel_busy_ms=kbusy, bound_ms=b_ms, bound_by=b_by,
                   share=b_ms / kbusy, dense_bound_ms=dense_ms,
                   plain_ms=cuda_ms(plain),
                   plain_busy_ms=device_busy(plain)[0])
        out[name] = res
        print(f"deferred shade, {name} {w}x{h} ({covered} covered): "
              f"against the plain composition largest f32 difference "
              f"{diff['f32']}, {diff['bits']} values not bit-equal, "
              f"{diff['u8_pixels']} uint8 pixels differ (share "
              f"{diff['u8_share']:.3g}, at most {diff['lsb']} LSB); call "
              f"{res['ms']:.4f} ms events / {res['busy_ms']:.4f} ms busy, "
              f"the kernel {kbusy:.4f} ms busy, bound {b_ms:.4f} ms ({b_by}),"
              f" share {100 * res['share']:.1f}% (dense bound {dense_ms:.4f}"
              f" ms); plain {res['plain_ms']:.4f}"
              f" / {res['plain_busy_ms']:.4f} ms ({card})", flush=True)
        del args, kw, gbuf, k_out, p_out, lsb
    torch.cuda.empty_cache()

    # the mechanism in the frame loop: the kernel path runs at each
    # capture, the replays run the kernel without Python, and the texel
    # kernel stays off these frames
    counts = {}
    for name, r, step in (
            ("crowd", crowd.renderer, lambda k: crowd.scene.update(1 / 60)),
            ("field", field, lambda k: rotate(freg, k))):
        before = (_build.LAUNCHES["trident_deferred_shade"],
                  _build.LAUNCHES["trident_texel"], r.graphs.captures)
        for k in range(8 if name == "crowd" else 4):
            step(k)
            r.render_viewport()
        torch.cuda.synchronize()
        counts[name] = dict(
            launches=_build.LAUNCHES["trident_deferred_shade"] - before[0],
            texel=_build.LAUNCHES["trident_texel"] - before[1],
            captures=r.graphs.captures - before[2])
    for name, c in counts.items():
        runs = 2 * c["captures"]    # each capture's warm-up, itself
        if c["captures"] < 1 or c["launches"] != runs or c["texel"]:
            fail(f"deferred shade's counts in the {name} frames: {c}")
    out["frame_loop"] = counts
    print(f"deferred shade in the frame loop: 8 crowd frames "
          f"{counts['crowd']}, 4 spheres1080_1m frames {counts['field']} "
          f"({card})", flush=True)
    del crowd, field, freg
    torch.cuda.empty_cache()
    return out


BIN_BYTES_TRI = 60 + 1 + 16 + 64   # a valid triangle: setup columns, valid,
                                   # bbox read; its row written
BIN_BYTES_INVALID = 1 + 64         # an invalid one: valid read, row written
BIN_BYTES_PAD = 64                 # a padding row past T, written
BIN_BYTES_SLOT = 40                # a pool slot: keys written, sorted, merged
BIN_KERNELS = ("bin_records_kernel", "bin_claims_kernel", "bin_heads_kernel",
               "bin_pairs_kernel")
BIN_ENTRY_POINTS = ("trident_bin_records", "trident_bin_claims",
                    "trident_bin_heads", "trident_bin_pairs")
BIN_FIELDS = ("records", "pair_tile", "pair_chunk", "pair_mask", "tile_start",
              "n_real", "aux")


def binning_inputs(r) -> tuple:
    """(setup, setup_cols, width, height) of the build_bins call in
    Renderer `r`'s eager render_frame at its viewport's size."""
    import torch

    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.render import renderer as rmod

    caught, real = [], raster.build_bins

    def catch(setup, width, height, setup_cols=None, **kw):
        caught.append((setup, setup_cols, width, height))
        return real(setup, width, height, setup_cols=setup_cols, **kw)

    raster.build_bins = catch
    try:
        rmod.render_frame(**frame_inputs_at(r))
    finally:
        raster.build_bins = real
    torch.cuda.synchronize()
    return caught[0]


def phase_bin_tiles(dev, card: str) -> dict:
    """Phase 24: the binning kernels (csrc/bin_tiles.cu,
    ops/raster.py::bin_tiles_kernel) against build_bins_plain on the
    binning inputs of both benchmark configurations' 1920×1080 frames
    (spheres1080_1m's field, phase 16's loaded crowd posed by one
    Scene.update, whose bucket pads its triangles to 2,097,152): every
    field of the Bins bit-equal (fails otherwise, or on aux not [0, 0]);
    the call (four kernels, two cumsums and the sort) timed (CUDA events,
    median of 10; busy, torch.profiler, mean of 5), each kernel's busy
    time, the stage's bound (BIN_BYTES_TRI a valid triangle,
    BIN_BYTES_INVALID an invalid one, BIN_BYTES_PAD a padding row,
    BIN_BYTES_SLOT a pool slot; beside it the dense bound, every triangle
    read whole) and the plain version's times; then the frame loop: each entry point counts
    (_build.LAUNCHES) two runs a capture (its eager warm-up and the
    capture) and none a replay, in 8 crowd and 4 field frames. Returns
    the phase's numbers."""
    import tempfile

    import torch

    from trident_tpu_torch import _build
    from trident_tpu_torch.ops import raster
    from trident_tpu_torch.tools_dev import timing
    from trident_tpu_torch.tools_dev.scenes import (
        loaded_crowd,
        write_tube_gltf,
    )

    td = tempfile.TemporaryDirectory()
    crowd = loaded_crowd(dev, write_tube_gltf(Path(td.name) / "tube.glb"))
    crowd.scene.update(1 / 60)
    field, freg = build_bench_scene(BENCH_GRID, dev)
    rotate(freg, 0)
    out = {}
    for name, r in (("field", field), ("crowd", crowd.renderer)):
        setup, cols, w, h = binning_inputs(r)
        shape = raster.bin_shape(setup.valid.shape[0], w, h)

        def call(setup=setup, cols=cols, w=w, h=h):
            return raster.build_bins(setup, w, h, setup_cols=cols)

        def plain(setup=setup, cols=cols, w=w, h=h):
            return raster.build_bins_plain(setup, w, h, setup_cols=cols)

        before = {n: _build.LAUNCHES[n] for n in BIN_ENTRY_POINTS}
        k_bins = call()
        launched = {n: _build.LAUNCHES[n] - before[n]
                    for n in BIN_ENTRY_POINTS}
        p_bins = plain()
        torch.cuda.synchronize()
        differ = {}
        for f in BIN_FIELDS:
            a, b = getattr(k_bins, f), getattr(p_bins, f)
            if a.is_floating_point():
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.shape != b.shape or a.dtype != b.dtype:
                differ[f] = "shape or dtype"
            elif not torch.equal(a, b):
                differ[f] = int((a != b).sum())
        if differ or launched != {n: 1 for n in BIN_ENTRY_POINTS}:
            fail(f"bin tiles ({name}): the kernels' Bins differ from the "
                 f"plain version's in {differ}; launches {launched}")
        if k_bins.aux.tolist() != [0, 0]:
            fail(f"bin tiles ({name}): aux {k_bins.aux.tolist()}")
        events = timing._device_events(call, SKGEO_REPS)
        per_kernel = {k: (sum(e.time_range.elapsed_us() for e in events
                              if k in e.name) / SKGEO_REPS / 1e3
                          if events else float("nan"))
                      for k in BIN_KERNELS}
        n_valid = int(setup.valid.sum())
        rest = (BIN_BYTES_PAD * (shape.tpad - shape.t)
                + BIN_BYTES_SLOT * shape.pool)
        b_ms, b_by = timing.bound(BIN_BYTES_TRI * n_valid + BIN_BYTES_INVALID
                                  * (shape.t - n_valid) + rest)
        dense_ms = timing.bound(BIN_BYTES_TRI * shape.t + rest)[0]
        res = dict(t=shape.t, tpad=shape.tpad, valid=n_valid,
                   pool=shape.pool, n_real=int(k_bins.n_real),
                   ms=cuda_ms(call), busy_ms=device_busy(call)[0],
                   kernel_busy_ms=per_kernel, bound_ms=b_ms, bound_by=b_by,
                   dense_bound_ms=dense_ms, plain_ms=cuda_ms(plain),
                   plain_busy_ms=device_busy(plain)[0])
        res["share"] = b_ms / res["busy_ms"]
        out[name] = res
        kernels = ", ".join(f"{k} {v:.4f}" for k, v in per_kernel.items())
        print(f"bin tiles, {name} {w}x{h} ({shape.t} triangles, {n_valid} "
              f"valid, {shape.tpad} rows, pool {shape.pool}, "
              f"{res['n_real']} pairs): bit-equal to the plain version in "
              f"{', '.join(BIN_FIELDS)}; call {res['ms']:.4f} ms events / "
              f"{res['busy_ms']:.4f} ms busy (kernels {kernels}), bound "
              f"{b_ms:.4f} ms ({b_by}), share {100 * res['share']:.1f}% "
              f"(dense bound {dense_ms:.4f} ms); plain {res['plain_ms']:.4f}"
              f" / {res['plain_busy_ms']:.4f} ms ({card})", flush=True)
        del setup, cols, k_bins, p_bins
    torch.cuda.empty_cache()

    # the frame loop: each capture runs the entry points twice (its eager
    # warm-up and the capture), a replay none
    counts = {}
    for name, r, step in (
            ("crowd", crowd.renderer, lambda k: crowd.scene.update(1 / 60)),
            ("field", field, lambda k: rotate(freg, k))):
        before = ({n: _build.LAUNCHES[n] for n in BIN_ENTRY_POINTS},
                  r.graphs.captures)
        for k in range(8 if name == "crowd" else 4):
            step(k)
            r.render_viewport()
        torch.cuda.synchronize()
        counts[name] = dict(
            launches={n: _build.LAUNCHES[n] - before[0][n]
                      for n in BIN_ENTRY_POINTS},
            captures=r.graphs.captures - before[1])
    for name, c in counts.items():
        runs = 2 * c["captures"]
        if c["captures"] < 1 or set(c["launches"].values()) != {runs}:
            fail(f"bin tiles' counts in the {name} frames: {c}")
    out["frame_loop"] = counts
    print(f"bin tiles in the frame loop: 8 crowd frames {counts['crowd']}, "
          f"4 spheres1080_1m frames {counts['field']} ({card})", flush=True)
    del crowd, field, freg
    torch.cuda.empty_cache()
    return out


RIGID_ENTRY = "trident_rigid_geometry"
# the corner-table rows the kernel reads a triangle, by record width: each
# corner's position, normal and UV, with vertex colours its colour too
RIGID_ROWS = {32: 24, 40: 33}
RIGID_SIZES = ((1920, 1080), (960, 540))    # the field's, full and :ai


def phase_rigid_geometry(dev, card: str, skinned: dict) -> dict:
    """Phase 25: the rigid geometry kernel (csrc/rigid_geometry.cu,
    ops/rigid.py::rigid_geometry) on spheres1080_1m's field (1,296 spheres
    of 768 triangles in the plan's 1,048,576-triangle bucket) at 1920×1080
    and 960×540, under the uniform layout (draw_stride) and the tri_draw
    gather, with 32- and 40-wide records: the setup, its columns and the
    records bit-equal to rigid_geometry_plain (fails otherwise, or unless
    the call launched the entry point once); the call (CUDA events, median
    of 10; busy, torch.profiler, mean of 5), the kernel's busy time beside
    its bound (each input read once, each output written once: the corner
    rows it reads, tri_valid, tri_draw on the gather path, the draw rows,
    the 15 setup columns, bbox, valid and the records) and the plain
    version's times; then the frame loop: the entry point counts
    (_build.LAUNCHES) two runs a capture (its eager warm-up and the
    capture) and none a replay in 4 field frames, none in 8 crowd frames.
    `skinned` is phase 22's result: its triangle kernel's busy times are
    printed beside, the tail the two kernels share
    (geometry_common.cuh). Returns the phase's numbers."""
    import tempfile

    import torch

    from trident_tpu_torch import _build
    from trident_tpu_torch.ops import indexed, rigid
    from trident_tpu_torch.render.renderer import shading_consts
    from trident_tpu_torch.tools_dev import timing
    from trident_tpu_torch.tools_dev.scenes import (
        loaded_crowd,
        write_tube_gltf,
    )

    fr, freg = build_bench_scene(BENCH_GRID, dev)
    rotate(freg, 0)
    inp = frame_inputs_at(fr)
    if inp["corner_t"] is None or inp["skinned"] or inp["draw_stride"] <= 0:
        fail(f"spheres1080_1m: corner table {inp['corner_t'] is not None}, "
             f"skinned {inp['skinned']}, draw_stride {inp['draw_stride']}")
    plan, tri_draw = inp["plan"], inp["tri_draw"]
    t = inp["corner_t"].shape[1]
    consts = shading_consts(inp["params"], inp["shade_table"],
                            inp["textures"])
    args = (plan, tri_draw, inp["params"], inp["camera"], consts,
            inp["corner_t"])
    layouts = {"stride": dict(draw_stride=inp["draw_stride"],
                              real_draws=inp["real_draws"]),
               "gather": dict(draw_stride=0, real_draws=0)}
    out = dict(triangles=t, drawn=int(plan.tri_valid.sum()),
               draws=inp["real_draws"], draw_stride=inp["draw_stride"])
    draw_bytes = consts.shape[0] * 48 * 4

    def bits(a):
        return a.contiguous().view(torch.int32) if a.dtype == \
            torch.float32 else a

    for (w, h), layout, vc in [(size, layout, vc) for size in RIGID_SIZES
                               for layout in layouts for vc in (False, True)]:
        kw = dict(width=w, height=h, vertex_colors=vc, **layouts[layout])
        before = _build.LAUNCHES[RIGID_ENTRY]
        cs, rec = rigid.rigid_geometry(*args, **kw)
        launched = _build.LAUNCHES[RIGID_ENTRY] - before
        ref, rec_p = rigid.rigid_geometry_plain(*args, **kw)
        torch.cuda.synchronize()
        pairs = [("records", rec, rec_p)] + [
            (f"setup.{f}", getattr(cs.setup, f), getattr(ref.setup, f))
            for f in ("edge", "z", "w", "bbox", "valid")] + [
            (f"cols.setup.{f}[{i}]", a, b) for f in ("e", "z", "w")
            for i, (a, b) in enumerate(zip(getattr(cs.cols.setup, f),
                                           getattr(ref.cols.setup, f)))]
        bad = {name: (int((bits(a) != bits(b)).sum())
                      if a.shape == b.shape and a.dtype == b.dtype
                      else "shape or dtype") for name, a, b in pairs}
        bad = {k: v for k, v in bad.items() if v}
        rw = rec.shape[1]
        name = f"{w}x{h}.{layout}.{rw}"
        if bad or launched != 1:
            fail(f"rigid geometry ({name}): the kernel differs from its "
                 f"plain version in {bad}; launches {launched}")
        n_bytes = (RIGID_ROWS[rw] * 4 * t + plan.tri_valid.nbytes
                   + (tri_draw.nbytes if layout == "gather" else 0)
                   + draw_bytes + indexed.SETUP_ROWS * t * 4
                   + cs.setup.bbox.nbytes + cs.setup.valid.nbytes
                   + rec.nbytes)
        b_ms, b_by = timing.bound(n_bytes)

        def call(kw=kw):
            return rigid.rigid_geometry(*args, **kw)

        def plain(kw=kw):
            return rigid.rigid_geometry_plain(*args, **kw)

        events = timing._device_events(call, SKGEO_REPS)
        k_busy = (sum(e.time_range.elapsed_us() for e in events
                      if "rigid_geometry_kernel" in e.name)
                  / SKGEO_REPS / 1e3 if events else float("nan"))
        res = dict(ms=cuda_ms(call), busy_ms=device_busy(call)[0],
                   kernel_busy_ms=k_busy, bound_ms=b_ms, bound_by=b_by,
                   bytes=n_bytes, share=b_ms / k_busy,
                   plain_ms=cuda_ms(plain),
                   plain_busy_ms=device_busy(plain)[0])
        out[name] = res
        print(f"rigid geometry {name} ({t} triangles, {out['drawn']} drawn): "
              f"bit-equal to the plain version; call {res['ms']:.4f} ms "
              f"events / {res['busy_ms']:.4f} ms busy, kernel "
              f"{k_busy:.4f} ms busy, bound {b_ms:.4f} ms ({b_by}, "
              f"{n_bytes / t:.1f} B a triangle), share "
              f"{100 * res['share']:.1f}%; plain {res['plain_ms']:.4f} / "
              f"{res['plain_busy_ms']:.4f} ms ({card})", flush=True)
        del cs, rec, ref, rec_p, pairs
    torch.cuda.empty_cache()
    tri_busy = {rw: skinned[f"records{rw}"]["kernels"][
        f"skinned_triangle_kernel<{rw}>"]["busy_ms"] for rw in (40, 32)}
    out["skinned_triangle_busy_ms"] = tri_busy
    print(f"the shared tail's other kernel (phase 22): "
          f"skinned_triangle_kernel<40> {tri_busy[40]:.4f} ms busy, <32> "
          f"{tri_busy[32]:.4f} ms busy ({card})", flush=True)

    # the frame loop: each capture runs the entry point twice (its eager
    # warm-up and the capture), a replay none; the crowd's frames none
    td = tempfile.TemporaryDirectory()
    crowd = loaded_crowd(dev, write_tube_gltf(Path(td.name) / "tube.glb"))
    counts = {}
    for name, r, step, frames in (
            ("field", fr, lambda k: rotate(freg, k + 1), 4),
            ("crowd", crowd.renderer, lambda k: crowd.scene.update(1 / 60),
             8)):
        before = (_build.LAUNCHES[RIGID_ENTRY], r.graphs.captures)
        for k in range(frames):
            step(k)
            r.render_viewport()
        torch.cuda.synchronize()
        counts[name] = dict(launches=_build.LAUNCHES[RIGID_ENTRY] - before[0],
                            captures=r.graphs.captures - before[1])
    field, crowd_c = counts["field"], counts["crowd"]
    if field["captures"] < 1 or field["launches"] != 2 * field["captures"] \
            or crowd_c["captures"] < 1 or crowd_c["launches"]:
        fail(f"rigid geometry's counts: {counts}")
    out["frame_loop"] = counts
    print(f"rigid geometry in the frame loop: 4 spheres1080_1m frames "
          f"{field}, 8 crowd frames {crowd_c} ({card})", flush=True)
    del fr, freg, crowd
    torch.cuda.empty_cache()
    return out


def phase_knob_set(dev, card: str, kernel_names: list, drive,
                   results: dict) -> dict:
    """Phase 21 (module docstring): every kernel knob the JAX package
    accepts. Adds the bf16 instances to `kernel_names` and `results` and
    returns the main path's launch counts."""
    import torch

    from trident_tpu_torch.ai import upscaler as up
    from trident_tpu_torch.ops import raster, resolve, warp
    from trident_tpu_torch.render.renderer import frame_geometry
    from trident_tpu_torch.tools_dev import kbench as kb

    t21 = time.perf_counter()
    kernel_names.extend(BF16_KERNELS)

    # (a) the bf16 instances on spheres1080_1m's bins and records (1920 ×
    # 1080), the band ones on band 2 of 4 of phase 18's field (1920 × 1024)
    r, reg = build_bench_scene(BENCH_GRID, dev)
    rotate(reg, 0)
    for w, h in ((1920, 1080), (BAND_W, BAND_H)):
        sized(r, w, h)
        inp = r.frame_inputs()
        geo = dict(width=w, height=h, draw_stride=inp["draw_stride"],
                   real_draws=inp["real_draws"])
        args = (inp["plan"], inp["tri_draw"], inp["params"],
                inp["shade_table"], inp["camera"], inp["textures"],
                inp["corner_t"])
        cs, rec32 = frame_geometry(*args, **geo)
        _cs40, rec40 = frame_geometry(*args, vertex_colors=True, **geo)
        cases = bf16_cases(cs.setup, cs.cols.setup, rec32, rec40, w, h,
                           None if h != BAND_H else (KNOB_BAND_N,
                                                     KNOB_BAND_B))
        for name, case in cases.items():
            hold_bf16_case(name, case, results, card)
        del inp, cs, rec32, rec40, cases, _cs40
        torch.cuda.empty_cache()

    # (f) kbench's bins through the indexed path (vertex_stage, the corner
    # gather, triangle_setup_cols) against the frame's corner-stage bins;
    # the two geometry paths round the clip coordinates in other orders,
    # so ids flip where a pixel centre lies on a shared edge: the counts
    # and the two paths' frames' drift are printed
    from trident_tpu_torch.render.frame import geometry_to_device
    from trident_tpu_torch.render.renderer import render_frame

    sized(r, 1920, 1080)
    kcs, _krec, kbins, w, h = kb.frame_bins(r)
    inp = r.frame_inputs()
    cs, _rec = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=w, height=h,
        draw_stride=inp["draw_stride"], real_draws=inp["real_draws"])
    cbins = raster.build_bins(cs.setup, w, h, setup_cols=cs.cols.setup)
    ntx, nty = -(-w // raster.TILE), -(-h // raster.TILE)
    d_i, t_i = raster.visibility_tiles(kbins, ntx, ntx * nty)
    d_ip, t_ip = raster.visibility_tiles_plain(kbins, ntx, ntx * nty)
    d_c, t_c = raster.visibility_tiles(cbins, ntx, ntx * nty)
    torch.cuda.synchronize()
    bad = _bit_diffs((d_i, t_i), (d_ip, t_ip))
    covered = int((t_c >= 0).sum())
    ids_off = int((t_i != t_c).sum())
    depth_off = int((d_i.view(torch.int32) != d_c.view(torch.int32)).sum())
    same_id = (t_i == t_c) & (t_c >= 0)
    ulps = int((d_i.view(torch.int32) - d_c.view(torch.int32))[same_id]
               .abs().max()) if bool(same_id.any()) else 0
    idx_frame = render_frame(**{**inp, "corner_t": None,
                                "geometry": geometry_to_device(
                                    r.geometry.packed(), dev)})
    cor_frame = render_frame(**inp)
    print(f"kbench's indexed-path bins: {int(kbins.n_real)} pairs against "
          f"the corner stage's {int(cbins.n_real)}, aux "
          f"{kbins.aux.tolist()}; K1 on them bit-equal to its plain version "
          f"({bad} values off); against K1 on the corner-stage bins {ids_off}"
          f" ids and {depth_off} depths off of {covered} covered pixels "
          f"(max {ulps} ulps where the ids agree), "
          f"{int(kcs.setup.valid.sum())} against "
          f"{int(cs.setup.valid.sum())} valid triangles ({card})",
          flush=True)
    if bad or kbins.aux.tolist() != [0, 0]:
        fail(f"kbench's indexed bins: {bad} values off K1's plain version, "
             f"aux {kbins.aux.tolist()}")
    diff = (idx_frame.color.int() - cor_frame.color.int()).abs()
    print(f"spheres1080_1m through the indexed path vs the corner-stage "
          f"frame: {float((diff > GOLDEN_LSB).float().mean()):.6f} of values "
          f"> {GOLDEN_LSB} LSB, mean {float(diff.float().mean()):.6f}, max "
          f"{int(diff.max())} ({card})", flush=True)
    del kcs, _krec, kbins, inp, cs, _rec, cbins, d_i, t_i, d_ip, t_ip
    del d_c, t_c, same_id, idx_frame, cor_frame
    torch.cuda.empty_cache()

    # the main path's Renderers: spheres1080_1m at 1920 × 1024 under each
    # bf16 set (one-device frames, then over 2 bands of this card); the
    # 128² vertex-coloured cube likewise; spheres1080_1m:ai with the V2
    # defaults, V1, bf16 convs and the windowless warp; the 128² golden
    # base scene with shadows under each no-op knob and each routing limit
    sph = {s: sized(build_bench_scene(BENCH_GRID, dev, kernel=k, reg=reg)[0])
           for s, k in BF16_SETS.items()}
    vco = {s: feature_scene("vcolor", dev, kernel=k)
           for s, k in BF16_SETS.items()}
    ai_sets = {"v2": None, "v1": {"upscale_v2": False},
               "bf16": {"upscale_dtype": "bf16"},
               "nowindow": {"warp_mxu": False}}
    ai = {s: build_bench_scene(BENCH_GRID, dev, ai=True, kernel=k, reg=reg)[0]
          for s, k in ai_sets.items()}
    base_kw = dict(shadows=True, shadow_map_size=256)
    noop = [base_scene(dev, kernel=k, **base_kw) for k in NOOP_KNOBS]
    routes = {"tiled": ({"tiled_shade": True}, True),
              "texel_max_pix": ({"tiled_shade": True,
                                 "texel_max_pix": 128 * 128 - 1}, False),
              "texel_max_q": ({"tiled_shade": True, "texel_max_q": 16},
                              False),
              "texel_mxu": ({"tiled_shade": True, "texel_mxu": False},
                            False)}
    route_r = {s: base_scene(dev, kernel=k, **base_kw)
               for s, (k, _t) in routes.items()}
    base = base_scene(dev, **base_kw)
    one = {}                # one-device frames, for the banded ones
    ai_out = {}

    def knob_frames():
        for s, rr in list(sph.items()) + [(f"{s}_vc", v)
                                          for s, v in vco.items()]:
            for k in range(2):
                rotate(reg, k)
                out = rr.render_viewport()
            if out.aux.tolist() != [0, 0]:
                fail(f"bf16{s} frame: aux {out.aux.tolist()}")
            replay_check(rr, f"bf16{s} frame", rr.graphs.last_launches)
            one[s] = rr.render_viewport()
            banded = rr.render_viewport(devices=[dev, dev])
            bad = [f for f in ("color", "depth", "tri_id")
                   if not torch.equal(getattr(banded, f), getattr(one[s], f))]
            if bad:
                fail(f"bf16{s} frame over 2 bands differs from one device "
                     f"in {bad}")
        for s, rr in ai.items():
            rr.prev_state = None
            rotate(reg, 0)
            first = rr.render_viewport()
            prev = rr.prev_state
            rotate(reg, 1)
            rr.editor_camera.orbit([0.0, 0.0, 0.0], 3.0, 2.0)
            cam_in = rr.frame_inputs()
            second = rr.render_viewport()
            if any(o.aux.tolist() != [0, 0] for o in (first, second)):
                fail(f"spheres1080_1m:ai {s}: aux")
            same_as_eager(second, cam_in, f"spheres1080_1m:ai {s} frame 2")
            ai_out[s] = (first, prev, second, cam_in)
        default = base.render_viewport()
        for k, rr in zip(NOOP_KNOBS, noop):
            bad = differing(rr.render_viewport(), default)
            if bad:
                fail(f"no-op knob {k}: the frame differs from the default "
                     f"frame in {bad}")
        for s, (k, tiled) in routes.items():
            out = route_r[s].render_viewport()
            ran = route_r[s].graphs.last_launches
            took = ran.get("resolve_tiled", 0) > 0
            if took != tiled or (not tiled and differing(out, default)):
                fail(f"routing {k}: launches {ran}, expected the "
                     f"{'tiled' if tiled else 'untiled'} route")
        return default

    renderers = (list(sph.values()) + list(vco.values()) + list(ai.values())
                 + noop + list(route_r.values()) + [base])
    _default, launches21 = drive(knob_frames,
                                 list(BF16_KERNELS) + ["warp"], renderers)
    print(f"phase 21's main path (bf16 frames one-device and over 2 bands, "
          f":ai V1 / bf16 convs / windowless warp, {len(NOOP_KNOBS)} no-op "
          f"knob frames bit-equal to the default, 4 routes): launches "
          f"{ {k: v for k, v in launches21.items() if v} } ({card})",
          flush=True)

    # (a') the bf16 frames against the exact frames: pixels that differ
    for s, rr in sph.items():
        ex = sized(build_bench_scene(BENCH_GRID, dev, reg=reg,
                                     kernel={k: v for k, v in
                                             BF16_SETS[s].items()
                                             if k != "resolve_prec"})[0])
        rotate(reg, 1)
        a, b = rr.render_viewport(), ex.render_viewport()
        n_px = int((a.color != b.color).any(-1).sum())
        print(f"spheres1080_1m bf16{s} frame at {BAND_W}x{BAND_H}: {n_px} "
              f"pixels off the exact frame ({card})", flush=True)
        del ex

    # (b) V1 against V2: each graph replayed alone
    for s in ("v2", "v1"):
        replay_line(ai[s], f"spheres1080_1m:ai {s} frame", card)
    first, prev, second, cam_in = ai_out["v1"]
    if second.history is not None or prev[0].shape != (1080, 1920, 4):
        fail("the V1 frame's history is not the RGBA8 frame")

    # (c) bf16 convs: the net on the V2 frame's own half-res input
    first, prev, second, cam_in = ai_out["v2"]
    net = ai["v2"]._upscale_params()
    cam = cam_in["camera"]
    d_half = second.depth[::2, ::2].contiguous()
    temporal = up.temporal_from_prev(net, prev, d_half, cam, 1920, 1080)
    rgb = (second.color[::2, ::2, :3].float() / 255.0).contiguous()
    x = up._assemble_inputs(net, rgb, temporal, d_half)
    out32 = up.depth_to_space(net(x, "f32"))
    out16 = up.depth_to_space(net(x, "bf16"))
    p = float(up.psnr(out16, out32))
    nets = {"f32": lambda: net(x, "f32"), "bf16": lambda: net(x, "bf16")}
    order = ("f32", "bf16", "bf16", "f32")
    busy = [device_busy(nets[d])[0] for d in order]
    ev = [cuda_ms(nets[d]) for d in order]
    fb = ai_out["bf16"][2]
    p_frame = float(up.psnr(fb.color.float() / 255.0,
                            second.color.float() / 255.0))
    print(f"upscaler net at 960x540 (17 inputs, 32 channels): bf16 against "
          f"f32 {p:.2f} dB (bound {BF16_PSNR_MIN}); one window f32 / bf16 / "
          f"bf16 / f32, busy {' '.join(f'{v:.4f}' for v in busy)} ms, events "
          f"{' '.join(f'{v:.4f}' for v in ev)} ms; the bf16 Renderer's "
          f"frame against the f32 one {p_frame:.2f} dB ({card})", flush=True)
    if not p > BF16_PSNR_MIN:
        fail(f"bf16 convs: {p:.2f} dB against f32")
    replay_line(ai["bf16"], "spheres1080_1m:ai bf16-conv frame", card)

    # (d) the windowless warp on its moving-camera frame's own inputs
    first, prev, second, cam_in = ai_out["nowindow"]
    hist, prev_vp = prev
    cam = cam_in["camera"]
    d_half = second.depth[::2, ::2].contiguous()
    vp_inv = torch.linalg.inv(cam.proj @ cam.view)
    by, bx, in_b, ok_w = up.warp_indices(hist, d_half, vp_inv, prev_vp,
                                         1920, 1080)
    ok_n = up.warp_indices(hist, d_half, vp_inv, prev_vp, 1920, 1080,
                           windowed=False)[3]
    bym = torch.where(ok_n, by, -1).contiguous()
    bxm = torch.where(ok_n, bx, -1).contiguous()
    f_k, f_p = warp.warp_fetch(hist, bym, bxm), warp.warp_fetch_ref(hist, bym,
                                                                    bxm)
    torch.cuda.synchronize()
    bad = int((f_k.view(torch.int32) != f_p.view(torch.int32)).sum())
    n_diff = int((ok_w != ok_n).sum())
    print(f"windowless warp on a moving-camera frame: {int(ok_n.sum())} "
          f"valid (in bounds), {int(ok_w.sum())} in the band window, "
          f"{n_diff} pixels whose validity differs; K8 on the windowless "
          f"indices bit-equal to its plain version ({bad} off) ({card})",
          flush=True)
    if bad or not bool(torch.equal(ok_n, in_b)):
        fail(f"windowless warp: {bad} values off the plain fetch")
    replay_line(ai["nowindow"], "spheres1080_1m:ai windowless-warp frame",
                card)
    del sph, vco, ai, noop, route_r, base, one, ai_out, r, reg
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t21:.1f} s ({card})",
          flush=True)
    return launches21


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

    # the kernels held so far, by entry point without "trident_"
    kernel_names = ["visibility", "visibility_depth", "resolve", "texel",
                    "shadow_taps"]

    def drive(path, needed, renderers=()):
        """Run `path`; each kernel's runs in it, failing if a kernel in
        `needed` never ran. A kernel's runs are its entry point's launches
        (_build.LAUNCHES), less those the graph captures of `renderers`
        (every Renderer whose frames `path` renders) recorded, plus those
        their replays ran."""
        before = dict(_build.LAUNCHES)
        for rr in renderers:
            rr.graphs.captured.clear()
            rr.graphs.replayed.clear()
        out = path()
        torch.cuda.synchronize()
        counts = {name: _build.LAUNCHES["trident_" + name]
                  - before.get("trident_" + name, 0)
                  - sum(rr.graphs.captured[name] for rr in renderers)
                  + sum(rr.graphs.replayed[name] for rr in renderers)
                  for name in kernel_names}
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
    # the plain corner stage's full columns (the kernel route hands on the
    # setup's alone): the record producer alone reads them, and so do
    # phases 14 and 15 through `bench`
    ccs = plain_corner_stage(inp)
    stages = {
        "geometry": lambda: frame_geometry(
            inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
            inp["camera"], inp["textures"], inp["corner_t"], width=w,
            height=h, draw_stride=inp["draw_stride"],
            real_draws=inp["real_draws"]),
        # the (T, 32) record table alone, as the plain geometry builds it
        "records": lambda: planes.build_resolve_cols_planar(ccs.cols),
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

    out, launches4 = drive(spheres_frames, ("visibility", "resolve"),
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
    bench = (ccs, records, bins)             # phase 11 reuses them
    del r, reg, inp, cs, ccs, records, bins, d_k, t_k, d_p, t_p, tri, a_k
    del a_p
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

    (out, pcf_ms), launches6 = drive(shadow_frames, kernel_names, (r,))
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

    out, launches7 = drive(ultra_frames, ("visibility", "resolve"),
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
    launches9 = phase_ai(dev, card, kernel_names, drive, results)

    # -- phase 10: the kernel-knob frame --------------------------------------
    launches10 = phase_knobs(dev, card, kernel_names, drive, results)

    # -- phase 11: the tools_dev probes ---------------------------------------
    launches11 = phase_probes(dev, card, kernel_names, drive, results, *bench,
                              w=1920, h=1080)

    # -- phase 12: the interactive frame loop ----------------------------------
    phase_frame_loop(dev, card, drive)

    # -- phase 13: the port's bench and the interpolation net -----------------
    launches13 = phase_bench(dev, card, drive)
    print(f"bench sweep's launches {launches13}", flush=True)

    # -- phase 14: the forward frame's features --------------------------------
    launches14 = phase_features(dev, card, kernel_names, drive, results, bench)

    # -- phase 15: the reference raster, planes and the skinned path --------
    launches15 = phase_routes(dev, card, kernel_names, drive, bench)
    print(f"route launches {launches15}", flush=True)
    del bench
    torch.cuda.empty_cache()

    # -- phase 16: a glTF crowd loaded and animated by the Scene ------------
    t16 = time.perf_counter()
    launches16 = phase_loaded(dev, card, drive)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s; loaded-crowd "
          f"launches {launches16} ({card})", flush=True)

    # -- phase 17: FBX / COLLADA crowds, the field and textures from files --
    t17 = time.perf_counter()
    launches17 = phase_imported(dev, card, drive)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s; imported "
          f"launches {launches17} ({card})", flush=True)

    # -- phase 18: the banded frame, n bands on this card -------------------
    launches18 = phase_bands(dev, card, kernel_names, drive, results)

    # -- phase 19: training ----------------------------------------------------
    launches19 = phase_training(dev, card, drive)

    # -- phase 20: the application shell ---------------------------------------
    launches20 = phase_shell(dev, card, drive)

    # -- phase 21: every kernel knob --------------------------------------------
    launches21 = phase_knob_set(dev, card, kernel_names, drive, results)

    # -- phase 22: the skinned indexed geometry's kernel pair -------------------
    skinned_geometry = phase_skinned_geometry(dev, card)

    # -- phase 23: the shading kernel ----------------------------------------
    deferred_shade = phase_deferred_shade(dev, card)

    # -- phase 24: the binning kernels -------------------------------------
    bin_tiles = phase_bin_tiles(dev, card)

    # -- phase 25: the rigid geometry kernel ----------------------------------
    rigid_geometry = phase_rigid_geometry(dev, card, skinned_geometry)

    # launches: each kernel's count in the main-path run of the frame it
    # was held on (phase 4 for the main pass, phase 6 for the shadow pass
    # and the texel kernel, which the shadowed frame's plain shading runs,
    # phase 9 for the warp, phase 10 for the knob kernels, phase 11 for
    # the probes, phase 14 for the vertex-colour instances, phase 18 for
    # the band instances, phase 21 for the bf16 instances)
    launches = {**launches4, "visibility_depth": launches6["visibility_depth"],
                "shadow_taps": launches6["shadow_taps"],
                "texel": launches6["texel"],
                "warp": launches9["warp"],
                **{n: launches10[n] for n in (
                    "visibility_ck", "visibility_resolve", "resolve_tiled",
                    "texel_planar")},
                **{n: launches11[n] for n in (
                    "visibility_dense", "visibility_dual", "visibility_reset",
                    "lut_gather", "split_select")},
                **{n: launches14[n] for n in (
                    "resolve_vc", "resolve_tiled_vc",
                    "visibility_resolve_vc")},
                **{n: launches18[n] for n in BAND_KERNELS},
                **{n: launches21[n] for n in BF16_KERNELS}}
    kernels = []
    for name in kernel_names:
        res = {k: v for k, v in results[name].items() if k != "colour_ms"}
        # the launches of each of phase 15's, 16's and 17's route runs,
        # of phase 19's pair rendering and of phase 20's application loop
        kernels.append(dict(name=name, launches=launches[name], **res,
                            route_launches={route: counts.get(name, 0)
                                            for route, counts in
                                            {**launches15, **launches16,
                                             **launches17, **launches19,
                                             **launches20}.items()}))
    print(json.dumps({"kernels": kernels,
                      "skinned_geometry": skinned_geometry,
                      "deferred_shade": deferred_shade,
                      "bin_tiles": bin_tiles,
                      "rigid_geometry": rigid_geometry}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
