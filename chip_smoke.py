#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trident_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. print the card (nvidia-smi name, power limit) and the torch build;
     require a CUDA device
  2. build the three kernels from trident_tpu_torch/csrc (nvcc, timed)
  3. on the spheres1080_1m frame (1920×1080, 36×36 spheres ≈ 995k
     triangles, 128² checker — the bench.py default scene), hold each
     kernel against its plain PyTorch version on that frame's own
     intermediates, and time both (CUDA events, median of 10 after
     warm-up): visibility ids equal and depth bit-equal, resolve
     channels within RESOLVE_TOL, texel bit-equal
  4. render that scene through the port's Renderer for 12 frames while
     rotating the entities as bench.py does: aux == [0, 0] every frame,
     every kernel's launch count rose, the frame is not all clear color;
     print the median frame time
  5. render the 256² cube of render_frame_entry() and hold it against the
     JAX package's frame (tests/goldens/torch_slice_cube256.npy) under the
     golden gate: < 0.2% of channel values off by > 3 LSB, mean < 0.35
Then it prints the kernels as one JSON line, the card line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "torch_slice_cube256.npy"
BENCH_GRID = 36
RESOLVE_TOL = 1e-6       # max |kernel − plain| per channel (log2 may differ
                         # by an ulp between libms; everything else is exact)
GOLDEN_LSB, GOLDEN_FRAC, GOLDEN_MEAN = 3, 0.002, 0.35

# trident_tpu/__init__ imports jax when JAX_PLATFORMS=cpu; this script and
# the port run without jax, so the variable must not reach that import
os.environ.pop("JAX_PLATFORMS", None)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_bench_scene(grid: int, device):
    """The bench.py build_scene("spheres1080_1m") scene on the port."""
    from trident_tpu.core.config import EngineConfig, RenderConfig
    from trident_tpu.ecs.components import (
        MeshComponent,
        TextureComponent,
        TransformComponent,
    )
    from trident_tpu.ecs.registry import Registry
    from trident_tpu.geometry.primitives import PrimitiveType
    from trident_tpu.io.image import checkerboard
    from trident_tpu_torch.render.renderer import Renderer

    r = Renderer(EngineConfig(render=RenderConfig(width=1920, height=1080)),
                 device=device)
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh_idx = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(grid):
        for j in range(grid):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array(
                [(i - grid / 2) * 1.4, (j - grid / 2) * 1.4, 0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh_idx))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg


def rotate(reg, k: int) -> None:
    """bench.py's per-frame rotation of every entity."""
    from trident_tpu.ecs.components import TransformComponent

    angle = 25.0 + k * 3.0
    for _e, (t,) in reg.view(TransformComponent):
        t.rotation = np.array([angle * 0.4, angle, 0.0], np.float32)


def main() -> None:
    # -- phase 1: the card ---------------------------------------------------
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi did not run: {exc}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {card}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)

    # -- phase 2: build ------------------------------------------------------
    sys.path.insert(0, str(ROOT))
    from trident_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"(nvcc {_build.build_seconds} s; library {_build.BUILD_DIR})",
          flush=True)

    from trident_tpu_torch.ops import raster, resolve, texel
    from trident_tpu_torch.ops.deferred import (
        deferred_shade_attrs,
        texel_lookup,
    )
    from trident_tpu_torch.render.renderer import (
        frame_geometry,
        render_frame,
        render_frame_entry,
    )
    from trident_tpu_torch.render.types import GBuffer

    kernels_fns = {"visibility": raster.visibility_tiles,
                   "resolve": resolve.resolve_attrs,
                   "texel": texel.sample_bilinear}

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
    results["visibility"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/visibility.cu",
        replaces="trident_tpu/ops/raster_pallas.py:943",
        max_abs_err=float((d_k - d_p).abs().max()),
        ms=cuda_ms(lambda: raster.visibility_tiles(bins, ntx, n_tiles)),
        plain_ms=cuda_ms(
            lambda: raster.visibility_tiles_plain(bins, ntx, n_tiles)))
    covered = int((t_k >= 0).sum())
    print(f"visibility: {covered} covered pixels", flush=True)

    tri = raster.untile_frame(t_k, ntx, nty)[:h, :w].contiguous()
    a_k = resolve.resolve_attrs(tri, records)
    a_p = resolve.resolve_attrs_plain(tri, records)
    err_ch = (a_k - a_p).abs().reshape(-1, resolve.CHANNELS).amax(0)
    if not bool(torch.isfinite(a_k).all()) or float(err_ch.max()) > RESOLVE_TOL:
        fail(f"resolve kernel disagrees: per-channel {err_ch.tolist()}")
    print(f"resolve per-channel max err: {err_ch.tolist()}", flush=True)
    results["resolve"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/resolve.cu",
        replaces="trident_tpu/ops/resolve_pallas.py:412",
        max_abs_err=float(err_ch.max()),
        ms=cuda_ms(lambda: resolve.resolve_attrs(tri, records)),
        plain_ms=cuda_ms(lambda: resolve.resolve_attrs_plain(tri, records)))

    q = inp["textures"].quads
    idx, fx, fy = texel_lookup(a_k, tri >= 0, inp["textures"].max_level)
    x_k = texel.sample_bilinear(q, idx, fx, fy)
    x_p = texel.sample_bilinear_plain(q, idx, fx, fy)
    bad_tx = int((x_k.view(torch.int32) != x_p.view(torch.int32)).sum())
    if bad_tx:
        fail(f"texel kernel disagrees on {bad_tx} values")
    results["texel"] = dict(
        route="cuda", source="trident_tpu_torch/csrc/texel.cu",
        replaces="trident_tpu/ops/texel_pallas.py:118",
        max_abs_err=float((x_k - x_p).abs().max()),
        ms=cuda_ms(lambda: texel.sample_bilinear(q, idx, fx, fy)),
        plain_ms=cuda_ms(lambda: texel.sample_bilinear_plain(q, idx, fx, fy)))
    for name, res in results.items():
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
              f" ms ({card})", flush=True)

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
    stage_ms = {name: cuda_ms(fn) for name, fn in stages.items()}
    print("stages (ms): " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in stage_ms.items())
          + f" ({card})", flush=True)

    # -- phase 4: the main path through the Renderer --------------------------
    for fn in kernels_fns.values():
        fn.launches = 0
    frame_ms, host_ms = [], []
    out = None
    for k in range(12):
        rotate(reg, k)
        t0 = time.perf_counter()
        out = r.render_viewport()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if out.aux.tolist() != [0, 0]:
            fail(f"frame {k}: raster overflow aux {out.aux.tolist()}")
        # the host share of the same frame: its draw gathering alone, on
        # the transforms just rendered (frame_inputs launches no kernel)
        t0 = time.perf_counter()
        r.frame_inputs()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: fn.launches for name, fn in kernels_fns.items()}
    for name, n in launches.items():
        if n < 1:
            fail(f"the main path never launched the {name} kernel")
    color = out.color
    if tuple(color.shape) != (1080, 1920, 4) or color.dtype != torch.uint8:
        fail(f"frame shape {tuple(color.shape)} {color.dtype}")
    clear = torch.round(torch.tensor(r.config.render.clear_color) * 255.0)
    n_fg = int((color.float().cpu() != clear).any(-1).sum())
    if n_fg == 0:
        fail("the frame is all clear color")
    wall = statistics.median(frame_ms[2:])
    dev_ms = cuda_ms(lambda: render_frame(**inp))
    print(f"frame: median {wall:.3f} ms wall per render_viewport, of which "
          f"{statistics.median(host_ms[2:]):.3f} ms host draw gathering "
          f"(frame_inputs); {dev_ms:.3f} ms render_frame device time, "
          f"{n_fg} non-clear pixels, launches {launches} ({card})",
          flush=True)

    # -- phase 5: the cube against the JAX package's frame --------------------
    ref = np.load(GOLDEN)
    cube = render_frame_entry(dev).cpu().numpy()
    if cube.shape != ref.shape:
        fail(f"cube frame shape {cube.shape} vs reference {ref.shape}")
    diff = np.abs(cube.astype(np.int32) - ref.astype(np.int32))
    frac, mean = float((diff > GOLDEN_LSB).mean()), float(diff.mean())
    print(f"cube vs JAX reference: {frac:.6f} of values > {GOLDEN_LSB} LSB, "
          f"mean {mean:.6f}, max {int(diff.max())}", flush=True)
    if not (frac < GOLDEN_FRAC and mean < GOLDEN_MEAN):
        fail("cube frame outside the golden gate")

    kernels = [dict(name=name, launches=launches[name], **res)
               for name, res in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
