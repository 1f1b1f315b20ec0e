"""The port's bench: frames/s through the full render pipeline on the card.

    python3 -m trident_tpu_torch.bench [--device cpu]

The counterpart of bench.py, read from the same environment: BENCH_CONFIG
(cube512, spheres1080, spheres1080_1m — the default —, ultra4k,
shadows1080 or interp), BENCH_AI (1: the NAME:ai mode, a half-size render
rebuilt by the upscaler net), BENCH_ITERS (frames, default 30),
BENCH_AI_CKPT (the upscaler's .npz, default the port's), BENCH_INTERP_CKPT
and BENCH_INTERP_SRC (interp's .npz and PNG directory), BENCH_WATCHDOG
(seconds, 0 disables). It prints ONE JSON line with bench.py's keys:
metric, value, unit, vs_baseline and extra. vs_baseline is FPS/60, the
60-FPS display bar (interp: the reference's 66 ms inference cadence over
the measured ms).

Host state stays out of the timed loops (bench.py:232-248): `iters`
frames are packed ahead, each after bench.py's per-frame rotation, by
Renderer.frame_bundle. Two timed modes, as in bench.py:

- interactive (bench.py:327-383): each frame goes through
  FrameGraphs.run on its host blobs (pinned staging, then a graph
  replay), what render_viewport pays; the frames run back to back on one
  stream and end in one synchronize, timed on the host clock. Runs repeat
  (up to 5) until the two best agree within 20%; the lower of those two
  is `interactive_fps`.
- device throughput (bench.py:385-419, the `lax.scan`): every frame's
  blobs are uploaded once as one (iters, n) tensor per blob, and frame k
  replays through FrameGraphs.run_rows (device-to-device copies of row k,
  no host-to-device copy, no synchronize); aux is summed on the device and
  read once after the window, which CUDA events time. This is `value`.

Under :ai frame k's (history, view·proj) is frame k+1's `prev`; both
loops start from bench.py's zeros-but-valid history (bench.py:289-291,
352), so one graph key serves every frame. `psnr_vs_native_db` holds
frame 1 rebuilt from frame 0's history (frame 0 with no history) against
frame 1 rendered natively (bench.py:421-444).

On the CPU (--device cpu) the frames run eagerly and the windows are
timed on the host clock; the line's backend says "cpu".
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from trident_tpu_torch import resolve_device
from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.ai.metrics import psnr
from trident_tpu_torch.ai.model import DEFAULT_WEIGHTS, load_frame_generator
from trident_tpu_torch.render.renderer import render_frame
from trident_tpu_torch.tools_dev.scenes import build_scene, rotate

INTERP_RES = 256                 # the reference's net resolution
INTERP_CADENCE_MS = 66.0         # the reference's inference throttle
                                 # (Renderer.h:522)
TARGET_FPS = 60.0


def settings_from_env() -> dict:
    """The bench's settings from bench.py's environment variables."""
    return dict(
        iters=int(os.environ.get("BENCH_ITERS", "30")),
        ai_ckpt=os.environ.get("BENCH_AI_CKPT") or None,
        interp_ckpt=os.environ.get("BENCH_INTERP_CKPT") or str(
            DEFAULT_WEIGHTS),
        interp_src=os.environ.get("BENCH_INTERP_SRC", "Dataset"))


def arm_watchdog():
    """bench.py's watchdog: after BENCH_WATCHDOG seconds (default 2100,
    0 disables) print the bench_error line and exit 3 instead of hanging
    whoever waits for the line. Returns the timer (None when disabled);
    the caller cancels it."""
    limit = float(os.environ.get("BENCH_WATCHDOG", "2100"))
    if limit <= 0:
        return None

    def fire():
        print(json.dumps({
            "metric": "bench_error", "value": 0, "unit": "none",
            "vs_baseline": 0,
            "extra": {"error": f"no result within {limit:.0f}s — a kernel "
                               "build or the device hung"}}), flush=True)
        os._exit(3)

    t = threading.Timer(limit, fire)
    t.daemon = True
    t.start()
    return t


def window_ms(fn, dev) -> float:
    """ms of fn(): CUDA events around it on the card, the host clock (fn
    runs synchronously) on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frame_aux(out) -> torch.Tensor:
    """A frame's drop counters, the light pass's added in: (2,) i32
    [truncated pairs, dropped chunks]."""
    return out.aux if out.shadow_aux is None else out.aux + out.shadow_aux


def check_aux(aux, where: str) -> np.ndarray:
    """bench.py's check_aux: abort on a raster capacity overflow — a bench
    that silently truncates would report a high FPS on missing
    geometry."""
    a = np.asarray(aux.cpu() if isinstance(aux, torch.Tensor) else aux,
                   np.int64).reshape(-1, 2).sum(axis=0)
    if a[0] or a[1]:
        raise SystemExit(
            f"bench invalid ({where}): raster overflow — {int(a[0])} "
            f"pairs truncated, {int(a[1])} big chunks dropped; the "
            "rendered geometry is incomplete")
    return a


class FrameBench:
    """One render config's bench on Renderer `r` (its registry `reg`):
    `iters` frames packed ahead, the interactive and the device-throughput
    loops over them, and (under :ai) the PSNR against the native frame.
    `measure()` runs bench.py's sequence and returns its JSON line."""

    def __init__(self, r, reg, config: str, iters: int) -> None:
        self.r, self.reg, self.config, self.iters = r, reg, config, iters
        self.dev = r.device
        rc = r.config.render
        self.width, self.height = rc.width, rc.height
        self.ai = bool(rc.ai_upscale)
        # the timed loops' zeros-but-valid history (bench.py:289-291, 352)
        self.prev0 = None
        r.prev_state = None
        if self.ai and up.upscaler_wants_temporal(r._upscale_params()):
            r.frame_bundle()                 # sizes the camera
            cam = r.editor_camera.params(self.dev)
            self.prev0 = (torch.zeros((self.height // 2, self.width // 2, 12),
                                      dtype=torch.uint8, device=self.dev),
                          cam.proj @ cam.view)
        r.prev_state = self.prev0
        self.bundles = []
        for k in range(iters):
            rotate(reg, k)
            self.bundles.append(r.frame_bundle())
        fb = self.bundles[0]
        if any(b.key != fb.key for b in self.bundles):
            raise RuntimeError(f"{config}: the rotating frames' graph keys "
                               "differ")
        st = fb.state
        self.triangles = sum(st.packed.draw_infos[m].index_count // 3
                             for m in st.draws.mesh_index.tolist())
        # the throughput mode's inputs, uploaded once
        self.f32_rows = torch.from_numpy(
            np.stack([b.f32 for b in self.bundles])).to(self.dev)
        self.i32_rows = torch.from_numpy(
            np.stack([b.i32 for b in self.bundles])).to(self.dev)

    def _next_prev(self, out):
        return None if self.prev0 is None else (out.history, out.view_proj)

    def interactive_frame(self, k: int, prev):
        """Frame k from its host blobs: a graph replay after pinned
        staging on the card (FrameGraphs.run), eager on the CPU."""
        b = self.bundles[k]
        if self.r.graphs is None:
            return b.frame_fn(torch.from_numpy(b.f32),
                              torch.from_numpy(b.i32), prev, b.ai)
        return self.r.graphs.run(b.key, b.f32, b.i32, prev, b.ai,
                                 b.frame_fn, keep=b.keep)

    def device_frame(self, k: int, prev):
        """Frame k from row k of the device-resident blobs
        (FrameGraphs.run_rows on the card: the graph's own outputs, which
        its next replay overwrites)."""
        b = self.bundles[0]
        if self.r.graphs is None:
            return b.frame_fn(self.f32_rows[k], self.i32_rows[k], prev, b.ai)
        return self.r.graphs.run_rows(b.key, self.f32_rows, self.i32_rows,
                                      k, prev, b.ai, b.frame_fn, keep=b.keep)

    def interactive_run(self) -> float:
        """FPS of the `iters` frames back to back on one stream, from the
        first submit to one synchronize, on the host clock."""
        _sync(self.dev)
        t0 = time.perf_counter()
        prev = self.prev0
        for k in range(self.iters):
            prev = self._next_prev(self.interactive_frame(k, prev))
        _sync(self.dev)
        return self.iters / (time.perf_counter() - t0)

    def throughput_window(self):
        """(ms, summed aux) of the `iters` device-resident frames, the aux
        summed on the device and read once after the window."""
        aux = torch.zeros(2, dtype=torch.int64, device=self.dev)

        def frames():
            prev = self.prev0
            for k in range(self.iters):
                out = self.device_frame(k, prev)
                aux.add_(frame_aux(out))
                prev = self._next_prev(out)

        ms = window_ms(frames, self.dev)
        return ms, aux.cpu()

    def psnr_vs_native(self) -> float:
        """bench.py:421-444: frame 1 rendered natively at the full size
        against frame 1 rebuilt from frame 0's history, frame 0 itself
        with none (prev None: the net's zero-validity start, a graph key of
        its own), both through render_viewport."""
        r = self.r
        rotate(self.reg, 1)
        inp = r.frame_inputs()
        native = render_frame(**dict(inp, width=self.width,
                                     height=self.height, upscale_params=None,
                                     prev=None))
        check_aux(frame_aux(native),
                  f"native {self.width}x{self.height} PSNR oracle frame")
        r.prev_state = None
        rotate(self.reg, 0)
        r.render_viewport()
        rotate(self.reg, 1)
        recon = r.render_viewport()
        a = native.color[..., :3].float().cpu() / 255.0
        b = recon.color[..., :3].float().cpu() / 255.0
        mse = float(torch.mean(torch.square(a - b)))
        return -10.0 * float(np.log10(max(mse, 1e-10)))

    def measure(self) -> dict:
        """bench.py's sequence: the warm-up frame (on the card, the graph's
        capture) with its aux checked, the interactive runs under the
        agreement gate, the throughput window with its aux checked, the
        PSNR under :ai; → the JSON line."""
        out = self.interactive_frame(0, self.prev0)
        aux_counts = check_aux(frame_aux(out), "warmup frame")
        runs = [self.interactive_run() for _ in range(2)]
        while len(runs) < 5:
            best2 = sorted(runs)[-2:]
            if best2[0] >= 0.8 * best2[1]:     # two best agree within 20%
                break
            runs.append(self.interactive_run())
        best2 = sorted(runs)[-2:]
        ms, aux_all = self.throughput_window()
        check_aux(aux_all, f"throughput window over all {self.iters} frames")
        fps = self.iters / (ms / 1e3)
        extra_quality = {}
        if self.ai:
            extra_quality["psnr_vs_native_db"] = round(self.psnr_vs_native(),
                                                       2)
        w, h = self.width, self.height
        return {
            "metric": f"render_fps_{self.config}{'_ai' if self.ai else ''}"
                      f"_{w}x{h}",
            "value": round(fps, 2),
            "unit": "frames/s",
            "vs_baseline": round(fps / TARGET_FPS, 3),
            "extra": {"mpix_per_s": round(fps * w * h / 1e6, 1),
                      "triangles": int(self.triangles),
                      "interactive_fps": round(best2[0], 2),
                      "interactive_runs": [round(c, 2) for c in runs],
                      "interactive_agreed": bool(best2[0] >= 0.8 * best2[1]),
                      "raster": "cuda" if self.dev.type == "cuda" else "plain",
                      "aux": [int(aux_counts[0]), int(aux_counts[1])],
                      "backend": self.dev.type, **extra_quality}}

    def close(self) -> None:
        """Free the Renderer's graphs and their pools."""
        if self.r.graphs is not None:
            self.r.graphs.clear()


def _load_pngs(src: str, res: int, dev):
    """The first three PNGs of `src`, RGB in [0, 1] resized to res² as
    (1, 3, res, res) tensors; [] when `src` holds fewer than three. A
    directory with PNGs and no PNG decoder (PIL) raises: the bench does
    not quietly time synthetic frames instead."""
    src = Path(src)
    names = sorted(src.glob("*.png"))[:3] if src.is_dir() else []
    if not names:
        return []
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(f"{src} holds PNGs but no PNG decoder (PIL) is "
                           "importable") from exc
    if len(names) < 3:
        return []
    frames = []
    for n in names:
        with Image.open(n) as im:
            rgb = np.asarray(im.convert("RGB"), np.float32) / 255.0
        x = torch.from_numpy(rgb).permute(2, 0, 1)[None].to(dev)
        frames.append(torch.nn.functional.interpolate(
            x, size=(res, res), mode="bilinear", align_corners=False,
            antialias=True))
    return frames


def bench_interp(iters: int, device, interp_ckpt: str,
                 interp_src: str) -> dict:
    """bench.py's bench_interp: the frame-interpolation U-Net at the
    reference's 256² net resolution on the first three PNGs of
    `interp_src` (else bench.py's synthetic rolled ramp); warm up once,
    then `iters` chained inferences (the output fed back as both frames)
    timed with CUDA events → ms per frame, and the PSNR of the net's
    middle frame against the true one."""
    dev = resolve_device(device)
    net, _bc = load_frame_generator(interp_ckpt, dev)
    res = INTERP_RES
    frames = _load_pngs(interp_src, res, dev)
    if len(frames) < 3:      # no dataset: a moving pattern (bench.py:129-131)
        base = (torch.linspace(0, 1, res, device=dev)[:, None, None]
                * torch.ones((1, res, 3), device=dev))
        frames = [torch.roll(base, 8 * k, dims=1).permute(2, 0, 1)[None]
                  for k in range(3)]
    pair = torch.cat([frames[0], frames[2]], dim=1)
    with torch.inference_mode():
        out = net(pair)                      # warm-up at the timed shape
        _sync(dev)

        def chain():
            nonlocal out
            for _ in range(iters):
                out = net(torch.cat([out, out], dim=1))

        ms = window_ms(chain, dev) / iters
        quality = float(psnr(net(pair), frames[1]))
    return {
        "metric": f"interp_infer_{res}", "value": round(ms, 3),
        "unit": "ms/frame",
        "vs_baseline": round(INTERP_CADENCE_MS / max(ms, 1e-6), 3),
        "extra": {"psnr_db_vs_middle_frame": round(quality, 2),
                  "iters": iters, "checkpoint": interp_ckpt,
                  "backend": dev.type}}


def run(config: str, ai: bool, device=None, iters: int = 30,
        ai_ckpt=None, interp_ckpt: str = str(DEFAULT_WEIGHTS),
        interp_src: str = "Dataset", on_bench=None) -> dict:
    """One bench entry → its JSON line (a dict). `on_bench(bench)`, when
    given, sees the FrameBench after its measurement, before its graphs
    are freed."""
    if config == "interp":
        return bench_interp(iters, device, interp_ckpt, interp_src)
    r, reg = build_scene(config, resolve_device(device), ai=ai,
                         upscaler_path=ai_ckpt)
    bench = FrameBench(r, reg, config, iters)
    try:
        line = bench.measure()
        if on_bench is not None:
            on_bench(bench)
        return line
    finally:
        bench.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    config = os.environ.get("BENCH_CONFIG", "spheres1080_1m")
    ai = os.environ.get("BENCH_AI", "") not in ("", "0")
    watchdog = arm_watchdog()
    try:
        print(json.dumps(run(config, ai, args.device, **settings_from_env())),
              flush=True)
    finally:
        if watchdog is not None:
            watchdog.cancel()


if __name__ == "__main__":
    main()
