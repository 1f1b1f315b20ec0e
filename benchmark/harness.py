"""One run of one cell: build the configuration's scene on the program,
set the traffic's loop up, measure the window, optionally profile a
stretch, then compare what the window produced with the plain reference.

Everything about a cell is found by name in files of its own:
benchmark/cells/<cell>.json (configuration, traffic, chips, why),
benchmark/configs/<config>.json (the scene's sizes and settings, and the
limits of the comparison), benchmark/traffic/<traffic>.json (the loop, the
frames it keeps queued, the cycle of the scene's motion),
benchmark/loops/<loop>.py (the loop, its class `LOOP`),
benchmark/scenes/<scene>.py (the scene on the program, its class `SCENE`,
with its plain reference in benchmark/reference/, `KEPT`, the arrays it
keeps at each step, and `given` where its frames take in state from
earlier frames: check.py), and
benchmark/metrics/<metric>.py (one reader per metric, reported in the
cells that BENCHMARK.json gives it).

What a run compares and traces is the harness's own, the same for every
traffic mix (the constants below).
"""

from __future__ import annotations

import gc
import importlib
import json
import pkgutil
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from benchmark import check, trace, work
from benchmark.loops import Clock, frame_aux

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
AUX_ROWS = 1 << 17           # frames a window can log the drop counters of
WORK_FRAMES = 4              # traced frames the raster work is counted on
WARMUP = 8                   # frames each loop runs at the end of set-up
SAMPLES = 4                  # window frames compared besides the last ...
SAMPLE_SPAN = 240            # ... drawn from the seed among its first 240
TRACE_FRAMES = 32            # frames in a traced run's profiled stretch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def cell(name: str) -> tuple:
    """(cell, configuration, traffic) of a cell by name."""
    c = load("cells", name)
    return c, load("configs", c["config"]), load("traffic", c["traffic"])


def _named(package: str, name: str, attr: str):
    """benchmark/<package>/<name>.py's `attr`."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad {package} name {name!r}")
    return getattr(importlib.import_module(f"benchmark.{package}.{name}"),
                   attr)


def scene_class(cfg: dict):
    return _named("scenes", cfg["scene"], "SCENE")


def loop_class(traffic: dict):
    return _named("loops", traffic["loop"], "LOOP")


def readers() -> dict:
    """Every metric reader in benchmark/metrics/, by name."""
    from benchmark import metrics

    return {m.name: importlib.import_module(f"benchmark.metrics.{m.name}")
            for m in pkgutil.iter_modules(metrics.__path__)}


def reported(name: str, kind: str) -> Optional[set]:
    """The metrics of `kind` that BENCHMARK.json gives cell `name`: those
    whose `workloads` list it and those that list none. None where the
    cell is not listed there (a cell being added, the tests' cells):
    every metric of that kind that reads a value is reported."""
    path = ROOT.parent / "BENCHMARK.json"
    if not path.is_file():
        return None
    bench = json.loads(path.read_text())
    if name not in {w["name"] for w in bench["workloads"]}:
        return None
    return {m["name"] for m in bench[kind]
            if name in m.get("workloads", [name])}


def sample_frames(seed: int) -> set:
    """The window frames (by position in the window) whose output is kept
    for the comparison, drawn from the seed; the last frame is kept too."""
    rng = np.random.default_rng([seed, 1])
    return set(rng.choice(SAMPLE_SPAN, SAMPLES, replace=False).tolist())


class Window(NamedTuple):
    frames: int
    times_ms: list           # each frame's completion, from the start mark
    failed: int              # frames whose drop counters are not [0, 0]
    device_ms: Optional[list] = None  # each frame's time on the card


class Run(NamedTuple):
    setup_s: float
    window: Window
    spans: trace.Spans
    stretch: Optional[trace.Stretch]
    work: Optional[work.RasterWork]


def _mark_replays(clock: Clock, starts: list) -> Callable:
    """Record a mark on the card into `starts` just before each replay of
    a frame graph (`torch.cuda.CUDAGraph.replay`); returns what undoes
    it. Nothing is marked off the card."""
    if not clock.cuda:
        return lambda: None
    graph = torch.cuda.CUDAGraph
    fn = graph.replay

    def marked(self, *args, **kwargs):
        starts.append(clock.mark())
        return fn(self, *args, **kwargs)

    def undo() -> None:
        graph.replay = fn

    graph.replay = marked
    return undo


def _window(loop, clock: Clock, seconds: float, keep: set, dev):
    """Frames back to back for `seconds` of host time (then drained): the
    Window, the kept frames (check.Kept: reference step, RGBA8 frame, kept
    outputs, the state the frame was given) and the next frame number.
    The previous frame's output is held by reference only, for the state
    its successor took in (the scene's `given`): no copy, no launch.
    A frame's time on the card runs from a mark recorded just before its
    first graph replay to its completion mark: the card reaches the first
    mark once the replay is launched and the frames before it are done,
    so neither the host's pace nor the queue ahead counts; a frame that
    replays nothing (an idle frame served again) takes no time there."""
    aux = torch.zeros((AUX_ROWS, 2), dtype=torch.int32, device=dev)
    marks, kept, starts, first = [], [], [], {}
    n, k = 0, loop.next
    out, loop.last = loop.last, None
    undo = _mark_replays(clock, starts)
    try:
        start = clock.mark()
        t_end = time.perf_counter() + seconds
        while n == 0 or time.perf_counter() < t_end:
            if n >= AUX_ROWS:
                raise RuntimeError(f"more than {AUX_ROWS} frames in a "
                                   "window")
            if loop.throttle and n >= loop.throttle:
                clock.wait(marks[n - loop.throttle])
            prev, replays = out, len(starts)
            out = loop.frame(k)
            marks.append(clock.mark())
            if len(starts) > replays:
                first[n] = starts[replays]
            aux[n].copy_(frame_aux(out))
            if n in keep:
                kept.append(check.Kept(loop.ref_index(k), loop.colour(out),
                                       loop.scene_kept(k),
                                       loop.given(prev)))
            n, k = n + 1, k + 1
    finally:
        undo()
    kept.append(check.Kept(loop.ref_index(k - 1), loop.colour(out),
                           loop.scene_kept(k - 1), loop.given(prev)))
    clock.sync()
    times = [clock.ms(start, m) for m in marks]
    device = ([clock.ms(first[i], marks[i]) if i in first else 0.0
               for i in range(n)] if first else None)
    failed = int((aux[:n] != 0).any(dim=1).sum())
    return Window(n, times, failed, device), kept, k


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device="cuda", t_start: Optional[float] = None,
             hook: Optional[Callable] = None,
             config: Optional[dict] = None, control: bool = False) -> dict:
    """One run of cell `name` → the result line (a dict). `config`
    replaces the cell's configuration (the tests' small sizes); `hook`
    (scene, loop) runs once both are built (the tests' planted faults).
    With `control` the comparison is the control's (check.compare), each
    frame given the state this run's frame was given, and the line also
    holds every number it computed under `numbers` (benchmark/control.py)."""
    t_start = time.perf_counter() if t_start is None else t_start
    _c, cfg, traffic = cell(name)
    cfg = config or cfg
    dev = torch.device(device)
    if dev.type == "cuda":
        from trident_tpu_torch import _build

        _build.load_library()
        log("kernels: " + ("built by nvcc in "
                           f"{_build.build_seconds:.1f} s"
                           if _build.build_seconds is not None
                           else "cached library, nvcc not called"))
    cls = scene_class(cfg)
    workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        scene = cls(cfg, seed, traffic["cycle"], dev, workdir)
        loop = loop_class(traffic)(scene, traffic)
        if hook is not None:
            hook(scene, loop)
        clock = Clock(dev)
        keep = sample_frames(seed)
        loop.setup(WARMUP)
        clock.sync()
        setup_s = time.perf_counter() - t_start
        spans = trace.Spans()
        if trace_on:
            for obj, attr, span, drain in loop.span_targets():
                spans.wrap(obj, attr, span, drain)
        window, kept, nxt = _window(loop, clock, seconds, keep, dev)
        stretch, traced = None, []
        if trace_on and dev.type == "cuda":
            def run_frames(count: int) -> None:
                nonlocal nxt
                for _ in range(count):
                    loop.frame(nxt)
                    traced.append(loop.ref_index(nxt))
                    nxt += 1

            stretch = trace.profile_stretch(run_frames, TRACE_FRAMES,
                                            spans, loop.launch_list)
            if stretch is None:
                raise RuntimeError(f"no whole profiled stretch in "
                                   f"{trace.ATTEMPTS} attempts: the device "
                                   "metrics are not measured")
            traced = traced[-TRACE_FRAMES:]
        clock.sync()
        memory = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
        scene.close()
        del loop, scene
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        numbers = check.compare(cls, cfg, cls.motion_of(
            cfg, seed, traffic["cycle"]), kept, dev, control=control)
        raster = None
        if stretch is not None:
            raster = _raster_work(cls, cfg, seed, traffic, traced, dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run = Run(setup_s, window, spans, stretch, raster)
    ok, checks = check.verdict(numbers, cfg["limits"])
    metrics = {}
    kind = "per_layer" if trace_on else "end_to_end"
    listed = reported(name, kind)
    for mname, mod in sorted(readers().items()):
        if mod.KIND != kind or (listed is not None and mname not in listed):
            continue
        value = mod.read(run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": mod.UNIT}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(memory)}
    out = {"correct": bool(ok and window.failed == 0),
           "attempted": window.frames, "failed": window.failed,
           "metrics": metrics, "device": dev_info}
    if trace_on and stretch is not None:
        busy, first, last = trace.busy_union(stretch.device)
        dev_info["busy_s"] = busy * 1e-6
        dev_info["window_s"] = (last - first) * 1e-6
        out["breakdown"] = trace.breakdown(stretch)
    if control:
        out["numbers"] = numbers
    out["checks"] = checks
    return out


def _raster_work(cls, cfg: dict, seed: int, traffic: dict, traced: list,
                 dev) -> Optional[work.RasterWork]:
    """The mean raster work of WORK_FRAMES of the traced frames, counted
    on the reference's geometry and winners at the size the frame
    rasterises, which is the winner map's: a 2× upscaled frame rasterises
    at half its output's width and height. The winners take in nothing
    from earlier frames, so each frame is counted with no given state."""
    if not traced:
        return None
    motion = cls.motion_of(cfg, seed, traffic["cycle"])
    picks = [traced[i * len(traced) // WORK_FRAMES]
             for i in range(min(WORK_FRAMES, len(traced)))]
    works = []
    for k in picks:
        ref = cls.reference.reference_frame(cfg, motion, k, dev)
        height, width = ref["tri"].shape
        works.append(work.raster_work(ref["mesh"], ref["tri"], width, height))
        del ref
    mean = [float(np.mean([getattr(w, f) for w in works]))
            for f in work.RasterWork._fields]
    return work.RasterWork(*mean)
