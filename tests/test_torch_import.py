"""trident_tpu_torch imports and renders without jax, pins TF32 off, and
never moves a CUDA request to the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import trident_tpu_torch
from trident_tpu_torch.render.renderer import Renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

_NO_JAX_RENDER = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["trident_tpu"] = None  # and so does any import of the JAX package
import importlib, pkgutil
import trident_tpu_torch
for m in pkgutil.walk_packages(trident_tpu_torch.__path__, "trident_tpu_torch."):
    importlib.import_module(m.name)
import numpy as np, torch
from trident_tpu_torch.render.renderer import build_entry_renderer
r = build_entry_renderer(64, 64, device="cpu")
frame = r.read_frame()
assert frame.shape == (64, 64, 4), frame.shape
assert (frame[..., :3] != frame[0, 0, :3]).any(), "all clear color"
r.config.render.ai_upscale = True          # the upscaler and the warp
for _ in range(2):
    out = r.render_viewport()
    r.editor_camera.orbit([0, 0, 0], 6.0, 4.0)
assert out.color.shape == (64, 64, 4) and out.history.shape == (32, 32, 12)
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.render.renderer import Renderer
for kernel in ({"ckern": True, "dynhit": False},
               {"fuse": True, "tiled_shade": True}):
    k = build_entry_renderer(64, 64, device="cpu")
    kr = Renderer(EngineConfig(render=RenderConfig(width=64, height=64,
                                                   kernel=kernel)),
                  device="cpu")
    kr.geometry, kr.textures = k.geometry, k.textures
    kr.editor_camera, kr.registry = k.editor_camera, k.registry
    assert (kr.read_frame() == frame).all(), kernel
r.set_ai_frame(np.full((64, 64, 3), 0.5, np.float32), 0.5)   # the AI blend
assert (r.read_frame() != frame).any()
import tempfile
from trident_tpu_torch.tools_dev.scenes import FEATURE_FLAVORS, feature_scene
with tempfile.TemporaryDirectory() as td:       # the forward features
    for name in FEATURE_FLAVORS:
        f = feature_scene(name, "cpu", shader_path=td + "/shader.py",
                          width=48, height=48).read_frame()
        assert f.shape == (48, 48, 4), name
from trident_tpu_torch.ai.model import load_frame_generator
net, bc = load_frame_generator(device="cpu")
assert net(torch.zeros((1, 6, 32, 32))).shape == (1, 3, 32, 32)
for name in ("ops.kernel_knobs", "ops.deferred_tiled", "ops.raster",
             "ops.resolve", "ops.texel", "tools_dev.kbench",
             "tools_dev.gather_probe", "tools_dev.diag_split_kernel",
             "bench", "bench_sweep", "ai.model", "ai.metrics",
             "ai.frame_generator", "render.shader_hook", "tools_dev.scenes"):
    assert "trident_tpu_torch." + name in sys.modules, name
assert sys.modules["jax"] is None and sys.modules["trident_tpu"] is None
print("rendered", frame.shape, "upscaled", tuple(out.color.shape))
"""


def test_renders_with_jax_blocked():
    # JAX_PLATFORMS stays set as the tests set it: the port never reads it
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RENDER], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "rendered (64, 64, 4) upscaled (64, 64, 4)" in proc.stdout


def test_sources_never_import_jax():
    """Neither jax nor anything of the JAX package `trident_tpu`: every
    `from trident_tpu.` / `from trident_tpu import` and every
    `import trident_tpu` not followed by `_torch` is banned."""
    banned = re.compile(
        r"^\s*(import jax\b|from jax\b|from trident_tpu(\.|\s)"
        r"|import trident_tpu(?!_torch))", re.M)
    files = sorted((ROOT / "trident_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f) for f in files if banned.search(f.read_text())]
    assert not offenders
    # the scan covers the probe tools, and the pattern catches the JAX
    # scripts they port
    tools = {f.name for f in files if f.parent.name == "tools_dev"}
    assert {"kbench.py", "gather_probe.py", "diag_split_kernel.py",
            "timing.py", "scenes.py"} <= tools
    render = {f.name for f in files if f.parent.name == "render"}
    assert {"shader_hook.py", "renderer.py", "textures.py",
            "frame.py"} <= render
    assert banned.search((ROOT / "tools_dev" / "gather_probe.py").read_text())


# the modules of model import (every format), images, skyboxes, the
# animation system, its graph view and the Scene, and glTF, FBX and
# COLLADA crowds loaded, played and posed with them on the CPU under a
# KTX2 skybox, an SVG and a KTX2 texture decoded, all without building
# the native OBJ loader
_LOADED_MODULES = """
import sys
mods = ["mathx.quat", "anim", "anim.data", "anim.pose", "anim.player",
        "anim.service", "anim.blend_tree", "anim.state_machine",
        "anim.batch", "anim.system", "anim.graph_view", "io.image",
        "io.svg", "assets", "assets.model_loader", "assets.gltf_loader",
        "assets.stl_ply_loader", "assets.fbx_loader", "assets.dae_loader",
        "assets.ktx2", "assets.skybox", "assets.native",
        "assets.scene_loader", "ecs.scene", "tools_dev.scenes"]
import importlib
for m in mods:
    importlib.import_module("trident_tpu_torch." + m)
from trident_tpu_torch.assets import native
import tempfile
import numpy as np
from trident_tpu_torch.assets.skybox import load_skybox_mips
from trident_tpu_torch.io.image import load_rgba8_mips
from trident_tpu_torch.tools_dev import scenes
tube = dict(bones=4, keys=5, segments=8, rings=4)
with tempfile.TemporaryDirectory() as td:
    sky = load_skybox_mips(scenes.write_sky_ktx2(td + "/sky.ktx2", 8))
    assert len(sky) == 4
    for write, ext in ((scenes.write_tube_gltf, "glb"),
                       (scenes.write_tube_fbx, "fbx"),
                       (scenes.write_tube_dae, "dae")):
        path = write(td + "/tube." + ext, **tube)
        crowd = scenes.loaded_crowd("cpu", path, grid=2, width=32,
                                    height=32)
        crowd.renderer.set_skybox(sky[0], mips=sky[1:])
        crowd.scene.update(0.5)
        assert crowd.renderer.read_frame().shape == (32, 32, 4), path
    rig = scenes.write_rig_gltf(td)
    from trident_tpu_torch.assets.model_loader import load_model
    assert len(load_model(rig).clips) == 1
    with open(td + "/t.svg", "w") as f:
        f.write(scenes.SVG_TEXTURE)
    assert load_rgba8_mips(td + "/t.svg")[0].shape == (64, 64, 4)
    rgba, mips = load_rgba8_mips(scenes.write_checker_ktx2(td + "/c.ktx2"))
    assert rgba.shape == (128, 128, 4) and len(mips) == 7
assert native._lib is None and not native._load_failed
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "PIL", "trident_tpu",
                                    "zstandard", "imageio"))
assert not bad, bad
print("clean", len(mods))
"""


def test_loaded_modules_import_no_jax_pil_or_reference():
    """Importing every module of model import, images, skyboxes, animation
    and the Scene in a fresh process, and loading, playing and rendering
    glTF, FBX and COLLADA crowds with them under a KTX2 skybox, leaves no
    jax, PIL, zstandard, imageio or trident_tpu module in sys.modules (the
    card's machine has none of them), and the native OBJ loader unbuilt."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _LOADED_MODULES], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "clean 25" in proc.stdout


def test_loading_sources_never_import_pil():
    """Model import, images, animation, the ECS and the scenes decode
    without PIL (the card's machine has none)."""
    banned = re.compile(r"^\s*(import PIL\b|from PIL\b)", re.M)
    port = ROOT / "trident_tpu_torch"
    files = [f for d in ("anim", "assets", "io", "ecs", "mathx")
             for f in sorted((port / d).rglob("*.py"))]
    files += [port / "tools_dev" / "scenes.py", ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert not [str(f) for f in files if banned.search(f.read_text())]
    assert banned.search((ROOT / "trident_tpu" / "io" / "image.py")
                         .read_text())


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_request_without_card_raises(monkeypatch):
    """The default device is the card: with none, the entry points raise
    unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not hasattr(trident_tpu_torch, "default_device")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer()
    with pytest.raises(RuntimeError, match="cuda"):
        trident_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        trident_tpu_torch.resolve_device("cuda:0")


def test_unported_features_raise():
    """What the port once refused, and what it still refuses: every
    kernel knob the JAX package accepts now builds a Renderer
    (test_formerly_unported_kernel_renders renders these two); an unknown
    sampling mode raises."""
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig

    for kw in ({"kernel": {"chunk": 128}},
               {"kernel": {"resolve_prec": "bf16"}}):
        r = Renderer(EngineConfig(render=RenderConfig(**kw)), device="cpu")
        assert r.config.render.kernel == kw["kernel"]
    assert r.knobs.resolve_prec == "bf16"
    # the banded frame is ported: n bands run on the CPU device
    r = Renderer(EngineConfig(render=RenderConfig(bands=2)), device="cpu")
    assert r._band_devices() == [torch.device("cpu")] * 2
    # the reference raster and the plane-gather frame are ported routes
    for kw in ({"use_pallas": False}, {"forward_shading": False},
               {"forward_shading": False, "plane_f16": False},
               {"use_pallas": False, "forward_shading": False}):
        r = Renderer(EngineConfig(render=RenderConfig(**kw)), device="cpu")
        assert r._statics(0)["raster_mode"] == (
            "ref" if kw.get("use_pallas") is False else "pallas")
    # the sampling modes are ported; an unknown one is a ValueError
    for mode in ("nearest", "bilinear", "trilinear"):
        Renderer(EngineConfig(render=RenderConfig(sampling=mode)),
                 device="cpu")
    with pytest.raises(ValueError):
        Renderer(EngineConfig(render=RenderConfig(sampling="aniso")),
                 device="cpu")


@pytest.mark.parametrize("kernel", [{"chunk": 128},
                                    {"resolve_prec": "bf16"}],
                         ids=["chunk", "resolve_prec"])
def test_formerly_unported_kernel_renders(kernel):
    """The two kernel dicts test_unported_features_raise once refused
    render the golden-base scene: chunk (a TPU blocking) its default
    frame bit for bit, resolve_prec "bf16" the same winners with the
    colours of the bf16-rounded records."""
    from trident_tpu_torch.tools_dev.scenes import golden_base_scene

    out = golden_base_scene("cpu", kernel=kernel).render_viewport()
    default = golden_base_scene("cpu").render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert torch.equal(out.tri_id, default.tri_id)
    assert torch.equal(out.color, default.color) == ("chunk" in kernel)


def test_chip_smoke_fails_without_card():
    """With no CUDA device visible the smoke test must exit non-zero and
    print no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# the training path with jax, PIL and the JAX package unimportable (the
# card's machine has no PIL): frames written and decoded without PIL,
# train() with its checkpoints, validate_checkpoint, the upscaler's save
# and load, and the dataset recorder
_TRAINING = """
import sys
for name in ("jax", "trident_tpu", "PIL"):
    sys.modules[name] = None
import json, tempfile
import numpy as np, torch
torch.set_num_threads(1)
from trident_tpu_torch import models
from trident_tpu_torch.ai import upscaler as up
from trident_tpu_torch.io.dataset_recorder import FrameDatasetRecorder
from trident_tpu_torch.io.image import save_png
from trident_tpu_torch.parallel import dryrun, mesh
from trident_tpu_torch.scripts import train_frame_generator, train_upscaler
with tempfile.TemporaryDirectory() as td:
    base = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    for i in range(5):
        save_png(f"{td}/frame_{i:02d}.png", np.roll(base, i, 1))
    cfg = models.TrainConfig(source=td, resolution=(12, 12), base_channels=4,
                             batch_size=2, epochs=1, checkpoint_every=0,
                             checkpoint_dir=td + "/ck")
    summary = models.train(cfg, device="cpu")
    assert summary["epochs_run"] == 1, summary
    assert models.validate_checkpoint(td + "/ck", (12, 12), 4,
                                      device="cpu").ok
    net = up.init_upscaler(torch.Generator().manual_seed(0), 4, 17,
                           device="cpu")
    back, bc = up.load_upscaler(up.save_upscaler(net, td + "/up"), "cpu")
    assert bc == 4 and up.upscaler_in_channels(back) == 17
    rec = FrameDatasetRecorder(td + "/rec")
    rec.start()
    rec.record_input_frame(base, now=0.0)
    rec.stop()
    assert rec.written_count == 1
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "PIL", "trident_tpu"))
assert not bad, bad
print("trained", json.dumps(summary["epochs_run"]))
"""


def test_training_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _TRAINING], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "trained 1" in proc.stdout


# the application shell's modules with jax, PIL and the JAX package
# unimportable (the card's machine has no PIL): each imports, an
# Application renders, presents text and records a Y4M file, the facade
# and the inspector answer, and the three scripts import
_SHELL = """
import sys
for name in ("jax", "trident_tpu", "PIL"):
    sys.modules[name] = None
import importlib, tempfile
import numpy as np, torch
torch.set_num_threads(1)
mods = ["app", "core.events", "core.input", "core.filewatch",
        "core.threadcheck", "core.alloc", "ecs.inspect", "utils",
        "utils.profiling", "io.text_overlay", "io.video", "render.command",
        "scripts.render_demo", "scripts.profile_stages", "scripts.viewer",
        "tools_dev.make_font_atlas"]
for m in mods:
    importlib.import_module("trident_tpu_torch." + m)
from trident_tpu_torch.app import Application
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.render.command import RenderCommand
from trident_tpu_torch.render.renderer import build_entry_renderer
from trident_tpu_torch.utils import Profiler, profile_block
with tempfile.TemporaryDirectory() as td:
    app = Application(EngineConfig(render=RenderConfig(width=32, height=32),
                                   assets_root=td, log_file=None),
                      device="cpu")
    entry = build_entry_renderer(32, 32, device="cpu")
    app.renderer.geometry, app.renderer.textures = (entry.geometry,
                                                    entry.textures)
    app.scene.editor_registry = entry.registry
    app.renderer.set_active_registry(entry.registry)
    app.renderer.editor_camera = entry.editor_camera
    assert app.video_encoder.begin_session(td + "/v.y4m", 32, 32)
    p = Profiler(td + "/traces")
    p.start()
    with profile_block("shell"):
        app.run(2)
    assert p.stop()
    app.renderer.queue_text(0, "ok", 1, 1, (1, 1, 1, 1), 12)
    shown = app.renderer.present()
    assert (shown != app.renderer.read_frame()).any()
    app.shutdown()
    assert app.video_encoder.frames_encoded == 2
    RenderCommand._app = app
    assert "Transform" in RenderCommand.inspect_entity(
        next(iter(entry.registry.alive())))
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "jaxlib", "PIL", "trident_tpu"))
assert not bad, bad
print("shell", len(mods))
"""


def test_shell_runs_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SHELL], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "shell 16" in proc.stdout


def test_shell_sources_never_import_pil():
    """The shell draws text from its atlas and encodes PNG with zlib: none
    of its modules imports PIL (the atlas generator imports it inside its
    functions, on a machine that has it)."""
    banned = re.compile(r"^(import PIL\b|from PIL\b)", re.M)
    port = ROOT / "trident_tpu_torch"
    files = [port / f for f in (
        "app.py", "core/events.py", "core/input.py", "core/filewatch.py",
        "core/threadcheck.py", "core/alloc.py", "ecs/inspect.py",
        "utils/__init__.py", "utils/profiling.py", "io/text_overlay.py",
        "io/video.py", "render/command.py", "render/renderer.py",
        "scripts/render_demo.py", "scripts/profile_stages.py",
        "scripts/viewer.py", "tools_dev/make_font_atlas.py")]
    assert not [str(f) for f in files if banned.search(f.read_text())]
