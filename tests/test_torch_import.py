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
    from trident_tpu_torch.core.config import EngineConfig, RenderConfig

    for kw in ({"bands": 2}, {"kernel": {"chunk": 128}},
               {"kernel": {"resolve_prec": "bf16"}}):
        with pytest.raises(NotImplementedError):
            Renderer(EngineConfig(render=RenderConfig(**kw)), device="cpu")
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


def test_chip_smoke_fails_without_card():
    """With no CUDA device visible the smoke test must exit non-zero and
    print no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
