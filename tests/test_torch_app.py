"""The port's application shell (trident_tpu_torch/app.py, Renderer.present)
against the JAX package's, on the CPU.

  * Application.run(3) with the AI on (cadence 0, blend 0.9, a 16² net
    whose weights are carried across from the JAX init_model) and the
    dataset recorder on, both packages: after each frame the test waits
    until the generator has finished every job it took, so that both loops
    consume the same AI output at the same frame; then one more frame
    blends it. Each frame is within the golden gate of the JAX frame (<
    0.2% of RGBA8 values off by > 3 LSB, mean < 0.35), the blended frame
    differs from the unblended one, and the recorder writes the same file
    names;
  * present() with queued text within the gate of the JAX present(), its
    text pixels equal wherever the two scene frames are;
  * _upscale bit-equal;
  * hot reload through the watched Assets directories: a rewritten PNG
    changes only the pixels of the entity that uses it, a rewritten
    shader module reloads (a broken one keeps the old and is FAILED), a
    broken model re-import keeps the old geometry and is FAILED; the
    events' statuses equal the JAX Application's;
  * layers, events and the input singleton as the JAX shell routes them;
  * the render_demo script on the CPU (PNGs and a Y4M file).
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from trident_tpu.ai.model import init_model as j_init_model
from trident_tpu.app import Application as JApplication
from trident_tpu.app import _upscale as j_upscale
from trident_tpu.core import config as jconfig
from trident_tpu.core import events as jev
from trident_tpu.core.input import Input as JInput
from trident_tpu.ecs import components as jc
from trident_tpu.geometry import primitives as jprim
from trident_tpu.io import image as jimage

from trident_tpu_torch.ai.model import unet_from_flax
from trident_tpu_torch.app import Application, Layer, _upscale
from trident_tpu_torch.core import config
from trident_tpu_torch.core import events as ev
from trident_tpu_torch.core.input import Input
from trident_tpu_torch.ecs import components as C
from trident_tpu_torch.geometry import primitives as prim
from trident_tpu_torch.io import image

from test_torch_frame import _assert_golden_gate

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 48
JAX_SIDE = (JApplication, jconfig, jc, jprim, jimage)
PORT_SIDE = (Application, config, C, prim, image)


@pytest.fixture(autouse=True)
def _restore_input():
    saved = (Input._instance, JInput._instance)
    yield
    Input._instance, JInput._instance = saved


def build_scene(app, C_, prim_, image_):
    """A checkered cube and a sphere, a sun; the same on either package."""
    r, reg = app.renderer, app.scene.editor_registry
    slot = r.acquire_texture("checker", image_.checkerboard(32, 4))
    for pos, kind in (([-0.7, 0, 0], "CUBE"), ([0.8, 0.1, 0], "SPHERE")):
        e = reg.create()
        t = reg.add(e, C_.TransformComponent())
        t.position = np.array(pos, np.float32)
        t.rotation = np.array([20.0, 30.0, 0.0], np.float32)
        reg.add(e, C_.MeshComponent(
            mesh_index=r.ensure_primitive(prim_.PrimitiveType[kind])))
        reg.add(e, C_.TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0.4, 3.2])
    r.editor_camera.look_at_target([0, 0, 0])


def make_app(side, tmp, **cfg_kw):
    App, cfg, C_, prim_, image_ = side
    render = dict(width=SIZE, height=SIZE, use_pallas=False)
    ec = cfg.EngineConfig(
        render=cfg.RenderConfig(**render),
        assets_root=str(tmp / "Assets"), log_file=None, **cfg_kw)
    app = App(ec) if side is JAX_SIDE else App(ec, device="cpu")
    build_scene(app, C_, prim_, image_)
    return app


def _wait_jobs(gen, timeout=120.0):
    """Until every job the generator took has an output waiting or was
    consumed (its worker is a plain thread)."""
    deadline = time.monotonic() + timeout
    while gen._done.qsize() + gen.stats.completed_count < gen._next_index:
        assert time.monotonic() < deadline, "the AI worker stalled"
        time.sleep(0.01)


def run_loop(side, tmp, variables):
    cfg = side[1]
    app = make_app(side, tmp, ai=cfg.AiConfig(
        enabled=True, blend=0.9, net_resolution=(16, 16), cadence_ms=0.0),
        capture=cfg.CaptureConfig(dataset_enabled=True,
                                  dataset_dir=str(tmp / "dataset"),
                                  dataset_interval_s=0.0,
                                  perf_dir=str(tmp / "perf")))
    gen = app.frame_generator
    if side is JAX_SIDE:
        model, _v = j_init_model(jax.random.PRNGKey(0), (16, 16),
                                 base_channels=4)
        assert gen.initialise(model=model, variables=variables)
    else:
        assert gen.initialise(net=unet_from_flax(
            variables["params"], variables["batch_stats"], "cpu"))
    frames = []

    def on_frame(k, out):
        frames.append(np.asarray(app.renderer.read_frame(out)))
        _wait_jobs(gen)

    try:
        app.run(3, on_frame=on_frame)
        assert app.renderer.ai_blend > 0, "no AI output was consumed"
        app.update()
        frames.append(np.asarray(app.renderer.read_frame(app.render())))
        app.renderer.queue_text(0, "fps 59.9 | AI on", 2, 3, (1, 1, 0, 1), 13)
        app.renderer.queue_text(0, "text two", 5, 30, (0, 1, 1, 0.7), 16)
        scene = np.asarray(app.renderer.read_frame())
        presented = np.asarray(app.renderer.present())
        return dict(frames=frames, scene=scene, presented=presented,
                    stats=gen.stats, pairs=dict(app._ai_job_to_dataset))
    finally:
        app.shutdown()


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    _model, variables = j_init_model(jax.random.PRNGKey(0), (16, 16),
                                     base_channels=4)
    out = {}
    for name, side in (("jax", JAX_SIDE), ("port", PORT_SIDE)):
        tmp = tmp_path_factory.mktemp(name)
        out[name] = run_loop(side, tmp, variables)
        out[name]["files"] = sorted(os.listdir(tmp / "dataset"))
    return out


def test_app_run_frames_within_gate(loops):
    j, p = loops["jax"], loops["port"]
    assert len(p["frames"]) == len(j["frames"]) == 4
    for a, b in zip(p["frames"], j["frames"]):
        assert a.shape == (SIZE, SIZE, 4) and a.dtype == np.uint8
        _assert_golden_gate(a, b)
    # frames 0-2 are the raster alone; frame 3 blends the first AI output
    assert (p["frames"][3] != p["frames"][2]).any()
    assert p["stats"].completed_count == j["stats"].completed_count >= 1


def test_recorder_writes_the_same_files(loops):
    j, p = loops["jax"], loops["port"]
    assert p["files"] == j["files"]
    assert sum(f.endswith("_input.npy") for f in p["files"]) == 4
    assert sum(f.endswith("_output.npy") for f in p["files"]) >= 1


def test_present_text_matches_jax(loops):
    j, p = loops["jax"], loops["port"]
    _assert_golden_gate(p["presented"], j["presented"])
    same = (p["scene"] == j["scene"]).all(-1)
    assert same.mean() > 0.5
    text = (p["presented"] != p["scene"]).any(-1)
    assert text.sum() > 40
    assert (p["presented"][same] == j["presented"][same]).all()


@pytest.mark.parametrize("src,dst", [((16, 16), (48, 48)), ((16, 16),
                                     (37, 53)), ((7, 5), (4, 9))])
def test_upscale_bit_equal(src, dst):
    img = np.random.default_rng(sum(dst)).random((*src, 3), np.float32)
    got, want = _upscale(img, *dst), j_upscale(img, *dst)
    assert got.shape == (*dst, 3) and (got == want).all()


TRI_OBJ = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n"
SHADER = ("def shade(world, normal, albedo, metallic, roughness,\n"
          "          ambient_strength, camera_pos, lights, dir_shadow=None):\n"
          "    return albedo * {k}\n")


def _write(path: pathlib.Path, data, mtime: float) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(data, np.ndarray):
        image.save_png(path, data)
    else:
        path.write_text(data)
    os.utime(path, (mtime, mtime))


def _entity_map(r, out) -> np.ndarray:
    """The entity of each pixel's winner (-1 for the background)."""
    tri = out.tri_id.numpy()
    tri_draw = r._last_tri_draw.numpy()
    ents = np.asarray(r._last_draws.entity)
    emap = np.full(tri.shape, -1, np.int64)
    hit = tri >= 0
    emap[hit] = ents[tri_draw[tri[hit]]]
    return emap


def _reload_statuses(app):
    """process_reload_events' events with their statuses."""
    seen = []
    orig = app.file_watcher.pop_pending

    def spy():
        e = orig()
        if e is not None:
            seen.append(e)
        return e

    app.file_watcher.pop_pending = spy
    app.process_reload_events()
    app.file_watcher.pop_pending = orig
    return sorted((os.path.basename(e.path), e.kind.name, e.status.name)
                  for e in seen)


def test_hot_reload_matches_jax_and_patches_the_frame(tmp_path):
    apps = {}
    for name, side in (("jax", JAX_SIDE), ("port", PORT_SIDE)):
        tmp = tmp_path / name
        assets = tmp / "Assets"
        _write(assets / "Textures" / "t.png",
               np.full((8, 8, 4), (200, 40, 40, 255), np.uint8), 1000.0)
        _write(assets / "Shaders" / "unlit.py", SHADER.format(k=1.0), 1000.0)
        _write(assets / "Models" / "tri.obj", TRI_OBJ, 1000.0)
        apps[name] = app = make_app(side, tmp)
        app.file_watcher._poll_interval = 0.0
        r, reg = app.renderer, app.scene.editor_registry
        tex = str(assets / "Textures" / "t.png")
        ent = next(e for e, _c in reg.view(side[2].TextureComponent))
        reg.get(ent, side[2].TextureComponent).path = tex
        reg.get(ent, side[2].TextureComponent).slot = r.acquire_texture(
            tex, side[4].load_rgba8(tex))
        assert app.import_assets([str(assets / "Models" / "tri.obj")])
        assert r.set_custom_shader(str(assets / "Shaders" / "unlit.py"))
        app.process_reload_events()              # the watcher's baseline
        apps[name + "_ent"] = ent
    port, r = apps["port"], apps["port"].renderer
    before = r.render_viewport()
    frame0, emap = before.color.numpy().copy(), _entity_map(r, before)
    statuses = {}
    for name in ("jax", "port"):
        assets = tmp_path / name / "Assets"
        _write(assets / "Textures" / "t.png",
               np.full((8, 8, 4), (30, 220, 60, 255), np.uint8), 2000.0)
        statuses[name] = _reload_statuses(apps[name])
    assert statuses["port"] == statuses["jax"] == [
        ("t.png", "TEXTURE", "SUCCESS")]
    frame1 = r.render_viewport().color.numpy()
    changed = (frame1 != frame0).any(-1)
    assert changed.sum() > 30
    assert (emap[changed] == apps["port_ent"]).all()

    geometry = [m.positions.copy() for m in r.geometry.meshes]
    for step, (shader, model, mtime) in enumerate((
            (SHADER.format(k=0.5), "", 3000.0),           # empty model file
            ("def shade(:\n", TRI_OBJ.replace("v 1 0 0", "v 2 0 0"),
             4000.0))):
        for name in ("jax", "port"):
            assets = tmp_path / name / "Assets"
            _write(assets / "Shaders" / "unlit.py", shader, mtime)
            _write(assets / "Models" / "tri.obj", model, mtime)
            statuses[name] = _reload_statuses(apps[name])
        assert statuses["port"] == statuses["jax"], step
        want = ([("tri.obj", "MODEL", "FAILED"),
                 ("unlit.py", "SHADER", "SUCCESS")] if step == 0 else
                [("tri.obj", "MODEL", "SUCCESS"),
                 ("unlit.py", "SHADER", "FAILED")])
        assert statuses["port"] == want
        if step == 0:
            # the broken model kept its geometry; the shader reloaded
            assert all((m.positions == g).all() for m, g in
                       zip(r.geometry.meshes, geometry))
            frame2 = r.render_viewport().color.numpy()
            assert (frame2 != frame1).any()
        else:
            assert r.shader_hook.last_error
            assert any(not (m.positions == g).all() for m, g in
                       zip(r.geometry.meshes, geometry))
    for name in ("jax", "port"):
        apps[name].shutdown()


class _Recorder(Layer):
    def __init__(self, handles):
        self.handles, self.seen, self.updates = handles, [], 0

    def update(self, app, dt):
        self.updates += 1

    def on_event(self, app, event):
        self.seen.append(type(event).__name__)
        return isinstance(event, self.handles)


def test_layers_events_and_input(tmp_path):
    app = make_app(PORT_SIDE, tmp_path)
    Input._instance = None
    app.input = Input.get()
    low, high = _Recorder(ev.KeyPressedEvent), _Recorder(ev.MouseMovedEvent)
    app.push_layer(low)
    app.push_layer(high)
    handled = []
    app.dispatcher.subscribe(ev.KeyPressedEvent,
                             lambda e: handled.append(e.key) or True)
    app.post_event(ev.MouseMovedEvent(x=3.0, y=4.0))   # the top layer takes it
    app.post_event(ev.KeyPressedEvent(key=7))          # the lower layer does
    assert high.seen == ["MouseMovedEvent", "KeyPressedEvent"]
    assert low.seen == ["KeyPressedEvent"]
    assert handled == []                               # already handled
    assert app.input.mouse_position == (3.0, 4.0) and app.input.key_down(7)
    obj = tmp_path / "drop.obj"
    obj.write_text(TRI_OBJ)
    n = len(list(app.scene.editor_registry.alive()))
    app.post_event(ev.FileDropEvent(paths=[str(obj), str(tmp_path / "x.obj")]))
    assert len(list(app.scene.editor_registry.alive())) == n + 1
    frames = []
    app.run(5, on_frame=lambda k, out: (
        frames.append(k), k == 1 and app.post_event(ev.WindowCloseEvent())))
    assert frames == [0, 1] and low.updates == 2 and not app.running
    app.shutdown()


def test_render_demo_script(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "trident_tpu_torch.scripts.render_demo",
         "--frames", "2", "--width", "48", "--height", "32", "--shadows",
         "--bloom", "--video", str(tmp_path / "v.y4m"), "--out",
         str(tmp_path / "png"), "--device", "cpu"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    pngs = sorted(os.listdir(tmp_path / "png"))
    assert pngs == ["frame_0000.png", "frame_0001.png"]
    frame = image.read_png(tmp_path / "png" / pngs[1])
    assert frame.shape == (32, 48, 4) and len(np.unique(frame)) > 8
    y4m = (tmp_path / "v.y4m").read_bytes()
    header = b"YUV4MPEG2 W48 H32 F30:1 Ip A1:1 C420\n"
    assert y4m.startswith(header)
    assert len(y4m) == len(header) + 2 * (6 + 48 * 32 * 3 // 2)
