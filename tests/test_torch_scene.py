"""The port's Scene (trident_tpu_torch/ecs/scene.py), Renderer.append_meshes
and the loaded, animated tube crowd, on the CPU.

  * save / load: a round trip of tests/test_scene.py's scene; the file
    the port saves is byte-equal to the one the JAX Scene saves of the
    same registry (carried across with from_reference), each loads in the
    other package to the same components, and both re-resolve geometry and
    texture slots the same way through a renderer.
  * play / pause / stop, find_by_tag, entity_names against the JAX Scene;
    a script module runs during play; a failing one stops.
  * Scene.play / update sample on the renderer's device.
  * a model appended after a rendered frame is in the next frame, whose
    graph key moved with the geometry version, and that frame equals
    eager render_frame on its inputs.
  * the loaded crowd (tools_dev/scenes.py::loaded_crowd) at 2 × 2 tubes,
    128²: every frame's palettes against the port's AnimationPlayer
    (3e-5) and tube_bone_matrices of the interpolated key bends (1e-4),
    and the frame against skinned_scene posed with those matrices under
    the golden gate of test_golden_flavors.py, plain and shadowed.
"""

import os

import numpy as np
import pytest
import torch

from trident_tpu.assets.model_loader import load_model as j_load_model
from trident_tpu.assets.scene_loader import import_model_entities as j_import
from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.ecs.scene import Scene as JScene
from trident_tpu.geometry.primitives import PrimitiveType as JPrimitiveType
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.anim.player import AnimationPlayer
from trident_tpu_torch.anim.service import AnimationAssetService
from trident_tpu_torch.anim.system import AnimationSystem
from trident_tpu_torch.assets.model_loader import load_model
from trident_tpu_torch.assets.scene_loader import import_model_entities
from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ecs import components as pc
from trident_tpu_torch.ecs.registry import Registry, from_reference
from trident_tpu_torch.ecs.scene import Scene
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.io.image import checkerboard
from trident_tpu_torch.render.renderer import Renderer, render_frame
from trident_tpu_torch.tools_dev import scenes

from test_scene import build_scene
from test_stl_ply import QUAD, _write_binary_stl
from test_torch_anim import reset_animation_state
from test_torch_assets import _png_bytes, _seeded_image
from test_torch_frame import _assert_golden_gate
from test_torch_frame_loop import _same

torch.set_num_threads(1)

PLAYER_TOL = 3e-5          # tests/test_anim_batch.py:79
BEND_TOL = 1e-4            # against the f64 tube_bone_matrices, cast to f32
CROWD = dict(grid=2, width=128, height=128)
TUBE = dict(bones=16, keys=24, segments=16, rings=8)


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_animation_state()
    yield
    reset_animation_state()


def dump(registry, mod, uuids: bool = True) -> list:
    """Every entity of `registry` and each of its components' fields, by
    class name (enums by member name, arrays as lists), for components of
    module `mod` (either package's ecs.components); without `uuids` the
    random UUIDComponent is left out."""
    out = []
    for e in registry.alive():
        comps = {}
        for name in ("UUIDComponent", "TagComponent", "TransformComponent",
                     "CameraComponent", "MeshComponent", "SpriteComponent",
                     "TextureComponent", "AnimationComponent",
                     "LightComponent", "ScriptComponent"):
            c = registry.try_get(e, getattr(mod, name))
            if c is None or (name == "UUIDComponent" and not uuids):
                continue
            fields = {}
            for k, v in vars(c).items():
                if isinstance(v, np.ndarray):
                    v = v.tolist()
                elif hasattr(v, "name") and hasattr(v, "value"):
                    v = v.name
                fields[k] = v
            comps[name] = fields
        out.append((e, comps))
    return out


def carried_scene():
    """tests/test_scene.py's scene in the JAX package and the same registry
    in a port Scene."""
    jscene, _e, _l = build_scene()
    return jscene, Scene(registry=from_reference(jscene.editor_registry))


def test_save_load_roundtrip(tmp_path):
    jscene, scene = carried_scene()
    path = str(tmp_path / "port.trident")
    scene.save(path)
    loaded = Scene()
    loaded.load(path)
    again = str(tmp_path / "again.trident")
    loaded.save(again)
    with open(path) as f, open(again) as g:
        assert f.read() == g.read()
    cube = loaded.find_by_tag('cube "one"')
    assert len(cube) == 1
    reg = loaded.editor_registry
    anim = reg.get(cube[0], pc.AnimationComponent)
    assert anim.clip_name == "Run" and anim.speed == 1.5
    np.testing.assert_allclose(anim.bone_matrices.reshape(-1), np.arange(32),
                               atol=1e-4)
    mesh = reg.get(cube[0], pc.MeshComponent)
    assert mesh.primitive == PrimitiveType.CUBE and mesh.material_index == 2


def test_files_interchange_with_jax(tmp_path):
    """The port saves the JAX Scene's file byte for byte; each package
    loads the other's file to the same components."""
    jscene, scene = carried_scene()
    jpath, path = str(tmp_path / "jax.trident"), str(tmp_path / "port.trident")
    jscene.save(jpath)
    scene.save(path)
    with open(jpath) as f, open(path) as g:
        assert f.read() == g.read()
    mine, theirs = Scene(), JScene()
    mine.load(jpath)
    theirs.load(path)
    assert dump(mine.editor_registry, pc) == dump(theirs.editor_registry, jc)
    assert mine.entity_names() == theirs.entity_names()


def _port_renderer():
    return Renderer(EngineConfig(render=RenderConfig(
        width=64, height=64, use_pallas=False)), device="cpu")


def _jax_renderer():
    return JRenderer(JEngineConfig(render=JRenderConfig(
        width=64, height=64, use_pallas=False)))


# each package's Scene, components, importer, primitives, registry,
# model loader and a 64² reference-raster Renderer
PACKAGES = {
    "port": (Scene, pc, import_model_entities, PrimitiveType, Registry,
             load_model, _port_renderer),
    "jax": (JScene, jc, j_import, JPrimitiveType, JRegistry, j_load_model,
            _jax_renderer),
}


def _quad_stl(tmp_path) -> str:
    """test_stl_ply.py's unit quad centred on the origin, each triangle's
    winding reversed to face a camera on +z under the engine's winding."""
    path = str(tmp_path / "quad.stl")
    if not os.path.exists(path):
        quad = (QUAD - np.float32([0.5, 0.5, 0.0])).reshape(2, 3, 3)[:, ::-1]
        _write_binary_stl(path, np.ascontiguousarray(quad))
    return path


def test_load_rebuilds_geometry_and_textures_as_jax(tmp_path):
    """A saved scene with a primitive, an imported model (re-imported by
    the asset importer), a PNG file texture and a stale texture slot
    re-resolves mesh indices and texture slots through a renderer as the
    JAX Scene does."""
    stl = _quad_stl(tmp_path)
    png = tmp_path / "tex.png"
    png.write_bytes(_png_bytes(_seeded_image()))
    outs = []
    for name, (scene_cls, mods, importer, prims, registry_cls, _load,
               make_renderer) in PACKAGES.items():
        r = make_renderer()
        scene = scene_cls(renderer=r)
        reg = scene.editor_registry
        r.set_active_registry(reg)
        e = reg.create()
        reg.add(e, mods.TransformComponent())
        reg.add(e, mods.MeshComponent(primitive=prims.SPHERE))
        reg.add(e, mods.TextureComponent(path="never_acquired", slot=4))
        ents = importer(stl, reg, r)
        reg.add(ents[0], mods.TextureComponent(path=str(png), slot=9))
        path = str(tmp_path / f"{name}.trident")
        scene.save(path)

        def reimport(p, r=r, importer=importer, registry_cls=registry_cls):
            base = len(r.geometry.meshes)
            importer(p, registry_cls(), r)
            return base, 1

        scene.load(path, asset_importer=reimport)
        outs.append((dump(scene.editor_registry, mods, uuids=False),
                     len(r.geometry.meshes)))
    assert outs[0] == outs[1]


def test_play_pause_stop_and_lookups_match_jax():
    jscene, scene = carried_scene()
    for s in (jscene, scene):
        s.play()
        assert s.playing and s.registry is s.runtime_registry
    assert scene.find_by_tag('cube "one"') == jscene.find_by_tag('cube "one"')
    assert scene.entity_names() == jscene.entity_names()
    (cube,) = scene.find_by_tag('cube "one"')
    rt = scene.runtime_registry
    rt.get(cube, pc.TransformComponent).position[0] = 99.0
    rt.destroy(cube)
    assert scene.editor_registry.is_alive(cube)
    assert scene.editor_registry.get(cube, pc.TransformComponent).position[0] == 1.5
    scene.pause()
    scene.update(0.5)                   # paused: nothing runs
    scene.pause(False)
    scene.stop()
    assert not scene.playing and scene.registry is scene.editor_registry


def test_script_module_runs_during_play(tmp_path, monkeypatch):
    (tmp_path / "port_scene_script.py").write_text(
        "from trident_tpu_torch.ecs.components import TransformComponent\n"
        "def update(entity, registry, dt):\n"
        "    registry.get(entity, TransformComponent).position[1] += dt\n"
        "def broken(entity, registry, dt):\n"
        "    raise RuntimeError('script bug')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    scene = Scene()
    reg = scene.editor_registry
    mover, bad = reg.create(), reg.create()
    reg.add(mover, pc.TransformComponent())
    reg.add(mover, pc.ScriptComponent(path="x", autostart=True,
                                      module="port_scene_script:update"))
    reg.add(bad, pc.ScriptComponent(path="y", autostart=True,
                                    module="port_scene_script:broken"))
    scene.play()
    for _ in range(3):
        scene.update(0.25)
    rt = scene.runtime_registry
    assert rt.get(mover, pc.TransformComponent).position[1] == pytest.approx(0.75)
    assert reg.get(mover, pc.TransformComponent).position[1] == 0.0
    assert not rt.get(bad, pc.ScriptComponent).running


def test_scene_samples_on_the_renderers_device(tmp_path):
    """Play and update pose through the sampler on the renderer's device;
    a scene without a renderer uses its own `device`."""
    path = scenes.write_rig_gltf(tmp_path)
    for with_renderer in (True, False):
        reset_animation_state()
        r = _port_renderer()
        scene = Scene(renderer=r) if with_renderer else Scene(device="cpu")
        reg = scene.editor_registry
        ents = import_model_entities(path, reg, r)
        reg.add(ents[0], pc.AnimationComponent(
            skeleton_asset=path, animation_asset=path, looping=False))
        scene.play()
        scene.update(0.5)
        assert [k[2] for k in AnimationSystem._samplers] == ["cpu"]
        anim = scene.runtime_registry.get(ents[0], pc.AnimationComponent)
        service = AnimationAssetService.get()
        player = AnimationPlayer(service.acquire_skeleton(path))
        player.set_clip(service.acquire_animation_library(path)[0])
        np.testing.assert_allclose(anim.bone_matrices, player.evaluate_at(0.5),
                                   atol=PLAYER_TOL, rtol=0)


def _inputs(r):
    rc = r.config.render
    r.editor_camera.set_viewport_size(rc.width, rc.height)
    return r.frame_inputs()


def test_append_meshes_after_a_rendered_frame(tmp_path):
    """A model appended after a frame: the geometry version and the graph
    key move, the next frame draws it (as the JAX Renderer's does, within
    the golden gate) and equals eager render_frame on its inputs."""
    frames = []
    for name, (_s, mods, _i, prims, registry_cls, load, make_renderer) \
            in PACKAGES.items():
        r = make_renderer()
        reg = registry_cls()
        r.set_active_registry(reg)
        slot = r.acquire_texture("checker", checkerboard(32, 4))
        e = reg.create()
        t = reg.add(e, mods.TransformComponent())
        t.rotation = np.array([20.0, 30.0, 0.0], np.float32)
        t.position = np.array([0.8, 0.0, -1.0], np.float32)
        reg.add(e, mods.MeshComponent(mesh_index=r.ensure_primitive(prims.CUBE)))
        reg.add(e, mods.TextureComponent(path="checker", slot=slot))
        r.editor_camera.set_position([0, 0, 3.0])
        r.editor_camera.look_at_target([0, 0, 0])
        before = r.render_viewport()
        version = r.geometry.version
        key = r.frame_bundle().key if name == "port" else None
        data = load(_quad_stl(tmp_path))
        base, mat_base = r.append_meshes(data.meshes, data.materials)
        assert (base, mat_base) == (1, 1) and r.geometry.version > version
        q = reg.create()
        reg.add(q, mods.TransformComponent())
        reg.add(q, mods.MeshComponent(mesh_index=base,
                                      material_index=mat_base))
        if name == "port":
            assert r.frame_bundle().key != key
            inp = _inputs(r)
        after = r.render_viewport()
        tri, tri0 = np.asarray(after.tri_id), np.asarray(before.tri_id)
        assert (tri0 < 12).all() and (tri >= 12).sum() > 200   # cube: 12
        if name == "port":
            assert not _same(after, render_frame(**inp))
        frames.append(np.asarray(r.read_frame(after)))
    _assert_golden_gate(frames[0], frames[1])


# -- the loaded crowd --------------------------------------------------------------

@pytest.mark.parametrize("shadows", [False, True], ids=["plain", "shadowed"])
def test_loaded_crowd_matches_the_posed_crowd(shadows, tmp_path):
    path = scenes.write_tube_gltf(tmp_path / "tube.glb", **TUBE)
    crowd = scenes.loaded_crowd("cpu", path, shadows=shadows,
                                shadow_map_size=128, **CROWD)
    assert crowd.import_ms > 0
    ref, ref_reg = scenes.skinned_scene(
        "cpu", shadows=shadows, shadow_map_size=128, bones=TUBE["bones"],
        segments=TUBE["segments"], rings=TUBE["rings"], **CROWD)
    service = AnimationAssetService.get()
    player = AnimationPlayer(service.acquire_skeleton(path))
    player.set_clip(service.acquire_animation_library(path)[0])
    rt = crowd.scene.runtime_registry
    anims = [rt.get(e, pc.AnimationComponent) for e in crowd.entities]
    assert [a.speed for a in anims] == pytest.approx(
        [0.6 + 0.01 * i for i in range(len(anims))])
    ref_anims = [a for _e, (a,) in ref_reg.view(pc.AnimationComponent)]
    for k, dt in enumerate((0.0, 0.4, 1 / 60, 1.9)):
        crowd.scene.update(dt)
        bends = scenes.tube_bend_at([a.time for a in anims], TUBE["keys"])
        for a, ra, bend in zip(anims, ref_anims, bends):
            np.testing.assert_allclose(a.bone_matrices,
                                       player.evaluate_at(a.time),
                                       atol=PLAYER_TOL, rtol=0)
            ra.bone_matrices = scenes.tube_bone_matrices(bend, TUBE["bones"])
            np.testing.assert_allclose(a.bone_matrices, ra.bone_matrices,
                                       atol=BEND_TOL, rtol=0)
        inp = _inputs(crowd.renderer)
        out = crowd.renderer.render_viewport()
        assert not _same(out, render_frame(**inp))
        assert out.aux.tolist() == [0, 0]
        if shadows:
            assert out.shadow_aux.tolist() == [0, 0]
        if k in (1, 3):
            _assert_golden_gate(crowd.renderer.read_frame(out),
                                ref.read_frame())
    # the clip loops: times wrap into [0, 2 s)
    assert all(0.0 <= a.time < scenes.TUBE_CLIP_SECONDS for a in anims)
