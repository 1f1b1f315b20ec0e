"""The port's own copies of the host layers (config, ECS, meshes and
primitives, the checkerboard) give the JAX package's results exactly, and
`from_reference` carries a scene across with every entity and field.

`carry_renderer` is the other port tests' way to put one scene on both
packages: the scene is built once on the JAX package's Renderer and
carried across (config, primitives, texture slots, camera, registry).
Every comparison here is exact (bit-equal arrays, equal values).
"""

import dataclasses

import numpy as np
import torch

from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.geometry.mesh import GeometryCache as JGeometryCache
from trident_tpu.geometry.primitives import PrimitiveType as JPrimitiveType
from trident_tpu.geometry.primitives import build_primitive as j_build
from trident_tpu.io.image import checkerboard as j_checkerboard

from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ecs import components as pc
from trident_tpu_torch.ecs.registry import from_reference
from trident_tpu_torch.geometry.mesh import GeometryCache
from trident_tpu_torch.geometry.primitives import PrimitiveType, build_primitive
from trident_tpu_torch.io.image import checkerboard
from trident_tpu_torch.render.renderer import Renderer

torch.set_num_threads(1)


def carry_renderer(jr, device="cpu", **render_kw) -> Renderer:
    """The port's Renderer holding the scene of `jr`, a JAX-package
    Renderer built from primitives: the same render config (with
    `render_kw` overriding its fields), meshes at the same indices,
    textures in the same slots, the same editor camera and the registry
    carried across by `from_reference`."""
    rc = RenderConfig(**{**dataclasses.asdict(jr.config.render),
                         **render_kw})
    r = Renderer(EngineConfig(render=rc), device=device)
    for kind, idx in sorted(jr._primitive_mesh_indices.items(),
                            key=lambda kv: kv[1]):
        assert r.ensure_primitive(PrimitiveType[kind.name]) == idx
    slots = sorted(jr.textures._by_path.items(), key=lambda kv: kv[1])
    for key, slot in slots[1:]:                  # slot 0 is the white one
        assert r.acquire_texture(key, jr.textures._images[slot]) == slot
    jcam, cam = jr.editor_camera, r.editor_camera
    cam.position = np.array(jcam.position, np.float32)
    cam.rotation = np.array(jcam.rotation, np.float32)
    cam.fov_deg, cam.near_clip, cam.far_clip = (jcam.fov_deg, jcam.near_clip,
                                                jcam.far_clip)
    cam.viewport = tuple(jcam.viewport)
    cam._look_target = jcam._look_target
    cam._dirty = True
    r.set_active_registry(from_reference(jr.registry))
    return r


def test_primitives_pack_bitwise():
    jcache, cache = JGeometryCache(), GeometryCache()
    for kind in ("CUBE", "SPHERE", "QUAD"):
        assert (jcache.add_mesh(j_build(JPrimitiveType[kind]))
                == cache.add_mesh(build_primitive(PrimitiveType[kind])))
    jp, pp = jcache.packed(), cache.packed()
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(pp, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert ([dataclasses.asdict(x) for x in a]
                    == [dataclasses.asdict(x) for x in b]), f.name
    assert (jcache.material_table() == cache.material_table()).all()


def test_engine_config_defaults_equal():
    assert dataclasses.asdict(JEngineConfig()) == dataclasses.asdict(EngineConfig())
    assert JEngineConfig().to_json() == EngineConfig().to_json()


def test_checkerboard_equal():
    for size, cells in ((64, 8), (128, 8), (32, 4)):
        a, b = j_checkerboard(size, cells), checkerboard(size, cells)
        assert a.dtype == b.dtype == np.uint8 and (a == b).all()


def test_from_reference_keeps_entities_and_fields():
    rng = np.random.default_rng(5)
    jreg = JRegistry()
    kept = []
    for i in range(12):
        e = jreg.create()
        t = jreg.add(e, jc.TransformComponent())
        t.position = rng.uniform(-3, 3, 3).astype(np.float32)
        t.rotation = rng.uniform(-90, 90, 3).astype(np.float32)
        jreg.add(e, jc.MeshComponent(mesh_index=i % 3, visible=i % 4 != 1,
                                     primitive=JPrimitiveType.SPHERE))
        if i % 2:
            jreg.add(e, jc.TextureComponent(path="t", slot=i % 5,
                                            tiling=2.0))
        if i % 3 == 0:
            jreg.add(e, jc.LightComponent(
                light_type=jc.LightType.POINT if i else jc.LightType.DIRECTIONAL,
                cast_shadows=i == 0, intensity=float(i)))
        if i == 7:
            jreg.add(e, jc.TagComponent("seven"))
            jreg.add(e, jc.CameraComponent(
                projection=jc.ProjectionType.ORTHOGRAPHIC, primary=True))
        kept.append(e)
    jreg.destroy(kept[4])                     # a hole in the ids
    preg = from_reference(jreg)
    assert preg.alive() == jreg.alive() and len(preg) == 11
    assert preg._next_entity == jreg._next_entity
    pairs = 0
    for ctype, storage in jreg._storages.items():
        ptype = getattr(pc, ctype.__name__)
        assert set(preg._storages[ptype]) == set(storage)
        for e, comp in storage.items():
            twin = preg.get(e, ptype)
            assert type(twin) is ptype
            for f in dataclasses.fields(comp):
                a, b = getattr(comp, f.name), getattr(twin, f.name)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and (a == b).all()
                    assert a is not b, "arrays must be copied"
                elif hasattr(a, "name") and hasattr(a, "value"):   # an enum
                    assert type(b).__module__.startswith("trident_tpu_torch")
                    assert (a.name, a.value) == (b.name, b.value)
                else:
                    assert a == b, (ctype.__name__, f.name)
                pairs += 1
    assert pairs > 100
    # the views the renderer walks see the same entities in the same order
    jview = [e for e, _ in jreg.view(jc.TransformComponent, jc.MeshComponent)]
    pview = [e for e, _ in preg.view(pc.TransformComponent, pc.MeshComponent)]
    assert jview == pview and len(pview) == 11
