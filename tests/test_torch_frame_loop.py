"""The interactive frame loop of trident_tpu_torch's Renderer on the CPU:
the bundled frame against render_frame, viewports, draw_frame's timing,
the idle-frame cache, picking and the runtime camera, against the JAX
package's Renderer where the JAX test is a scene check; the frame graphs'
key and the profiler-window rule for graph replays.

On the CPU the Renderer runs render_frame_bundled eagerly; the captured
CUDA graphs (render/graphs.py) run only on the card, where chip_smoke.py
holds every replay bit-equal to the eager frame (phase 12).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.geometry.primitives import PrimitiveType as JPrimitiveType
from trident_tpu.render.camera import RuntimeCamera as JRuntimeCamera
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ecs import components as pc
from trident_tpu_torch.ecs.registry import Registry
from trident_tpu_torch.geometry.primitives import PrimitiveType
from trident_tpu_torch.ops.kernel_knobs import KernelKnobs
from trident_tpu_torch.render.bundle import BundleShape
from trident_tpu_torch.render.camera import RuntimeCamera
from trident_tpu_torch.render.graphs import FrameGraphs, frame_key
from trident_tpu_torch.render.renderer import (
    Renderer,
    render_frame,
    render_frame_bundled,
)
from trident_tpu_torch.tools_dev.timing import whole

from test_torch_frame import _sphere_grid
from test_torch_host import carry_renderer

torch.set_num_threads(1)

FIELDS = ("color", "depth", "tri_id", "aux", "shadow_aux", "history",
          "view_proj")


def _bits(t):
    return None if t is None else t.contiguous().view(torch.uint8).numpy()


def _same(a, b) -> list:
    """Fields of two FrameOutputs that differ in any bit."""
    bad = []
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or (
                x is not None and (x.shape != y.shape or x.dtype != y.dtype
                                   or not np.array_equal(_bits(x),
                                                         _bits(y)))):
            bad.append(f)
    return bad


def _scene_gate(out, jout) -> None:
    """The port's frame against the JAX Renderer's by the North-star gates:
    winners equal but on a few pixels (on the CPU, XLA contracts the JAX
    edge functions into FMAs, which flips pixel centres on a shared edge),
    and zero interior outliers: no pixel with the same winner off by more
    than 3 LSB."""
    tri, jtri = out.tri_id.numpy(), np.asarray(jout.tri_id)
    assert tri.shape == jtri.shape
    same = tri == jtri
    assert (~same).mean() < 0.005, f"{(~same).sum()} winners differ"
    diff = np.abs(out.color.numpy().astype(np.int32)
                  - np.asarray(jout.color).astype(np.int32)).max(-1)
    assert int((diff[same] > 3).sum()) == 0, "interior outliers"


def _bundled_and_eager(r: Renderer):
    """Viewport 0's frame through render_viewport (pack → eager
    render_frame_bundled) and eager render_frame on the same inputs."""
    rc = r.config.render
    r.editor_camera.set_viewport_size(rc.width, rc.height)
    inp = r.frame_inputs()
    return r.render_viewport(), render_frame(**inp)


@pytest.mark.parametrize("render_kw", [
    {},
    {"shadows": True, "shadow_map_size": 128, "shadow_pcf": True},
    {"kernel": {"fuse": True, "tiled_shade": True}},
], ids=["default", "shadows_pcf", "fuse_tiled"])
def test_bundled_frame_equals_render_frame_bitwise(render_kw):
    """The sphere grid of test_torch_frame.py through the bundle equals
    render_frame bit for bit (color, depth, tri_id, aux; the light pass's
    aux when shadowed)."""
    jr = _sphere_grid()
    reg = jr.registry
    if render_kw.get("shadows"):
        sun = reg.create()
        reg.add(sun, jc.TransformComponent())
        reg.add(sun, jc.LightComponent(
            direction=np.array([0.35, -0.3, -1.0], np.float32),
            cast_shadows=True))
    r = carry_renderer(jr, **render_kw)
    out, ref = _bundled_and_eager(r)
    assert not _same(out, ref)
    assert out.aux.tolist() == [0, 0]
    assert (out.shadow_aux is not None) == bool(render_kw.get("shadows"))


def test_bundled_upscaled_chain_equals_render_frame_bitwise():
    """Two chained AI-upscaled frames: each bundled frame equals
    render_frame on the same inputs and prev (history, view·proj); the
    viewport's prev_state is the frame's own history and view·proj."""
    jr = _sphere_grid()
    r = carry_renderer(jr, ai_upscale=True, width=64, height=64)
    for k in range(2):
        if k:
            r.editor_camera.orbit([0.0, 0.0, 0.0], 6.0, 4.0)
        out, ref = _bundled_and_eager(r)
        assert not _same(out, ref), k
        assert out.color.shape == (64, 64, 4) and out.history is not None
        assert r.prev_state[0] is out.history
        assert r.prev_state[1] is out.view_proj


def test_render_frame_bundled_is_render_frame():
    """render_frame_bundled on a packed blob called directly, as the
    frame graphs call it, equals render_frame."""
    from trident_tpu_torch.render.bundle import pack_frame, zero_palette

    r = carry_renderer(_sphere_grid())
    r.editor_camera.set_viewport_size(128, 128)
    st = r._frame_state()
    f32, i32, shape = pack_frame(st.params, zero_palette(), st.shade,
                                 r.editor_camera.host_params(), st.lights,
                                 st.light_camera, 0.0)
    out = render_frame_bundled(
        st.plan, st.tri_draw, torch.from_numpy(f32), torch.from_numpy(i32),
        r.textures.device_arrays("cpu"), r._plan_cache.corner_table(
            st.packed), shape=shape, width=128, height=128,
        knobs=r.knobs, **r._statics(st.shadow_size))
    assert not _same(out, render_frame(**r.frame_inputs()))


# -- the JAX package's renderer tests (tests/test_render_smoke.py:110-175,
#    tests/test_facade.py:81), on the port ---------------------------------

def _jax_cube_renderer(w, h, positions, use_pallas=True):
    jr = JRenderer(JEngineConfig(render=JRenderConfig(
        width=w, height=h, texture_size=64, use_pallas=use_pallas)))
    reg = JRegistry()
    jr.set_active_registry(reg)
    ents = []
    for pos in positions:
        e = reg.create()
        t = reg.add(e, jc.TransformComponent())
        t.position = np.array(pos, np.float32)
        reg.add(e, jc.MeshComponent(
            mesh_index=jr.ensure_primitive(JPrimitiveType.CUBE)))
        ents.append(e)
    return jr, ents


def test_resize_and_second_viewport():
    """Viewport 1 at 64×96: its frame has that shape, and its picture is
    the JAX Renderer's viewport 1 by the winners-and-interior gate."""
    jr, _ents = _jax_cube_renderer(128, 128, [(0, 0, 0)])
    jr.editor_camera.set_position([0, 0, 3])
    jr.editor_camera.look_at_target([0, 0, 0])
    r = carry_renderer(jr)
    jr.set_viewport(1, 64, 96)
    r.set_viewport(1, 64, 96)
    out = r.render_viewport(1)
    assert tuple(out.color.shape) == (96, 64, 4)
    assert r.viewports[0].width == 128           # viewport 0 untouched
    _scene_gate(out, jr.render_viewport(1))


def test_viewport_zero_is_the_configured_target():
    """Viewport 0 follows RenderConfig's size both ways."""
    r = carry_renderer(_jax_cube_renderer(32, 32, [(0, 0, 0)])[0])
    r.config.render.width = 48
    assert r.render_viewport().color.shape == (32, 48, 4)
    r.set_viewport(0, 40, 24)
    assert (r.config.render.width, r.config.render.height) == (40, 24)
    assert r.render_viewport(0).color.shape == (24, 40, 4)


def test_draw_frame_telemetry():
    r = Renderer(EngineConfig(render=RenderConfig(width=64, height=64,
                                                  texture_size=64)),
                 device="cpu")
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    reg.add(e, pc.TransformComponent())
    reg.add(e, pc.MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    r.editor_camera.set_position([0, 0, 3])
    for _ in range(3):
        r.draw_frame()
    stats = r.timing.stats()
    assert stats.sample_count == 3
    assert stats.avg_ms > 0
    assert r.stats_models == 1
    assert r.stats_triangles == 12
    assert r.graphs is None and not r._inflight  # eager, no pacing events


def test_draw_frame_renders_every_viewport_active_last():
    r = carry_renderer(_jax_cube_renderer(32, 32, [(0, 0, 0)])[0])
    r.editor_camera.set_position([0, 0, 3])
    r.set_viewport(r.GAME_VIEWPORT, 24, 16)
    r.active_viewport = r.GAME_VIEWPORT
    out = r.draw_frame()
    assert out is r.viewports[r.GAME_VIEWPORT].last_frame
    assert out.color.shape == (16, 24, 4)
    assert r.viewports[0].last_frame.color.shape == (32, 32, 4)
    assert r.timing.stats().sample_count == 1


def test_idle_frame_cache_reuses_output():
    """Unchanged inputs skip the frame entirely (editor-idle path); any
    mutation invalidates."""
    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32)),
                 device="cpu")
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    t = reg.add(e, pc.TransformComponent())
    reg.add(e, pc.MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    a = r.render_viewport(0)
    b = r.render_viewport(0)
    assert b is a                       # cached, no new frame
    t.rotation = np.array([0.0, 10.0, 0.0], np.float32)
    c = r.render_viewport(0)
    assert c is not a                   # transform change invalidates
    d = r.render_viewport(0)
    assert d is c
    r.config.render.shadow_pcf = True   # a static changes the signature
    assert r.render_viewport(0) is not d


def test_entity_picking():
    """The JAX test's scene and clicks; the port picks what the JAX
    Renderer picks at every click."""
    jr, (left, right) = _jax_cube_renderer(96, 96, [(-0.8, 0, 0),
                                                    (0.8, 0, 0)],
                                           use_pallas=False)
    jr.editor_camera.set_position([0, 0, 4])
    jr.editor_camera.look_at_target([0, 0, 0])
    r = carry_renderer(jr, use_pallas=True)
    assert r.pick(24, 48) == -1          # nothing rendered yet
    r.render_viewport(0)
    jr.render_viewport(0)
    assert r.pick(24, 48) == left        # left third of the screen
    assert r.pick(72, 48) == right
    assert r.pick(48, 4) == -1           # sky
    assert r.pick(-5, 10) == -1          # out of bounds
    for x, y in [(24, 48), (72, 48), (48, 4), (-5, 10), (10, 48), (86, 30)]:
        assert r.pick(x, y) == jr.pick(x, y), (x, y)
    assert r.pick_entity(72, 48) == right


@pytest.mark.parametrize("projection", ["perspective", "orthographic"])
def test_runtime_camera_bind_matches_jax(projection):
    """RuntimeCamera.bind gives the JAX class's view and projection."""
    kind = projection.upper()
    comp = dict(projection=None, fov_deg=60.0, ortho_size=7.5,
                near_clip=0.5, far_clip=250.0, primary=True)
    pos = np.array([1.0, 2.0, 9.0], np.float32)
    rot = np.array([-10.0, 25.0, 3.0], np.float32)
    cams = []
    for mod, cam in ((jc, JRuntimeCamera()), (pc, RuntimeCamera())):
        t = mod.TransformComponent()
        t.position, t.rotation = pos.copy(), rot.copy()
        cam.set_viewport_size(640, 360)
        cam.bind(t, mod.CameraComponent(
            **{**comp, "projection": mod.ProjectionType[kind]}))
        cams.append(cam)
    j, p = cams
    assert np.array_equal(np.asarray(j.view), p.view)
    assert np.array_equal(np.asarray(j.proj), p.proj)
    hp = p.host_params()
    assert np.array_equal(hp.view, p.view) and hp.view.dtype == np.float32


def test_bind_runtime_camera_drives_the_game_viewport():
    """bind_runtime_camera picks the primary camera; the game viewport
    then renders through it, as the JAX Renderer's does."""
    jr, _ents = _jax_cube_renderer(48, 48, [(0, 0, 0)])
    reg = jr.registry
    for primary, z in ((False, 9.0), (True, 4.0)):
        e = reg.create()
        t = reg.add(e, jc.TransformComponent())
        t.position = np.array([0.0, 0.5, z], np.float32)
        reg.add(e, jc.CameraComponent(primary=primary))
    r = carry_renderer(jr)
    assert r.bind_runtime_camera(r.registry) and jr.bind_runtime_camera(reg)
    assert np.array_equal(r.runtime_camera.position, [0.0, 0.5, 4.0])
    for ctx in (jr, r):
        ctx.set_viewport(ctx.GAME_VIEWPORT, 40, 32)
    out = r.render_viewport(r.GAME_VIEWPORT)
    assert np.array_equal(np.asarray(jr.runtime_camera.view),
                          r.runtime_camera.view)
    _scene_gate(out, jr.render_viewport(jr.GAME_VIEWPORT))
    assert not r.bind_runtime_camera(Registry())
    assert not r.runtime_camera_ready


# -- the frame graphs' key and the profiler's replay windows ----------------

BASE = dict(shape=BundleShape(16, 1, 2), width=128, height=96,
            statics=dict(clear_color=(0.1, 0.1, 0.12, 1.0), shadow_size=0,
                         shadow_pcf=False, supersample=1, bloom=False,
                         bloom_threshold=1.0, bloom_strength=0.6,
                         draw_stride=0, real_draws=0),
            knobs=KernelKnobs(), has_prev=False, versions=(3, 1, 2, False),
            ai_shape=(1, 1, 3))
CHANGES = {
    "shape": BundleShape(32, 1, 2), "width": 64, "height": 48,
    "has_prev": True, "knobs": KernelKnobs(fuse=True),
    "ai_shape": (128, 128, 3),
    "geometry_version": None, "plan_version": None,
    "textures_version": None, "upscaler": None,
    **{f"static_{k}": v for k, v in dict(
        clear_color=(0.0, 0.0, 0.0, 1.0), shadow_size=1024,
        shadow_pcf=True, supersample=2, bloom=True, bloom_threshold=0.5,
        bloom_strength=0.9, draw_stride=768, real_draws=1296).items()}}


def _changed(name, value):
    kw = dict(BASE, statics=dict(BASE["statics"]))
    if name.startswith("static_"):
        kw["statics"][name[len("static_"):]] = value
    elif name.endswith("_version") or name == "upscaler":
        i = ["geometry_version", "plan_version", "textures_version",
             "upscaler"].index(name)
        v = list(kw["versions"])
        v[i] = (not v[i]) if name == "upscaler" else v[i] + 1
        kw["versions"] = tuple(v)
    else:
        kw[name] = value
    return kw


@pytest.mark.parametrize("name", sorted(CHANGES))
def test_frame_key_changes_with_each_static_and_version(name):
    base = frame_key(**BASE)
    assert frame_key(**dict(BASE, statics=dict(BASE["statics"]))) == base
    assert frame_key(**_changed(name, CHANGES[name])) != base


def test_frame_key_ignores_static_order():
    flipped = dict(reversed(list(BASE["statics"].items())))
    assert frame_key(**dict(BASE, statics=flipped)) == frame_key(**BASE)
    hash(frame_key(**BASE))


def test_frame_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        FrameGraphs("cpu")


@pytest.mark.parametrize("activities, kernels, launches, graphs, listed, "
                         "launch_list, keep", [
    (700, 690, 0, 5, {"visibility": 5, "resolve": 5, "texel": 5},
     {"visibility": 1, "resolve": 1, "texel": 1}, True),
    (699, 689, 0, 5, {"visibility": 4, "resolve": 5, "texel": 5},
     {"visibility": 1, "resolve": 1, "texel": 1}, False),   # K1 lost once
    (700, 690, 0, 5, {"visibility": 5, "resolve": 5},
     {"visibility": 1, "resolve": 1, "texel": 1}, False),   # K3 lost
    (700, 690, 0, 5, {"visibility": 5}, None, False),      # no launch list
    (700, 690, 0, 0, {}, None, True),                      # no replay
    (0, 0, 0, 5, {}, {"visibility": 1}, False),             # all lost
    (710, 700, 10, 5, {"visibility": 5, "warp": 5},
     {"visibility": 1, "warp": 1}, True),                  # eager + replay
])
def test_whole_holds_replay_windows_to_the_launch_list(
        activities, kernels, launches, graphs, listed, launch_list, keep):
    assert whole(activities, kernels, launches, graphs, listed,
                 launch_list) is keep


def test_renderer_config_roundtrip_keeps_jax_fields():
    """carry_renderer's RenderConfig copy stays valid with the frame
    loop's fields (viewport 0 writes width and height back)."""
    jr, _ents = _jax_cube_renderer(40, 24, [(0, 0, 0)])
    r = carry_renderer(jr)
    assert dataclasses.asdict(r.config.render)["width"] == 40
    assert r.viewports[0].width == 40 and r.viewports[0].height == 24


# -- host draw gathering: the batched forms against the JAX package's
#    per-record loops, and tools_dev/host_gather.py's loop baseline -------

def _mixed_scene():
    """Textured and untextured draws of two meshes, some hidden or out of
    range, material indices in and out of the table, 1.5 tiling: the JAX
    registry and geometry, and the port's."""
    from trident_tpu.geometry.mesh import GeometryCache as JGeometryCache
    from trident_tpu.geometry.primitives import build_primitive as j_build
    from trident_tpu_torch.ecs.registry import from_reference
    from trident_tpu_torch.geometry.mesh import GeometryCache
    from trident_tpu_torch.geometry.primitives import build_primitive

    rng = np.random.default_rng(9)
    jcache, cache = JGeometryCache(), GeometryCache()
    meshes = [jcache.add_mesh(j_build(JPrimitiveType[k]))
              for k in ("CUBE", "SPHERE")]
    assert [cache.add_mesh(build_primitive(PrimitiveType[k]))
            for k in ("CUBE", "SPHERE")] == meshes
    jreg = JRegistry()
    for i in range(40):
        e = jreg.create()
        t = jreg.add(e, jc.TransformComponent())
        t.position = rng.uniform(-5, 5, 3).astype(np.float32)
        t.rotation = rng.uniform(-360, 360, 3).astype(np.float32)
        t.scale = rng.uniform(0.1, 3, 3).astype(np.float32)
        m = jreg.add(e, jc.MeshComponent(
            mesh_index=meshes[i % 2] if i % 11 else 9,
            material_index=(i % 3) - 1,
            tint=rng.uniform(0, 1, 4).astype(np.float32)))
        m.visible = i % 7 != 3
        if i % 2:
            jreg.add(e, jc.TextureComponent(
                path="t", slot=i % 5, uv_scale=(2.0, 0.5),
                uv_offset=(0.25, 0.125), tiling=1.5))
    return (jreg, jcache), (from_reference(jreg), cache)


def _scenes():
    jr = _sphere_grid()
    r = carry_renderer(jr)
    return {"sphere_grid": ((jr.registry, jr.geometry),
                            (r.registry, r.geometry)),
            "mixed": _mixed_scene()}


def _params_equal(a, b) -> None:
    """Two (DrawParams, shade) pairs, numpy or JAX, agree in every byte."""
    assert np.asarray(a[1]).tobytes() == np.asarray(b[1]).tobytes()
    for f in a[0]._fields:
        x, y = np.asarray(getattr(a[0], f)), np.asarray(getattr(b[0], f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("name", ["sphere_grid", "mixed"])
def test_batched_gathering_equals_jax(name):
    """gather_draw_batch and build_draw_params_host give the JAX
    package's draws (gather_mesh_draws), DrawParams and shade table
    (build_draw_params) bit for bit, with the geometry's material table,
    a wider random one, an empty one and none, at draw buckets below, at
    and above the draw count; so does tools_dev/host_gather.py's
    per-record loop baseline."""
    from trident_tpu.render.frame import build_draw_params as j_params
    from trident_tpu.render.frame import gather_mesh_draws as j_gather
    from trident_tpu_torch.render.frame import (
        build_draw_params_host,
        gather_draw_batch,
        gather_mesh_draws,
    )
    from trident_tpu_torch.tools_dev.host_gather import loop_draw_params

    (jreg, jcache), (reg, cache) = _scenes()[name]
    jrecs = j_gather(jreg, jcache)
    batch = gather_draw_batch(reg, cache)
    assert len(batch) == len(jrecs) > 0
    for j, p in zip(jrecs, gather_mesh_draws(reg, cache)):
        assert (j.entity, j.mesh_index, j.tiling, j.texture_slot,
                j.material_index) == (p.entity, p.mesh_index, p.tiling,
                                      p.texture_slot, p.material_index)
        for f in ("model", "tint", "uv_scale", "uv_offset"):
            x, y = np.asarray(getattr(j, f)), getattr(p, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    rng = np.random.default_rng(2)
    tables = [cache.material_table(), None,
              rng.uniform(0, 1, (3, 8)).astype(np.float32),
              np.zeros((0, 8), np.float32)]          # no index in range
    for table in tables:
        for d in (4, len(jrecs), 2 * len(jrecs)):
            jp, _palette, js = j_params(jrecs, d, material_table=table)
            _params_equal((jp, js), build_draw_params_host(batch, d, table))
            _params_equal((jp, js), loop_draw_params(reg, cache, d, table))


def test_empty_draw_batch():
    from trident_tpu.render.frame import build_draw_params as j_params
    from trident_tpu_torch.geometry.mesh import GeometryCache
    from trident_tpu_torch.render.frame import (
        build_draw_params_host,
        gather_draw_batch,
        gather_mesh_draws,
    )

    batch = gather_draw_batch(Registry(), GeometryCache())
    assert len(batch) == 0 and list(batch) == []
    assert gather_mesh_draws(Registry(), GeometryCache()) == []
    jp, _palette, js = j_params([], 4)
    _params_equal((jp, js), build_draw_params_host(batch, 4))


def test_host_gather_ab_runs_on_the_cpu():
    """tools_dev/host_gather.py's A/B on a small grid: the loops and the
    batched forms agree, and each leg has a time."""
    from trident_tpu_torch.tools_dev.host_gather import gather_ab

    r = carry_renderer(_sphere_grid())
    ms = gather_ab(r, pairs=1)
    assert sorted(ms) == ["batch", "frame_bundle", "loop"]
    assert all(v > 0 for v in ms.values())


# -- the idle-frame signature, frame_bundle, the profiler record names ----

def test_a_frame_that_raises_is_rendered_anew(monkeypatch):
    """A frame that raises leaves no idle-frame signature behind: the next
    call with the same inputs renders the new scene instead of returning
    the previous scene's frame."""
    from trident_tpu_torch.render import renderer as renderer_mod

    r = Renderer(EngineConfig(render=RenderConfig(width=32, height=32)),
                 device="cpu")
    reg = Registry()
    r.set_active_registry(reg)
    e = reg.create()
    t = reg.add(e, pc.TransformComponent())
    reg.add(e, pc.MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    r.editor_camera.set_position([0, 0, 3])
    a = r.render_viewport(0)
    t.rotation = np.array([0.0, 40.0, 0.0], np.float32)

    def fails(*_args, **_kw):
        raise RuntimeError("capture hazard")

    with monkeypatch.context() as m:
        m.setattr(renderer_mod, "render_frame_bundled", fails)
        with pytest.raises(RuntimeError, match="capture hazard"):
            r.render_viewport(0)
    b = r.render_viewport(0)
    assert b is not a
    assert not _same(b, render_frame(**r.frame_inputs()))
    assert r.render_viewport(0) is b                 # now cached


def test_frame_bundle_is_the_viewport_frame():
    """Renderer.frame_bundle's eager frame on its blobs is the frame
    render_viewport returns; its key is the frame key of the Renderer's
    statics and versions, the same for a moved scene."""
    r = carry_renderer(_sphere_grid())
    fb = r.frame_bundle()
    out = fb.frame_fn(torch.from_numpy(fb.f32), torch.from_numpy(fb.i32),
                      fb.prev, fb.ai)
    assert not _same(out, r.render_viewport())
    st = fb.state
    shape = BundleShape(*fb.key[0])
    assert shape.d == st.plan.num_draws and shape.p == 1
    assert fb.key == frame_key(
        shape, 128, 128, r._statics(st.shadow_size), r.knobs, False,
        (r.geometry.version, r._plan_cache.version, r.textures.version,
         False), (1, 1, 3))
    t = r.registry.get(int(st.draws.entity[0]), pc.TransformComponent)
    t.position = t.position + np.float32(0.5)
    moved = r.frame_bundle()
    assert moved.key == fb.key and moved.f32.tobytes() != fb.f32.tobytes()
    assert moved.sig != fb.sig


# the profiler's record name of each render-path kernel: (source, device
# function, template argument)
KERNEL_SOURCES = {
    "visibility": ("visibility.cu", "visibility_kernel", "<false>"),
    "visibility_depth": ("visibility.cu", "visibility_kernel", "<true>"),
    "visibility_ck": ("visibility_ck.cu", "visibility_ck_kernel", ""),
    "visibility_resolve": ("visibility_resolve.cu",
                           "visibility_resolve_kernel", ""),
    "visibility_resolve_vc": ("visibility_resolve.cu",
                              "visibility_resolve_vc_kernel", ""),
    "resolve": ("resolve.cu", "resolve_kernel", ""),
    "resolve_vc": ("resolve.cu", "resolve_vc_kernel", ""),
    "resolve_tiled": ("resolve.cu", "resolve_tiled_kernel", ""),
    "resolve_tiled_vc": ("resolve.cu", "resolve_tiled_vc_kernel", ""),
    "texel": ("texel.cu", "texel_kernel", "<false>"),
    "texel_planar": ("texel.cu", "texel_kernel", "<true>"),
    "shadow_taps": ("shadow_taps.cu", "taps4_kernel", ""),
    "warp": ("warp.cu", "warp_kernel", ""),
}


@pytest.mark.parametrize("name", sorted(KERNEL_SOURCES))
def test_kernel_records_name_one_kernel(name):
    """record_counts gives a device function's profiler record to its own
    kernel and to no other; the function is a kernel of its source; every
    render-path kernel wrapper has a record pattern."""
    import pathlib
    import re

    from trident_tpu_torch.render.graphs import frame_kernels
    from trident_tpu_torch.tools_dev.timing import (
        KERNEL_RECORDS,
        record_counts,
    )

    assert sorted(KERNEL_RECORDS) == sorted(frame_kernels())
    src, fn, targ = KERNEL_SOURCES[name]
    text = (pathlib.Path(__file__).parents[1] / "trident_tpu_torch" / "csrc"
            / src).read_text()
    assert re.search(r"__global__[^;{]*\b" + fn + r"\(", text), fn
    record = f"void (anonymous namespace)::{fn}{targ}(float const*, int)"
    assert record_counts([record, "Memcpy HtoD (Pageable -> Device)",
                          "spin_kernel(long)"]) == {name: 1}
