"""The frame bundle: trident_tpu_torch/render/bundle.py against the JAX
package's trident_tpu/render/bundle.py, and the port's host forms of the
per-frame state (build_draw_params_host, gather_lights_host,
Camera.host_params) against the JAX package's numpy forms.

Every comparison is exact: the same numpy inputs, made from a seed, pack
into byte-identical blobs in both packages, and the port's unpack_frame
returns the JAX unpack_frame's fields bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trident_tpu.render import bundle as jbundle
from trident_tpu.render.frame import build_draw_params as j_build_params
from trident_tpu.render.frame import gather_mesh_draws as j_gather_draws
from trident_tpu.render.lights import gather_lights as j_gather_lights
from trident_tpu.render.types import CameraParams as JCameraParams
from trident_tpu.render.types import DrawParams as JDrawParams
from trident_tpu.render.types import LightParams as JLightParams

from trident_tpu_torch.ecs.registry import Registry, from_reference
from trident_tpu_torch.geometry.mesh import GeometryCache
from trident_tpu_torch.geometry.primitives import PrimitiveType, build_primitive
from trident_tpu_torch.render import bundle
from trident_tpu_torch.render.frame import (
    build_draw_params,
    build_draw_params_host,
    gather_draw_batch,
    gather_mesh_draws,
)
from trident_tpu_torch.render.lights import gather_lights, gather_lights_host
from trident_tpu_torch.render.types import (
    CameraParams,
    DrawParams,
    LightParams,
)

torch.set_num_threads(1)

FIELDS = ("params", "palette", "shade", "camera", "lights", "light_camera",
          "ai_blend", "shadow_bias")


def _inputs(d: int, p: int, lp: int, seed: int):
    """Random per-frame state of draw bucket d, palette bucket p and
    point-light bucket lp, as numpy NamedTuple field dicts."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def i(*shape):
        return rng.integers(-1, 9, shape).astype(np.int32)

    params = dict(model=f(d, 4, 4), xform_a=f(d, 12), xform_b=f(d, 12),
                  tint=f(d, 4), uv_scale=f(d, 2), uv_offset=f(d, 2),
                  tiling=f(d), texture_slot=i(d), material_index=i(d),
                  bone_offset=i(d), bone_count=i(d))
    cam = dict(view=f(4, 4), proj=f(4, 4), position=f(3))
    light_cam = dict(view=f(4, 4), proj=f(4, 4), position=f(3))
    lights = dict(ambient=f(4), dir_direction=f(3), dir_color=f(4),
                  dir_count=np.int32(1), point_pos_range=f(lp, 4),
                  point_color_intensity=f(lp, 4),
                  point_count=np.int32(lp))
    return params, f(p, 4, 4), f(d, 8), cam, lights, light_cam


SHAPES = [(4, 1, 0), (16, 1, 2), (32, 4, 8)]


def _pack_both(d, p, lp, seed, with_light_cam=True):
    params, palette, shade, cam, lights, lcam = _inputs(d, p, lp, seed)
    j = jbundle.pack_frame(
        JDrawParams(**params), palette, shade, JCameraParams(**cam),
        JLightParams(**lights),
        JCameraParams(**lcam) if with_light_cam else None, 0.25, 3e-3)
    t = bundle.pack_frame(
        DrawParams(**params), palette, shade, CameraParams(**cam),
        LightParams(**lights),
        CameraParams(**lcam) if with_light_cam else None, 0.25, 3e-3)
    return j, t


@pytest.mark.parametrize("with_light_cam", [True, False])
@pytest.mark.parametrize("d, p, lp", SHAPES)
def test_pack_frame_byte_identical(d, p, lp, with_light_cam):
    (jf, ji, jshape), (tf, ti, tshape) = _pack_both(d, p, lp, 7,
                                                    with_light_cam)
    assert tuple(jshape) == tuple(tshape) == (d, p, lp)
    assert tf.dtype == jf.dtype == np.float32
    assert ti.dtype == ji.dtype == np.int32
    assert tf.tobytes() == jf.tobytes() and ti.tobytes() == ji.tobytes()
    assert (tf.size, ti.size) == bundle.blob_sizes(tshape)


def _leaves(x):
    """A NamedTuple (or array) → its array leaves in field order."""
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


@pytest.mark.parametrize("d, p, lp", SHAPES)
def test_unpack_frame_returns_jax_fields_bitwise(d, p, lp):
    """The port unpacks the JAX package's blob (and so its own, which is
    byte-identical) into the JAX unpack_frame's fields, bit for bit, the
    zero placeholders included."""
    (jf, ji, jshape), _t = _pack_both(d, p, lp, 11)
    jout = jbundle.unpack_frame(jnp.asarray(jf), jnp.asarray(ji), jshape)
    tout = bundle.unpack_frame(torch.from_numpy(jf), torch.from_numpy(ji),
                               bundle.BundleShape(*jshape))
    for name, ja, ta in zip(FIELDS, jout, tout):
        jl, tl = _leaves(ja), _leaves(ta)
        assert len(jl) == len(tl), name
        for k, (a, b) in enumerate(zip(jl, tl)):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
            assert a.tobytes() == b.tobytes(), (name, k)


@pytest.mark.parametrize("cut", [-1, 1])
def test_layout_drift_raises(cut):
    """A blob one element short (or long) of its shape's layout raises."""
    _j, (f32, i32, shape) = _pack_both(16, 1, 2, 3)
    n = f32.size + cut
    bad = np.resize(f32, n)
    with pytest.raises(ValueError, match="layout drift"):
        bundle.unpack_frame(torch.from_numpy(bad), torch.from_numpy(i32),
                            shape)
    with pytest.raises(ValueError, match="layout drift"):
        bundle.unpack_frame(torch.from_numpy(f32),
                            torch.from_numpy(np.resize(i32, i32.size + cut)),
                            shape)


def test_zero_palette_is_the_jax_unskinned_palette():
    """Without skinned draws the JAX package's palette is one identity in
    a bucket of one; the port packs the same."""
    from trident_tpu.render.frame import DrawRecord as JDrawRecord

    rec = JDrawRecord(entity=0, mesh_index=0, model=np.eye(4, dtype=np.float32),
                      tint=np.ones(4, np.float32),
                      uv_scale=np.ones(2, np.float32),
                      uv_offset=np.zeros(2, np.float32), tiling=1.0,
                      texture_slot=0, material_index=0, bone_matrices=None)
    _params, palette, _shade = j_build_params([rec], 4)
    z = bundle.zero_palette()
    assert z.dtype == palette.dtype and z.tobytes() == palette.tobytes()


def _scene():
    """Three textured, tinted primitives and three lights (a directional
    one, two point lights), built on the JAX package's ECS."""
    from trident_tpu.ecs import components as jc
    from trident_tpu.ecs.registry import Registry as JRegistry
    from trident_tpu.geometry.mesh import GeometryCache as JGeometryCache
    from trident_tpu.geometry.primitives import PrimitiveType as JPT
    from trident_tpu.geometry.primitives import build_primitive as jbuild

    rng = np.random.default_rng(5)
    jreg, jcache = JRegistry(), JGeometryCache()
    kinds = [JPT.CUBE, JPT.SPHERE, JPT.QUAD]
    meshes = [jcache.add_mesh(jbuild(k)) for k in kinds]
    for k, mesh in enumerate(meshes):
        e = jreg.create()
        t = jreg.add(e, jc.TransformComponent())
        t.position = rng.standard_normal(3).astype(np.float32)
        t.rotation = rng.uniform(-90, 90, 3).astype(np.float32)
        t.scale = rng.uniform(0.5, 2, 3).astype(np.float32)
        jreg.add(e, jc.MeshComponent(mesh_index=mesh,
                                     tint=rng.uniform(0, 1, 4)
                                     .astype(np.float32)))
        jreg.add(e, jc.TextureComponent(path="t", slot=k, tiling=1.5 + k))
    sun = jreg.create()
    jreg.add(sun, jc.LightComponent(
        direction=np.array([0.3, -1.0, 0.2], np.float32), intensity=3.0))
    for k in range(2):
        pt = jreg.create()
        tp = jreg.add(pt, jc.TransformComponent())
        tp.position = rng.standard_normal(3).astype(np.float32)
        jreg.add(pt, jc.LightComponent(light_type=jc.LightType.POINT,
                                       intensity=2.0 + k, range=5.0))
    cache = GeometryCache()
    for k in kinds:
        cache.add_mesh(build_primitive(PrimitiveType[k.name]))
    return jreg, jcache, from_reference(jreg), cache


def test_host_forms_equal_jax_numpy_forms():
    """build_draw_params_host and gather_lights_host give the JAX
    package's numpy DrawParams, shade table and LightParams exactly."""
    jreg, jcache, reg, cache = _scene()
    jrecs = j_gather_draws(jreg, jcache)
    jparams, _palette, jshade = j_build_params(
        jrecs, 8, material_table=jcache.material_table())
    params, shade = build_draw_params_host(
        gather_draw_batch(reg, cache), 8,
        material_table=cache.material_table())
    assert shade.tobytes() == np.asarray(jshade).tobytes()
    for f in DrawParams._fields:
        a, b = np.asarray(getattr(jparams, f)), getattr(params, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    jl, tl = j_gather_lights(jreg), gather_lights_host(reg)
    for f in LightParams._fields:
        a, b = np.asarray(getattr(jl, f)), np.asarray(getattr(tl, f))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f


def test_device_forms_are_the_uploaded_host_forms():
    """build_draw_params and gather_lights (the device forms render_frame
    takes, on a DrawRecord list) equal their host forms uploaded, bit for
    bit."""
    _jreg, _jcache, reg, cache = _scene()
    hp, hs = build_draw_params_host(gather_draw_batch(reg, cache), 4,
                                    cache.material_table())
    dp, ds = build_draw_params(gather_mesh_draws(reg, cache), 4,
                               cache.material_table(), device="cpu")
    assert ds.numpy().tobytes() == hs.tobytes()
    for f in DrawParams._fields:
        assert getattr(dp, f).numpy().tobytes() == \
            getattr(hp, f).tobytes(), f
    hl, dl = gather_lights_host(reg), gather_lights(reg, "cpu")
    for f in LightParams._fields:
        a, b = np.asarray(getattr(hl, f)), getattr(dl, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_empty_registry_packs():
    """A scene with no draws and no lights packs and unpacks (the
    fallback sun, the minimum draw bucket)."""
    reg, cache = Registry(), GeometryCache()
    params, shade = build_draw_params_host(gather_draw_batch(reg, cache), 4)
    f32, i32, shape = bundle.pack_frame(
        params, bundle.zero_palette(), shade,
        CameraParams(np.eye(4, dtype=np.float32),
                     np.eye(4, dtype=np.float32), np.zeros(3, np.float32)),
        gather_lights_host(reg), None, 0.0)
    assert tuple(shape) == (4, 1, 0)
    out = bundle.unpack_frame(torch.from_numpy(f32), torch.from_numpy(i32),
                              shape)
    assert int(out[4].dir_count) == 1 and int(out[4].point_count) == 0
    assert out[5].view.numpy().tobytes() == out[3].view.numpy().tobytes()
