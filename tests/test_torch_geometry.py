"""Port vs JAX package: host layers and per-triangle geometry.

The same seeded numpy inputs go through the JAX function and its
trident_tpu_torch counterpart. Host-side packing (draw plans, draw
params, lights, textures, camera) must agree bit for bit. The geometry
math (build_draw_rows, corner_stage on both draw-row paths,
planar_setup_cols, build_resolve_cols_planar) is held to the JAX
functions evaluated op by op (jax.disable_jit): there each elementwise op
rounds once, exactly as PyTorch's eager ops do, so the results are
bitwise equal. (Under jit, XLA:CPU contracts a*b + c into FMAs, which
moves results by an ulp or so; the frame tests hold that path.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.ecs.components import (
    LightComponent,
    LightType,
    MeshComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.ecs.registry import Registry
from trident_tpu.geometry.primitives import PrimitiveType
from trident_tpu.io.image import checkerboard
from trident_tpu.mathx.transforms import compose_trs as j_compose_trs
from trident_tpu.mathx.transforms import look_at as j_look_at
from trident_tpu.mathx.transforms import normal_matrix as j_normal_matrix
from trident_tpu.mathx.transforms import perspective_rh_zo as j_persp
from trident_tpu.ops import corner as jcorner
from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import vertex as jvertex
from trident_tpu.render import frame as jframe
from trident_tpu.render import lights as jlights
from trident_tpu.render.renderer import Renderer as JRenderer
from trident_tpu.render.types import CameraParams as JCameraParams
from trident_tpu.render.types import DrawParams as JDrawParams

from trident_tpu_torch.ecs.registry import Registry as PRegistry
from trident_tpu_torch.ecs.registry import from_reference
from trident_tpu_torch.geometry.mesh import GeometryCache as PGeometryCache
from trident_tpu_torch.geometry.primitives import PrimitiveType as PPrimitiveType
from trident_tpu_torch.geometry.primitives import build_primitive as p_build_primitive
from trident_tpu_torch.mathx import transforms as ptf
from trident_tpu_torch.ops import corner as pcorner
from trident_tpu_torch.ops import planes as pplanes
from trident_tpu_torch.ops import vertex as pvertex
from trident_tpu_torch.render import frame as pframe
from trident_tpu_torch.render import lights as plights
from trident_tpu_torch.render.types import from_numpy

from test_torch_host import carry_renderer

torch.set_num_threads(1)
CPU = "cpu"


def _eq(a, b):
    """Bitwise equality of a jax/numpy array and a tensor (NaN-safe)."""
    a = np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        assert (a.view(np.int32) == b.astype(a.dtype).view(np.int32)).all(), \
            np.abs(a - b).max()
    else:
        assert (a == b).all()


def _ulps(a, b) -> int:
    """Largest distance in float32 ulps between two arrays of one sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return int(np.abs(a - b.astype(np.float32).view(np.int32)).max())


def _scene():
    """The scene, built once on the JAX package's Renderer."""
    r = JRenderer(EngineConfig(render=RenderConfig(width=96, height=64)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(32, 4))
    r.acquire_texture("odd", np.random.default_rng(3).integers(
        0, 256, (12, 20, 4), dtype=np.uint8))
    for i, kind in enumerate([PrimitiveType.SPHERE, PrimitiveType.CUBE,
                              PrimitiveType.SPHERE]):
        e = reg.create()
        t = reg.add(e, TransformComponent())
        t.position = np.array([i - 1.0, 0.2 * i, -0.5 * i], np.float32)
        t.rotation = np.array([10.0 * i, 25.0, 5.0], np.float32)
        reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(kind)))
        reg.add(e, TextureComponent(path="checker", slot=slot))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL,
                                direction=np.array([0.3, -1.0, -0.4],
                                                   np.float32),
                                intensity=2.0))
    for k in range(3):
        p = reg.create()
        pt = reg.add(p, TransformComponent())
        pt.position = np.array([k - 1.0, 1.0, 1.0], np.float32)
        reg.add(p, LightComponent(light_type=LightType.POINT, range=4.0,
                                  intensity=3.0))
    r.editor_camera.set_position([0.3, 0.8, 4.0])
    r.editor_camera.look_at_target([0, 0, 0])
    return r, reg


def test_transforms_match():
    rng = np.random.default_rng(0)
    t, rot, s = (rng.uniform(-2, 2, 3), rng.uniform(-180, 180, 3),
                 rng.uniform(0.5, 2, 3))
    assert (ptf.compose_trs(t, rot, s) == j_compose_trs(t, rot, s)).all()
    eye, ctr = rng.uniform(-3, 3, 3), rng.uniform(-1, 1, 3)
    assert (ptf.look_at(eye, ctr, (0, 1, 0)) == j_look_at(eye, ctr, (0, 1, 0))).all()
    assert (ptf.perspective_rh_zo(45.0, 1.7, 0.1, 100.0)
            == j_persp(45.0, 1.7, 0.1, 100.0)).all()
    model = ptf.compose_trs(t, rot, s)
    assert (ptf.normal_matrix(model) == j_normal_matrix(model)).all()


def test_host_layers_bitwise():
    """Draw plan, draw params, lights, textures, camera and the corner
    table: the state carried across must be identical."""
    jr, jreg = _scene()
    tr = carry_renderer(jr, device=CPU)
    preg = tr.registry
    jpacked, ppacked = jr.geometry.packed(), tr.geometry.packed()
    jrec = jframe.gather_mesh_draws(jreg, jr.geometry)
    prec = pframe.gather_mesh_draws(preg, tr.geometry)
    jplan, jtd = jr._plan_cache.plan(jpacked, jrec, jr.geometry.version)
    pplan, ptd = tr._plan_cache.plan(ppacked, prec, tr.geometry.version)
    for f in ("vtx_src", "vtx_draw", "tri_vtx", "tri_valid"):
        _eq(getattr(jplan, f), getattr(pplan, f))
    assert jplan.num_draws == pplan.num_draws
    _eq(jtd, ptd)
    jparams, _pal, jshade = jframe.build_draw_params(
        jrec, jplan.num_draws, material_table=jr.geometry.material_table())
    pparams, pshade = pframe.build_draw_params(
        prec, pplan.num_draws, material_table=tr.geometry.material_table(),
        device=CPU)
    for f in JDrawParams._fields:
        _eq(getattr(jparams, f), getattr(pparams, f))
    _eq(jshade, pshade)
    jl, pl_ = jlights.gather_lights(jreg), plights.gather_lights(preg, CPU)
    for f in jl._fields:
        _eq(getattr(jl, f), getattr(pl_, f))
    jt, pt = jr.textures.device_arrays(), tr.textures.device_arrays(CPU)
    for f in jt._fields:
        _eq(getattr(jt, f), getattr(pt, f))
    jc, pc = jr.editor_camera.params(), tr.editor_camera.params(CPU)
    for f in jc._fields:
        _eq(getattr(jc, f), getattr(pc, f))
    _eq(jr._plan_cache.corner_table(jpacked),
        tr._plan_cache.corner_table(ppacked))
    jg = jframe.geometry_to_device(jpacked)
    pg = pframe.geometry_to_device(ppacked, CPU)
    for f in jg._fields:
        _eq(getattr(jg, f), getattr(pg, f))
    assert jr._plan_cache.draw_stride == tr._plan_cache.draw_stride == 0


def test_default_sun_when_no_lights():
    reg = Registry()
    e = reg.create()
    reg.add(e, TransformComponent())
    jl = jlights.gather_lights(reg)
    pl_ = plights.gather_lights(from_reference(reg), CPU)
    for f in jl._fields:
        _eq(getattr(jl, f), getattr(pl_, f))
    assert int(pl_.dir_count) == 1 and float(pl_.dir_color[3]) == 5.0


def test_gather_mesh_draws_batched_bitwise():
    """The port composes all model matrices in one batched call; every
    record must equal the JAX package's per-entity gather bit for bit, over
    seeded transforms and with hidden and out-of-range meshes skipped."""
    from trident_tpu.geometry.mesh import GeometryCache
    from trident_tpu.geometry.primitives import build_primitive

    rng = np.random.default_rng(17)
    cache = GeometryCache()
    mesh = cache.add_mesh(build_primitive(PrimitiveType.CUBE))
    reg = Registry()
    for i in range(64):
        e = reg.create()
        t = reg.add(e, TransformComponent())
        t.position = rng.uniform(-5, 5, 3).astype(np.float32)
        t.rotation = rng.uniform(-720, 720, 3).astype(np.float32)
        t.scale = rng.uniform(0.1, 3, 3).astype(np.float32)
        m = reg.add(e, MeshComponent(mesh_index=mesh if i % 9 else 7))
        m.visible = i % 13 != 5
        if i % 2:
            reg.add(e, TextureComponent(path="t", slot=i % 5,
                                        uv_scale=(2.0, 0.5), tiling=3.0))
    pcache = PGeometryCache()
    assert pcache.add_mesh(p_build_primitive(PPrimitiveType.CUBE)) == mesh
    jrec = jframe.gather_mesh_draws(reg, cache)
    prec = pframe.gather_mesh_draws(from_reference(reg), pcache)
    assert 40 < len(prec) == len(jrec) < 64
    for j, p in zip(jrec, prec):
        assert (j.entity, j.mesh_index, j.tiling, j.texture_slot,
                j.material_index) == (p.entity, p.mesh_index, p.tiling,
                                      p.texture_slot, p.material_index)
        for f in ("model", "tint", "uv_scale", "uv_offset"):
            _eq(getattr(j, f), getattr(p, f))
    assert pframe.gather_mesh_draws(PRegistry(), pcache) == []


def _geometry_inputs(seed, t=2048, d=8, stride=0):
    """Seeded corner table, draw params, camera and draw consts."""
    rng = np.random.default_rng(seed)
    corners = np.zeros((t, 3, 12), np.float32)
    corners[..., 0:3] = (rng.uniform(-1, 1, (t, 1, 3))
                         + rng.uniform(-0.15, 0.15, (t, 3, 3)))
    n = rng.standard_normal((t, 3, 3))
    corners[..., 3:6] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    corners[..., 6:8] = rng.uniform(0, 1, (t, 3, 2))
    corners[..., 8:11] = 1.0
    corner_t = np.ascontiguousarray(corners.reshape(t, 36).T)
    model = np.stack([j_compose_trs(rng.uniform(-1, 1, 3),
                                    rng.uniform(-90, 90, 3),
                                    rng.uniform(0.5, 1.5, 3)) for _ in range(d)])
    mf = model.reshape(d, 16)
    uv_scale = rng.uniform(0.5, 2, (d, 2)).astype(np.float32)
    uv_off = rng.uniform(-0.5, 0.5, (d, 2)).astype(np.float32)
    tiling = rng.uniform(1, 3, d).astype(np.float32)
    params = JDrawParams(
        model=model, xform_a=mf[:, :12].copy(),
        xform_b=np.concatenate([mf[:, 12:16], uv_scale, uv_off,
                                tiling[:, None], np.zeros((d, 3), np.float32)],
                               axis=1),
        tint=np.ones((d, 4), np.float32), uv_scale=uv_scale, uv_offset=uv_off,
        tiling=tiling, texture_slot=np.ones(d, np.int32),
        material_index=np.zeros(d, np.int32),
        bone_offset=np.full(d, -1, np.int32), bone_count=np.zeros(d, np.int32))
    camera = JCameraParams(
        view=j_look_at(np.array([0.2, 0.3, 4.0], np.float32),
                       np.zeros(3, np.float32), (0, 1, 0)),
        proj=j_persp(50.0, 1.5, 0.1, 100.0),
        position=np.array([0.2, 0.3, 4.0], np.float32))
    consts = rng.uniform(0, 1, (d, 12)).astype(np.float32)
    if stride:
        tri_draw = np.minimum(np.arange(t) // stride, d - 1).astype(np.int32)
        tri_draw[d * stride:] = 0
        valid = np.arange(t) < d * stride
    else:
        tri_draw = np.sort(rng.integers(0, d, t)).astype(np.int32)
        valid = np.arange(t) < t - 100
    return corner_t, params, camera, consts, tri_draw, valid


@pytest.mark.parametrize("stride", [0, 240], ids=["gather", "draw_stride"])
def test_corner_stage_and_records_bitwise(stride):
    w, h = 160, 96
    corner_t, params, camera, consts, tri_draw, valid = _geometry_inputs(
        11, stride=stride)
    d = params.xform_a.shape[0]
    kw = dict(draw_stride=stride, real_draws=d if stride else 0)
    with jax.disable_jit():
        jdr = jcorner.build_draw_rows(params, camera, w, h,
                                      draw_consts=jnp.asarray(consts))
        jcs = jcorner.corner_stage(jnp.asarray(corner_t), jdr,
                                   jnp.asarray(tri_draw), jnp.asarray(valid),
                                   w, h, **kw)
        jrec = jplanes.build_resolve_cols_planar(jcs.cols)
    pdr = pcorner.build_draw_rows(from_numpy(params, CPU),
                                  from_numpy(camera, CPU), w, h,
                                  draw_consts=torch.from_numpy(consts))
    # draw rows go through 4×4 matrix products whose summation order is
    # the BLAS's: agree to float32 rounding, not bitwise
    np.testing.assert_allclose(pdr.numpy(), np.asarray(jdr), rtol=2e-6,
                               atol=1e-5)
    # the per-triangle math gets the SAME draw rows and must be bitwise
    pcs = pcorner.corner_stage(torch.from_numpy(corner_t),
                               torch.from_numpy(np.array(jdr)),
                               torch.from_numpy(tri_draw),
                               torch.from_numpy(valid), w, h, **kw)
    for f in ("edge", "z", "w", "bbox", "valid"):
        _eq(getattr(jcs.setup, f), getattr(pcs.setup, f))
    for k in range(9):
        _eq(jcs.cols.setup.e[k], pcs.cols.setup.e[k])
        # rsqrt is not correctly rounded in XLA nor in PyTorch (each is
        # within ~1 ulp of the true value): ≤ 2 ulps apart
        assert _ulps(jcs.cols.nrm[k], pcs.cols.nrm[k]) <= 2
    for k in range(6):
        _eq(jcs.cols.uv[k], pcs.cols.uv[k])
    for k in range(12):
        _eq(jcs.cols.consts[k], pcs.cols.consts[k])
    assert int(pcs.setup.valid.sum()) > 100
    # from the JAX package's own corner columns: bitwise (the port's
    # (T, RW) rows are the JAX (RW, T) columns, transposed)
    _eq(jrec, pplanes.build_resolve_cols_planar(from_numpy(jcs.cols, CPU)).T)
    # from the port's: the normal planes carry the rsqrt difference
    prec = pplanes.build_resolve_cols_planar(pcs.cols).numpy().T
    jrec = np.asarray(jrec)
    nrm = slice(pplanes.RR_NX, pplanes.RR_U)
    keep = np.ones(pplanes.RR_WIDTH, bool)
    keep[nrm] = False
    _eq(jrec[keep], torch.from_numpy(prec[keep]))
    scale = np.abs(jrec[nrm]).max(axis=1, keepdims=True)
    assert (np.abs(prec[nrm] - jrec[nrm]) <= 2e-7 * scale).all(), \
        (np.abs(prec[nrm] - jrec[nrm]) / scale).max()


def test_planar_setup_cols_bitwise():
    """planar_setup_cols from seeded planar corner columns, with corners
    behind the eye, near-zero w and both windings: stacked setup and the
    planar columns bitwise."""
    rng = np.random.default_rng(9)
    t, w, h = 700, 120, 72
    ws = rng.uniform(-0.3, 2.5, (3, t)).astype(np.float32)
    ws[:, :20] = rng.uniform(-1e-8, 1e-8, (3, 20))
    sx = (rng.uniform(-0.2, 1.2, (3, t)) * w * ws).astype(np.float32)
    sy = (rng.uniform(-0.2, 1.2, (3, t)) * h * ws).astype(np.float32)
    zs = (rng.uniform(0, 1, (3, t)) * ws).astype(np.float32)
    valid = rng.uniform(size=t) < 0.95
    with jax.disable_jit():
        js, jc = jvertex.planar_setup_cols(
            *[[jnp.asarray(a[k]) for k in range(3)] for a in (sx, sy, ws, zs)],
            jnp.asarray(valid), w, h)
    ps, pc = pvertex.planar_setup_cols(
        *[[torch.from_numpy(a[k]) for k in range(3)] for a in (sx, sy, ws, zs)],
        torch.from_numpy(valid), w, h)
    for f in ("edge", "z", "w", "bbox", "valid"):
        _eq(getattr(js, f), getattr(ps, f))
    for f in ("e", "z", "w"):
        for a, b in zip(getattr(jc, f), getattr(pc, f)):
            _eq(a, b)
    n_valid = int(ps.valid.sum())
    assert 50 < n_valid < t - 50            # both windings and culls occur


def test_triangle_setup_bitwise():
    rng = np.random.default_rng(5)
    t, w, h = 500, 128, 64
    clip = rng.uniform(-1.5, 1.5, (t * 3, 4)).astype(np.float32)
    clip[:, 3] = rng.uniform(-0.2, 2.0, t * 3)         # some behind the eye
    tri_vtx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    valid = rng.uniform(size=t) < 0.9
    with jax.disable_jit():
        js = jvertex.triangle_setup(jnp.asarray(clip), jnp.asarray(tri_vtx),
                                    jnp.asarray(valid), w, h)
    ps = pvertex.triangle_setup(torch.from_numpy(clip),
                                torch.from_numpy(tri_vtx),
                                torch.from_numpy(valid), w, h)
    for f in ("edge", "z", "w", "bbox", "valid"):
        _eq(getattr(js, f), getattr(ps, f))
