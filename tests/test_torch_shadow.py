"""The shadow pass of the port against the JAX package: the light camera
and scene bounds, the depth-only visibility kernel's plain version, the
light pass (render_shadow_map), the shadow taps and shadow_factor.

Tolerances, each with its reason:
  * light_camera, scene_bounds: bit-equal (the same numpy arithmetic).
  * depth-only visibility: bit-equal to the JAX
    package's Pallas kernel (interpreted) run in a child process whose
    XLA:CPU emits no FMAs (--xla_cpu_max_isa=AVX), where every product and
    sum rounds once, as in PyTorch's eager ops and the CUDA kernel
    (-fmad=false); ±0 count as equal. In this process XLA would contract
    the edge functions into FMAs.
  * render_shadow_map: the same coverage as that kernel on the JAX light
    pass's geometry (op by op in this process), depths within 1e-5 and
    over 97% bit-equal: the light camera's 4×4 products in build_draw_rows
    round differently in PyTorch's CPU matmul than in XLA's dot (ulps in
    a few draw-row entries), which moves the planes by ulps. Its indexed
    path (the skinned frames' light pass) is bit-equal to the JAX indexed
    light pass (vertex stage, setup and kernel) run whole in the child:
    without FMAs the clip coordinates agree bit for bit
    (tests/test_torch_skinning.py).
  * the depth-only pass against the colour pass on the same bins:
    bit-equal depths.
  * taps: bit-equal to shadow_tap_bits (interpreted), −1 indices and the
    map's edges included.
  * shadow_factor: the JAX function runs op by op here, but its HIGHEST
    f32 light-space product and PyTorch's CPU matmul round differently,
    so a pixel may take another tap index or flip its compare. A hard
    factor may differ only where the compare sits on the bias
    (|test_depth − tap| ≤ 1e-6) or a tap index sits on a texel boundary
    (u·S or v·S within 1e-4 of an integer); a PCF factor beyond 1e-4 only
    there too (its lerp weights inherit that rounding, scaled by S: about
    3e-5 at S = 512); fewer than 0.1% of the pixels may differ at all.
Run as a script, this file is the child: `python test_torch_shadow.py
OUT.npz [NAME SETUP.npz WIDTH HEIGHT]...` runs the depth-only kernel on
each setup.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.ecs.components import (
    LightComponent,
    MeshComponent,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.ecs.registry import Registry
from trident_tpu.geometry.primitives import PrimitiveType
from trident_tpu.io.image import checkerboard
from trident_tpu.ops import shadow as jshadow
from trident_tpu.ops import shadow_pallas as jsp
from trident_tpu.ops.raster_pallas import untile_frame, visibility_pallas_tiled
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup
from trident_tpu.render.renderer import Renderer as JRenderer
from trident_tpu.render.types import ShadowParams as JShadowParams

from trident_tpu_torch import _build
from trident_tpu_torch.ops import raster, shadow, shadow_taps
from trident_tpu_torch.render.types import ShadowParams, from_numpy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAP = 256
DEPTH_W, DEPTH_H = 256, 64


def _grid_scene():
    """A 3×3 sphere grid before a backdrop slab, lit by a shadow-casting
    sun (bench.py's shadows1080 layout, scaled down), on the JAX package."""
    r = JRenderer(EngineConfig(render=RenderConfig(
        width=128, height=128, use_pallas=True, shadows=True,
        shadow_map_size=MAP)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    sphere = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(3):
        for j in range(3):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - 1.5) * 1.4, (j - 1.5) * 1.4, 0],
                                  np.float32)
            t.rotation = np.array([10.0, 25.0 + 7.0 * i, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=sphere))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    back = reg.create()
    bt = reg.add(back, TransformComponent())
    bt.position = np.array([0.0, 0.0, -2.0], np.float32)
    bt.scale = np.array([4.2, 4.2, 0.2], np.float32)
    reg.add(back, MeshComponent(mesh_index=r.ensure_primitive(
        PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(direction=np.array([0.35, -0.3, -1.0],
                                                   np.float32),
                                intensity=2.5, cast_shadows=True))
    r.editor_camera.set_position([0, 0, 5.3])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def _jax_light_inputs(r):
    """(records, packed, plan, tri_draw, params, corner_t, light camera)
    of the JAX scene `r`, as the JAX Renderer builds them."""
    from trident_tpu.render.frame import build_draw_params, gather_mesh_draws

    packed = r.geometry.packed()
    records = gather_mesh_draws(r.registry, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    params, _pal, _shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    (_e, (lc,)), = [v for v in r.registry.view(LightComponent)]
    cam = jshadow.light_camera(lc.direction,
                               *jshadow.scene_bounds(records, packed))
    return (records, packed, plan, tri_draw, params,
            r._plan_cache.corner_table(packed), cam)


def _depth_setup():
    """A seeded random scene (test_torch_raster.py's kind) for the
    depth-only kernel: the JAX TriangleSetup and the port's copy."""
    from test_torch_raster import _random_scene

    (js, ps), _w = _random_scene(np.random.default_rng(2024), t=300)
    return js, ps


def _light_setup():
    """The JAX light pass's triangle setup of _grid_scene(), op by op (the
    corner path of render_shadow_map)."""
    from trident_tpu.ops.corner import build_draw_rows, corner_stage

    _rec, _pk, plan, tri_draw, params, corner_t, cam = _jax_light_inputs(
        _grid_scene())
    with jax.disable_jit():
        rows = build_draw_rows(params, cam, MAP, MAP)
        return corner_stage(corner_t, rows, tri_draw, plan.tri_valid, MAP,
                            MAP).setup


def _indexed_light_inputs():
    """The JAX indexed light pass's inputs for _grid_scene() (what
    render_shadow_map takes without a corner table: the vertex stage at
    the light camera, then triangle_setup), as arrays named for the
    child."""
    from trident_tpu.render.frame import geometry_to_device

    _rec, packed, plan, _td, params, _ct, cam = _jax_light_inputs(
        _grid_scene())
    arrays = {}
    for name, nt in (("geo", geometry_to_device(packed)), ("plan", plan),
                     ("params", params), ("cam", cam)):
        arrays.update({f"{name}_{f}": np.asarray(v)
                       for f, v in nt._asdict().items()
                       if not isinstance(v, int)})
    return arrays


@pytest.fixture(scope="module")
def child_out(tmp_path_factory):
    """The JAX depth-only kernel, run without FMAs (see the module note),
    on _depth_setup() and on the light pass's setup → their depth images."""
    tmp = tmp_path_factory.mktemp("shadow_child")
    args = [str(tmp / "out.npz")]
    for name, (js, w, h) in {
            "depth_only": (_depth_setup()[0], DEPTH_W, DEPTH_H),
            "shadow_map": (_light_setup(), MAP, MAP),
            "indexed_map": (_indexed_light_inputs(), MAP, MAP)}.items():
        np.savez(tmp / f"{name}.npz",
                 **(js if isinstance(js, dict) else
                    {f: np.asarray(getattr(js, f)) for f in js._fields}))
        args += [name, str(tmp / f"{name}.npz"), str(w), str(h)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(args[0])


def test_light_camera_and_bounds_bitwise():
    from test_torch_host import carry_renderer
    from trident_tpu_torch.render.frame import gather_mesh_draws

    jr = _grid_scene()
    records, packed, *_rest, jcam = _jax_light_inputs(jr)
    tr = carry_renderer(jr)
    precords = gather_mesh_draws(tr.registry, tr.geometry)
    ppacked = tr.geometry.packed()
    jc, jrad = jshadow.scene_bounds(records, packed)
    boxes = {}
    for _ in range(2):                      # cold, then from the bbox cache
        pc, prad = shadow.scene_bounds(precords, ppacked, boxes)
        assert pc.dtype == jc.dtype and (pc == jc).all() and prad == jrad
    assert sorted(boxes) == [0, 1]
    pcam = shadow.light_camera(np.array([0.35, -0.3, -1.0], np.float32),
                               pc, prad)
    for f in jcam._fields:
        a, b = np.asarray(getattr(jcam, f)), getattr(pcam, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # a light straight down takes the other up vector
    for d in ([0.0, -1.0, 0.0], [0.1, 0.2, -1.0]):
        a = jshadow.light_camera(np.array(d, np.float32), jc, 3.0)
        b = shadow.light_camera(np.array(d, np.float32), jc, 3.0)
        assert all(np.asarray(x).tobytes() == y.tobytes()
                   for x, y in zip(a, b))
    (pc, prad), (jc, jrad) = (shadow.scene_bounds([], ppacked),
                              jshadow.scene_bounds([], packed))
    assert (pc == jc).all() and prad == jrad == 1.0


def test_depth_only_plain_matches_pallas_and_colour_pass(child_out):
    js, ps = _depth_setup()
    ntx, nty = -(-DEPTH_W // raster.TILE), -(-DEPTH_H // raster.TILE)
    bins = raster.build_bins(ps, DEPTH_W, DEPTH_H)
    assert bins.aux.tolist() == [0, 0]
    depth = raster.visibility_tiles(bins, ntx, ntx * nty, depth_only=True)
    colour_depth, tri = raster.visibility_tiles(bins, ntx, ntx * nty)
    assert int((tri >= 0).sum()) > 500
    assert (depth == colour_depth).all()                   # ±0 equal
    assert (depth[tri < 0] == 1.0).all()
    img = raster.untile_frame(depth, ntx, nty)[:DEPTH_H, :DEPTH_W].numpy()
    pal = child_out["depth_only"]
    assert pal.shape == img.shape
    assert (img == pal).all()


def test_render_shadow_map_matches_jax(child_out):
    from test_torch_host import carry_renderer

    jr = _grid_scene()
    tr = carry_renderer(jr)
    inp = tr.frame_inputs()
    assert inp["shadow_size"] == MAP and inp["draw_stride"] == 0
    depth, aux = shadow.render_shadow_map(
        inp["plan"], inp["params"], inp["light_camera"], MAP,
        corner_t=inp["corner_t"], tri_draw=inp["tri_draw"])
    assert aux.tolist() == [0, 0]
    ref = child_out["shadow_map"]
    assert depth.shape == ref.shape == (MAP, MAP)
    d = depth.numpy()
    assert (d < 1.0).mean() > 0.2                           # it saw the scene
    assert ((d < 1.0) == (ref < 1.0)).all()                 # same coverage
    assert np.abs(d - ref).max() <= 1e-5
    assert (d == ref).mean() > 0.97
    # the indexed light pass (the skinned frames' path: vertex stage at the
    # light camera, triangle setup, the depth-only kernel) against the JAX
    # indexed light pass run whole in the child: bit-equal
    from trident_tpu_torch.render.frame import geometry_to_device

    depth, aux = shadow.render_shadow_map(
        inp["plan"], inp["params"], inp["light_camera"], MAP, corner_t=None,
        tri_draw=inp["tri_draw"],
        geometry=geometry_to_device(tr.geometry.packed(), "cpu"),
        palette=torch.eye(4)[None])
    assert aux.tolist() == [0, 0]
    ref = child_out["indexed_map"]
    d = depth.numpy()
    assert (d < 1.0).mean() > 0.2
    assert d.tobytes() == ref.tobytes()


def _tap_inputs(rng, s, h=40, w=300):
    """Seeded tap indices: uniform over the map with the edges 0 and s−1
    over-represented, y1 = min(y0+1, s−1) (the caller's clipping), and −1
    on every index of ~20% of the pixels."""
    y0 = rng.integers(0, s, (h, w)).astype(np.int32)
    x0 = rng.integers(0, s, (h, w)).astype(np.int32)
    y0[rng.random((h, w)) < 0.05] = s - 1
    x0[rng.random((h, w)) < 0.05] = 0
    x0[:, -3:] = s - 1
    y1 = np.minimum(y0 + 1, s - 1).astype(np.int32)
    x1 = np.minimum(x0 + 1, s - 1).astype(np.int32)
    off = rng.random((h, w)) < 0.2
    return [np.where(off, -1, a).astype(np.int32) for a in (y0, x0, y1, x1)]


@pytest.mark.parametrize("ntaps", [1, 4])
def test_plain_taps_match_pallas(ntaps):
    rng = np.random.default_rng(41 + ntaps)
    s = jsp.CW
    dmap = rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)
    dmap[rng.random((s, s)) < 0.1] = 1.0
    idx = _tap_inputs(rng, s)
    if ntaps == 1:
        idx = idx[:2]
    want = np.asarray(jsp.shadow_tap_bits(
        jsp.build_shadow_chunks(jnp.asarray(dmap)),
        *[jnp.asarray(a) for a in idx], interpret=True))
    before = dict(_build.LAUNCHES)
    got = shadow_taps.shadow_tap_bits(torch.from_numpy(dmap),
                                      *[torch.from_numpy(a) for a in idx])
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert (got.numpy() == want).all()
    assert (got.numpy()[idx[0] < 0] == 0).all()
    assert dict(_build.LAUNCHES) == before   # CPU: the plain version


def _factor_inputs(rng, s, h=48, w=96):
    """A seeded light-space scene: a smooth depth map with a step, and
    world points whose light-space depth lies near the map (some in front,
    some behind, a few outside the frustum), seen through the light camera
    of a unit-ish scene."""
    cam = jshadow.light_camera(np.array([0.35, -0.3, -1.0], np.float32),
                               np.array([0.1, -0.2, 0.0], np.float32), 2.5)
    vp = (cam.proj @ cam.view).astype(np.float32)
    yy, xx = np.mgrid[0:s, 0:s] / s
    dmap = (0.45 + 0.2 * np.sin(5 * xx) * np.cos(3 * yy)
            + 0.15 * (xx > 0.6)).astype(np.float32)
    u = rng.uniform(-0.05, 1.05, (h, w))
    v = rng.uniform(-0.05, 1.05, (h, w))
    ui = np.clip((u * s).astype(int), 0, s - 1)
    vi = np.clip((v * s).astype(int), 0, s - 1)
    z = dmap[vi, ui] + rng.normal(0.0, 0.01, (h, w))
    ndc = np.stack([u * 2 - 1, v * 2 - 1, z, np.ones_like(z)], -1)
    world_h = ndc @ np.linalg.inv(vp.astype(np.float64)).T
    world = (world_h[..., :3] / world_h[..., 3:]).astype(np.float32)
    return dmap, vp, world


def _classify_factor(port, ref, shadow_p, world, pcf):
    """Count factor mismatches; assert each sits on a compare or texel
    boundary (see the module note)."""
    s = shadow_p.depth.shape[0]
    pos_h = torch.cat([world, torch.ones_like(world[..., :1])], -1)
    clip = pos_h @ shadow_p.light_vp.T
    ndc = clip[..., :3] / clip[..., 3:4]
    us, vs = (ndc[..., 0] + 1) * 0.5 * s, (ndc[..., 1] + 1) * 0.5 * s
    test = ndc[..., 2] - shadow_p.bias
    dmap = shadow_p.depth
    tol = 1e-4 if pcf else 0.0
    bad = np.abs(port - ref) > tol
    ys, xs = np.nonzero(bad)
    for y, x in zip(ys, xs):
        fx, fy = float(us[y, x]), float(vs[y, x])
        if pcf:
            fx, fy = fx - 0.5, fy - 0.5
        on_texel = min(abs(fx - round(fx)), abs(fy - round(fy))) < 1e-4
        xi0, yi0 = int(np.floor(fx)), int(np.floor(fy))
        near = [float(dmap[min(max(yi, 0), s - 1), min(max(xi, 0), s - 1)])
                for yi in (yi0, yi0 + 1) for xi in (xi0, xi0 + 1)]
        on_bias = min(abs(float(test[y, x]) - d) for d in near) <= 1e-6
        assert on_texel or on_bias, (y, x, port[y, x], ref[y, x])
    return int(bad.sum())


@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("pcf", [False, True], ids=["hard", "pcf"])
def test_shadow_factor_matches_jax(s, pcf):
    rng = np.random.default_rng(s + pcf)
    dmap, vp, world = _factor_inputs(rng, s)
    jp = JShadowParams(depth=jnp.asarray(dmap), light_vp=jnp.asarray(vp),
                       enabled=jnp.asarray(True),
                       bias=jnp.asarray(2e-3, jnp.float32))
    assert jsp.SHADOW_MXU and jsp.supported(s)     # JAX takes its kernel
    ref = np.asarray(jshadow.shadow_factor(jp, jnp.asarray(world), pcf=pcf))
    pp = from_numpy(jp, "cpu")
    assert isinstance(pp, ShadowParams)
    port = shadow.shadow_factor(pp, torch.from_numpy(world), pcf=pcf).numpy()
    assert port.shape == ref.shape == (*world.shape[:2], 1)
    lit = port[..., 0]
    assert 0.1 < (lit < 1).mean() < 0.9                 # both sides occur
    n_bad = _classify_factor(port[..., 0], ref[..., 0], pp,
                             torch.from_numpy(world), pcf)
    assert n_bad < 0.001 * lit.size + 1, n_bad
    # disabled → all lit
    off = pp._replace(enabled=torch.tensor(False))
    assert (shadow.shadow_factor(off, torch.from_numpy(world), pcf=pcf)
            == 1.0).all()


def _child_indexed_setup(arrays, w: int, h: int):
    """The JAX indexed light pass's setup (vertex_stage at the light
    camera, triangle_setup, under jit) from _indexed_light_inputs()."""
    from trident_tpu.ops.vertex import triangle_setup, vertex_stage
    from trident_tpu.render.types import (
        CameraParams,
        DrawParams,
        DrawPlan,
        GeometryBuffers,
    )

    def nt(cls, name, **extra):
        return cls(**{f: jnp.asarray(arrays[f"{name}_{f}"])
                      for f in cls._fields if f"{name}_{f}" in arrays},
                   **extra)

    geo, params, cam = (nt(GeometryBuffers, "geo"), nt(DrawParams, "params"),
                        nt(CameraParams, "cam"))
    plan = nt(DrawPlan, "plan", num_draws=0)

    def setup(geo, plan, params, cam):
        verts = vertex_stage(geo, plan, params, cam,
                             jnp.eye(4, dtype=jnp.float32)[None],
                             skinned=False)
        return triangle_setup(verts.clip, plan.tri_vtx, plan.tri_valid, w,
                              h)

    return jax.jit(setup)(geo, plan, params, cam)


if __name__ == "__main__":
    out_npz, *jobs = sys.argv[1:]
    results = {}
    for i in range(0, len(jobs), 4):
        name, setup_npz, w, h = jobs[i:i + 4]
        w, h = int(w), int(h)
        arrays = np.load(setup_npz)
        if "geo_attr_table" in arrays:      # the indexed light pass
            setup = _child_indexed_setup(arrays, w, h)
        else:
            setup = JTriangleSetup(**{f: jnp.asarray(arrays[f])
                                      for f in JTriangleSetup._fields})
        _b, depth_t, _t, _w = jax.jit(lambda st: visibility_pallas_tiled(
            st, w, h, interpret=True, depth_only=True))(setup)
        results[name] = np.asarray(
            untile_frame(depth_t, -(-w // 32), -(-h // 32)))[:h, :w]
    np.savez(out_npz, **results)
