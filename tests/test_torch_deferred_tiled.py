"""The port's tiled (channel-planar) shading against the JAX package's
`shade_attrs_tiled` on the same inputs, and the planar texel fetch.

Inputs: test_torch_shadow.py's shadowed 3×3 sphere grid at 128² with a
point lamp added, as the JAX package computes them under one jit — the
light pass's 256² map, the winners and depths in tile layout, and the
tiled resolve's (n_tiles, 16, 1024) attributes — then read as numpy and
handed to both sides. The JAX function runs op by op (its texel kernel
interpreted), so every elementwise op rounds once, as in PyTorch.

Tolerances, each with its reason: the two sides take 4×4 products and
the inverse of proj·view through different libraries (PyTorch's CPU
matmul and LAPACK against XLA's dot and its LU), and rsqrt, pow and
sqrt through different approximations, so world positions, normals and
the lighting terms differ by ulps. Every RGB value agrees within 5e-6
absolute where the shadow factor agrees (2.5e-6 measured, in all three
modes); a shadow tap whose compare sits on the bias (or, with PCF, a lerp
weight on a texel boundary) may flip, which moves the lit value further,
and fewer than 0.2% of the pixels may do so (none did here). Alpha is a
product of exact inputs and is bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trident_tpu.ecs.components import LightComponent, LightType
from trident_tpu.ecs.components import TransformComponent
from trident_tpu.ops import deferred_tiled as jdt
from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import raster_pallas as jrp
from trident_tpu.ops import resolve_pallas as jrsp
from trident_tpu.ops import shadow as jshadow
from trident_tpu.ops import texel_pallas as jtp
from trident_tpu.ops.corner import build_draw_rows, corner_stage
from trident_tpu.render.lights import gather_lights
from trident_tpu.render.types import ShadowParams as JShadowParams

from trident_tpu_torch.ops import deferred_tiled, texel
from trident_tpu_torch.render.types import from_numpy

from test_torch_shadow import MAP, _grid_scene, _jax_light_inputs

torch.set_num_threads(1)

W = H = 128
RGB_TOL = 5e-6
FLIP_FRAC = 0.002


@pytest.fixture(scope="module")
def inputs():
    """(JAX inputs, port inputs) of the tiled shading stage: tri and depth
    (n_tiles, 1024), attrs (n_tiles, 16, 1024), textures, camera, lights
    and the light pass's ShadowParams."""
    from trident_tpu.render.frame import build_draw_params

    r = _grid_scene()
    records, packed, plan, tri_draw, params, corner_t, lcam = \
        _jax_light_inputs(r)
    lamp = r.registry.create()
    lt = r.registry.add(lamp, TransformComponent())
    lt.position = np.array([1.5, 1.0, 2.5], np.float32)
    r.registry.add(lamp, LightComponent(
        light_type=LightType.POINT, color=np.array([1.0, 0.8, 0.6],
                                                   np.float32),
        intensity=3.0, range=8.0))
    params, _pal, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    r.editor_camera.set_viewport_size(W, H)
    cam = r.editor_camera.params()
    tex = r.textures.device_arrays()

    def run(params, shade, cam, lcam, corner_t, tri_draw, valid, sizes):
        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        rows = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        cs = corner_stage(corner_t, rows, tri_draw, valid, W, H)
        cols = jplanes.build_resolve_cols_planar(cs.cols)
        bins, depth_t, tri_t, _w = jrp.visibility_pallas_tiled(
            cs.setup, W, H, interpret=True, setup_cols=cs.cols.setup)
        attrs_t = jrsp.resolve_attrs_pallas(
            bins, tri_t, jplanes.chunk_resolve_cols(cols, jrp.CHUNK), W, H,
            interpret=True, tiled=True)
        dmap = jshadow.render_shadow_map(
            None, plan, params, lcam, None, MAP, False, corner_t=corner_t,
            tri_draw=tri_draw)
        return tri_t[:, 0], depth_t[:, 0], attrs_t, dmap

    tri_t, depth_t, attrs_t, dmap = [np.array(a) for a in jax.jit(run)(
        params, shade, cam, lcam, r._plan_cache.corner_table(packed),
        tri_draw, plan.tri_valid, tex.sizes)]
    vp = np.asarray(jnp.matmul(lcam.proj, lcam.view,
                               precision=jax.lax.Precision.HIGHEST))
    jshadow_p = JShadowParams(depth=jnp.asarray(dmap), light_vp=jnp.asarray(vp),
                              enabled=jnp.asarray(True),
                              bias=jnp.asarray(2e-3, jnp.float32))
    lights = gather_lights(r.registry)
    assert int(lights.point_count) == 1 and int(lights.dir_count) == 1
    jin = dict(tri=jnp.asarray(tri_t), depth=jnp.asarray(depth_t),
               attrs=jnp.asarray(attrs_t), textures=tex, camera=cam,
               lights=lights, shadow=jshadow_p)
    pin = dict(tri=torch.from_numpy(tri_t), depth=torch.from_numpy(depth_t),
               attrs=torch.from_numpy(attrs_t),
               textures=from_numpy(tex, "cpu"), camera=from_numpy(cam, "cpu"),
               lights=from_numpy(lights, "cpu"),
               shadow=from_numpy(jshadow_p, "cpu"))
    return jin, pin


def _shade(fn, a, shadow, pcf, tri_layout):
    return fn(tri_layout(a["tri"]), tri_layout(a["depth"]), a["attrs"],
              a["textures"], a["camera"], a["lights"], W, H,
              shadow=a["shadow"] if shadow else None, shadow_pcf=pcf)


def _spy(monkeypatch, module, seen, key):
    """Record the shadow factor `module`'s shade_attrs_tiled computes."""
    real = module._shadow_factor_planar

    def spy(*args):
        seen[key] = real(*args)
        return seen[key]

    monkeypatch.setattr(module, "_shadow_factor_planar", spy)


@pytest.mark.parametrize("mode", ["unshadowed", "hard", "pcf"])
def test_shade_attrs_tiled_matches_jax(inputs, mode, monkeypatch):
    jin, pin = inputs
    shadow, pcf = mode != "unshadowed", mode == "pcf"
    seen = {}
    _spy(monkeypatch, jdt, seen, "jax")
    _spy(monkeypatch, deferred_tiled, seen, "port")
    with jax.disable_jit():
        ref = np.asarray(_shade(
            lambda *a, **k: jdt.shade_attrs_tiled(*a, interpret=True, **k),
            jin, shadow, pcf, lambda x: x[:, None, :]))
    port = _shade(deferred_tiled.shade_attrs_tiled, pin, shadow, pcf,
                  lambda x: x).numpy()
    assert port.shape == ref.shape == (16, 4, 1024)
    covered = pin["tri"].numpy() >= 0
    assert covered.sum() > 3000
    # alpha: exact
    assert (port[:, 3].view(np.int32) == ref[:, 3].view(np.int32)).all()
    err = np.abs(port[:, :3] - ref[:, :3]).max(axis=1)        # (nt, 1024)
    off = err > RGB_TOL
    assert off.sum() <= FLIP_FRAC * covered.sum(), (off.sum(), err.max())
    if not shadow:
        assert not off.any() and not seen, err.max()
        return
    # every value past the tolerance is a shadow factor that differs
    jf, pf = np.asarray(seen["jax"]), seen["port"].numpy()
    assert (np.abs(jf - pf)[off] > 1e-4).all()
    assert (pf < 1.0)[covered].mean() > 0.05              # shadows are there


def test_planar_texel_matches_flat_and_jax_kernel():
    """The planar fetch is K3's fetch with channels in front (bit-equal),
    and within 4 ulps of the JAX tiled texel kernel (interpreted, jitted:
    XLA:CPU contracts its lerps into FMAs, as test_torch_texel.py
    states)."""
    from test_torch_texel import _fetch_inputs

    jt, pt, idx, fx, fy, _flat = _fetch_inputs()
    n = idx.size // 1024 * 1024
    planes = [a.reshape(-1)[:n].reshape(-1, 1024) for a in (idx, fx, fy)]
    ti, tx, ty = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
    got = texel.sample_bilinear_planar(pt.quads, ti, tx, ty).numpy()
    flat = texel.sample_bilinear(pt.quads, ti, tx, ty).numpy()
    assert got.shape == (n // 1024, 4, 1024)
    assert (got.view(np.int32) == flat.transpose(0, 2, 1).view(np.int32)).all()
    assert (got.transpose(0, 2, 1)[planes[0] < 0] == 0).all()
    table = jtp.build_texel_table(jnp.asarray(jt.quads))
    ref = np.asarray(jax.jit(lambda i, a, b: jtp.sample_bilinear_mxu_tiled(
        table, i, a, b, interpret=True))(*planes))
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)).astype(np.float32))
    assert (np.abs(ref - got) <= 4 * ulp).all()
    assert texel.sample_bilinear_planar.launches == 0   # CPU: the plain one
