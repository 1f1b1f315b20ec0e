"""The plane-gather path's modules against the JAX package: the attribute
planes (build_planes_corners; f32, f16 and with vertex colours),
deferred_shade on a given G-buffer and planes, and the indexed path's
(T, 32 | 40) resolve records (build_resolve_cols after the vertex stage's
one corner gather).

The scene is the `_base` golden-flavor scene at 128² with the vertex-
coloured cube (tests/test_torch_frame.py::jax_feature_renderer("vcolor")),
its JAX geometry evaluated op by op and carried across with from_numpy.

Tolerances, each with its reason:
  * the plane tables, f32 and f16: bit-equal. Both sides run the same
    elementwise chains in the same association, op by op on both sides,
    and the f16 rounding is to nearest even on both.
  * deferred_shade: the RGBA f32 frame within 2e-5 per value (XLA's and
    PyTorch's pow, log2 and rsqrt differ by an ulp or two, which the
    tonemap's pow(·, 1/2.2) can grow a little), identical texel indices
    where the mip does not sit on a level boundary; the RGBA8 frame
    under the golden gate of test_golden_flavors.py.
  * the indexed records: bit-equal to build_resolve_cols on the same
    gathered corners; from the port's own vertex stage within 1e-6 ·
    (1 + |value|) (its normals round by ulps, tests/test_torch_skinning.py).
"""

import numpy as np
import pytest
import torch

import jax

from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import vertex as jvertex
from trident_tpu.ops.corner import build_draw_rows, corner_stage
from trident_tpu.ops.deferred import deferred_shade as j_deferred_shade
from trident_tpu.ops.raster_ref import visibility_ref as j_visibility_ref
from trident_tpu.render.frame import build_draw_params, gather_mesh_draws
from trident_tpu.render.frame import geometry_to_device as j_geometry
from trident_tpu.render.lights import gather_lights

from trident_tpu_torch.ops import planes as pplanes
from trident_tpu_torch.ops.corner import indexed_corner_stage
from trident_tpu_torch.ops.deferred import deferred_shade
from trident_tpu_torch.render.renderer import frame_geometry
from trident_tpu_torch.render.types import GBuffer, from_numpy

from test_torch_frame import _assert_golden_gate, jax_feature_renderer

torch.set_num_threads(1)

W = H = 128
SHADE_TOL = 2e-5
ROW_TOL = 2e-6


def _scene(name="vcolor", **render_kw):
    """(JAX Renderer, its numpy frame inputs) of feature flavor `name`."""
    jr = jax_feature_renderer(name, **render_kw)
    jr.editor_camera.set_viewport_size(W, H)
    packed = jr.geometry.packed()
    records = gather_mesh_draws(jr.registry, jr.geometry)
    plan, tri_draw = jr._plan_cache.plan(packed, records, jr.geometry.version)
    params, palette, shade = build_draw_params(
        records, plan.num_draws, material_table=jr.geometry.material_table())
    return jr, dict(packed=packed, plan=plan, tri_draw=tri_draw,
                    params=params, palette=palette, shade=shade,
                    camera=jr.editor_camera.params(),
                    corner_t=jr._plan_cache.corner_table(packed))


def _jax_planes(inp, f16: bool, vcolor: bool):
    """The JAX corner stage and planes of the scene, op by op."""
    with jax.disable_jit():
        rows = build_draw_rows(inp["params"], inp["camera"], W, H)
        cs = corner_stage(inp["corner_t"], rows, inp["tri_draw"],
                          inp["plan"].tri_valid, W, H,
                          vertex_colors=vcolor)
        planes = jplanes.build_planes_corners(
            cs.setup, cs.corner_nrm, cs.corner_uv, inp["tri_draw"],
            inp["shade"], corner_col=cs.corner_col, f16=f16)
    return cs, planes


def _port_planes(cs, inp, f16: bool):
    return pplanes.build_planes_cols(
        from_numpy(cs.cols, "cpu"), torch.from_numpy(np.asarray(
            cs.setup.bbox)), torch.from_numpy(np.asarray(inp["tri_draw"])),
        torch.from_numpy(np.asarray(inp["shade"])), f16=f16)


PLANE_CASES = {"f32": (False, False), "f16": (True, False),
               "f32_vcolor": (False, True), "f16_vcolor": (True, True)}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_planes_bitwise_vs_jax(case):
    f16, vcolor = PLANE_CASES[case]
    _jr, inp = _scene()
    cs, jp = _jax_planes(inp, f16, vcolor)
    pp = _port_planes(cs, inp, f16)
    dtype = torch.float16 if f16 else torch.float32
    for f in ("table_a", "table_b", "table_c"):
        j, p = getattr(jp, f), getattr(pp, f)
        if f == "table_c" and not vcolor:
            assert j is None and p is None
            continue
        j = np.asarray(j)
        assert p.dtype == dtype and tuple(p.shape) == j.shape
        assert p.numpy().tobytes() == j.tobytes(), f
    anchors = pp.table_b[:, 11:13].float()
    if f16:   # the 16-px-snapped bbox corner, exact in f16
        bbox = np.asarray(cs.setup.bbox)[:, :2]
        assert (anchors.numpy() == bbox // 16 * 16).all()
        assert float(anchors.max()) > 0
    else:
        assert (anchors == 0).all()


DEFERRED_CASES = {"f32": dict(f16=False), "f16": dict(f16=True),
                  "f16_vcolor": dict(f16=True, vcolor=True),
                  "trilinear": dict(f16=True, name="trilinear",
                                    sampling="trilinear"),
                  "nearest": dict(f16=False, name="nearest",
                                  sampling="nearest")}


@pytest.mark.parametrize("case", sorted(DEFERRED_CASES))
def test_deferred_shade_matches_jax(case):
    """deferred_shade on the same G-buffer (the JAX reference raster's)
    and planes as the JAX function, op by op."""
    c = DEFERRED_CASES[case]
    name, sampling = c.get("name", "vcolor"), c.get("sampling", "bilinear")
    jr, inp = _scene(name)
    cs, jp = _jax_planes(inp, c["f16"], c.get("vcolor", False))
    textures = jr.textures.device_arrays()
    lights = gather_lights(jr.registry)
    with jax.disable_jit():
        jg = j_visibility_ref(cs.setup, W, H)
        jframe = j_deferred_shade(jg, jp, textures, inp["camera"], lights, W,
                                  H, sampling=sampling)
    gbuf = GBuffer(tri_id=torch.from_numpy(np.asarray(jg.tri_id)),
                   depth=torch.from_numpy(np.asarray(jg.depth)))
    assert int((gbuf.tri_id >= 0).sum()) > 5000
    pframe = deferred_shade(gbuf, _port_planes(cs, inp, c["f16"]),
                            from_numpy(textures, "cpu"),
                            from_numpy(inp["camera"], "cpu"),
                            from_numpy(lights, "cpu"), W, H,
                            sampling=sampling)
    j = np.asarray(jframe)
    assert pframe.shape == (H, W, 4)
    assert np.abs(pframe.numpy() - j).max() <= SHADE_TOL
    _assert_golden_gate(np.round(pframe.numpy() * 255).astype(np.uint8),
                        np.round(j * 255).astype(np.uint8))


@pytest.mark.parametrize("vcolor", [False, True], ids=["rows32", "rows40"])
def test_indexed_records_match_jax(vcolor):
    """The indexed path's records (vertex stage → one (T, 3, 16) corner
    gather → setup → rows): bit-equal to the JAX build_resolve_cols on the
    same gathered corners, and from the port's own vertex stage within
    ROW_TOL of each row's scale."""
    jr, inp = _scene()
    geometry = j_geometry(inp["packed"])
    plan, tri_draw = inp["plan"], inp["tri_draw"]
    textures = jr.textures.device_arrays()
    draw_consts = np.concatenate(
        [np.asarray(inp["shade"]),
         np.asarray(textures.sizes)[np.asarray(inp["params"].texture_slot)]
         .astype(np.float32)], axis=1)
    with jax.disable_jit():
        verts = jvertex.vertex_stage(geometry, plan, inp["params"],
                                     inp["camera"], inp["palette"],
                                     skinned=False)
        corners = verts.packed[plan.tri_vtx]
        setup = jvertex.triangle_setup(corners[..., 0:4], None,
                                       plan.tri_valid, W, H)
        cols = jplanes.build_resolve_cols(
            setup, corners[..., 4:7], corners[..., 7:9], tri_draw,
            draw_consts, corners[..., 9:12] if vcolor else None)
    ref = pplanes.records_from_reference(np.asarray(cols))
    width = pplanes.RR_WIDTH_VCOLOR if vcolor else pplanes.RR_WIDTH
    assert tuple(ref.shape) == (plan.tri_vtx.shape[0], width)
    t_draw = torch.from_numpy(np.asarray(tri_draw))
    cs = indexed_corner_stage(
        torch.from_numpy(np.asarray(verts.packed)),
        torch.from_numpy(np.asarray(plan.tri_vtx)),
        torch.from_numpy(np.asarray(plan.tri_valid)), W, H,
        consts=torch.from_numpy(draw_consts)[t_draw.long()],
        vertex_colors=vcolor)
    rows = pplanes.build_resolve_cols_planar(cs.cols)
    assert rows.numpy().tobytes() == ref.numpy().tobytes()
    for f in ("edge", "z", "w", "bbox", "valid"):
        assert (getattr(cs.setup, f).numpy()
                == np.asarray(getattr(setup, f))).all(), f
    _cs, own = frame_geometry(
        from_numpy(plan, "cpu"), t_draw, from_numpy(inp["params"], "cpu"),
        torch.from_numpy(np.asarray(inp["shade"])),
        from_numpy(inp["camera"], "cpu"), from_numpy(textures, "cpu"), None,
        width=W, height=H, vertex_colors=vcolor,
        geometry=from_numpy(geometry, "cpu"),
        palette=torch.from_numpy(np.asarray(inp["palette"])))
    assert own.shape == ref.shape
    o, r = own.numpy(), ref.numpy()
    scale = 1.0 + np.abs(r).max(1, keepdims=True)
    assert (np.abs(o - r) <= ROW_TOL * scale).all()
