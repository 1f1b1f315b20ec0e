"""Vertex colours through the port: the corner stage's colour columns, the
(T, 40) resolve records, the three 40-wide resolve instances (their plain
versions on the CPU) against the JAX package's Pallas kernels with
`vertex_colors=True` (interpret mode), and vertex-coloured frames through
the port's Renderer against the JAX frames.

The kernel-level scene is test_torch_resolve.py's 3×3 sphere grid at 128²
with per-vertex colours 0.5 + 0.5·n on the sphere. Tolerances, as in
test_torch_resolve.py: in this process XLA:CPU contracts the plane
evaluations into FMAs, so the plane channels (normal, UV and now the
vertex-coloured colour factor, channels 6–8) agree to 5e-5 relative to
max(1, |value|), the mip level to 1e-4, and the copied channels (alpha,
material, texture geometry) exactly; in a child process whose XLA:CPU may
not emit FMAs (--xla_cpu_max_isa=AVX) every channel is bit-equal except
the mip level (one ulp: XLA's log2 against PyTorch's). Frames are held to
the golden gate of test_golden_flavors.py (< 0.2% of RGBA8 values off by
> 3 LSB, mean < 0.35).

Run as a script, this file is the child: `python test_torch_vcolor.py
OUT.npz` writes the JAX side's records, winners and attributes.
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
from trident_tpu.ecs import (
    MeshComponent,
    Registry,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.geometry.primitives import PrimitiveType as JPrimitiveType
from trident_tpu.geometry.primitives import build_primitive as j_build
from trident_tpu.io.image import checkerboard
from trident_tpu.ops import planes as jplanes
from trident_tpu.ops import raster_pallas as jrp
from trident_tpu.ops import resolve_pallas as jrsp
from trident_tpu.ops.corner import build_draw_rows, corner_stage
from trident_tpu.ops.vertex import TriangleSetup as JTriangleSetup
from trident_tpu.render.frame import build_draw_params, gather_mesh_draws
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.ops import corner as pcorner
from trident_tpu_torch.ops import planes as pplanes
from trident_tpu_torch.ops import raster, resolve
from trident_tpu_torch.render.types import from_numpy
from trident_tpu_torch.tools_dev.scenes import coloured_mesh, feature_scene

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 128
NTX = NTY = W // raster.TILE
PLANE_CHANNELS = [resolve.CH_NX, resolve.CH_NY, resolve.CH_NZ, resolve.CH_U,
                  resolve.CH_V, resolve.CH_CF, resolve.CH_CF + 1,
                  resolve.CH_CF + 2]
COPIED_CHANNELS = list(range(resolve.CH_CF + 3, resolve.CHANNELS))


def _scene_inputs():
    """The JAX Renderer's inputs of the vertex-coloured sphere grid."""
    r = JRenderer(EngineConfig(render=RenderConfig(width=W, height=H,
                                                   use_pallas=True)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh = r.geometry.add_mesh(coloured_mesh(j_build(JPrimitiveType.SPHERE)))
    for i in range(3):
        for j in range(3):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - 1) * 1.4, (j - 1) * 1.4, 0],
                                  np.float32)
            t.rotation = np.array([10.0, 25.0 + 7.0 * i, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    r.editor_camera.set_position([0, 0, 5.2])
    r.editor_camera.look_at_target([0, 0, 0])
    r.editor_camera.set_viewport_size(W, H)
    packed = r.geometry.packed()
    assert (packed.colors != 1.0).any()
    records = gather_mesh_draws(reg, r.geometry)
    plan, tri_draw = r._plan_cache.plan(packed, records, r.geometry.version)
    params, _pal, shade = build_draw_params(
        records, plan.num_draws, material_table=r.geometry.material_table())
    return (params, shade, r.editor_camera.params(),
            r._plan_cache.corner_table(packed), tri_draw, plan.tri_valid,
            r.textures.device_arrays().sizes)


def _jax_vcolor():
    """The JAX side in one jit, vertex_colors=True throughout: the corner
    stage's colour columns, the (40, T) record columns, the winners and the
    resolve pass untiled, tiled and fused → dict of numpy arrays."""
    def run(params, shade, cam, corner_t, tri_draw, valid, sizes):
        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        rows = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        cs = corner_stage(corner_t, rows, tri_draw, valid, W, H,
                          vertex_colors=True)
        cols = jplanes.build_resolve_cols_planar(cs.cols)
        rec = jplanes.chunk_resolve_cols(cols, jrp.CHUNK)
        bins, _d, tri_t, _w = jrp.visibility_pallas_tiled(
            cs.setup, W, H, interpret=True, setup_cols=cs.cols.setup)
        attrs = jrsp.resolve_attrs_pallas(bins, tri_t, rec, W, H,
                                          vertex_colors=True, interpret=True)
        attrs_t = jrsp.resolve_attrs_pallas(bins, tri_t, rec, W, H,
                                            vertex_colors=True,
                                            interpret=True, tiled=True)
        _b, fdepth, ftri, fattrs, _w = jrsp.fused_visibility_resolve_pallas(
            cs.setup, rec, W, H, vertex_colors=True, interpret=True,
            setup_cols=cs.cols.setup)
        tri = jrp.untile_frame(tri_t, NTX, NTY)[:H, :W]
        return (cs.setup, jnp.stack(cs.cols.col), cols, tri, tri_t[:, 0],
                attrs, attrs_t, fdepth[:, 0], ftri[:, 0], fattrs)

    (setup, col, cols, tri, tri_t, attrs, attrs_t, fdepth, ftri,
     fattrs) = jax.jit(run)(*_scene_inputs())
    out = {f"setup_{f}": np.array(getattr(setup, f))
           for f in setup._fields}
    out.update(col=col, cols=cols, tri=tri, tri_t=tri_t, attrs=attrs,
               attrs_t=attrs_t, fdepth=fdepth, ftri=ftri, fattrs=fattrs)
    return {k: np.array(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_side():
    return _jax_vcolor()


def _op_by_op_corner():
    """(JAX corner stage, its (40, T) columns, port corner stage) on the
    same draw rows: the JAX side op by op (no FMA contraction), the port
    fed the JAX draw rows (their 4×4 products round by BLAS order)."""
    params, shade, cam, corner_t, tri_draw, valid, sizes = _scene_inputs()
    with jax.disable_jit():
        tex_row = sizes[params.texture_slot].astype(jnp.float32)
        jdr = build_draw_rows(
            params, cam, W, H,
            draw_consts=jnp.concatenate([shade, tex_row], axis=1))
        jcs = corner_stage(corner_t, jdr, tri_draw, valid, W, H,
                           vertex_colors=True)
        jrec = np.asarray(jplanes.build_resolve_cols_planar(jcs.cols))
    pcs = pcorner.corner_stage(
        torch.from_numpy(np.array(corner_t)), torch.from_numpy(np.array(jdr)),
        torch.from_numpy(np.array(tri_draw)), torch.from_numpy(np.array(valid)),
        W, H, vertex_colors=True)
    return jcs, jrec, pcs


def test_corner_colour_columns_equal_jax():
    """The corner stage's nine colour columns are the corner table's rows
    12k+8 .. 12k+10, bit for bit the JAX corner_stage(vertex_colors=True)'s;
    without vertex_colors there are none."""
    jcs, _jrec, pcs = _op_by_op_corner()
    col = torch.stack(pcs.cols.col).numpy()
    jcol = np.stack([np.asarray(c) for c in jcs.cols.col])
    assert col.shape == jcol.shape and col.shape[0] == 9
    assert (col.view(np.int32) == jcol.view(np.int32)).all()
    assert (col != 1.0).any()
    assert pcs.cols._replace(col=None).col is None


def test_vcolor_record_table_against_jax_columns():
    """The (T, 40) row table: 160-byte rows, column 39 zero, the first 30
    columns the 32-wide table's. From the JAX package's own corner columns
    it is the JAX (40, T) table (records_from_reference) bit for bit; from
    the port's, every column but the normal planes is (the normals carry
    rsqrt's ≤ 2 ulps, test_torch_geometry.py)."""
    jcs, jrec, pcs = _op_by_op_corner()
    assert jrec.shape[0] == pplanes.RR_WIDTH_VCOLOR
    from_jax = pplanes.build_resolve_cols_planar(from_numpy(jcs.cols, "cpu"))
    ref = pplanes.records_from_reference(jrec)
    assert from_jax.shape == ref.shape == (jrec.shape[1],
                                           pplanes.RR_WIDTH_VCOLOR)
    assert (from_jax.numpy().view(np.int32) == ref.numpy().view(np.int32)
            ).all()
    table = pplanes.build_resolve_cols_planar(pcs.cols)
    assert table.is_contiguous() and table.data_ptr() % 16 == 0
    assert (table[:, pplanes.RR_WIDTH_VCOLOR - 1] == 0).all()
    plain = pplanes.build_resolve_cols_planar(pcs.cols._replace(col=None))
    assert plain.shape == (table.shape[0], pplanes.RR_WIDTH)
    assert (table[:, :pplanes.RR_COL] == plain[:, :pplanes.RR_COL]).all()
    got, ref = table.numpy(), ref.numpy()
    nrm = slice(pplanes.RR_NX, pplanes.RR_U)
    keep = np.ones(pplanes.RR_WIDTH_VCOLOR, bool)
    keep[nrm] = False
    assert (got[:, keep].view(np.int32) == ref[:, keep].view(np.int32)).all()
    # a normal plane coefficient is (n0·e0 + n1·e1) + n2·e2 with |n| ≤ 1
    # and each n within 2 ulps: bound it by 8e-7 · (|e0| + |e1| + |e2|)
    e = np.abs(torch.stack(pcs.cols.setup.e).numpy())           # (9, T)
    esum = np.stack([e[c] + e[3 + c] + e[6 + c] for c in range(3)], axis=1)
    bound = 8e-7 * np.tile(esum, (1, 3))                        # (T, 9)
    assert (np.abs(got[:, nrm] - ref[:, nrm]) <= bound).all()


def _check_attrs(p, j, covered):
    """Port attributes p against the JAX ones j, both (N, 16) rows over
    `covered`, under the in-process (FMA) tolerance."""
    assert (p[~covered] == 0).all() and (j[~covered] == 0).all()
    p, j = p[covered], j[covered]
    assert (p[:, COPIED_CHANNELS] == j[:, COPIED_CHANNELS]).all()
    for ch in PLANE_CHANNELS:
        err = np.abs(p[:, ch] - j[:, ch]) / np.maximum(1.0, np.abs(j[:, ch]))
        assert err.max() <= 5e-5, (ch, err.max())
    mip = resolve.CH_MIP
    assert np.abs(p[:, mip] - j[:, mip]).max() <= 1e-4


def test_vcolor_resolve_matches_pallas(jax_side):
    """The plain vc resolve (what the wrappers run on CPU tensors), untiled
    and tiled, on the JAX winners and records, against
    resolve_attrs_pallas(vertex_colors=True). The colour factor really
    varies: the sphere's colours are not all one."""
    records = pplanes.records_from_reference(jax_side["cols"])
    tri = torch.from_numpy(jax_side["tri"])
    covered = jax_side["tri"] >= 0
    assert covered.sum() > 3000
    p = resolve.resolve_attrs(tri, records).numpy()
    assert (p == resolve.resolve_attrs_plain(tri, records).numpy()).all()
    assert (p == resolve.resolve_attrs_vc(tri, records).numpy()).all()
    _check_attrs(p.reshape(-1, 16), jax_side["attrs"].reshape(-1, 16),
                 covered.reshape(-1))
    cf = p[covered][:, resolve.CH_CF:resolve.CH_CF + 3]
    assert cf.std(axis=0).min() > 0.05 and cf.max() <= 1.0 + 1e-5
    tri_t = torch.from_numpy(jax_side["tri_t"])
    pt = resolve.resolve_attrs_tiled(tri_t, records, NTX).numpy()
    assert (pt == resolve.resolve_attrs_tiled_vc(tri_t, records, NTX)
            .numpy()).all()
    _check_attrs(pt.transpose(0, 2, 1).reshape(-1, 16),
                 jax_side["attrs_t"].transpose(0, 2, 1).reshape(-1, 16),
                 jax_side["tri_t"].reshape(-1) >= 0)


def test_vcolor_fused_matches_pallas(jax_side):
    """The plain vc fused pass on the JAX setup and records against
    fused_visibility_resolve_pallas(vertex_colors=True): ids equal but
    for FMA edge and tie flips, depth within 1e-6 and the attributes under
    the FMA tolerance where the ids agree."""
    fields = {f: jax_side[f"setup_{f}"] for f in JTriangleSetup._fields}
    ps = from_numpy(JTriangleSetup(**fields), "cpu")
    bins = raster.build_bins(ps, W, H)
    assert bins.aux.tolist() == [0, 0]
    records = pplanes.records_from_reference(jax_side["cols"])
    d, t, a = resolve.fused_visibility_resolve(bins, records, NTX, NTX * NTY)
    d2, t2, a2 = resolve.fused_visibility_resolve_vc(bins, records, NTX,
                                                     NTX * NTY)
    assert all((x == y).all() for x, y in ((d, d2), (t, t2), (a, a2)))
    from test_torch_fused import _image
    from test_torch_raster import _classify

    pt, jt = t.numpy(), jax_side["ftri"]
    covered = pt >= 0
    # in-process the JAX kernel's edge functions contract into FMAs: a few
    # winners flip at edges and depth ties (test_torch_fused.py's bound)
    n_bad = _classify(ps, _image(pt), _image(jt))
    assert n_bad <= max(2, int(covered.sum()) // 1000), n_bad
    same = pt == jt
    assert np.abs(d.numpy() - jax_side["fdepth"])[same].max() <= 1e-6
    both = (same & covered).reshape(-1)
    p = a.numpy().transpose(0, 2, 1).reshape(-1, 16)
    j = jax_side["fattrs"].transpose(0, 2, 1).reshape(-1, 16)
    _check_attrs(p[both | ~covered.reshape(-1)],
                 j[both | ~covered.reshape(-1)],
                 both[both | ~covered.reshape(-1)])


def test_vcolor_resolve_bitwise_without_fma(tmp_path):
    """Without FMA contraction on the JAX side the vc resolve, untiled,
    tiled and fused, is bit-equal except the mip level (≤ 1 ulp)."""
    dst = tmp_path / "vcolor.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(dst)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(dst)
    records = pplanes.records_from_reference(out["cols"])
    mip = resolve.CH_MIP
    others = [ch for ch in range(resolve.CHANNELS) if ch != mip]

    def same_bits(p, j, covered):
        p = p[covered].view(np.int32).astype(np.int64)
        j = j[covered].view(np.int32).astype(np.int64)
        assert (p[:, others] == j[:, others]).all()
        assert np.abs(p[:, mip] - j[:, mip]).max() <= 1

    p = resolve.resolve_attrs(torch.from_numpy(out["tri"]), records).numpy()
    same_bits(p.reshape(-1, 16), out["attrs"].reshape(-1, 16),
              out["tri"].reshape(-1) >= 0)
    pt = resolve.resolve_attrs_tiled(torch.from_numpy(out["tri_t"]), records,
                                     NTX).numpy()
    same_bits(pt.transpose(0, 2, 1).reshape(-1, 16),
              out["attrs_t"].transpose(0, 2, 1).reshape(-1, 16),
              out["tri_t"].reshape(-1) >= 0)
    fields = {f: out[f"setup_{f}"] for f in JTriangleSetup._fields}
    bins = raster.build_bins(from_numpy(JTriangleSetup(**fields), "cpu"),
                             W, H)
    d, t, a = resolve.fused_visibility_resolve(bins, records, NTX, NTX * NTY)
    assert (t.numpy() == out["ftri"]).all()
    assert (d.numpy().view(np.int32) == out["fdepth"].view(np.int32)).all()
    same_bits(a.numpy().transpose(0, 2, 1).reshape(-1, 16),
              out["fattrs"].transpose(0, 2, 1).reshape(-1, 16),
              t.numpy().reshape(-1) >= 0)


@pytest.mark.parametrize("wrapper", ["resolve", "tiled", "fused"])
def test_table_width_picks_the_instance(wrapper):
    """Each 40-wide instance's wrapper raises on a 32-wide table, the
    32-wide instances' check on a 40-wide one, and every wrapper on any
    other width."""
    from test_torch_resolve_rows import SCENES

    (_js, ps), w = SCENES["random"](np.random.default_rng(1234))
    bins = raster.build_bins(ps, w, H)
    ntx, nty = -(-w // raster.TILE), -(-H // raster.TILE)
    t = 300
    rec32 = torch.zeros((t, pplanes.RR_WIDTH))
    rec40 = torch.zeros((t, pplanes.RR_WIDTH_VCOLOR))
    rec36 = torch.zeros((t, 36))
    ids = torch.zeros((H, w), dtype=torch.int32)
    ids_t = torch.zeros((ntx * nty, raster.TILE_PX), dtype=torch.int32)
    vc, both = {
        "resolve": (lambda rec: resolve.resolve_attrs_vc(ids, rec),
                    lambda rec: resolve.resolve_attrs(ids, rec)),
        "tiled": (lambda rec: resolve.resolve_attrs_tiled_vc(ids_t, rec, ntx),
                  lambda rec: resolve.resolve_attrs_tiled(ids_t, rec, ntx)),
        "fused": (lambda rec: resolve.fused_visibility_resolve_vc(
                      bins, rec, ntx, ntx * nty),
                  lambda rec: resolve.fused_visibility_resolve(
                      bins, rec, ntx, ntx * nty)),
    }[wrapper]
    with pytest.raises(ValueError, match="records must be"):
        vc(rec32)
    vc(rec40)
    both(rec32)
    both(rec40)
    with pytest.raises(ValueError, match="records must be"):
        both(rec36)
    with pytest.raises(ValueError, match="records must be"):
        resolve._check_records(rec40, rec40.device, (pplanes.RR_WIDTH,))
    assert resolve._check_records(rec40, rec40.device) is True
    assert resolve._check_records(rec32, rec32.device) is False


# -- vertex-coloured frames through the Renderer ---------------------------

KNOBS = {"default": None, "fuse": {"fuse": True},
         "tiled_shade": {"tiled_shade": True}}


def _jax_vcolor_renderer(kernel=None):
    """The `_base` scene at 128² with the cube's mesh vertex-coloured, on
    the JAX package (scenes.feature_scene("vcolor")'s twin)."""
    from test_golden_flavors import _base

    r = JRenderer(EngineConfig(render=RenderConfig(
        width=128, height=128, texture_size=64, use_pallas=True,
        kernel=kernel)))
    r.set_active_registry(Registry())
    _base(r.registry, r)
    idx = r.geometry.add_mesh(coloured_mesh(j_build(JPrimitiveType.CUBE)))
    cube = next(e for e, _ in r.registry.view(TextureComponent))
    r.registry.get(cube, MeshComponent).mesh_index = idx
    return r


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_vcolor_frame_matches_jax(knob):
    """The vertex-coloured `_base` frame through the port's Renderer
    against the JAX frame (evaluated op by op, the same knobs) under the
    golden gate, by default and with fuse or tiled_shade; the colours
    change the frame."""
    from test_torch_frame import (
        _assert_golden_gate,
        _jax_frame_op_by_op,
    )
    from trident_tpu.ops import kernel_knobs

    try:
        jr = _jax_vcolor_renderer(KNOBS[knob])
        jout = _jax_frame_op_by_op(jr)
    finally:
        kernel_knobs.apply(kernel_knobs.env_defaults())
    tr = feature_scene("vcolor", "cpu", kernel=KNOBS[knob])
    out = tr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    assert np.asarray(jout.aux).tolist() == [0, 0]
    assert (out.tri_id.numpy() == np.asarray(jout.tri_id)).all()
    _assert_golden_gate(tr.read_frame(out), np.asarray(jout.color))
    plain = feature_scene("pallas_forward", "cpu", shadows=False,
                          kernel=KNOBS[knob]).read_frame()
    assert (np.abs(plain.astype(int) - out.color.numpy()) > 8).mean() > 0.05


def test_vcolor_frame_key_changes_when_a_mesh_gains_colours():
    """A mesh whose colours change from all ones to others is a new
    geometry version: the frame key (vertex_colors among its statics)
    and the record width change with it."""
    from trident_tpu_torch.geometry.primitives import (
        PrimitiveType,
        build_primitive,
    )

    r = feature_scene("pallas_forward", "cpu", shadows=False)
    before = r.frame_bundle()
    assert dict(before.key[3])["vertex_colors"] is False
    idx = r.geometry.add_mesh(build_primitive(PrimitiveType.SPHERE))
    assert r.frame_bundle().key[3] == before.key[3]
    r.geometry.meshes[idx] = coloured_mesh(r.geometry.meshes[idx])
    r.geometry.version += 1
    after = r.frame_bundle()
    assert dict(after.key[3])["vertex_colors"] is True
    assert after.key != before.key and after.sig != before.sig
    inp = r.frame_inputs()
    assert inp["vertex_colors"] is True
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0]


if __name__ == "__main__":
    np.savez(sys.argv[1], **_jax_vcolor())
