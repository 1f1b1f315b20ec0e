"""Skinning and the indexed geometry path of the port against the JAX
package: linear-blend skinning (_skin), the indexed vertex stage, the
global bone palette and its bundle blobs, and skinned frames through both
Renderers.

The scene is tools_dev/scenes.py's skinned tube crowd cut to 2 × 2 tubes
of 16 × 8 quads with two bones each at 128² (scenes.SKINNED_128: 1,024
triangles),
built on the port by scenes.skinned_scene and on the JAX package by
jax_skinned_renderer from the same numpy mesh, layout and poses, with
`AnimationComponent.bone_matrices` set in both registries.

Tolerances, each with its reason:
  * _skin and vertex_stage in this process: within 1e-6 · (1 + |value|):
    XLA:CPU's HIGHEST-pinned einsums may use FMAs and their own summation
    order (measured up to 2e-7 relative); rigid pass-through rows
    bit-equal. In a child process whose XLA:CPU emits no FMAs
    (--xla_cpu_max_isa=AVX) _skin is bit-equal, and so is vertex_stage
    but for its normals, within 2 ulps (XLA's rsqrt and PyTorch's differ
    by up to 2 ulps).
  * the palette, DrawParams and the bundle blobs: byte-equal.
  * frames: the golden gate of test_golden_flavors.py (< 0.2% of RGBA8
    values off by > 3 LSB, mean < 0.35), aux [0, 0]; the committed
    tests/goldens/torch_slice_skinned{,_shadow}.npy equal the JAX
    Renderer's frames (regenerate with `PYTHONPATH=. python
    tests/test_torch_skinning.py --write`).

Run as a script with an .npz path, this file is the child: it runs the
JAX _skin and vertex_stage on the inputs the parent saved there.
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
from trident_tpu.ecs import components as jc
from trident_tpu.ecs.registry import Registry as JRegistry
from trident_tpu.geometry.mesh import Mesh as JMesh
from trident_tpu.geometry.primitives import PrimitiveType as JPT
from trident_tpu.io.image import checkerboard
from trident_tpu.ops import vertex as jvertex
from trident_tpu.render import bundle as jbundle
from trident_tpu.render.frame import (
    DrawRecord as JDrawRecord,
    build_draw_params as j_params,
    gather_mesh_draws as j_gather,
    geometry_to_device as j_geometry,
)
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.ops import vertex as pvertex
from trident_tpu_torch.render import bundle
from trident_tpu_torch.render.frame import (
    DrawBatch,
    DrawRecord,
    bone_palette_host,
    build_draw_params_host,
    gather_draw_batch,
)
from trident_tpu_torch.render.types import from_numpy
from trident_tpu_torch.tools_dev import scenes

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"
SKINNED = {k: scenes.SKINNED_128[k]
           for k in ("grid", "segments", "rings", "bones")}
REL_TOL = 1e-6
NORMAL_ULPS = 2
SKIN_CASES = ("rigid", "one_bone", "four_bones", "out_of_range",
              "zero_weights")


def _gate(a: np.ndarray, b: np.ndarray) -> None:
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (diff > 3).mean() < 0.002, f"{(diff > 3).sum()} values drifted"
    assert diff.mean() < 0.35, f"mean drift {diff.mean():.4f}"


def jax_skinned_renderer(shadows: bool = False, k: int = 0, **render_kw):
    """scenes.skinned_scene(SKINNED at 128²)'s twin on the JAX package,
    posed at frame k; with `shadows` the backdrop and the sun, a 128²
    map."""
    grid, segments, rings, bones = (SKINNED[n] for n in
                                    ("grid", "segments", "rings", "bones"))
    r = JRenderer(EngineConfig(render=RenderConfig(**{
        "width": 128, "height": 128, "shadows": shadows,
        "shadow_map_size": 128, **render_kw})))
    reg = JRegistry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(128, 8))
    mesh = r.geometry.add_mesh(JMesh(**scenes.tube_mesh_arrays(
        segments, rings, bones)))
    for (pos, scale), mats in zip(scenes.tube_layout(grid),
                                  scenes.tube_poses(grid * grid, k, bones)):
        e = reg.create()
        t = reg.add(e, jc.TransformComponent())
        t.position, t.scale = pos, scale
        reg.add(e, jc.MeshComponent(mesh_index=mesh))
        reg.add(e, jc.TextureComponent(path="checker", slot=slot))
        reg.add(e, jc.AnimationComponent(bone_matrices=mats))
    if shadows:
        back = reg.create()
        bt = reg.add(back, jc.TransformComponent())
        bt.position = np.array([0.0, 0.0, -1.0], np.float32)
        side = grid * scenes.SKIN_SPACING + 1.0
        bt.scale = np.array([side, side, 0.2], np.float32)
        reg.add(back, jc.MeshComponent(mesh_index=r.ensure_primitive(
            JPT.CUBE)))
        reg.add(back, jc.TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, jc.TransformComponent())
        reg.add(sun, jc.LightComponent(
            direction=np.array([0.35, -0.3, -1.0], np.float32),
            intensity=2.5, cast_shadows=True))
    r.editor_camera.set_position([0, 0, grid * 1.1 + 2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


def port_skinned_renderer(shadows: bool = False, k: int = 0, **render_kw):
    r, reg = scenes.skinned_scene("cpu", shadows=shadows,
                                  **scenes.SKINNED_128, **render_kw)
    scenes.pose_skinned(reg, k, SKINNED["bones"])
    return r


def skinned_reference(shadows: bool) -> pathlib.Path:
    return GOLDENS / ("torch_slice_skinned_shadow.npy" if shadows
                      else "torch_slice_skinned.npy")


def write_skinned_references() -> None:
    for shadows in (False, True):
        np.save(skinned_reference(shadows),
                jax_skinned_renderer(shadows, use_pallas=True).read_frame())


# -- _skin and the vertex stage -------------------------------------------

def _skin_inputs(case: str, seed: int = 7) -> tuple:
    """Seeded _skin inputs (positions, normals, bone_indices, bone_weights,
    palette, bone_offset, bone_count) of `case`."""
    rng = np.random.default_rng(seed + SKIN_CASES.index(case))
    tv, p = 257, 11
    pos = (rng.standard_normal((tv, 3)) * 2).astype(np.float32)
    nrm = rng.standard_normal((tv, 3)).astype(np.float32)
    pal = (rng.standard_normal((p, 4, 4)) * 0.5 + np.eye(4)).astype(
        np.float32)
    idx = rng.integers(0, 4, (tv, 4)).astype(np.int32)
    w = rng.uniform(0.05, 1.0, (tv, 4)).astype(np.float32)
    count = {"rigid": 0, "one_bone": 1}.get(case, 4)
    bc = np.full(tv, count, np.int32)
    bo = (np.full(tv, -1, np.int32) if case == "rigid"
          else rng.integers(0, p - 4, tv).astype(np.int32))
    if case == "one_bone":
        idx[:, 1:] = rng.integers(-1, 3, (tv, 3))   # skipped: ≥ count
    if case == "out_of_range":
        idx = rng.integers(-3, 9, (tv, 4)).astype(np.int32)
        bo = rng.integers(p - 3, p + 2, tv).astype(np.int32)   # clamped
        bc = rng.choice([0, 1, 4], tv).astype(np.int32)
    if case == "zero_weights":
        w[rng.random((tv, 4)) < 0.4] = 0.0
        w[rng.random((tv, 4)) < 0.1] = -0.5
        w[:8] = 0.0                                  # no influence at all
    return pos, nrm, idx, w, pal, bo, bc


def _close(p: np.ndarray, j: np.ndarray) -> None:
    assert p.shape == j.shape and p.dtype == j.dtype
    assert (np.abs(p - j) <= REL_TOL * (1.0 + np.abs(j))).all(), \
        float(np.abs(p - j).max())


@pytest.mark.parametrize("case", SKIN_CASES)
def test_skin_matches_jax(case):
    args = _skin_inputs(case)
    jp, jn = jvertex._skin(*map(jnp.asarray, args))
    pp, pn = pvertex._skin(*map(torch.from_numpy, args))
    for p, j in ((pp, jp), (pn, jn)):
        _close(p.numpy(), np.asarray(j))
    rigid = args[-1] <= 0
    assert (pp.numpy()[rigid] == args[0][rigid]).all()
    assert (pn.numpy()[rigid] == args[1][rigid]).all()
    if case == "rigid":
        assert rigid.all()
    if case == "zero_weights":
        # every influence skipped: the zero matrix, not the rigid pass
        assert (pp.numpy()[:8] == 0).all() and not rigid[:8].any()


def _stage_inputs(jr):
    """The JAX scene's vertex-stage inputs (geometry, plan, params,
    camera, palette) as the JAX Renderer builds them, numpy-backed."""
    packed = jr.geometry.packed()
    records = j_gather(jr.registry, jr.geometry)
    plan, _tri_draw = jr._plan_cache.plan(packed, records,
                                          jr.geometry.version)
    params, palette, _shade = j_params(
        records, plan.num_draws, jr.config.render.max_bones,
        material_table=jr.geometry.material_table())
    jr.editor_camera.set_viewport_size(128, 128)
    return (j_geometry(packed), plan, params, jr.editor_camera.params(),
            palette)


@pytest.mark.parametrize("skinned", [True, False])
def test_vertex_stage_matches_jax(skinned):
    inputs = _stage_inputs(jax_skinned_renderer(k=3))
    with jax.disable_jit():
        jout = jvertex.vertex_stage(*inputs, skinned=skinned)
    pin = [from_numpy(x, "cpu") for x in inputs[:4]]
    pout = pvertex.vertex_stage(*pin, torch.from_numpy(np.asarray(
        inputs[4])), skinned=skinned)
    for f in jvertex.VertexStageOut._fields:
        _close(getattr(pout, f).numpy(), np.asarray(getattr(jout, f)))
    if skinned:   # the pose moved the vertices off the rigid ones
        rigid = pvertex.vertex_stage(*pin, None, skinned=False)
        assert (rigid.world - pout.world).abs().max() > 0.05


def test_skin_and_vertex_stage_bitwise_without_fma(tmp_path):
    """Without FMA contraction the JAX _skin (every case) is bit-equal to
    the port's, and so is vertex_stage (skinned and rigid, under jit) but
    for the normals, within NORMAL_ULPS."""
    inputs = _stage_inputs(jax_skinned_renderer(k=3))
    geometry, plan, params, camera, palette = inputs
    arrays = {f"skin_{c}_{i}": a for c in SKIN_CASES
              for i, a in enumerate(_skin_inputs(c))}
    for name, nt in (("geo", geometry), ("plan", plan), ("params", params),
                     ("cam", camera)):
        arrays.update({f"{name}_{f}": np.asarray(v)
                       for f, v in nt._asdict().items()
                       if not isinstance(v, int)})
    arrays["palette"] = np.asarray(palette)
    src = tmp_path / "in.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(src),
                           str(plan.num_draws)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    for c in SKIN_CASES:
        pp, pn = pvertex._skin(*map(torch.from_numpy, _skin_inputs(c)))
        assert pp.numpy().tobytes() == out[f"skin_{c}_pos"].tobytes(), c
        assert pn.numpy().tobytes() == out[f"skin_{c}_nrm"].tobytes(), c
    pin = [from_numpy(x, "cpu") for x in inputs[:4]]
    for skinned in (True, False):
        pout = pvertex.vertex_stage(*pin, torch.from_numpy(np.asarray(
            palette)), skinned=skinned)
        for f in ("clip", "attrs", "packed"):
            p = getattr(pout, f).numpy().view(np.int32).astype(np.int64)
            j = out[f"vs_{skinned}_{f}"].view(np.int32).astype(np.int64)
            nrm = slice(3, 6) if f == "attrs" else slice(4, 7)
            rest = np.ones(p.shape[1], bool)
            rest[nrm] = f == "clip"
            assert (p[:, rest] == j[:, rest]).all(), (skinned, f)
            assert np.abs(p - j).max() <= NORMAL_ULPS, (skinned, f)


# -- the palette and the bundle --------------------------------------------

def _record(bones, k: int = 0) -> tuple:
    """One draw with `bones` as both packages' DrawRecord."""
    kw = dict(entity=k, mesh_index=0, model=np.eye(4, dtype=np.float32),
              tint=np.ones(4, np.float32), uv_scale=np.ones(2, np.float32),
              uv_offset=np.zeros(2, np.float32), tiling=1.0,
              texture_slot=0, material_index=0)
    return JDrawRecord(bone_matrices=bones, **kw), DrawRecord(
        bone_matrices=bones, **kw)


def _bones(rng, n: int) -> np.ndarray:
    return rng.standard_normal((n, 4, 4)).astype(np.float32)


PALETTE_CASES = {
    "cap": ([200], 4, 128),               # one draw over the 128-bone cap
    "mixed": ([5, None, 0, 16, 3], 8, 128),   # rigid and empty draws too
    "small_cap": ([5, 9, 2], 4, 3),
    "bucket_cut": ([4, 6, 8, 10, 12], 4, 128),  # draws past the bucket
    "none": ([None, None], 4, 128),
}


@pytest.mark.parametrize("case", sorted(PALETTE_CASES))
def test_palette_packing_matches_jax(case):
    """build_draw_params_host's bone_offset / bone_count and
    bone_palette_host's identity-padded palette equal the JAX package's
    build_draw_params, byte for byte (the 128-bone cap, rigid and empty
    draws, a smaller cap, draws past the draw bucket)."""
    counts, d, cap = PALETTE_CASES[case]
    rng = np.random.default_rng(11)
    pairs = [_record(None if n is None else _bones(rng, n), k)
             for k, n in enumerate(counts)]
    jp, jpal, _js = j_params([a for a, _b in pairs], d, max_bones=cap)
    batch = DrawBatch.from_records([b for _a, b in pairs])
    params, _shade = build_draw_params_host(batch, d, max_bones=cap)
    pal = bone_palette_host(batch, d, cap)
    for f in ("bone_offset", "bone_count"):
        a, b = np.asarray(getattr(jp, f)), getattr(params, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert pal.dtype == jpal.dtype and pal.tobytes() == jpal.tobytes()
    if case == "cap":
        assert int(params.bone_count[0]) == 128 and pal.shape[0] >= 128


def test_bone_cap_respected():
    """The port's twin of tests/test_edge_cases.py::test_bone_cap_respected:
    200 bones on one draw are clamped to max_bones 128."""
    rec = _record(np.tile(np.eye(4, dtype=np.float32), (200, 1, 1)))[1]
    batch = DrawBatch.from_records([rec])
    params, _shade = build_draw_params_host(batch, 4, max_bones=128)
    assert int(params.bone_count[0]) == 128
    assert bone_palette_host(batch, 4, 128).shape[0] >= 128


def test_skinned_bundle_byte_equal_to_jax():
    """The skinned scene's frame blobs packed by the port (its batched
    gathering, bone_palette_host) equal the JAX pack_frame's bytes, and
    unpack into the same palette."""
    jr = jax_skinned_renderer(shadows=True, k=2)
    pr = port_skinned_renderer(shadows=True, k=2)
    records = j_gather(jr.registry, jr.geometry)
    jp, jpal, jshade = j_params(records, 8, 128,
                                material_table=jr.geometry.material_table())
    batch = gather_draw_batch(pr.registry, pr.geometry)
    assert batch.skinned and len(batch) == len(records) == 5
    params, shade = build_draw_params_host(
        batch, 8, material_table=pr.geometry.material_table())
    pal = bone_palette_host(batch, 8)
    assert pal.shape == (8, 4, 4)             # 4 tubes × 2 bones
    cam = jr.editor_camera.params()
    cam = type(cam)(*(np.asarray(x) for x in cam))
    from trident_tpu.render.lights import gather_lights
    from trident_tpu_torch.render.lights import gather_lights_host

    jl = gather_lights(jr.registry)
    jl = type(jl)(*(np.asarray(x) for x in jl))
    jf, ji, jshape = jbundle.pack_frame(jp, jpal, jshade, cam, jl, cam, 0.25)
    pf, pi, pshape = bundle.pack_frame(params, pal, shade, cam,
                                       gather_lights_host(pr.registry), cam,
                                       0.25)
    assert tuple(jshape) == tuple(pshape) and pshape.p == 8
    assert jf.tobytes() == pf.tobytes() and ji.tobytes() == pi.tobytes()
    unpacked = bundle.unpack_frame(torch.from_numpy(pf),
                                   torch.from_numpy(pi), pshape)
    assert unpacked[1].numpy().tobytes() == jpal.tobytes()


# -- frames -----------------------------------------------------------------

@pytest.mark.parametrize("shadows", [False, True], ids=["plain", "shadow"])
def test_skinned_frame_matches_jax_renderer(shadows):
    """The port's Renderer (the forward frame on the indexed path) against
    the JAX Renderer's frame of the same skinned scene (use_pallas=True:
    the same route, its kernels interpreted), and the committed reference
    equal to the JAX frame."""
    jframe = jax_skinned_renderer(shadows, use_pallas=True).read_frame()
    ref = np.load(skinned_reference(shadows))
    assert ref.dtype == np.uint8 and ref.shape == (128, 128, 4)
    assert (ref == jframe).all(), "reference frame is stale: regenerate"
    r = port_skinned_renderer(shadows)
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0]
    if shadows:
        assert out.shadow_aux.tolist() == [0, 0]
    assert int((out.tri_id >= 0).sum()) > 1000
    _gate(r.read_frame(out), jframe)


@pytest.mark.parametrize("route", ["ref", "planes_f16", "planes_f32"])
def test_skinned_plane_routes_match_jax_renderer(route):
    """The shadowed skinned scene on the plane-gather routes (the
    reference raster, and the binned raster with f16 and f32 planes)
    against the JAX Renderer on the same route."""
    kw = {"ref": dict(use_pallas=False),
          "planes_f16": dict(use_pallas=True, forward_shading=False,
                             plane_f16=True),
          "planes_f32": dict(use_pallas=True, forward_shading=False,
                             plane_f16=False)}[route]
    jframe = jax_skinned_renderer(True, k=1, **kw).read_frame()
    r = port_skinned_renderer(True, k=1, **kw)
    out = r.render_viewport()
    assert out.aux.tolist() == [0, 0] and out.shadow_aux.tolist() == [0, 0]
    _gate(r.read_frame(out), jframe)


def test_skinned_frames_key_and_pose():
    """A skinned frame keys its own graph (skinned, no draw stride, the
    palette's bucket in the shape); a new pose changes the blob, not the
    key, and the frame; the same scene without bones keys another."""
    r = port_skinned_renderer()
    fb0 = r.frame_bundle()
    scenes.pose_skinned(r.registry, 5, SKINNED["bones"])
    fb5 = r.frame_bundle()
    assert fb0.key == fb5.key and fb0.f32.tobytes() != fb5.f32.tobytes()
    statics = dict(fb0.key[3])
    assert statics["skinned"] and statics["draw_stride"] == 0
    assert fb0.key[0][1] == 8                       # 4 tubes × 2 bones
    assert fb0.state.palette.shape == (8, 4, 4)
    f0 = fb0.frame_fn(torch.from_numpy(fb0.f32), torch.from_numpy(fb0.i32),
                      None, fb0.ai)
    f5 = fb5.frame_fn(torch.from_numpy(fb5.f32), torch.from_numpy(fb5.i32),
                      None, fb5.ai)
    assert not torch.equal(f0.color, f5.color)
    from trident_tpu_torch.ecs.components import AnimationComponent

    for _e, (anim,) in r.registry.view(AnimationComponent):
        anim.bone_matrices = None
    rigid = r.frame_bundle()
    assert rigid.key != fb0.key and not dict(rigid.key[3])["skinned"]
    assert rigid.key[0][1] == 1


def _child(src: str, num_draws: int) -> None:
    """The JAX side of test_skin_and_vertex_stage_bitwise_without_fma."""
    from trident_tpu.render.types import (
        CameraParams,
        DrawParams,
        DrawPlan,
        GeometryBuffers,
    )

    a = np.load(src)
    out = {}
    for c in SKIN_CASES:
        args = [jnp.asarray(a[f"skin_{c}_{i}"]) for i in range(7)]
        pos, nrm = jax.jit(jvertex._skin)(*args)
        out[f"skin_{c}_pos"], out[f"skin_{c}_nrm"] = (np.asarray(pos),
                                                      np.asarray(nrm))

    def nt(cls, name, **extra):
        return cls(**{f: jnp.asarray(a[f"{name}_{f}"]) for f in cls._fields
                      if f"{name}_{f}" in a}, **extra)

    geo = nt(GeometryBuffers, "geo")
    plan = nt(DrawPlan, "plan", num_draws=num_draws)
    params = nt(DrawParams, "params")
    cam = nt(CameraParams, "cam")
    for skinned in (True, False):
        vs = jax.jit(lambda g, p, q, c, pal, s=skinned: jvertex.vertex_stage(
            g, p, q, c, pal, skinned=s))(geo, plan, params, cam,
                                         jnp.asarray(a["palette"]))
        for f in ("clip", "attrs", "packed"):
            out[f"vs_{skinned}_{f}"] = np.asarray(getattr(vs, f))
    np.savez(pathlib.Path(src).parent / "out.npz", **out)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["--write"]:
        write_skinned_references()
        print("wrote", skinned_reference(False), skinned_reference(True))
    else:
        _child(sys.argv[1], int(sys.argv[2]))
