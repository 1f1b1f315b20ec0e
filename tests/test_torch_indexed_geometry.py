"""The forward route's indexed geometry (ops/indexed.py): the plain
version is the composition the renderer ran before (vertex_stage →
indexed_corner_stage → build_resolve_cols_planar), bit for bit; on CPU
tensors the wrapper takes it and counts no launch; frame_geometry's CPU
output is that composition's. Cases: skinned and rigid, 32- and 40-wide
records, on scenes.SKINNED_128 and on a hand-made plan with padded
triangles, a degenerate triangle, a corner with w ≤ 0, influences with
weight ≤ 0 or an index outside [0, bone_count), a palette index past the
palette's end and a draw with bone_count ≤ 0.

On the card (marker `card`; there: python3 -m pytest --noconftest -m card
tests/test_torch_indexed_geometry.py) the kernel pair
(csrc/skinned_geometry.cu) against the plain version bit for bit, at the
crowd's shapes (benchmark/gen.py's tube, 144 characters: 1,048,576
vertices and 2,097,152 triangles after the plan's buckets, 2,304 bones)
and on the CPU cases' inputs; inside a captured graph replayed after the
palette and the camera changed in place; and the wrapper's refusals.

No JAX here: the scenes are the port's own (tools_dev/scenes.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops import indexed
from trident_tpu_torch.ops.corner import indexed_corner_stage
from trident_tpu_torch.ops.planes import build_resolve_cols_planar
from trident_tpu_torch.ops.vertex import vertex_stage
from trident_tpu_torch.render.camera import Camera
from trident_tpu_torch.render.renderer import frame_geometry, shading_consts
from trident_tpu_torch.render.types import (
    DrawParams,
    DrawPlan,
    GeometryBuffers,
)
from trident_tpu_torch.tools_dev import scenes

SCENES = ("skinned128", "hand")
CASES = [(scene, skinned, vc) for scene in SCENES for skinned in (True, False)
         for vc in (False, True)]
CASE_IDS = [f"{s}-{'skinned' if k else 'rigid'}-{40 if v else 32}"
            for s, k, v in CASES]


def _bucket(n: int, minimum: int = 16) -> int:
    return max(minimum, 1 << (n - 1).bit_length())


def _camera(position, target, width, height, device="cpu", fov=45.0):
    cam = Camera()
    cam.set_viewport_size(width, height)
    cam.set_perspective(fov, 0.1, 1000.0)
    cam.set_position(position)
    cam.look_at_target(target)
    return cam.params(device)


def _params(models: np.ndarray, bone_offset, bone_count, rng,
            device="cpu") -> DrawParams:
    """DrawParams of (D, 4, 4) model matrices, seeded UV transforms."""
    d = models.shape[0]
    flat = models.reshape(d, 16).astype(np.float32)
    uv = rng.uniform(0.5, 2.0, (d, 5)).astype(np.float32)
    xform_b = np.concatenate([flat[:, 12:16], uv, np.zeros((d, 3),
                                                           np.float32)], 1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    zero = torch.zeros((), device=device)
    return DrawParams(
        model=t(models), xform_a=t(flat[:, 0:12]), xform_b=t(xform_b),
        tint=zero.expand(d, 4), uv_scale=t(uv[:, 0:2]),
        uv_offset=t(uv[:, 2:4]), tiling=t(uv[:, 4]),
        texture_slot=t(np.arange(d) % 2, torch.int32),
        material_index=torch.zeros(d, dtype=torch.int32, device=device),
        bone_offset=t(bone_offset, torch.int32),
        bone_count=t(bone_count, torch.int32))


def _geometry(attr: np.ndarray, bone_indices, bone_weights,
              device="cpu") -> GeometryBuffers:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return GeometryBuffers(
        positions=t(attr[:, 0:3]), normals=t(attr[:, 3:6]),
        tangents=t(attr[:, 3:6]), bitangents=t(attr[:, 3:6]),
        colors=t(attr[:, 8:11]), uvs=t(attr[:, 6:8]),
        bone_indices=t(bone_indices, torch.int32),
        bone_weights=t(bone_weights), attr_table=t(attr))


def _plan(draw_vertices: list, draw_triangles: list,
          device="cpu") -> tuple:
    """(DrawPlan, tri_draw) of per-draw source-vertex lists and per-draw
    local triangles, padded to the buckets as render/frame.py pads them:
    padded vertices and triangles point at vertex 0 of draw 0, padded
    triangles invalid."""
    src, draw, tris, tri_draw = [], [], [], []
    base = 0
    for d, (verts, local) in enumerate(zip(draw_vertices, draw_triangles)):
        src += list(verts)
        draw += [d] * len(verts)
        tris += [np.asarray(local, np.int64).reshape(-1, 3) + base]
        tri_draw += [d] * len(local)
        base += len(verts)
    tris = np.concatenate(tris)
    tv, tt = _bucket(len(src)), _bucket(len(tris))

    def pad(a, n):
        out = np.zeros((n, *np.shape(a)[1:]), np.int32)
        out[:len(a)] = a
        return torch.from_numpy(out).to(device)

    valid = torch.zeros(tt, dtype=torch.bool)
    valid[:len(tris)] = True
    return (DrawPlan(vtx_src=pad(src, tv), vtx_draw=pad(draw, tv),
                     tri_vtx=pad(tris, tt), tri_valid=valid.to(device),
                     num_draws=len(draw_vertices)),
            pad(tri_draw, tt))


def hand_inputs() -> dict:
    """The hand-made plan (module note) at 64 × 48: 10 source vertices,
    4 draws, 10 triangles padded to 16, an 8-matrix palette."""
    rng = np.random.default_rng(23)
    v = 10
    attr = np.zeros((v, 12), np.float32)
    attr[:, 0:3] = rng.uniform(-1.0, 1.0, (v, 3))
    attr[9, 0:3] = (0.2, 0.1, 30.0)                  # behind the camera
    attr[:, 3:6] = rng.standard_normal((v, 3))
    attr[:, 6:8] = rng.uniform(0.0, 1.0, (v, 2))
    attr[:, 8:11] = rng.uniform(0.0, 1.0, (v, 3))
    bone_indices = rng.integers(-2, 6, (v, 4)).astype(np.int32)
    bone_weights = rng.uniform(-0.2, 1.0, (v, 4)).astype(np.float32)
    bone_weights[rng.random((v, 4)) < 0.25] = 0.0
    palette = (np.eye(4) + 0.1 * rng.standard_normal((8, 4, 4))).astype(
        np.float32)
    # draw 2 passes through rigid; draw 3's influences reach past the
    # palette's end and are clamped into it
    bone_offset = np.array([0, 4, -1, 6], np.int32)
    bone_count = np.array([4, 2, 0, 3], np.int32)
    models = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    models[:, :3, :3] += 0.15 * rng.standard_normal((4, 3, 3))
    models[:, :3, 3] = rng.uniform(-0.3, 0.3, (4, 3))
    plan, tri_draw = _plan(
        [[0, 1, 2, 3], [2, 3, 4, 5, 6], [5, 6, 7, 8, 9], [0, 1, 9]],
        [[(0, 1, 2), (0, 2, 3), (1, 1, 2)],      # (1, 1, 2): degenerate
         [(0, 1, 2), (2, 3, 4), (0, 4, 2)],
         [(0, 1, 2), (1, 3, 4), (2, 3, 4)],      # vertex 9 (local 4): w ≤ 0
         [(0, 1, 2)]])
    w, h = 64, 48
    return dict(
        plan=plan, tri_draw=tri_draw,
        params=_params(models, bone_offset, bone_count, rng),
        shade_table=torch.from_numpy(
            rng.uniform(0.0, 1.0, (4, 8)).astype(np.float32)),
        camera=_camera([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], w, h, fov=60.0),
        textures=SimpleNamespace(sizes=torch.tensor(
            [[128, 128, 0, 7], [64, 64, 64, 6]], dtype=torch.int32)),
        geometry=_geometry(attr, bone_indices, bone_weights),
        palette=torch.from_numpy(palette), width=w, height=h)


def skinned128_inputs() -> dict:
    r, reg = scenes.skinned_scene("cpu", **scenes.SKINNED_128)
    scenes.pose_skinned(reg, 3, scenes.SKINNED_128["bones"])
    inp = r.frame_inputs()
    return {k: inp[k] for k in ("plan", "tri_draw", "params", "shade_table",
                                "camera", "textures", "geometry", "palette",
                                "width", "height")}


@pytest.fixture(scope="module")
def scene_inputs():
    torch.set_num_threads(1)
    return {"skinned128": skinned128_inputs(), "hand": hand_inputs()}


def draw_consts(inp) -> torch.Tensor:
    return shading_consts(inp["params"], inp["shade_table"], inp["textures"])


def call_args(inp, skinned: bool, vertex_colors: bool):
    return ((inp["plan"], inp["tri_draw"], inp["params"], inp["camera"],
             draw_consts(inp), inp["geometry"], inp["palette"]),
            dict(width=inp["width"], height=inp["height"], skinned=skinned,
                 vertex_colors=vertex_colors))


def composition(inp, skinned: bool, vertex_colors: bool):
    """What frame_geometry's indexed branch composed before the wrapper."""
    verts = vertex_stage(inp["geometry"], inp["plan"], inp["params"],
                         inp["camera"], inp["palette"], skinned=skinned)
    cs = indexed_corner_stage(
        verts.packed, inp["plan"].tri_vtx, inp["plan"].tri_valid,
        inp["width"], inp["height"],
        consts=draw_consts(inp)[inp["tri_draw"].long()],
        vertex_colors=vertex_colors)
    return cs, build_resolve_cols_planar(cs.cols)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return bool(torch.equal(a, b))


def differing(cs, rec, cs_ref, rec_ref, corner_cols: bool = True) -> list:
    """The fields of two (corner stage output, records) pairs that differ
    (the setup, its columns, the records; with `corner_cols` the normal,
    UV, const and colour columns too)."""
    out = [] if same(rec, rec_ref) else ["records"]
    for f in ("edge", "z", "w", "bbox", "valid"):
        if not same(getattr(cs.setup, f), getattr(cs_ref.setup, f)):
            out.append(f"setup.{f}")
    for f in ("e", "z", "w"):
        a, b = getattr(cs.cols.setup, f), getattr(cs_ref.cols.setup, f)
        if len(a) != len(b) or not all(same(x, y) for x, y in zip(a, b)):
            out.append(f"cols.setup.{f}")
    if corner_cols:
        for f in ("nrm", "uv", "consts", "col"):
            a, b = getattr(cs.cols, f), getattr(cs_ref.cols, f)
            if (a is None) != (b is None) or (a is not None and (
                    len(a) != len(b)
                    or not all(same(x, y) for x, y in zip(a, b)))):
                out.append(f"cols.{f}")
    return out


@pytest.mark.parametrize("scene,skinned,vc", CASES, ids=CASE_IDS)
def test_plain_is_the_composition(scene_inputs, scene, skinned, vc):
    inp = scene_inputs[scene]
    args, kw = call_args(inp, skinned, vc)
    cs, rec = indexed.indexed_geometry_plain(*args, **kw)
    cs_ref, rec_ref = composition(inp, skinned, vc)
    assert differing(cs, rec, cs_ref, rec_ref) == []
    assert rec.shape == (inp["plan"].tri_vtx.shape[0], 40 if vc else 32)


@pytest.mark.parametrize("scene,skinned,vc", CASES, ids=CASE_IDS)
def test_cpu_tensors_take_the_plain_version(scene_inputs, scene, skinned,
                                            vc):
    inp = scene_inputs[scene]
    args, kw = call_args(inp, skinned, vc)
    before = dict(_build.LAUNCHES)
    cs, rec = indexed.indexed_geometry(*args, **kw)
    assert dict(_build.LAUNCHES) == before
    cs_ref, rec_ref = indexed.indexed_geometry_plain(*args, **kw)
    assert differing(cs, rec, cs_ref, rec_ref) == []


@pytest.mark.parametrize("scene,skinned,vc", CASES, ids=CASE_IDS)
def test_frame_geometry_unchanged(scene_inputs, scene, skinned, vc):
    inp = scene_inputs[scene]
    cs, rec = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], None, width=inp["width"],
        height=inp["height"], vertex_colors=vc, geometry=inp["geometry"],
        palette=inp["palette"], skinned=skinned)
    cs_ref, rec_ref = composition(inp, skinned, vc)
    assert differing(cs, rec, cs_ref, rec_ref) == []


@pytest.mark.parametrize("scene,skinned,vc", CASES, ids=CASE_IDS)
def test_setup_views_of_the_planar_table(scene_inputs, scene, skinned, vc):
    """setup_from_table, which the kernel path's setup goes through, reads
    the (15, T) table's rows as the plain setup's columns and its edge, z
    and w as views of the table."""
    inp = scene_inputs[scene]
    args, kw = call_args(inp, skinned, vc)
    cs, _rec = indexed.indexed_geometry_plain(*args, **kw)
    sc = cs.cols.setup
    table = torch.stack([*sc.e, *sc.z, *sc.w])
    setup, cols = indexed.setup_from_table(table, cs.setup.bbox,
                                           cs.setup.valid)
    for f in ("edge", "z", "w", "bbox", "valid"):
        assert same(getattr(setup, f), getattr(cs.setup, f)), f
    for f in ("e", "z", "w"):
        assert all(same(x, y) for x, y in zip(getattr(cols, f),
                                               getattr(sc, f))), f
    for view in (setup.edge, setup.z, setup.w, *cols.e, *cols.z, *cols.w):
        assert view.untyped_storage().data_ptr() == \
            table.untyped_storage().data_ptr()


def test_hand_plan_holds_its_edge_cases(scene_inputs):
    """The hand-made plan has what the module note says it has."""
    inp = scene_inputs["hand"]
    plan, geo, params = inp["plan"], inp["geometry"], inp["params"]
    args, kw = call_args(inp, True, False)
    cs, _rec = indexed.indexed_geometry_plain(*args, **kw)
    n_real = 10
    assert not plan.tri_valid[n_real:].any() and plan.tri_valid[:n_real].all()
    assert not cs.setup.valid[2]                       # the degenerate one
    assert bool(cs.setup.valid[:n_real].any())
    behind = (cs.setup.w <= 1e-6).any(1)
    assert bool(behind[:n_real].any())
    full = torch.tensor([0, 0, inp["width"], inp["height"]],
                        dtype=torch.int32)
    assert (cs.setup.bbox[:n_real][behind[:n_real]] == full).all()
    draw = plan.vtx_draw.long()
    count = params.bone_count[draw][:, None]
    idx = geo.bone_indices[plan.vtx_src.long()]
    wts = geo.bone_weights[plan.vtx_src.long()]
    assert bool((wts <= 0).any()) and bool(((idx < 0) | (idx >= count)).any())
    assert bool((params.bone_offset[:, None] + idx.new_tensor(
        [[0, 1, 2]]) >= inp["palette"].shape[0]).any())
    assert bool((params.bone_count <= 0).any())


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card "
                    "tests/test_torch_indexed_geometry.py")
    _build.load_library()
    return torch.device("cuda")


def to_device(inp: dict, dev) -> dict:
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[move(f) for f in x])
        if isinstance(x, SimpleNamespace):
            return SimpleNamespace(**{k: move(f)
                                      for k, f in vars(x).items()})
        return x

    return {k: move(v) for k, v in inp.items()}


def crowd_inputs(dev, seed: int = 5) -> dict:
    """The crowd's shapes from benchmark/gen.py's tube and layout
    (benchmark/configs/crowd144_1080.json): 144 characters of 3,965
    vertices and 7,680 triangles, 16 bones each, in the plan's buckets;
    a seeded pose of every bone and the configuration's camera."""
    import json
    import pathlib

    from benchmark import gen

    cfg = json.loads((pathlib.Path(__file__).resolve().parent.parent
                      / "benchmark" / "configs" / "crowd144_1080.json")
                     .read_text())
    tb, n = cfg["tube"], cfg["grid"] ** 2
    mesh = gen.tube_mesh(tb["segments"], tb["rings"], tb["bones"],
                         tb["length"], tb["radius"])
    nv = mesh["positions"].shape[0]
    attr = np.concatenate([mesh["positions"], mesh["normals"], mesh["uvs"],
                           mesh["colors"], np.zeros((nv, 1), np.float32)],
                          axis=1)
    local = mesh["indices"].reshape(-1, 3)
    plan, tri_draw = _plan([range(nv)] * n, [local] * n, dev)
    d = _bucket(n, minimum=4)
    rng = np.random.default_rng(seed)
    pos, scale = gen.crowd_layout(cfg["grid"], cfg["spacing"], tb["scale"],
                                  tb["length"])
    models = np.tile(np.eye(4, dtype=np.float32), (d, 1, 1))
    models[:n, [0, 1, 2], [0, 1, 2]] = scale
    models[:n, :3, 3] = pos
    bones = n * tb["bones"]
    palette = np.tile(np.eye(4, dtype=np.float32), (_bucket(bones, 1), 1, 1))
    palette[:bones, :3, :] += 0.05 * rng.standard_normal((bones, 3, 4))
    offset = np.full(d, -1, np.int32)
    count = np.zeros(d, np.int32)
    offset[:n], count[:n] = np.arange(n) * tb["bones"], tb["bones"]
    params = _params(models, offset, count, rng, dev)
    cam = cfg["camera"]
    return dict(
        plan=plan, tri_draw=tri_draw, params=params,
        shade_table=torch.from_numpy(rng.uniform(0.0, 1.0, (d, 8)).astype(
            np.float32)).to(dev),
        camera=_camera(cam["position"], cam["target"], cfg["width"],
                       cfg["height"], dev, cam["fov_deg"]),
        textures=SimpleNamespace(sizes=torch.tensor(
            [[128, 128, 0, 7], [64, 64, 64, 6]], dtype=torch.int32,
            device=dev)),
        geometry=_geometry(attr, mesh["bone_indices"], mesh["bone_weights"],
                           dev),
        palette=torch.from_numpy(palette).to(dev), width=cfg["width"],
        height=cfg["height"])


def pair_launches() -> list:
    """The kernel pair's launches so far, vertices' then triangles'."""
    return [_build.LAUNCHES["trident_skinned_vertices"],
            _build.LAUNCHES["trident_skinned_triangles"]]


def kernel_against_plain(inp, skinned: bool, vc: bool) -> list:
    args, kw = call_args(inp, skinned, vc)
    cs, rec = indexed.indexed_geometry(*args, **kw)
    cs_ref, rec_ref = indexed.indexed_geometry_plain(*args, **kw)
    torch.cuda.synchronize()
    return differing(cs, rec, cs_ref, rec_ref, corner_cols=False)


@pytest.mark.card
@pytest.mark.parametrize("skinned,vc", [(True, True), (True, False),
                                        (False, True)])
def test_card_kernel_pair_bit_equal_at_the_crowds_shapes(card, skinned, vc):
    inp = crowd_inputs(card)
    assert inp["plan"].vtx_src.shape[0] == 1 << 20
    assert inp["plan"].tri_vtx.shape[0] == 1 << 21
    assert int(inp["params"].bone_count.sum()) == 2304
    before = pair_launches()
    assert kernel_against_plain(inp, skinned, vc) == []
    assert pair_launches() == [n + 1 for n in before]


@pytest.mark.card
@pytest.mark.parametrize("scene,skinned,vc", CASES, ids=CASE_IDS)
def test_card_kernel_pair_bit_equal_on_the_cpu_cases(card, scene_inputs,
                                                     scene, skinned, vc):
    inp = to_device(scene_inputs[scene], card)
    assert kernel_against_plain(inp, skinned, vc) == []


@pytest.mark.card
def test_card_capture_and_replay_with_new_palette_and_camera(card):
    inp = crowd_inputs(card)
    args, kw = call_args(inp, True, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        indexed.indexed_geometry(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = pair_launches()
    with torch.cuda.graph(graph):
        cs, rec = indexed.indexed_geometry(*args, **kw)
    captured = [n - b for n, b in zip(pair_launches(), before)]
    assert captured == [1, 1]
    moved = crowd_inputs(card, seed=11)
    inp["palette"].copy_(moved["palette"])
    other = _camera([1.5, 2.0, 13.0], [0.2, -0.3, 0.0], inp["width"],
                    inp["height"], card, 50.0)
    inp["camera"].view.copy_(other.view)
    inp["camera"].proj.copy_(other.proj)
    graph.replay()
    cs_ref, rec_ref = indexed.indexed_geometry_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pair_launches() == [n + 1 for n in before]
    assert differing(cs, rec, cs_ref, rec_ref, corner_cols=False) == []
    assert not same(rec, indexed.indexed_geometry_plain(
        *call_args(crowd_inputs(card), True, True)[0], **kw)[1])


@pytest.mark.card
def test_card_wrapper_refuses_what_the_kernels_do_not_take(card):
    inp = to_device(hand_inputs(), card)
    args, kw = call_args(inp, True, False)
    plan, geo = inp["plan"], inp["geometry"]
    wide = torch.zeros((geo.attr_table.shape[0], 24), device=card)
    bad = [
        (plan._replace(tri_vtx=plan.tri_vtx.long()), geo),
        (plan._replace(vtx_src=plan.vtx_src.repeat(2)[::2]), geo),
        (plan, geo._replace(attr_table=wide[:, :12])),
        (plan, geo._replace(bone_weights=geo.bone_weights.double())),
    ]
    for p, g in bad:
        with pytest.raises(ValueError):
            indexed.indexed_geometry(p, *args[1:5], g, *args[6:], **kw)

