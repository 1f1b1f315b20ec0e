"""The forward route's rigid geometry (ops/rigid.py): the plain version is
the composition the renderer ran before (build_draw_rows → corner_stage →
build_resolve_cols_planar), bit for bit; on CPU tensors the wrapper takes
it and counts no launch; frame_geometry's CPU output is that composition's.
Cases: both draw-row layouts (the uniform draw_stride broadcast with
padding, the tri_draw gather), 32- and 40-wide records, on a small sphere
field (tools_dev/scenes.py::build_bench_scene) and on a hand-made plan with
padded triangles, a corner with w <= 0, one with |w| < 1e-8, a back face, a
degenerate and an off-screen triangle and a zero normal.

On the card (marker `card`; there: python3 -m pytest --noconftest -m card
tests/test_torch_rigid_geometry.py) the kernel (csrc/rigid_geometry.cu)
against the plain version bit for bit at the field's shapes (1,296 spheres
of 768 triangles in the 1,048,576-triangle bucket, at 1920×1080 and
960×540, both layouts) and on the CPU cases' inputs; inside a captured
graph replayed after the transforms and the camera changed in place; the
wrapper's refusals; and the entry point's launches in the frame loop: two
a field frame key's capture (its warm-up and the capture), none a replay,
none in a skinned crowd's frames.

No JAX here: the scenes are the port's own (tools_dev/scenes.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from trident_tpu_torch import _build
from trident_tpu_torch.ops import rigid
from trident_tpu_torch.ops.corner import build_draw_rows, corner_stage
from trident_tpu_torch.ops.planes import build_resolve_cols_planar
from trident_tpu_torch.render.camera import Camera
from trident_tpu_torch.render.renderer import frame_geometry, shading_consts
from trident_tpu_torch.render.types import CameraParams, DrawParams, DrawPlan
from trident_tpu_torch.tools_dev import scenes

ENTRY = "trident_rigid_geometry"
SCENES = ("field", "hand")
LAYOUTS = ("stride", "gather")
CASES = [(scene, layout, vc) for scene in SCENES for layout in LAYOUTS
         for vc in (False, True)]
CASE_IDS = [f"{s}-{lay}-{40 if v else 32}" for s, lay, v in CASES]
FIELD_GRID = 10              # the CPU field: 76,800 of 131,072 rows (the
                             # uniform layout needs 65,536 triangles)

# the hand plan at 64 × 48: 3 draws of 4 triangles, padded to 16
HAND_W, HAND_H, HAND_DRAWS, HAND_STRIDE, HAND_T = 64, 48, 3, 4, 16
BACK, DEGENERATE, W_ZERO, BEHIND, OFF_SCREEN = 1, 2, 3, 4, 5


def _hand_corners(rng) -> np.ndarray:
    """(T, 3, 12) corners: position, normal, UV, colour, pad. Draw 0
    (identity model) holds a front face, its mirror (BACK), a degenerate
    triangle and one with a corner at z = 0 (clip w 0: W_ZERO); draw 1
    one corner behind the camera (BEHIND) and one far to the right
    (OFF_SCREEN); the rest seeded in front of the camera."""
    c = np.zeros((HAND_T, 3, 12), np.float32)
    front = [(0.0, 0.5, -3.0), (0.5, -0.5, -3.0), (-0.5, -0.5, -3.0)]
    pos = {0: front, BACK: front[::-1],
           DEGENERATE: [front[0], front[0], front[2]],
           W_ZERO: [(-0.4, 0.2, -2.0), (0.3, -0.1, 0.0), (0.2, 0.4, -2.5)],
           BEHIND: [(-0.3, -0.3, -3.0), (0.2, 0.1, 2.0), (0.0, 0.4, -3.0)],
           OFF_SCREEN: [(50.0, 0.0, -3.0), (51.0, 0.0, -3.0),
                        (50.5, 1.0, -3.0)]}
    for t in range(3 * HAND_STRIDE):
        c[t, :, 0:3] = pos.get(t, rng.uniform((-1, -1, -5), (1, 1, -2),
                                              (3, 3)))
    c[:12, :, 3:6] = rng.standard_normal((12, 3, 3))
    c[0, 1, 3:6] = 0.0                       # a zero normal: the clamp
    c[:12, :, 6:8] = rng.uniform(0.0, 1.0, (12, 3, 2))
    c[:12, :, 8:11] = rng.uniform(0.0, 1.0, (12, 3, 3))
    c[12:] = c[0, 0]                         # padding: vertex 0's corners
    return c


def hand_inputs(device="cpu") -> dict:
    """The hand-made plan (module note) with an identity view, so that a
    corner at z = 0 has clip w 0 exactly."""
    rng = np.random.default_rng(31)
    corners = _hand_corners(rng)
    models = np.tile(np.eye(4, dtype=np.float32), (HAND_DRAWS, 1, 1))
    models[1, :3, 3] = (0.1, 0.0, 0.0)
    models[2, :3, :3] += 0.15 * rng.standard_normal((3, 3))
    models[2, :3, 3] = rng.uniform(-0.3, 0.3, 3)
    flat = models.reshape(HAND_DRAWS, 16)
    uv = rng.uniform(0.5, 2.0, (HAND_DRAWS, 5)).astype(np.float32)
    xform_b = np.concatenate(
        [flat[:, 12:16], uv, np.zeros((HAND_DRAWS, 3), np.float32)], 1)
    cam = Camera()
    cam.set_viewport_size(HAND_W, HAND_H)
    cam.set_perspective(60.0, 0.1, 100.0)
    proj = cam.host_params().proj

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    valid = np.zeros(HAND_T, bool)
    valid[:3 * HAND_STRIDE] = True
    # the gather layout reads tri_draw: draws out of stride order
    tri_draw = np.zeros(HAND_T, np.int32)
    tri_draw[:12] = [0, 0, 0, 0, 1, 1, 2, 1, 2, 2, 1, 2]
    zero = torch.zeros((), device=device)
    params = DrawParams(
        model=t(models), xform_a=t(flat[:, 0:12]), xform_b=t(xform_b),
        tint=zero.expand(HAND_DRAWS, 4), uv_scale=t(uv[:, 0:2]),
        uv_offset=t(uv[:, 2:4]), tiling=t(uv[:, 4]),
        texture_slot=t(np.arange(HAND_DRAWS) % 2, torch.int32),
        material_index=t(np.zeros(HAND_DRAWS), torch.int32),
        bone_offset=t(np.full(HAND_DRAWS, -1), torch.int32),
        bone_count=t(np.zeros(HAND_DRAWS), torch.int32))
    return dict(
        plan=DrawPlan(vtx_src=t(np.zeros(3 * HAND_T), torch.int32),
                      vtx_draw=t(np.zeros(3 * HAND_T), torch.int32),
                      tri_vtx=t(np.arange(3 * HAND_T).reshape(HAND_T, 3),
                                torch.int32),
                      tri_valid=t(valid, torch.bool), num_draws=HAND_DRAWS),
        tri_draw=t(tri_draw, torch.int32), params=params,
        shade_table=t(rng.uniform(0.0, 1.0, (HAND_DRAWS, 8))),
        camera=CameraParams(view=t(np.eye(4)), proj=t(proj),
                            position=t(np.zeros(3))),
        textures=SimpleNamespace(sizes=t([[128, 128, 0, 7], [64, 64, 64, 6]],
                                         torch.int32)),
        corner_t=t(corners.reshape(HAND_T, 36).T),
        draw_stride=HAND_STRIDE, real_draws=HAND_DRAWS, width=HAND_W,
        height=HAND_H)


def field_inputs(device="cpu", grid: int = FIELD_GRID, k: int = 0) -> dict:
    """A sphere field's frame inputs (bench.py's scene, `grid` × `grid`
    spheres of 768 triangles at 1920×1080, rotated as its frame k)."""
    r, reg = scenes.build_bench_scene(grid, device)
    scenes.rotate(reg, k)
    inp = r.frame_inputs()
    keys = ("plan", "tri_draw", "params", "shade_table", "camera",
            "textures", "corner_t", "draw_stride", "real_draws", "width",
            "height")
    return {key: inp[key] for key in keys}


@pytest.fixture(scope="module")
def scene_inputs():
    torch.set_num_threads(1)
    return {"field": field_inputs(), "hand": hand_inputs()}


def draw_consts(inp) -> torch.Tensor:
    return shading_consts(inp["params"], inp["shade_table"], inp["textures"])


def layout_kw(inp, layout: str) -> dict:
    if layout == "stride":
        return dict(draw_stride=inp["draw_stride"],
                    real_draws=inp["real_draws"])
    return dict(draw_stride=0, real_draws=0)


def call_args(inp, layout: str, vertex_colors: bool, **size):
    return ((inp["plan"], inp["tri_draw"], inp["params"], inp["camera"],
             draw_consts(inp), inp["corner_t"]),
            dict(width=size.get("width", inp["width"]),
                 height=size.get("height", inp["height"]),
                 vertex_colors=vertex_colors, **layout_kw(inp, layout)))


def composition(inp, layout: str, vertex_colors: bool):
    """What frame_geometry's corner branch composed before the wrapper."""
    rows = build_draw_rows(inp["params"], inp["camera"], inp["width"],
                           inp["height"], draw_consts=draw_consts(inp))
    cs = corner_stage(inp["corner_t"], rows, inp["tri_draw"],
                      inp["plan"].tri_valid, inp["width"], inp["height"],
                      vertex_colors=vertex_colors, **layout_kw(inp, layout))
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


@pytest.mark.parametrize("scene,layout,vc", CASES, ids=CASE_IDS)
def test_plain_is_the_composition(scene_inputs, scene, layout, vc):
    inp = scene_inputs[scene]
    args, kw = call_args(inp, layout, vc)
    cs, rec = rigid.rigid_geometry_plain(*args, **kw)
    cs_ref, rec_ref = composition(inp, layout, vc)
    assert differing(cs, rec, cs_ref, rec_ref) == []
    assert rec.shape == (inp["corner_t"].shape[1], 40 if vc else 32)


@pytest.mark.parametrize("scene,layout,vc", CASES, ids=CASE_IDS)
def test_cpu_tensors_take_the_plain_version(scene_inputs, scene, layout, vc):
    inp = scene_inputs[scene]
    args, kw = call_args(inp, layout, vc)
    before = dict(_build.LAUNCHES)
    cs, rec = rigid.rigid_geometry(*args, **kw)
    assert dict(_build.LAUNCHES) == before
    cs_ref, rec_ref = rigid.rigid_geometry_plain(*args, **kw)
    assert differing(cs, rec, cs_ref, rec_ref) == []


@pytest.mark.parametrize("scene,layout,vc", CASES, ids=CASE_IDS)
def test_frame_geometry_unchanged(scene_inputs, scene, layout, vc):
    inp = scene_inputs[scene]
    cs, rec = frame_geometry(
        inp["plan"], inp["tri_draw"], inp["params"], inp["shade_table"],
        inp["camera"], inp["textures"], inp["corner_t"], width=inp["width"],
        height=inp["height"], vertex_colors=vc, **layout_kw(inp, layout))
    cs_ref, rec_ref = composition(inp, layout, vc)
    assert differing(cs, rec, cs_ref, rec_ref) == []


def test_field_layouts_are_the_benchs(scene_inputs):
    """The CPU field is the uniform layout with padding, and its tri_draw
    gather names the same draws, so both layouts give one frame."""
    inp = scene_inputs["field"]
    t = inp["corner_t"].shape[1]
    stride, draws = inp["draw_stride"], inp["real_draws"]
    assert (stride, draws) == (768, FIELD_GRID ** 2)
    assert t > stride * draws
    expect = torch.zeros(t, dtype=torch.int32)
    expect[:stride * draws] = torch.arange(stride * draws) // stride
    assert torch.equal(inp["tri_draw"], expect)
    cs_s, rec_s = composition(inp, "stride", False)
    cs_g, rec_g = composition(inp, "gather", False)
    assert differing(cs_s, rec_s, cs_g, rec_g) == []


def test_hand_plan_holds_its_edge_cases(scene_inputs):
    """The hand-made plan has what the module note says it has."""
    inp = scene_inputs["hand"]
    args, kw = call_args(inp, "stride", False)
    cs, _rec = rigid.rigid_geometry_plain(*args, **kw)
    s, n_real = cs.setup, 3 * HAND_STRIDE
    assert not inp["plan"].tri_valid[n_real:].any()
    ahead = (s.w > 1e-6).all(1)
    on_screen = (s.bbox[:, 2] > s.bbox[:, 0]) & (s.bbox[:, 3] > s.bbox[:, 1])
    assert bool(s.valid[0]) and bool(ahead[BACK]) and bool(on_screen[BACK])
    assert not s.valid[BACK]                       # the back face
    assert not s.valid[DEGENERATE]
    assert (s.edge[DEGENERATE, 2] == 0).all()      # corners 0 and 1 meet
    assert float(s.w[W_ZERO].abs().min()) < 1e-8
    assert float(s.w[BEHIND].min()) <= 0.0
    full = torch.tensor([0, 0, HAND_W, HAND_H], dtype=torch.int32)
    assert (s.bbox[[W_ZERO, BEHIND]] == full).all()
    assert bool(ahead[OFF_SCREEN]) and not on_screen[OFF_SCREEN]
    assert not s.valid[OFF_SCREEN]
    assert int(s.valid[:n_real].sum()) >= 4
    assert (inp["corner_t"][15, :n_real] == 0).any()   # the zero normal


@pytest.mark.parametrize("fn", ("rigid_geometry_plain", "rigid_geometry"))
def test_a_layout_past_the_table_raises(scene_inputs, fn):
    """draw_stride × real_draws beyond the table raises ValueError, in
    corner_stage and so in the wrapper's CPU path."""
    inp = scene_inputs["hand"]
    args, kw = call_args(inp, "stride", False)
    kw.update(draw_stride=HAND_STRIDE + 3)
    with pytest.raises(ValueError, match="exceeds"):
        getattr(rigid, fn)(*args, **kw)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card "
                    "tests/test_torch_rigid_geometry.py")
    _build.load_library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def field_on_card():
    """The benchmark field's frame inputs on the card (built once), or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    return field_inputs(torch.device("cuda"), grid=36)


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


def kernel_against_plain(inp, layout: str, vc: bool, **size) -> list:
    args, kw = call_args(inp, layout, vc, **size)
    before = _build.LAUNCHES[ENTRY]
    cs, rec = rigid.rigid_geometry(*args, **kw)
    assert _build.LAUNCHES[ENTRY] == before + 1
    cs_ref, rec_ref = rigid.rigid_geometry_plain(*args, **kw)
    torch.cuda.synchronize()
    return differing(cs, rec, cs_ref, rec_ref, corner_cols=False)


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("size", ((1920, 1080), (960, 540)),
                         ids=("1920x1080", "960x540"))
def test_card_kernel_bit_equal_at_the_fields_shapes(card, field_on_card,
                                                    size, layout):
    inp = field_on_card
    assert inp["corner_t"].shape == (36, 1 << 20)
    assert (inp["draw_stride"], inp["real_draws"]) == (768, 1296)
    assert kernel_against_plain(inp, layout, False, width=size[0],
                                height=size[1]) == []


@pytest.mark.card
@pytest.mark.parametrize("layout", LAYOUTS)
def test_card_kernel_bit_equal_with_vertex_colours(card, field_on_card,
                                                   layout):
    assert kernel_against_plain(field_on_card, layout, True) == []


@pytest.mark.card
@pytest.mark.parametrize("scene,layout,vc", CASES, ids=CASE_IDS)
def test_card_kernel_bit_equal_on_the_cpu_cases(card, scene_inputs, scene,
                                                layout, vc):
    inp = to_device(scene_inputs[scene], card)
    assert kernel_against_plain(inp, layout, vc) == []


@pytest.mark.card
def test_card_capture_and_replay_with_new_transforms_and_camera(
        card, field_on_card):
    inp = dict(field_on_card)
    inp["params"] = type(inp["params"])(*[x.clone() for x in inp["params"]])
    inp["camera"] = type(inp["camera"])(*[x.clone() for x in inp["camera"]])
    args, kw = call_args(inp, "stride", False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rigid.rigid_geometry(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _build.LAUNCHES[ENTRY]
    with torch.cuda.graph(graph):
        cs, rec = rigid.rigid_geometry(*args, **kw)
    assert _build.LAUNCHES[ENTRY] == before + 1
    first = rec.clone()
    moved = field_inputs(card, grid=36, k=7)
    inp["params"].xform_a.copy_(moved["params"].xform_a)
    inp["params"].xform_b.copy_(moved["params"].xform_b)
    cam = Camera()
    cam.set_viewport_size(inp["width"], inp["height"])
    cam.set_perspective(50.0, 0.1, 1000.0)
    cam.set_position([3.0, 2.0, 38.0])
    cam.look_at_target([0.5, -0.3, 0.0])
    other = cam.params(card)
    inp["camera"].view.copy_(other.view)
    inp["camera"].proj.copy_(other.proj)
    graph.replay()
    cs_ref, rec_ref = rigid.rigid_geometry_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[ENTRY] == before + 1
    assert differing(cs, rec, cs_ref, rec_ref, corner_cols=False) == []
    assert not same(rec, first)


@pytest.mark.card
def test_card_wrapper_refuses_what_the_kernel_does_not_take(card):
    inp = to_device(hand_inputs(), card)
    args, kw = call_args(inp, "stride", False)
    plan, tri_draw, corner_t = inp["plan"], inp["tri_draw"], inp["corner_t"]
    wide = torch.zeros((HAND_T, 36), device=card)
    bad_args = [
        (plan, tri_draw, corner_t.double()),
        (plan, tri_draw, wide.T),                            # not contiguous
        (plan, tri_draw, corner_t[:35]),
        (plan, tri_draw.long(), corner_t),
        (plan._replace(tri_valid=plan.tri_valid.to(torch.uint8)), tri_draw,
         corner_t),
        (plan, tri_draw, corner_t[:, :8].contiguous()),     # tri_valid's
    ]
    for p, td, ct in bad_args:
        with pytest.raises(ValueError):
            rigid.rigid_geometry(p, td, *args[2:5], ct, **kw)
    for layout in (dict(draw_stride=HAND_STRIDE + 3, real_draws=HAND_DRAWS),
                   dict(draw_stride=1, real_draws=HAND_DRAWS + 1),
                   dict(draw_stride=1, real_draws=-1)):
        with pytest.raises(ValueError):
            rigid.rigid_geometry(*args, **{**kw, **layout})


@pytest.mark.card
def test_card_frame_keys_count_the_entry_point(card):
    """A field frame key's capture runs the entry point twice (its eager
    warm-up and the capture), a replay never; a skinned crowd's frames
    never."""
    r, reg = scenes.build_bench_scene(FIELD_GRID, card)
    before = (_build.LAUNCHES[ENTRY], r.graphs.captures)
    for k in range(3):
        scenes.rotate(reg, k)
        r.render_viewport()
    torch.cuda.synchronize()
    captures = r.graphs.captures - before[1]
    assert captures == 1
    assert _build.LAUNCHES[ENTRY] - before[0] == 2 * captures
    crowd, creg = scenes.skinned_scene(card, **scenes.SKINNED_128)
    before = (_build.LAUNCHES[ENTRY], crowd.graphs.captures)
    for k in range(3):
        scenes.pose_skinned(creg, k, scenes.SKINNED_128["bones"])
        crowd.render_viewport()
    torch.cuda.synchronize()
    assert crowd.graphs.captures - before[1] >= 1
    assert _build.LAUNCHES[ENTRY] == before[0]
