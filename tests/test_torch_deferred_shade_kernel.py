"""The forward frame's shading stage (ops/deferred.py): deferred_shade_attrs
takes the shading kernel (csrc/deferred_shade.cu, shade_attrs_kernel) for
CUDA tensors with bilinear sampling and no shadow, skybox or custom shader,
and deferred_shade_attrs_plain, the plain composition, everywhere else.

On the CPU: the plain composition is the shading body it always was
(_shade_common on the attribute channels), bit for bit, on seeded frames
with P ∈ {0, 2, 4, 8} point-light rows and counts below the bucket, tonemap
on and off, a band of a taller frame and uncovered pixels; CPU tensors take
it with no launch and no `shading.kernel` count; shadow, skybox, custom
shader, trilinear and nearest frames route to it; the wrapper's input
checks raise.

On the card (marker `card`; there: python3 -m pytest --noconftest -m card
tests/test_torch_deferred_shade_kernel.py) the kernel against the plain
composition at 1920×1080 on both configurations' frames (the field of
spheres, tools_dev/scenes.py::build_bench_scene, and the glTF crowd,
loaded_crowd), tonemapped and linear, at each P, on a band, and after a
captured graph is replayed with a new camera and new light rows: bit for
bit (the kernel keeps the plain composition's orders: PyTorch's 3-wide
reduce, cuBLAS's FMA chain for the world position, the reciprocal product
of a division by a Python float); the routes it does not take launch it
not; mixed devices raise."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from trident_tpu_torch.ops import deferred, shading
from trident_tpu_torch.ops import resolve as rp
from trident_tpu_torch.render.camera import Camera
from trident_tpu_torch.render.textures import TextureSlots
from trident_tpu_torch.render.types import (
    GBuffer,
    LightParams,
    ShadowParams,
    SkyboxCube,
)
from trident_tpu_torch.utils.profiling import TRACER, tracing

BUCKETS = (0, 2, 4, 8)
TEX_SIZES = ((128, 128), (64, 32), (16, 16))
CLEAR = (0.05, 0.05, 0.08, 1.0)


class Frame(SimpleNamespace):
    """deferred_shade_attrs' inputs: gbuffer, attrs, textures, camera,
    lights, width, height, y_offset, full_height."""

    def args(self):
        return (self.gbuffer, self.attrs, self.textures, self.camera,
                self.lights, self.width, self.height)

    def kw(self, **more):
        return dict(clear_color=CLEAR, y_offset=self.y_offset,
                    full_height=self.full_height, **more)


def _camera(width, height, device, position=(0.0, 2.0, 9.0),
            target=(0.0, 0.0, 0.0)):
    cam = Camera()
    cam.set_viewport_size(width, height)
    cam.set_perspective(50.0, 0.1, 100.0)
    cam.set_position(position)
    cam.look_at_target(target)
    return cam.params(device)


def _lights(rng, n_point: int, count: int, device) -> LightParams:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pos = np.concatenate([rng.uniform(-3, 3, (n_point, 3)),
                          rng.uniform(2, 8, (n_point, 1))], 1)
    col = np.concatenate([rng.uniform(0, 1, (n_point, 3)),
                          rng.uniform(1, 6, (n_point, 1))], 1)
    return LightParams(
        ambient=t([0.3, 0.35, 0.4, 0.6]),
        dir_direction=t(rng.uniform(-1, 1, 3)),
        dir_color=t([1.0, 0.95, 0.8, 2.5]),
        dir_count=t(1, torch.int32),
        point_pos_range=t(pos.reshape(n_point, 4)),
        point_color_intensity=t(col.reshape(n_point, 4)),
        point_count=t(count, torch.int32))


def make_frame(height: int, width: int, n_point: int = 0, count: int = 0,
               seed: int = 0, device="cpu", y_offset: int = 0,
               full_height=None) -> Frame:
    """A seeded frame: a third of the pixels uncovered, depths inside the
    frustum, attribute rows as the resolve writes them (normal, UV, mip,
    colour factor, metallic, roughness and ambient a little past their
    clamps, a texture slot's base and size), three random textures."""
    rng = np.random.default_rng(seed)
    slots = TextureSlots()
    for k, (tw, th) in enumerate(TEX_SIZES):
        slots.acquire(f"t{k}", rng.integers(0, 256, (th, tw, 4),
                                            dtype=np.uint8))
    textures = slots.device_arrays(device)
    sizes = textures.sizes.cpu().numpy()
    slot = rng.integers(0, len(TEX_SIZES) + 1, (height, width))
    row = sizes[slot]
    attrs = np.zeros((height, width, rp.CHANNELS), np.float32)
    attrs[..., 0:3] = rng.normal(0, 1, (height, width, 3))
    attrs[..., rp.CH_U:rp.CH_V + 1] = rng.uniform(-1.5, 2.5,
                                                  (height, width, 2))
    attrs[..., rp.CH_MIP] = rng.uniform(-1.0, 9.0, (height, width))
    attrs[..., rp.CH_CF:rp.CH_CF + 4] = rng.uniform(0, 1, (height, width, 4))
    attrs[..., rp.CH_MET] = rng.uniform(-0.2, 1.2, (height, width))
    attrs[..., rp.CH_ROUGH] = rng.uniform(0.0, 1.2, (height, width))
    attrs[..., rp.CH_AMB] = rng.uniform(-0.2, 1.2, (height, width))
    attrs[..., rp.CH_BASE8] = row[..., 2]
    attrs[..., rp.CH_TSX] = row[..., 0]
    attrs[..., rp.CH_TSY] = row[..., 1]
    tri = rng.integers(0, 1000, (height, width)).astype(np.int32)
    tri[rng.uniform(0, 1, (height, width)) < 0.33] = -1
    depth = rng.uniform(0.9, 0.999, (height, width)).astype(np.float32)
    fh = height if full_height is None else full_height
    return Frame(
        gbuffer=GBuffer(tri_id=torch.as_tensor(tri, device=device),
                        depth=torch.as_tensor(depth, device=device)),
        attrs=torch.as_tensor(attrs, device=device), textures=textures,
        camera=_camera(width, fh, device),
        lights=_lights(rng, n_point, count, device), width=width,
        height=height, y_offset=y_offset, full_height=full_height)


def parent_composition(f: Frame, tonemap: bool = True) -> torch.Tensor:
    """The shading body deferred_shade_attrs ran before the kernel route,
    written out: _shade_common on the attribute channels."""
    a = f.attrs
    return deferred._shade_common(
        f.gbuffer, shading._normalize(a[..., rp.CH_NX:rp.CH_NZ + 1]),
        a[..., rp.CH_U:rp.CH_V + 1], a[..., rp.CH_MIP], deferred.size_hint(a),
        a[..., rp.CH_CF:rp.CH_CF + 4], a[..., rp.CH_MET:rp.CH_MET + 1],
        a[..., rp.CH_ROUGH:rp.CH_ROUGH + 1], a[..., rp.CH_AMB:rp.CH_AMB + 1],
        f.textures, f.camera, f.lights, f.width, f.height, CLEAR, None, False,
        tonemap, None, "bilinear", None, f.y_offset, f.full_height)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


CPU_CASES = [(p, c, tm, band) for p in BUCKETS
             for c in sorted({0, max(p - 1, 0)}) for tm in (True, False)
             for band in (False, True)]


@pytest.mark.parametrize("n_point,count,tonemap,band", CPU_CASES,
                         ids=[f"P{p}-n{c}-{'tm' if t else 'hdr'}"
                              f"{'-band' if b else ''}"
                              for p, c, t, b in CPU_CASES])
def test_plain_is_the_parent_composition(n_point, count, tonemap, band):
    kw = dict(y_offset=32, full_height=96) if band else {}
    f = make_frame(24, 40, n_point, count, seed=n_point + 10 * count, **kw)
    plain = deferred.deferred_shade_attrs_plain(*f.args(),
                                                **f.kw(tonemap=tonemap))
    routed = deferred.deferred_shade_attrs(*f.args(), **f.kw(tonemap=tonemap))
    parent = parent_composition(f, tonemap)
    assert plain.shape == (24, 40, 4) and plain.dtype == torch.float32
    assert torch.equal(bits(plain), bits(parent))
    assert torch.equal(bits(routed), bits(parent))
    covered = f.gbuffer.tri_id >= 0
    assert 0 < int(covered.sum()) < covered.numel()
    clear = torch.tensor(CLEAR)
    assert torch.equal(plain[~covered], clear.expand(int((~covered).sum()),
                                                     4))


def test_band_rows_are_the_full_frames():
    full = make_frame(96, 40, 4, 3, seed=5)
    band = Frame(**{**vars(full), "height": 32, "y_offset": 32,
                    "full_height": 96,
                    "gbuffer": GBuffer(*(t[32:64].contiguous()
                                         for t in full.gbuffer[:2])),
                    "attrs": full.attrs[32:64].contiguous()})
    whole = deferred.deferred_shade_attrs_plain(*full.args(), **full.kw())
    rows = deferred.deferred_shade_attrs_plain(*band.args(), **band.kw())
    assert torch.equal(bits(rows), bits(whole[32:64]))


def test_cpu_tensors_take_the_plain_path():
    f = make_frame(16, 24, 2, 1, seed=3)
    before = deferred.shade_attrs_kernel.launches
    tracing(True)
    TRACER.reset()
    try:
        out = deferred.deferred_shade_attrs(*f.args(), **f.kw())
        kernel_runs = TRACER.total("shading.kernel")
    finally:
        tracing(False)
        TRACER.reset()
    assert deferred.shade_attrs_kernel.launches == before
    assert kernel_runs == 0
    assert torch.equal(bits(out), bits(parent_composition(f)))


def _route_cases(f: Frame) -> dict:
    dev = f.attrs.device
    shadow = ShadowParams(
        depth=torch.ones((32, 32), device=dev),
        light_vp=torch.eye(4, device=dev),
        enabled=torch.ones((), dtype=torch.bool, device=dev),
        bias=torch.full((), 2e-3, device=dev))
    skybox = SkyboxCube(faces=torch.full((6, 4, 4, 3), 0.5, device=dev),
                        valid=torch.ones((), dtype=torch.bool, device=dev))
    return {"shadow": dict(shadow=shadow), "skybox": dict(skybox=skybox),
            "shader": dict(shader_fn=shading.shade_pbr),
            "trilinear": dict(sampling="trilinear"),
            "nearest": dict(sampling="nearest")}


ROUTES = ("shadow", "skybox", "shader", "trilinear", "nearest")


@pytest.mark.parametrize("route", ROUTES)
def test_other_frames_route_to_the_plain_path(route, monkeypatch):
    f = make_frame(16, 24, 2, 2, seed=4)
    kw = _route_cases(f)[route]
    # as a CUDA tensor would see it: the route's own condition declines
    cuda = SimpleNamespace(device=torch.device("cuda", 0))
    assert deferred.shades_by_kernel(cuda)
    assert not deferred.shades_by_kernel(cuda, **kw)
    assert not deferred.shades_by_kernel(f.attrs)

    def refuse(*_a, **_k):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(deferred, "shade_attrs_kernel", refuse)
    routed = deferred.deferred_shade_attrs(*f.args(), **f.kw(**kw))
    plain = deferred.deferred_shade_attrs_plain(*f.args(), **f.kw(**kw))
    assert torch.equal(bits(routed), bits(plain))


def _refusals(f: Frame) -> dict:
    """Inputs the wrapper refuses, each one field off a good frame."""
    lights, tex, gb = f.lights, f.textures, f.gbuffer
    flat = torch.zeros(f.attrs.numel() + 1)
    return {
        "attrs dtype": dict(attrs=f.attrs.double()),
        "attrs shape": dict(attrs=f.attrs[..., :12].contiguous()),
        "attrs contiguous": dict(
            attrs=torch.zeros((f.height, f.width, 32))[..., ::2]),
        "attrs aligned": dict(attrs=flat[1:].view(f.attrs.shape)),
        "depth dtype": dict(gbuffer=GBuffer(gb.tri_id, gb.depth.double())),
        "tri_id shape": dict(gbuffer=GBuffer(gb.tri_id[:-1].contiguous(),
                                             gb.depth)),
        "quads aligned": dict(textures=tex._replace(
            quads=torch.zeros(tex.quads.numel() + 1, dtype=torch.int32)
            [1:].view(tex.quads.shape))),
        "max_level dtype": dict(textures=tex._replace(
            max_level=tex.max_level.float())),
        "camera shape": dict(camera=f.camera._replace(
            position=torch.zeros(4))),
        "dir_count dtype": dict(lights=lights._replace(
            dir_count=lights.dir_count.float())),
        "point rows": dict(lights=lights._replace(
            point_color_intensity=torch.zeros((3, 4)))),
        "cpu": {},
    }


REFUSALS = ("attrs dtype", "attrs shape", "attrs contiguous",
            "attrs aligned", "depth dtype", "tri_id shape", "quads aligned",
            "max_level dtype", "camera shape", "dir_count dtype",
            "point rows", "cpu")


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    f = make_frame(8, 8, 2, 1, seed=6)
    g = Frame(**{**vars(f), **_refusals(f)[case]})
    before = deferred.shade_attrs_kernel.launches
    with pytest.raises(ValueError):
        deferred.shade_attrs_kernel(*g.args(), CLEAR, True, g.y_offset,
                                    g.full_height)
    assert deferred.shade_attrs_kernel.launches == before


# -- on the card -------------------------------------------------------------

W, H = 1920, 1080


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; where there is one: python3 -m "
                    "pytest --noconftest -m card "
                    "tests/test_torch_deferred_shade_kernel.py")
    from trident_tpu_torch import _build

    _build.load_library()
    return torch.device("cuda", 0)


def frame_difference(kernel: torch.Tensor, plain: torch.Tensor,
                     covered: torch.Tensor) -> dict:
    """The largest f32 difference, and the uint8 pixels that differ: how
    many, their share of the covered pixels, the largest LSB."""
    u8k = deferred.pack_rgba8(kernel).int()
    u8p = deferred.pack_rgba8(plain).int()
    lsb = (u8k - u8p).abs().amax(dim=-1)
    return dict(f32=float((kernel - plain).abs().max()),
                pixels=int((lsb > 0).sum()),
                share=float((lsb > 0).sum()) / max(int(covered.sum()), 1),
                lsb=int(lsb.max()))


def assert_equal_frames(kernel, plain, covered, what: str) -> None:
    d = frame_difference(kernel, plain, covered)
    print(f"{what}: {d}")
    assert torch.equal(bits(kernel), bits(plain)), (what, d)


def configuration_frames(dev) -> dict:
    """Each configuration's shading inputs at 1920×1080, caught from an
    eager render_frame: the field of spheres (spheres1080_1m) and the glTF
    crowd posed by one Scene.update."""
    import tempfile
    from pathlib import Path

    from trident_tpu_torch.render import renderer as rmod
    from trident_tpu_torch.tools_dev import scenes

    caught = {}
    real = rmod.deferred_shade_attrs

    def catch(*args, **kw):
        caught["call"] = (args, kw)
        return real(*args, **kw)

    frames = {}
    with tempfile.TemporaryDirectory() as td:
        crowd = scenes.loaded_crowd(dev, scenes.write_tube_gltf(
            Path(td) / "tube.glb"))
        crowd.scene.update(1 / 60)
        field, reg = scenes.build_bench_scene(36, dev)
        scenes.rotate(reg, 0)
        for name, r in (("field", field), ("crowd", crowd.renderer)):
            r.editor_camera.set_viewport_size(W, H)
            rmod.deferred_shade_attrs = catch
            try:
                rmod.render_frame(**r.frame_inputs())
            finally:
                rmod.deferred_shade_attrs = real
            frames[name] = caught.pop("call")
    return frames


@pytest.fixture(scope="module")
def config_frames(card):
    return configuration_frames(card)


@pytest.mark.card
@pytest.mark.parametrize("name", ("field", "crowd"))
@pytest.mark.parametrize("tonemap", (True, False))
def test_card_kernel_on_the_configurations_frames(card, config_frames, name,
                                                  tonemap):
    args, kw = config_frames[name]
    kw = {**kw, "tonemap": tonemap}
    gbuf = args[0]
    assert kw.get("shadow") is None and kw.get("skybox") is None
    before = deferred.shade_attrs_kernel.launches
    out = deferred.deferred_shade_attrs(*args, **kw)
    plain = deferred.deferred_shade_attrs_plain(*args, **kw)
    torch.cuda.synchronize()
    assert deferred.shade_attrs_kernel.launches == before + 1
    assert_equal_frames(out, plain, gbuf.tri_id >= 0,
                        f"{name} 1080p {'tonemapped' if tonemap else 'HDR'}")


@pytest.mark.card
@pytest.mark.parametrize("n_point", BUCKETS)
def test_card_kernel_at_each_bucket(card, n_point):
    for count in sorted({0, max(n_point - 1, 0), n_point}):
        f = make_frame(H, W, n_point, count, seed=20 + n_point, device=card)
        out = deferred.deferred_shade_attrs(*f.args(), **f.kw())
        plain = deferred.deferred_shade_attrs_plain(*f.args(), **f.kw())
        assert_equal_frames(out, plain, f.gbuffer.tri_id >= 0,
                            f"P {n_point}, count {count}")


@pytest.mark.card
def test_card_kernel_on_a_band(card):
    full = make_frame(H, W, 4, 3, seed=31, device=card)
    y0, bh = 512, 256
    band = Frame(**{**vars(full), "height": bh, "y_offset": y0,
                    "full_height": H,
                    "gbuffer": GBuffer(*(t[y0:y0 + bh].contiguous()
                                         for t in full.gbuffer[:2])),
                    "attrs": full.attrs[y0:y0 + bh].contiguous()})
    rows = deferred.deferred_shade_attrs(*band.args(), **band.kw())
    whole = deferred.deferred_shade_attrs(*full.args(), **full.kw())
    plain = deferred.deferred_shade_attrs_plain(*band.args(), **band.kw())
    # the band's pixels are the full frame's, in the kernel as in the plain
    assert torch.equal(bits(rows), bits(whole[y0:y0 + bh]))
    assert_equal_frames(rows, plain, band.gbuffer.tri_id >= 0, "band")


@pytest.mark.card
def test_card_capture_and_replay_with_new_camera_and_lights(card):
    f = make_frame(H, W, 8, 5, seed=41, device=card)
    moved = make_frame(H, W, 8, 7, seed=42, device=card)
    moved_cam = _camera(W, H, card, position=(2.0, 3.0, 8.0),
                        target=(0.5, 0.0, 0.0))
    deferred.deferred_shade_attrs(*f.args(), **f.kw())      # warm-up
    torch.cuda.synchronize()
    before = deferred.shade_attrs_kernel.launches
    graph = torch.cuda.CUDAGraph()
    tracing(True)
    TRACER.reset()
    try:
        with torch.cuda.graph(graph):
            out = deferred.deferred_shade_attrs(*f.args(), **f.kw())
        captured = TRACER.total("shading.kernel")
        for dst, src in zip((*f.camera, *f.lights),
                            (*moved_cam, *moved.lights)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        replayed = TRACER.total("shading.kernel") - captured
    finally:
        tracing(False)
        TRACER.reset()
    assert deferred.shade_attrs_kernel.launches == before + 1
    assert captured == 1 and replayed == 0
    plain = deferred.deferred_shade_attrs_plain(*f.args(), **f.kw())
    assert_equal_frames(out, plain, f.gbuffer.tri_id >= 0, "replay")
    first = deferred.deferred_shade_attrs_plain(
        *make_frame(H, W, 8, 5, seed=41, device=card).args(), **f.kw())
    assert not torch.equal(out, first)


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_card_other_frames_take_the_plain_path(card, route):
    f = make_frame(64, 96, 2, 2, seed=51, device=card)
    kw = _route_cases(f)[route]
    before = deferred.shade_attrs_kernel.launches
    routed = deferred.deferred_shade_attrs(*f.args(), **f.kw(**kw))
    plain = deferred.deferred_shade_attrs_plain(*f.args(), **f.kw(**kw))
    assert deferred.shade_attrs_kernel.launches == before
    assert torch.equal(bits(routed), bits(plain))


@pytest.mark.card
def test_card_wrapper_refuses_mixed_devices(card):
    f = make_frame(64, 96, 2, 1, seed=61, device=card)
    cpu_lights = f.lights._replace(ambient=f.lights.ambient.cpu())
    with pytest.raises(ValueError):
        deferred.shade_attrs_kernel(f.gbuffer, f.attrs, f.textures, f.camera,
                                    cpu_lights, 96, 64)
