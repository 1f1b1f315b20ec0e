"""Every kernel knob the JAX package accepts renders in the port: the
binning and layout knobs and the tiled-shade gate's limits, each held
against the JAX Renderer's frame under the same knob (the visibility
branches: test_torch_knob_branches.py; the resolve and fetch knobs and
the bf16 winner select: test_torch_knob_resolve.py; the upscaler's:
test_torch_upscale_knobs.py). The helpers here serve all three.

The scene (`knob_scene`): 3×3 textured spheres before a backdrop slab
(2,340 triangles) at 64², with `shadows` a shadow-casting sun and a 256²
map, built on the JAX package and carried across to the port's Renderer
with the same config and each case's RenderConfig.kernel (test_torch_host
.py::carry_renderer). The JAX frames are their Renderer's own
(render_viewport: one jit, the Pallas kernels interpreted), all of a
file's in one child process whose XLA:CPU may not emit FMAs
(--xla_cpu_max_isa=AVX, as test_torch_kbench.py runs its child): with
FMAs the jitted frame's UVs move and its checker edges flip (489 values
off by more than 3 LSB against the op-by-op frame, which the port's
default frame equals bit for bit); without, it is within 1 LSB of it
(with shadows, 3 values off by more than 3 LSB). Each JAX Renderer's
knobs are restored to the env defaults after its frame. The North-star
gates: aux [0, 0] on both sides and the golden gate
(test_golden_flavors.py). On the card the layout knobs select nothing
(ops/kernel_knobs.py), so the port's frame under each is also bit-equal
to its default frame; past a limit of the tiled-shade gate the frame
takes the untiled route, the default frame, as the JAX gate decides.

One knob leaves the gates on purpose: a pair_budget under the light
pass's pair count. The JAX light pass then truncates its pairs, which no
aux it returns counts, and its shadows change; the port's binning has no
such capacity outside ckern, so its frame stays whole (ROADMAP queue 3,
"Deliberate divergences"); under ckern the port drops as the JAX package
drops and its light-pass aux counts it. `test_pair_budget_divergence`
asserts those readings.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from trident_tpu.core.config import EngineConfig, RenderConfig
from trident_tpu.ecs import (
    MeshComponent,
    Registry,
    TextureComponent,
    TransformComponent,
)
from trident_tpu.ecs.components import LightComponent, LightType
from trident_tpu.geometry.primitives import PrimitiveType
from trident_tpu.io.image import checkerboard
from trident_tpu.ops import kernel_knobs as jknobs
from trident_tpu.render.renderer import Renderer as JRenderer

from test_torch_frame import _assert_golden_gate
from test_torch_host import carry_renderer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64

# knob cases of this file: id → RenderConfig.kernel (each valid on both
# sides)
LAYOUT_KNOBS = {
    "tile_h": {"tile_h": 16},
    "tile_w": {"tile_w": 64},
    "chunk": {"chunk": 128},
    "sub": {"sub": 32},
    "span0": {"span0": 3},
    "max_global": {"max_global": 1},
    "pair_budget": {"pair_budget": 4096},
    "planar": {"planar": False},
}

# tiled_shade with a routing limit: id → (kernel, takes the tiled route)
ROUTES = {
    "tiled": ({"tiled_shade": True}, True),
    "texel_max_q": ({"tiled_shade": True, "texel_max_q": 16}, False),
    "texel_max_pix": ({"tiled_shade": True, "texel_max_pix": 64 * 64 - 1},
                      False),
    "texel_mxu": ({"tiled_shade": True, "texel_mxu": False}, False),
}


class Case(NamedTuple):
    """A JAX frame to render: its kernel dict, the scene's shadows, and
    whether its resolve records are rounded to bf16 (jax_knob_frame)."""

    kernel: Optional[dict]
    shadows: bool = False
    round_records: bool = False


def knob_scene(kernel=None, shadows: bool = False, size: int = SIZE):
    """The JAX package's Renderer of this file's scene with `kernel`."""
    rc = dict(width=size, height=size, texture_size=64, use_pallas=True,
              kernel=kernel)
    if shadows:
        rc.update(shadows=True, shadow_map_size=256)
    r = JRenderer(EngineConfig(render=RenderConfig(**rc)))
    reg = Registry()
    r.set_active_registry(reg)
    slot = r.acquire_texture("checker", checkerboard(64, 8))
    mesh = r.ensure_primitive(PrimitiveType.SPHERE)
    for i in range(3):
        for j in range(3):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.array([(i - 1) * 1.4, (j - 1) * 1.4, 0],
                                  np.float32)
            t.rotation = np.array([10.0, 25.0 + 7.0 * i, 0.0], np.float32)
            reg.add(e, MeshComponent(mesh_index=mesh))
            reg.add(e, TextureComponent(path="checker", slot=slot))
    slab = reg.create()
    ts = reg.add(slab, TransformComponent())
    ts.position = np.array([0, 0, -1.2], np.float32)
    ts.scale = np.array([6, 6, 0.1], np.float32)
    reg.add(slab, MeshComponent(
        mesh_index=r.ensure_primitive(PrimitiveType.CUBE)))
    sun = reg.create()
    reg.add(sun, TransformComponent())
    reg.add(sun, LightComponent(
        light_type=LightType.DIRECTIONAL,
        direction=np.array([-0.35, -0.5, -1.0], np.float32), intensity=4.0,
        cast_shadows=True))
    r.editor_camera.set_position([0, 0, 5.2])
    r.editor_camera.look_at_target([0, 0, 0])
    return r


@contextlib.contextmanager
def rounded_records():
    """While open, the JAX package's chunk_resolve_cols rounds the record
    table it chunks to bf16 first: the TPU's resolve_prec="bf16" pass,
    which the CPU interpreter computes in f32 (resolve_pallas.py:80-85)."""
    import jax.numpy as jnp

    from trident_tpu.ops import planes as jplanes

    orig = jplanes.chunk_resolve_cols
    jplanes.chunk_resolve_cols = lambda cols, chunk: orig(
        cols.astype(jnp.bfloat16).astype(jnp.float32), chunk)
    try:
        yield
    finally:
        jplanes.chunk_resolve_cols = orig


def jax_knob_frame(kernel, round_records: bool = False,
                   shadows: bool = False):
    """(JAX Renderer, its frame's colour, its aux) under `kernel`, its
    records rounded to bf16 with `round_records` (rounded_records); the
    JAX knobs restored to their env defaults afterwards."""
    try:
        with (rounded_records() if round_records
              else contextlib.nullcontext()):
            jr = knob_scene(kernel, shadows)
            out = jr.render_viewport()
        return jr, np.asarray(out.color), np.asarray(out.aux).tolist()
    finally:
        jknobs.apply(jknobs.env_defaults())


def child(spec_path: str, out_path: str) -> None:
    """The child: each Case of the JSON spec {id: Case fields} → its JAX
    frame's colour and aux."""
    spec = json.loads(pathlib.Path(spec_path).read_text())
    out = {}
    for cid, case in spec.items():
        case = Case(**case)
        _jr, color, aux = jax_knob_frame(case.kernel, case.round_records,
                                         case.shadows)
        out[f"{cid}/color"], out[f"{cid}/aux"] = color, np.asarray(aux)
    np.savez(out_path, **out)


def jax_frames(tmp_path_factory, cases: dict) -> dict:
    """id → (colour, aux) of the JAX frames of `cases` (id → Case) and of
    "default" and "default_shadows" (no knob), rendered by the no-FMA
    child."""
    spec = {"default": Case(None)._asdict(),
            "default_shadows": Case(None, shadows=True)._asdict()}
    spec.update({cid: case._asdict() for cid, case in cases.items()})
    tmp = tmp_path_factory.mktemp("knob_frames")
    src, dst = tmp / "spec.json", tmp / "frames.npz"
    src.write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, __file__, str(src), str(dst)],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(dst) as z:
        return {cid: (z[f"{cid}/color"], z[f"{cid}/aux"].tolist())
                for cid in spec}


def port_frame(jr, **render_kw):
    """The port's frame of JAX Renderer `jr`'s scene (its kernel dict
    unless `render_kw` overrides it)."""
    tr = carry_renderer(jr, **render_kw)
    return tr, tr.render_viewport()


@pytest.fixture(scope="module")
def scene():
    """shadows → the scene on the JAX package with no knob set (the port
    carries it across with each case's kernel) and the port's default
    frame of it."""
    out = {}
    for shadows in (False, True):
        jr = knob_scene(shadows=shadows)
        _tr, frame = port_frame(jr)
        assert frame.aux.tolist() == [0, 0]
        assert shadows == (frame.shadow_aux is not None)
        out[shadows] = (jr, frame)
    return out


def check_knob_frame(kernel, scene, jax_frame, shadows=False,
                     port_same_as_default=True):
    """The port's frame under `kernel` against the JAX frame under it
    (`jax_frame`: colour, aux) on the scene with or without `shadows`:
    aux [0, 0] on both sides (the light pass's too on the port's), the
    golden gate; with `port_same_as_default`, bit-equal to the port's
    default frame. Returns the port's FrameOutput."""
    jr, default = scene[shadows]
    jcolor, jaux = jax_frame
    tr, out = port_frame(jr, kernel=kernel)
    assert tr.config.render.kernel == kernel
    assert jaux == [0, 0]
    assert out.aux.tolist() == [0, 0]
    assert out.shadow_aux is None or out.shadow_aux.tolist() == [0, 0]
    _assert_golden_gate(out.color.numpy(), jcolor)
    if port_same_as_default:
        for f in ("color", "depth", "tri_id"):
            assert torch.equal(getattr(out, f), getattr(default, f)), f
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return jax_frames(tmp_path_factory, {
        **{k: Case(v) for k, v in LAYOUT_KNOBS.items()},
        **{k: Case(v, shadows=True) for k, (v, _t) in ROUTES.items()},
        "pair_budget_64": Case({"pair_budget": 64}, shadows=True)})


@pytest.mark.parametrize("name", sorted(LAYOUT_KNOBS))
def test_layout_knob_frame_matches_jax(name, scene, frames):
    check_knob_frame(LAYOUT_KNOBS[name], scene, frames[name])


@pytest.fixture(scope="module")
def tiled_frame(scene):
    """The port's tiled_shade frame of the shadowed scene; it differs from
    the default frame (the tiled shading reassociates the lighting), so
    the route a frame took shows in its bits."""
    jr, default = scene[True]
    _tr, out = port_frame(jr, kernel={"tiled_shade": True})
    assert not torch.equal(out.color, default.color)
    return out


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_tiled_gate_routes_as_jax(name, scene, frames, tiled_frame):
    kernel, tiled = ROUTES[name]
    out = check_knob_frame(kernel, scene, frames[name], shadows=True,
                           port_same_as_default=not tiled)
    if tiled:
        assert torch.equal(out.color, tiled_frame.color)


def test_pair_budget_divergence(scene, frames):
    """pair_budget 64 is under the light pass's pairs: the JAX frame's
    shadows lose geometry (its colour differs from its default frame while
    the aux it returns, the main pass's, reads [0, 0]); the port's
    default binning has no pair capacity, so its frame is its default
    frame and its light-pass aux reads [0, 0]; under ckern the port caps
    the compact-bank pairs at 64 (raster.CK_PAIR_BUDGET's override) and
    its light-pass aux counts the drop."""
    jr, port_default = scene[True]
    jcolor, jaux = frames["pair_budget_64"]
    assert jaux == [0, 0]
    assert int((jcolor != frames["default_shadows"][0]).sum()) > 0
    tr, out = port_frame(jr, kernel={"pair_budget": 64})
    assert tr.knobs.pair_budget == 64 and tr.knobs.ck_pair_budget is None
    assert torch.equal(out.color, port_default.color)
    assert out.shadow_aux.tolist() == [0, 0]
    ck = {"pair_budget": 64, "ckern": True, "dynhit": False}
    _tr, cout = port_frame(jr, kernel=ck)
    assert _tr.knobs.ck_pair_budget == 64
    assert cout.shadow_aux.tolist()[0] > 0


if __name__ == "__main__":
    child(sys.argv[1], sys.argv[2])
