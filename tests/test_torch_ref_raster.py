"""The reference raster as a Renderer route (use_pallas=False) and the
plane-gather frame through the port's Renderer, against the JAX package.

  * visibility_ref: bit-equal to the JAX oracle evaluated op by op (ids
    and depths), whatever the chunk, with aux a (2,) i32 zero.
  * frames: the port's Renderer on the reference raster against the JAX
    Renderer on the same scene (its default route on the CPU), and the
    plane-gather frame on the binned raster (forward_shading=False)
    against the JAX Renderer's, under the golden gate of
    test_golden_flavors.py (< 0.2% of RGBA8 values off by > 3 LSB,
    mean < 0.35), aux [0, 0]; the JAX frames run under jit, where XLA:CPU
    contracts the edge functions into FMAs, so a few winners at edges
    and depth ties may differ (at most 1% of the covered pixels).
  * the frame reads nothing back: the three routes' bundled frames run
    with every device-to-host read of a tensor (item, tolist, bool, int,
    float, numpy) made to raise, as a CUDA graph capture would fail on
    one.
"""

import numpy as np
import pytest
import torch

import jax

from trident_tpu.ops.raster_ref import visibility_ref as j_visibility_ref

from trident_tpu_torch.ops.raster_ref import visibility_ref
from trident_tpu_torch.tools_dev import scenes

from test_torch_frame import (
    _assert_golden_gate,
    _sphere_grid,
    jax_feature_renderer,
)
from test_torch_host import carry_renderer
from test_torch_raster import SCENES

torch.set_num_threads(1)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_visibility_ref_matches_jax_at_every_chunk(scene):
    (js, ps), w = SCENES[scene](np.random.default_rng(31))
    h = 64
    with jax.disable_jit():
        ref = j_visibility_ref(js, w, h)
    rt, rd = np.asarray(ref.tri_id), np.asarray(ref.depth)
    assert (rt >= 0).sum() > 300
    for chunk in (1, 7, 64, 1000):
        g = visibility_ref(ps, w, h, chunk=chunk)
        assert (g.tri_id.numpy() == rt).all(), chunk
        assert g.depth.numpy().tobytes() == rd.tobytes(), chunk
        assert g.aux.dtype == torch.int32 and g.aux.tolist() == [0, 0]


def _jax_and_port(name: str):
    """(JAX Renderer, port Renderer) of one frame scene."""
    if name == "sphere_grid":
        jr = _sphere_grid()
        jr.config.render.use_pallas = False
        return jr, carry_renderer(jr)
    if name == "vcolor_ref":
        return (jax_feature_renderer("vcolor", use_pallas=False),
                scenes.feature_scene("vcolor", "cpu", use_pallas=False))
    kw = {"shadows_hard_ref": dict(use_pallas=False, shadows=True,
                                   shadow_map_size=256),
          "planes_f32_pcf": dict(forward_shading=False, plane_f16=False,
                                 shadows=True, shadow_map_size=256,
                                 shadow_pcf=True),
          "vcolor_planes_f16": dict(forward_shading=False,
                                    plane_f16=True)}[name]
    feature = "vcolor" if name.startswith("vcolor") else "pallas_forward"
    return (jax_feature_renderer(feature, **kw),
            scenes.feature_scene(feature, "cpu", **kw))


@pytest.mark.parametrize("name", ["sphere_grid", "vcolor_ref",
                                  "shadows_hard_ref", "planes_f32_pcf",
                                  "vcolor_planes_f16"])
def test_route_frames_match_jax_renderer(name):
    from trident_tpu.ops import kernel_knobs

    try:
        jr, pr = _jax_and_port(name)
        jframe = jr.read_frame()
        jout = jr.viewports[0].last_frame
    finally:
        kernel_knobs.apply(kernel_knobs.env_defaults())
    out = pr.render_viewport()
    assert out.aux.tolist() == [0, 0]
    if pr.config.render.shadows:
        assert out.shadow_aux.tolist() == [0, 0]
    pt, jt = out.tri_id.numpy(), np.asarray(jout.tri_id)
    covered = int((jt >= 0).sum())
    assert covered > 2000
    assert (pt != jt).sum() <= max(32, covered // 100)
    _assert_golden_gate(pr.read_frame(out), jframe)


READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "numpy")


@pytest.mark.parametrize("route", ["ref", "planes_f16", "skinned_ref",
                                   "skinned_planes_f32"])
def test_route_frame_reads_nothing_back(route, monkeypatch):
    """The bundled frame of each new route, the light pass included,
    reads no tensor back to the host."""
    kw = {"ref": dict(use_pallas=False),
          "planes_f16": dict(forward_shading=False, plane_f16=True),
          "skinned_ref": dict(use_pallas=False),
          "skinned_planes_f32": dict(forward_shading=False,
                                     plane_f16=False)}[route]
    if route.startswith("skinned"):
        r, _reg = scenes.skinned_scene("cpu", width=96, height=64, grid=2,
                                       segments=8, rings=4, bones=2,
                                       shadows=True, shadow_map_size=64,
                                       **kw)
    else:
        r = scenes.feature_scene("pallas_forward", "cpu", **kw)
    fb = r.frame_bundle()
    f32, i32 = torch.from_numpy(fb.f32), torch.from_numpy(fb.i32)
    expect = fb.frame_fn(f32, i32, None, fb.ai)

    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read back to the host")

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = fb.frame_fn(f32, i32, None, fb.ai)
    monkeypatch.undo()
    assert torch.equal(out.color, expect.color)
    assert torch.equal(out.shadow_aux, expect.shadow_aux)


def test_plane_route_under_ckern_equals_k1():
    """Under the ckern knob the plane-gather frame's visibility is the
    compact-bank kernel's (its plain version here), as the JAX visibility
    is under CKERN; the frame equals the K1 frame bit for bit."""
    kw = dict(forward_shading=False, shadows=True, shadow_map_size=128)
    k1 = scenes.feature_scene("pallas_forward", "cpu", **kw)
    ck = scenes.feature_scene("pallas_forward", "cpu",
                              kernel={"ckern": True, "dynhit": False}, **kw)
    a, b = k1.render_viewport(), ck.render_viewport()
    for f in ("color", "depth", "tri_id", "aux", "shadow_aux"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
