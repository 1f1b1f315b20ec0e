"""RenderConfig.kernel in the port: validated as the JAX package validates
it, accepted wherever the JAX package accepts it, and carried per
Renderer.

  * For each kernel dict of CASES the port raises exactly when the JAX
    package's `kernel_knobs.apply` raises, with the same exception type
    (KeyError for an unknown name, ValueError for an inconsistent set),
    and so do the two Renderers at construction. The JAX knobs are
    restored to their env defaults after every case.
  * Each of the 31 knobs the port refused before it ran them all
    (FORMERLY_REFUSED, one non-default value each) is accepted, carried in
    KernelKnobs where the port reads it, and builds a Renderer; the cases
    that asserted the refusal now check what the port renders under them
    (the frames against the JAX package's: test_torch_knob_frames.py,
    test_torch_knob_resolve.py, test_torch_upscale_knobs.py).
  * Two Renderers with different knobs, interleaved, each render their
    own frame (the property the JAX package's trace_key() gives).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trident_tpu.core.config import EngineConfig as JEngineConfig
from trident_tpu.core.config import RenderConfig as JRenderConfig
from trident_tpu.ops import kernel_knobs as jknobs
from trident_tpu.render.renderer import Renderer as JRenderer

from trident_tpu_torch.core.config import EngineConfig, RenderConfig
from trident_tpu_torch.ops.kernel_knobs import (
    JAX_DEFAULTS,
    KernelKnobs,
)
from trident_tpu_torch.render.renderer import Renderer
from trident_tpu_torch.tools_dev.scenes import golden_base_scene

from test_torch_frame import _flavor_renderer
from test_torch_host import carry_renderer

torch.set_num_threads(1)

CASES = [
    None,
    {},
    {"fuse": True},
    {"fuse": True, "tiled_shade": True},
    {"tiled_shade": True},
    {"ckern": True},
    {"ckern": True, "dynhit": False},
    {"ckern": True, "dynhit": False, "ck_bank": 4},
    {"ckern": True, "dynhit": False, "ck_bank": 2},
    {"ckern": True, "dynhit": False, "ck_bank": 1},
    {"ckern": True, "dynhit": False, "ck_bank": 0},
    {"ckern": True, "dynhit": False, "qgate": True},
    {"fuse": True, "ckern": True, "dynhit": False},
    {"fuse": True, "acc": False},
    {"fuse": True, "acc": False, "dynhit": False},
    {"acc": False},
    {"acc": False, "dynhit": False},
    {"dynhit": False},
    {"zskip": True, "zorder": True},
    {"ckern": True, "dynhit": False, "zskip": True, "tiled_shade": True},
    {"chunk": 100},
    {"resolve_prec": "fp64"},
    {"upscale_dtype": "f16"},
    {"bogus": 1},
    {"fuse": True, "Fuse": True},
]


def _outcome(fn):
    try:
        fn()
    except Exception as exc:            # noqa: BLE001 — compared by type
        return type(exc)
    return None


def _jax_apply(kernel):
    try:
        return _outcome(lambda: jknobs.apply(kernel))
    finally:
        jknobs.apply(jknobs.env_defaults())


def test_known_knobs_are_the_jax_packages():
    assert set(JAX_DEFAULTS) == set(jknobs._KNOBS)
    assert JAX_DEFAULTS == jknobs.env_defaults()


@pytest.mark.parametrize("kernel", CASES, ids=[str(c) for c in CASES])
def test_validation_matches_jax(kernel):
    port = _outcome(lambda: KernelKnobs.from_config(kernel))
    assert port is _jax_apply(kernel)
    assert port in (None, KeyError, ValueError)


@pytest.mark.parametrize("kernel", [{"ckern": True}, {"bogus": True},
                                    {"fuse": True, "ckern": True,
                                     "dynhit": False},
                                    {"ckern": True, "dynhit": False}],
                         ids=["ckern-alone", "unknown", "fuse+ckern",
                              "ckern-config"])
def test_renderers_raise_alike(kernel):
    try:
        jax_out = _outcome(lambda: JRenderer(JEngineConfig(
            render=JRenderConfig(width=64, height=64, kernel=kernel))))
    finally:
        jknobs.apply(jknobs.env_defaults())
    port = _outcome(lambda: Renderer(EngineConfig(render=RenderConfig(
        width=64, height=64, kernel=kernel)), device="cpu"))
    assert port is jax_out


# one non-default value of each knob the port refused before it ran them
# all (every knob but fuse, ckern, ck_bank, tiled_shade, dynhit, acc, zskip, zorder;
# upscale_dtype at the JAX default "bf16", the port's being "f32"), with
# dynhit off where the JAX rules require it
FORMERLY_REFUSED = {
    "tile_h": {"tile_h": 16}, "tile_w": {"tile_w": 64},
    "chunk": {"chunk": 128}, "sub": {"sub": 32}, "span0": {"span0": 3},
    "sort_pad": {"sort_pad": True}, "exact_bins": {"exact_bins": True},
    "cover_gate": {"cover_gate": True},
    "qgate": {"qgate": True, "dynhit": False}, "treset": {"treset": False},
    "recpad": {"recpad": True}, "rect": {"rect": True, "dynhit": False},
    "max_global": {"max_global": 4}, "pair_budget": {"pair_budget": 4096},
    "resolve_half": {"resolve_half": True},
    "resolve_compact": {"resolve_compact": True},
    "resolve_skip": {"resolve_skip": True},
    "resolve_prec": {"resolve_prec": "bf16"},
    "resolve_tr": {"resolve_tr": False}, "planar": {"planar": False},
    "texel_mxu": {"texel_mxu": False}, "texel_slab": {"texel_slab": 256},
    "texel_br": {"texel_br": 16}, "texel_bc": {"texel_bc": 128},
    "texel_max_q": {"texel_max_q": 1024},
    "texel_max_pix": {"texel_max_pix": 1 << 20},
    "shadow_mxu": {"shadow_mxu": False}, "warp_mxu": {"warp_mxu": False},
    "upscale_v2": {"upscale_v2": False}, "d2s_mode": {"d2s_mode": "pad"},
    "upscale_dtype": {"upscale_dtype": "bf16"},
}


def test_formerly_refused_knobs_are_the_31():
    assert len(FORMERLY_REFUSED) == 31
    assert set(FORMERLY_REFUSED) | {
        "fuse", "ckern", "ck_bank", "tiled_shade", "dynhit", "acc",
        "zskip", "zorder"} == set(JAX_DEFAULTS)


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_knob_is_accepted(name):
    """Valid on the JAX side, accepted by the port, carried where the port
    reads it, and a Renderer builds."""
    kernel = FORMERLY_REFUSED[name]
    assert _jax_apply(kernel) is None
    knobs = KernelKnobs.from_config(kernel)
    if name in {f.name for f in dataclasses.fields(KernelKnobs)}:
        assert getattr(knobs, name) == kernel[name]
    else:
        assert knobs == KernelKnobs()
    r = Renderer(EngineConfig(render=RenderConfig(kernel=kernel)),
                 device="cpu")
    assert r.knobs == knobs


_DEFAULT_FRAME = {}


def _base_frame(kernel=None):
    if kernel is None and "frame" in _DEFAULT_FRAME:
        return _DEFAULT_FRAME["frame"]
    out = golden_base_scene("cpu", kernel=kernel).render_viewport()
    if kernel is None:
        _DEFAULT_FRAME["frame"] = out
    return out


@pytest.mark.parametrize("kernel", [
    {"chunk": 128}, {"resolve_prec": "bf16"}, {"resolve_prec": "fp32"},
    {"upscale_dtype": "bf16"}, {"qgate": True, "dynhit": False},
    {"rect": True, "dynhit": False}, {"pair_budget": 4096},
    {"texel_max_q": 1024}, {"tile_h": 16}, {"resolve_skip": True},
], ids=lambda k: ",".join(k))
def test_unported_knob_raises_not_implemented(kernel):
    """Before the port ran every knob, each of these raised
    NotImplementedError. Now each is accepted and renders the golden-base
    scene at 128²: the no-op knobs (and upscale_dtype, without an
    upscaler) the default frame bit for bit, aux [0, 0]; resolve_prec
    "bf16" the same winners with the colour of the bf16-rounded records,
    off the default frame."""
    assert _jax_apply(kernel) is None          # valid on the JAX side
    KernelKnobs.from_config(kernel)
    out, default = _base_frame(kernel), _base_frame()
    assert out.aux.tolist() == [0, 0]
    assert torch.equal(out.tri_id, default.tri_id)
    if kernel.get("resolve_prec") == "bf16":
        assert not torch.equal(out.color, default.color)
    else:
        assert torch.equal(out.color, default.color)
        assert torch.equal(out.depth, default.depth)


def test_port_values_are_accepted():
    """The JAX defaults pass, with upscale_dtype at the port's default
    "f32" the default knob set; and a ckern set carries its fields."""
    assert KernelKnobs.from_config(dict(JAX_DEFAULTS, upscale_dtype="f32")) \
        == KernelKnobs()
    assert KernelKnobs().upscale_dtype == "f32"
    assert KernelKnobs.from_config(JAX_DEFAULTS).upscale_dtype == "bf16"
    k = KernelKnobs.from_config({"ckern": True, "dynhit": False,
                                 "ck_bank": 4, "zskip": True})
    assert (k.ckern, k.ck_bank, k.fuse) == (True, 4, False)


def test_interleaved_renderers_render_their_own_frames():
    """A default-knob and a tiled_shade Renderer of one shadowed PCF scene,
    rendered in turns, give exactly the frames each gives alone — and the
    two differ (the tiled shading reassociates the lighting)."""
    jr = _flavor_renderer("shadows_pcf")
    alone = {}
    for name, kernel in (("default", None), ("tiled", {"tiled_shade": True})):
        alone[name] = carry_renderer(jr, kernel=kernel).render_viewport().color
    pair = {"default": carry_renderer(jr),
            "tiled": carry_renderer(jr, kernel={"tiled_shade": True})}
    assert pair["tiled"].knobs.tiled_shade and not pair["default"].knobs \
        .tiled_shade
    for _ in range(2):
        for name, r in pair.items():
            assert (r.render_viewport().color == alone[name]).all(), name
    assert (alone["default"] != alone["tiled"]).any()
    diff = np.abs(alone["default"].numpy().astype(int)
                  - alone["tiled"].numpy().astype(int))
    assert diff.max() <= 2
