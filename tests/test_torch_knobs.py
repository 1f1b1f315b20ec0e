"""RenderConfig.kernel in the port: validated as the JAX package validates
it, refused where the port does not run it, and carried per Renderer.

  * For each kernel dict of CASES the port raises exactly when the JAX
    package's `kernel_knobs.apply` raises, with the same exception type
    (KeyError for an unknown name, ValueError for an inconsistent set),
    and so do the two Renderers at construction. The JAX knobs are
    restored to their env defaults after every case.
  * A known knob the port does not run, at a value other than the one it
    implements, raises NotImplementedError naming it.
  * Two Renderers with different knobs, interleaved, each render their
    own frame (the property the JAX package's trace_key() gives).
"""

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


@pytest.mark.parametrize("kernel", [
    {"chunk": 128}, {"resolve_prec": "bf16"}, {"resolve_prec": "fp32"},
    {"upscale_dtype": "bf16"}, {"qgate": True, "dynhit": False},
    {"rect": True, "dynhit": False}, {"pair_budget": 4096},
    {"texel_max_q": 1024}, {"tile_h": 16}, {"resolve_skip": True},
], ids=lambda k: ",".join(k))
def test_unported_knob_raises_not_implemented(kernel):
    assert _jax_apply(kernel) is None          # valid on the JAX side
    name = next(n for n in kernel if n != "dynhit")
    with pytest.raises(NotImplementedError, match=name):
        KernelKnobs.from_config(kernel)
    with pytest.raises(NotImplementedError, match=name):
        Renderer(EngineConfig(render=RenderConfig(kernel=kernel)),
                 device="cpu")


def test_port_values_are_accepted():
    """Knobs at the value the port implements pass: the JAX defaults, and
    upscale_dtype f32 (the port's convs are f32)."""
    assert KernelKnobs.from_config(dict(JAX_DEFAULTS, upscale_dtype="f32")) \
        == KernelKnobs()
    k = KernelKnobs.from_config({"ckern": True, "dynhit": False,
                                 "ck_bank": 4, "zskip": True})
    assert (k.ckern, k.dynhit, k.ck_bank, k.fuse) == (True, False, 4, False)


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
