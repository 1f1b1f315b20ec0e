"""Custom shaders on the port (render/shader_hook.py, the torch twin of
trident_tpu/render/shader_hook.py), mirroring tests/test_shader_hook.py:
one shader written twice, in jnp and in torch, gives the JAX frame; a hot
swap changes the frame and its graph key; a failed reload keeps the
previous shader; `clear` restores PBR; the idle-frame cache misses after
a reload. Frames are held to the golden gate of test_golden_flavors.py.
"""

import textwrap

import numpy as np
import torch

from trident_tpu_torch.render.shader_hook import ShaderHook
from trident_tpu_torch.tools_dev.scenes import feature_scene

from test_torch_frame import check_feature_frame

torch.set_num_threads(1)

ALBEDO_SHADER = textwrap.dedent("""\
    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        # unlit: pass the albedo straight through
        return albedo
""")

RED_SHADER = textwrap.dedent("""\
    import torch

    def shade(world, normal, albedo, metallic, roughness,
              ambient_strength, camera_pos, lights, dir_shadow=None):
        red = torch.zeros_like(albedo)
        red[..., 0] = 1.0
        return red
""")


def _scene():
    return feature_scene("pallas_forward", "cpu", shadows=False)


def test_shader_frame_matches_jax(tmp_path):
    """The banded shader (tools_dev/scenes.py BANDED_SHADER, and its jnp
    twin) on the `_base` scene against the JAX frame."""
    r, out, _j = check_feature_frame("shader", tmp_path)
    assert r.shader_hook.fn is not None and r.shader_hook.version == 1
    pbr = _scene().render_viewport()
    assert (np.abs(out.color.numpy().astype(int) - pbr.color.numpy())
            > 8).mean() > 0.05


def test_hot_swap_changes_frame_and_key(tmp_path):
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)
    r = _scene()
    pbr = r.frame_bundle()
    pbr_frame = r.read_frame()
    assert r.set_custom_shader(str(shader))
    assert r.shader_hook.matches(str(shader))
    unlit = r.frame_bundle()
    assert unlit.key != pbr.key and unlit.key[-1] == 1
    unlit_frame = r.read_frame()
    assert np.abs(unlit_frame.astype(int) - pbr_frame.astype(int)).max() > 8
    shader.write_text(RED_SHADER)
    assert r.set_custom_shader(str(shader))
    red = r.frame_bundle()
    assert red.key not in (pbr.key, unlit.key)
    out = r.render_viewport()
    body = out.color.numpy()[(out.tri_id >= 0).numpy()]
    assert body[:, 0].mean() > 100 and body[:, 1].max() <= 30


def test_failed_reload_keeps_previous_shader(tmp_path):
    shader = tmp_path / "s.py"
    shader.write_text(ALBEDO_SHADER)
    r = _scene()
    assert r.set_custom_shader(str(shader))
    good = r.read_frame()
    v = r.shader_hook.version
    shader.write_text("def shade(:  # syntax error\n")
    assert not r.set_custom_shader(str(shader))
    assert r.shader_hook.version == v
    assert "SyntaxError" in r.shader_hook.last_error
    np.testing.assert_array_equal(good, r.read_frame())
    shader.write_text("x = 1\n")  # imports fine, no shade()
    assert not r.set_custom_shader(str(shader))
    assert "shade" in r.shader_hook.last_error
    assert not ShaderHook().load(str(tmp_path / "missing.py"))


def test_clear_restores_pbr(tmp_path):
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)
    r = _scene()
    pbr = r.read_frame()
    assert r.set_custom_shader(str(shader))
    assert (r.read_frame() != pbr).any()
    r.clear_custom_shader()
    assert r.shader_hook.fn is None and r.shader_hook.path is None
    assert r.shader_hook.version == 2
    np.testing.assert_array_equal(r.read_frame(), pbr)


def test_idle_cache_misses_after_reload(tmp_path):
    shader = tmp_path / "unlit.py"
    shader.write_text(ALBEDO_SHADER)
    r = _scene()
    first = r.render_viewport()
    assert r.render_viewport() is first            # idle: the cached frame
    assert r.set_custom_shader(str(shader))
    second = r.render_viewport()
    assert second is not first
    assert (second.color != first.color).any()
    assert r.render_viewport() is second
    assert r.set_custom_shader(str(shader))         # the same file again
    assert r.render_viewport() is not second
