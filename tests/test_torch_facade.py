"""The port's RenderCommand facade (trident_tpu_torch/render/command.py)
against the JAX package's, on the CPU: tests/test_facade.py's sequence and
the rest of the facade's methods run through both, each step's result
compared (images within the golden gate, the world matrix to 1e-6, the
inspector's dicts equal but for the random UUIDs, pick_entity equal).
RenderCommand._app and the Input singleton are restored after each test.

The JAX side runs in a child process with XLA_FLAGS=--xla_cpu_max_isa=AVX:
the sequence's cube faces the camera, and under jit XLA:CPU contracts the
reference raster's edge functions into FMAs, which leaves a one-pixel
crack along the face's diagonal (30 pixels at 64²); without FMAs the JAX
frame has none, as the port's has none."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from trident_tpu.core import config as jconfig
from trident_tpu.ecs import components as jc
from trident_tpu.geometry import primitives as jprim
from trident_tpu.render.command import RenderCommand as JRC

from trident_tpu_torch.core import config
from trident_tpu_torch.core.input import Input
from trident_tpu_torch.ecs import components as C
from trident_tpu_torch.geometry import primitives as prim
from trident_tpu_torch.render.command import RenderCommand as RC

from test_torch_frame import _assert_golden_gate

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_facades():
    saved = (RC._app, JRC._app, Input._instance)
    yield
    for facade in (RC, JRC):
        if facade._app is not None and facade._app not in saved:
            facade.shutdown()
    RC._app, JRC._app, Input._instance = saved


def sequence(rc, cfg, C_, prim_, tmp, **init_kw):
    """tests/test_facade.py's steps, then the other facade methods; the
    results in order."""
    out = {}
    rc.init(cfg.EngineConfig(
        render=cfg.RenderConfig(width=64, height=64, use_pallas=False),
        capture=cfg.CaptureConfig(perf_dir=str(tmp / "perf"),
                                  dataset_dir=str(tmp / "ds")),
        assets_root=str(tmp / "Assets"), log_file=None), **init_kw)
    reg = rc.get_registry()
    e = reg.create()
    reg.add(e, C_.TransformComponent())
    reg.add(e, C_.MeshComponent(
        mesh_index=rc.renderer().ensure_primitive(prim_.PrimitiveType.CUBE)))
    rc.set_editor_camera([0, 0, 3], target=[0, 0, 0])
    rc.queue_text(0, "hi", 2, 2)
    rc.begin_performance_capture()
    rc.draw_frame()
    out["image"] = np.asarray(rc.get_viewport_texture(0))
    csv = rc.end_performance_capture()
    out["csv"] = csv is None or csv.endswith(".csv")
    out["samples"] = rc.get_frame_timing_stats().sample_count >= 1
    out["pick_centre"] = rc.pick_entity(32, 32) == e
    out["pick_corner"] = rc.pick_entity(1, 1)

    m = rc.get_world_transform(e)
    m[0, 3] = 2.5
    rc.set_world_transform(e, m)
    out["position"] = reg.get(e, C_.TransformComponent).position.tolist()
    out["matrix"] = np.asarray(rc.get_world_transform(e))
    out["ai_enabled"] = rc.get_ai_debug_stats().enabled
    rc.set_ai_blend_strength(0.4)
    out["blend"] = rc.app().config.ai.blend

    out["inspect"] = rc.inspect_entity(e)
    out["set"] = rc.set_component_field(e, "Transform", "scale", [2, 1, 1])
    out["set"] = np.asarray(out["set"]).tolist()
    out["get"] = rc.get_component_field(e, "Transform", "scale")
    try:
        rc.set_component_field(e, "Transform", "scale", [1, 1])
    except ValueError as exc:
        out["set_error"] = str(exc)
    out["schema"] = rc.component_schema("Light")
    rc.set_viewport(3, 32, 16)
    out["viewport3"] = np.asarray(rc.get_viewport_texture(3)).shape
    rc.set_runtime_camera_ready(False)
    out["moved_image"] = np.asarray(rc.get_viewport_texture(0))

    tri = prim_.build_primitive(prim_.PrimitiveType.QUAD)
    out["append"] = rc.append_meshes([tri], [])
    obj = tmp / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    out["import"] = len(rc.import_assets([str(obj)]))
    rc.configure_dataset_capture(str(tmp / "ds2"), 0.25)
    rc.set_dataset_capture_enabled(True)
    out["dataset"] = (rc.app().dataset_recorder.running,
                      os.path.basename(rc.app().dataset_recorder.directory))
    rc.set_dataset_capture_enabled(False)
    out["record_on"] = rc.set_viewport_recording_enabled(
        True, str(tmp / "cap.y4m"), 24)
    rc.draw_frame()
    out["record_off"] = rc.set_viewport_recording_enabled(False)
    out["recorded"] = os.path.getsize(tmp / "cap.y4m") > 0
    shader = tmp / "unlit.py"
    shader.write_text(
        "def shade(world, normal, albedo, metallic, roughness,\n"
        "          ambient_strength, camera_pos, lights, dir_shadow=None):\n"
        "    return albedo\n")
    out["shader"] = rc.set_custom_shader(str(shader))
    rc.clear_custom_shader()
    rc.set_active_registry(reg)
    rc.shutdown()
    out["after"] = rc._app
    try:
        rc.app()
    except RuntimeError as exc:
        out["no_app"] = str(exc)
    return out


def jax_sequence(tmp) -> dict:
    """sequence() on the JAX facade, in a child process without FMAs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(tmp)], env=env,
                          cwd=tmp, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        return pickle.load(f)


def _no_uuid(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "UUID"}


def test_facade_sequence_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = jax_sequence(tmp_path / "j")
    got = sequence(RC, config, C, prim, tmp_path / "p", device="cpu")
    for out in (got, want):
        out["inspect"] = _no_uuid(out["inspect"])
    assert set(got) == set(want)
    for key in ("image", "moved_image"):
        _assert_golden_gate(got[key], want[key])
    assert (got["image"] != got["moved_image"]).any()
    np.testing.assert_allclose(got["matrix"], want["matrix"], atol=1e-6)
    assert got["position"][0] == pytest.approx(2.5, abs=1e-4)
    for key in sorted(set(got) - {"image", "moved_image", "matrix"}):
        assert got[key] == want[key], key
    assert got["pick_centre"] and got["pick_corner"] is None
    assert got["import"] == 1 and got["record_on"] and got["shader"]


if __name__ == "__main__":          # the JAX side, in a child process
    tmp = pathlib.Path(sys.argv[1])
    result = sequence(JRC, jconfig, jc, jprim, tmp)
    with open(tmp / "jax.pkl", "wb") as f:
        pickle.dump(result, f)
