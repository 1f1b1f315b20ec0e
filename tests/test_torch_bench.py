"""The port's bench (trident_tpu_torch/bench.py, bench_sweep.py) on the CPU:
its JSON line has bench.py's keys (read from bench.py's source, which is
not imported: it imports jax at run time), its scenes are bench.py's, the
device-throughput frames equal the interactive frames, an unknown config
and dropped geometry abort it, and the sweep reports a failing entry and
goes on. chip_smoke.py runs the bench on the card (phase 13).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from trident_tpu_torch import bench
from trident_tpu_torch.bench_sweep import sweep
from trident_tpu_torch.ecs.components import TransformComponent
from trident_tpu_torch.ops import raster
from trident_tpu_torch.tools_dev.scenes import BENCH_GRIDS, build_scene

from test_torch_frame_loop import _same

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 2


def _printed_dict(func: ast.FunctionDef) -> ast.Dict:
    """The dict literal of the last print(json.dumps({...})) in `func`."""
    found = [n.args[0] for n in ast.walk(func)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "") ==
             "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    return found[-1]


def _keys(d: ast.Dict) -> list:
    return [k.value for k in d.keys if k is not None]


def bench_py_keys() -> dict:
    """bench.py's printed keys: the render line's, its extra's (with
    `psnr_vs_native_db` under BENCH_AI), and bench_interp's."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    funcs = {f.name: f for f in ast.walk(tree)
             if isinstance(f, ast.FunctionDef)}
    render = _printed_dict(funcs["_main_inner"])
    extra = render.values[_keys(render).index("extra")]
    quality = [t.slice.value for n in ast.walk(funcs["_main_inner"])
               if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(t, ast.Subscript)
               and getattr(t.value, "id", "") == "extra_quality"]
    interp = _printed_dict(funcs["bench_interp"])
    return {"render": _keys(render), "extra": _keys(extra),
            "quality": quality, "interp": _keys(interp),
            "interp_extra": _keys(interp.values[_keys(interp).index(
                "extra")])}


def test_bench_py_keys_are_read():
    keys = bench_py_keys()
    assert keys["render"] == ["metric", "value", "unit", "vs_baseline",
                              "extra"]
    assert "interactive_agreed" in keys["extra"] and keys["quality"] == [
        "psnr_vs_native_db"]


@pytest.mark.parametrize("ai", [False, True], ids=["native", "ai"])
def test_cube512_line_has_bench_py_keys(ai):
    """cube512 (and cube512:ai) at 2 frames: bench.py's keys, in its
    order, aux [0, 0], the metric name bench.py gives the config."""
    keys = bench_py_keys()
    line = bench.run("cube512", ai, "cpu", iters=ITERS)
    assert list(line) == keys["render"]
    want = keys["extra"] + (keys["quality"] if ai else [])
    assert list(line["extra"]) == want
    assert line["metric"] == f"render_fps_cube512{'_ai' if ai else ''}_512x512"
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 60.0,
                                                abs=1e-3)
    ex = line["extra"]
    assert ex["aux"] == [0, 0] and ex["triangles"] == 12
    assert ex["backend"] == "cpu" and ex["raster"] == "plain"
    assert 2 <= len(ex["interactive_runs"]) <= 5
    assert ex["interactive_fps"] in ex["interactive_runs"]
    if ai:
        assert 10.0 < ex["psnr_vs_native_db"] < 100.0
    json.dumps(line)


def test_interp_line_has_bench_py_keys():
    keys = bench_py_keys()
    line = bench.run("interp", False, "cpu", iters=1,
                     interp_src=str(ROOT / "no_such_dataset"))
    assert list(line) == keys["interp"]
    assert list(line["extra"]) == keys["interp_extra"]
    assert line["metric"] == "interp_infer_256" and line["value"] > 0
    assert line["unit"] == "ms/frame"
    assert line["extra"]["backend"] == "cpu" and line["extra"]["iters"] == 1


def test_interp_refuses_pngs_it_cannot_decode(tmp_path, monkeypatch):
    """A source that holds PNGs with no decoder importable raises; it does
    not quietly time the synthetic frames."""
    for k in range(3):
        (tmp_path / f"frame_{k}.png").write_bytes(b"\x89PNG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PNG decoder"):
        bench.run("interp", False, "cpu", iters=1, interp_src=str(tmp_path))


def _bench_py_scene(config):
    sys.path.insert(0, str(ROOT))
    try:
        import bench as jbench
    finally:
        sys.path.remove(str(ROOT))
    return jbench.build_scene(config)


@pytest.mark.parametrize("config", sorted(BENCH_GRIDS))
def test_scenes_are_bench_py_scenes(config):
    """build_scene(config) against bench.py's: the frame size, bloom and
    shadows, each entity's transform and mesh, the lights and the
    camera."""
    from trident_tpu.ecs.components import TransformComponent as JT

    jr, jreg, (w, h) = _bench_py_scene(config)
    r, reg = build_scene(config, "cpu")
    rc, jrc = r.config.render, jr.config.render
    assert (rc.width, rc.height, rc.bloom, rc.shadows) == (
        w, h, jrc.bloom, jrc.shadows)
    ents = [(e, t) for e, (t,) in reg.view(TransformComponent)]
    jents = [(e, t) for e, (t,) in jreg.view(JT)]
    assert len(ents) == len(jents)
    for (_e, t), (_je, jt) in zip(ents, jents):
        for f in ("position", "rotation", "scale"):
            assert np.array_equal(getattr(t, f), getattr(jt, f)), f
    assert r.geometry.packed().positions.tobytes() == \
        jr.geometry.packed().positions.tobytes()
    assert np.array_equal(r.editor_camera.position, jr.editor_camera.position)
    assert np.array_equal(r.editor_camera.rotation, jr.editor_camera.rotation)


def test_unknown_config_raises_and_the_sweep_goes_on(capsys):
    with pytest.raises(SystemExit, match="unknown BENCH_CONFIG 'cube'"):
        build_scene("cube", "cpu")
    lines = sweep(["cube", "interp"], "cpu", settings=dict(
        bench.settings_from_env(), iters=1,
        interp_src=str(ROOT / "no_such_dataset")))
    assert lines[0]["metric"] == "bench_error_cube"
    assert "unknown BENCH_CONFIG" in lines[0]["extra"]["error"]
    assert lines[1]["metric"] == "interp_infer_256"
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == lines


def _small_bench(ai: bool, iters: int = 3):
    r, reg = build_scene("cube512", "cpu", ai=ai)
    r.set_viewport(0, 64, 48)
    return bench.FrameBench(r, reg, "cube512", iters)


@pytest.mark.parametrize("ai", [False, True], ids=["native", "ai"])
def test_throughput_frames_equal_interactive_frames(ai):
    """Row k of the device-resident blobs is frame k's host blobs, and the
    throughput path's frames (chained through prev under :ai, from the
    zeros-but-valid history) equal the interactive path's bit for bit."""
    b = _small_bench(ai)
    assert (b.prev0 is not None) == ai
    if ai:
        assert b.prev0[0].shape == (24, 32, 12) and not b.prev0[0].any()
    prev_i = prev_d = b.prev0
    for k in range(b.iters):
        assert b.f32_rows[k].numpy().tobytes() == b.bundles[k].f32.tobytes()
        assert b.i32_rows[k].numpy().tobytes() == b.bundles[k].i32.tobytes()
        out_i = b.interactive_frame(k, prev_i)
        out_d = b.device_frame(k, prev_d)
        assert not _same(out_i, out_d), k
        prev_i, prev_d = b._next_prev(out_i), b._next_prev(out_d)
    ms, aux = b.throughput_window()
    assert ms > 0 and aux.tolist() == [0, 0]
    assert len({bd.key for bd in b.bundles}) == 1


def test_check_aux_aborts_on_dropped_geometry(monkeypatch):
    """A scene whose geometry the binner drops (an emission pool too small
    for the cube) aborts the bench at its warm-up frame."""
    assert bench.check_aux(torch.zeros(2, dtype=torch.int32), "x").tolist() \
        == [0, 0]
    with pytest.raises(SystemExit, match=r"0 pairs truncated, 3 big"):
        bench.check_aux(np.array([0, 3]), "x")
    monkeypatch.setattr(raster, "default_pool", lambda n_sub, n_tiles: 1)
    with pytest.raises(SystemExit, match="warmup frame.*raster overflow"):
        _small_bench(False).measure()


def test_watchdog_prints_bench_error_and_exits_3():
    code = ("import time\n"
            "from trident_tpu_torch.bench import arm_watchdog\n"
            "arm_watchdog()\n"
            "time.sleep(60)\n")
    env = dict(os.environ, BENCH_WATCHDOG="0.5", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "bench_error" and line["value"] == 0
    assert set(line["extra"]) == {"error"}
    env["BENCH_WATCHDOG"] = "0"
    assert subprocess.run([sys.executable, "-c", "from trident_tpu_torch."
                           "bench import arm_watchdog; "
                           "assert arm_watchdog() is None"], env=env,
                          cwd=ROOT, timeout=120).returncode == 0
