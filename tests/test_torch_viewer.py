"""The port's live web viewer (trident_tpu_torch/scripts/viewer.py) on the
CPU: tests/test_viewer.py's flows against the port's ViewerServer over a
port Application (device="cpu") — frame streaming, orbit, pick-to-select,
inspector round-trip, play/stop, spawn, gizmos, console, assets, capture
toggles, thread checks and the animation-graph panel — and the streamed
PNG, decoded by the port's reader, equal to the frame the renderer
presented."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch


torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    from trident_tpu_torch.scripts import viewer as viewer_mod

    class Args:
        width = 128
        height = 128
        port = 0            # ephemeral
        host = "127.0.0.1"
        model = []
        scene = None
        shadows = False

    from trident_tpu_torch.core.input import Input

    saved = Input._instance
    app = viewer_mod.build_app(Args, device="cpu")
    srv = viewer_mod.ViewerServer(app, Args.host, Args.port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    app.shutdown()
    Input._instance = saved


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}") as r:
        return r.read()


def _post(srv, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(body or {}).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:  # surface the server's error body
        raise AssertionError(f"{path}: {exc} — {exc.read().decode()}")


def test_page_and_frame(server):
    page = _get(server, "/")
    assert b"trident_tpu viewer" in page
    png = _get(server, "/api/frame")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    state = json.loads(_get(server, "/api/state"))
    assert state["width"] == 128 and not state["playing"]
    assert state["triangles"] > 0


def test_entities_and_inspect(server):
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    tags = {e["tag"] for e in ents}
    assert {"cube", "sphere", "sun"} <= tags
    cube = next(e for e in ents if e["tag"] == "cube")
    comp = json.loads(_get(server, f"/api/entity?id={cube['id']}"))
    assert "Transform" in comp["components"]


def test_pick_and_transform_edit(server):
    # cube sits left of center → pick a pixel there
    res = _post(server, "/api/pick", {"x": 40, "y": 70})
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    cube = next(e for e in ents if e["tag"] == "cube")
    assert res["entity"] == cube["id"]
    # background pixel picks nothing
    assert _post(server, "/api/pick", {"x": 2, "y": 2})["entity"] is None

    # inspector round-trip: move the cube up and see the edit stick
    _post(server, "/api/set", {"entity": cube["id"],
                               "component": "Transform",
                               "field": "position", "value": [-1.1, 0.6, 0.0]})
    comp = json.loads(_get(server, f"/api/entity?id={cube['id']}"))
    np.testing.assert_allclose(
        comp["components"]["Transform"]["position"],
        [-1.1, 0.6, 0.0], atol=1e-6)


def test_camera_orbit_changes_frame(server):
    before = _get(server, "/api/frame")
    for _ in range(5):
        _post(server, "/api/camera", {"op": "orbit", "dx": 30, "dy": 0})
    after = _get(server, "/api/frame")
    assert before != after


def test_play_stop_and_spawn(server):
    assert _post(server, "/api/play") == {"ok": True}
    assert json.loads(_get(server, "/api/state"))["playing"]
    # spawning while playing goes into the runtime registry
    spawned = _post(server, "/api/spawn", {"primitive": "quad"})["entity"]
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    assert any(e["id"] == spawned for e in ents)
    assert _post(server, "/api/stop") == {"ok": True}
    assert not json.loads(_get(server, "/api/state"))["playing"]


def test_gizmo_translate_writes_transform(server):
    """Move mode (the ImGuizmo-translate analogue): dragging the selected
    entity writes its TransformComponent back through the facade."""
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    sphere = next(e for e in ents if e["tag"] == "sphere")
    before = json.loads(_get(server, f"/api/entity?id={sphere['id']}"))
    p0 = np.asarray(before["components"]["Transform"]["position"])
    _post(server, "/api/gizmo", {"entity": sphere["id"], "dx": 40, "dy": -25})
    after = json.loads(_get(server, f"/api/entity?id={sphere['id']}"))
    p1 = np.asarray(after["components"]["Transform"]["position"])
    assert np.linalg.norm(p1 - p0) > 1e-3


def test_gizmo_rotate_and_scale_modes(server):
    """Rotate and Scale gizmo drags (the reference's E/R ImGuizmo modes,
    SceneViewportPanel.cpp:63-100) write euler rotation / uniform scale."""
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    sphere = next(e for e in ents if e["tag"] == "sphere")
    before = json.loads(_get(server, f"/api/entity?id={sphere['id']}"))
    r0 = np.asarray(before["components"]["Transform"]["rotation"])
    s0 = np.asarray(before["components"]["Transform"]["scale"])
    _post(server, "/api/gizmo", {"entity": sphere["id"], "dx": 60, "dy": 20,
                                 "mode": "rotate"})
    _post(server, "/api/gizmo", {"entity": sphere["id"], "dx": 0, "dy": -80,
                                 "mode": "scale"})
    after = json.loads(_get(server, f"/api/entity?id={sphere['id']}"))
    r1 = np.asarray(after["components"]["Transform"]["rotation"])
    s1 = np.asarray(after["components"]["Transform"]["scale"])
    assert abs(r1[1] - r0[1]) > 1.0 and abs(r1[0] - r0[0]) > 1.0
    assert (s1 > s0 * 1.2).all()       # -80 px up-drag grows ~1.49x
    # position untouched by rotate/scale drags
    p0 = np.asarray(before["components"]["Transform"]["position"])
    p1 = np.asarray(after["components"]["Transform"]["position"])
    np.testing.assert_allclose(p1, p0)


def test_console_and_ai_state(server):
    from trident_tpu_torch.core.log import get_logger

    get_logger("viewer-test").warning("panel smoke warning")
    entries = json.loads(_get(server, "/api/console?level=30"))["entries"]
    assert any("panel smoke warning" in e["message"] for e in entries)
    state = json.loads(_get(server, "/api/state"))
    assert "ai" in state and state["ai"]["enabled"] in (True, False)
    _post(server, "/api/ai_blend", {"value": 0.4})
    assert abs(server.app.config.ai.blend - 0.4) < 1e-6


def test_state_reads_the_tracer(server):
    """The status panel carries the tracer's reads: device ms per frame
    stage (none off the card) and the host's waits on the card per
    frame (None until a frame was traced)."""
    state = json.loads(_get(server, "/api/state"))
    assert state["stage_ms"] == {}
    assert state["host_wait_ms"] is None or state["host_wait_ms"] >= 0.0


def test_assets_browse_and_import(server, tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "tri.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    server.assets_root = str(tmp_path)
    root = json.loads(_get(server, "/api/assets"))
    assert any(i["kind"] == "dir" and i["name"] == "sub"
               for i in root["items"])
    sub = json.loads(_get(server, "/api/assets?dir=sub"))
    tri = next(i for i in sub["items"] if i["name"] == "tri.obj")
    out = _post(server, "/api/import", {"path": tri["path"]})
    assert out["entities"], out
    # escapes clamp back to the root instead of listing outside it
    esc = json.loads(_get(server, "/api/assets?dir=..%2F..%2F"))
    assert esc["dir"] == "."


def test_destroy_and_capture_toggles(server):
    spawned = _post(server, "/api/spawn", {"primitive": "cube"})["entity"]
    _post(server, "/api/destroy", {"entity": spawned})
    ents = json.loads(_get(server, "/api/entities"))["entities"]
    assert not any(e["id"] == spawned for e in ents)

    _post(server, "/api/perf_capture", {"enabled": True})
    _get(server, "/api/frame")
    out = _post(server, "/api/perf_capture", {"enabled": False})
    assert out.get("path")

    png = _get(server, "/api/frame?vp=2")  # game viewport renders too
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


def test_viewer_works_with_thread_checks_active(server):
    """Round-3 regression: the cross-thread mutation detector
    (core/threadcheck) flagged the viewer's HTTP-thread registry
    mutations even though every engine access serializes through one
    lock. The viewer now rebinds guard ownership under the lock, so the
    two compose (and a test that installs the guard can no longer break
    later viewer tests)."""
    from trident_tpu_torch.core import threadcheck

    threadcheck.install_registry_guard()
    try:
        out = _post(server, "/api/spawn", {"primitive": "cube"})
        assert "entity" in out, out
        out = _post(server, "/api/destroy", {"entity": out["entity"]})
        assert out.get("ok"), out
    finally:
        threadcheck.set_active(threadcheck.checks_enabled())


def test_animation_graph_panel(server):
    """AnimationGraphPanel analogue: /api/animgraph serializes the live
    state machine (layers/states/transitions/params) and /api/anim_param
    edits drive transitions — the reference reserves this panel
    (Trident-Forge AnimationGraphPanel); here it is functional."""
    from trident_tpu_torch.anim.data import (
        AnimationClip, Bone, Skeleton, TransformChannel,
    )
    from trident_tpu_torch.anim.blend_tree import ClipNode
    from trident_tpu_torch.anim.state_machine import (
        AnimationStateMachine, Comparison, Condition, Layer, ParameterType,
        State, Transition,
    )
    from trident_tpu_torch.ecs.components import AnimationComponent

    sk = Skeleton(name="t")
    sk.add_bone(Bone(name="root", source_name="root"))
    ch = TransformChannel(
        bone_name="root",
        position_times=np.array([0.0, 1.0], np.float32),
        positions=np.array([[0, 0, 0], [0, 1, 0]], np.float32))
    clip = AnimationClip(name="rise", duration=1.0, channels=[ch])

    sm = AnimationStateMachine(sk)
    sm.add_parameter("speed", ParameterType.FLOAT, 0.25)
    sm.add_parameter("go", ParameterType.TRIGGER)
    layer = sm.add_layer(Layer("base"))
    layer.add_state(State("idle", ClipNode(clip, speed=0.0)), default=True)
    layer.add_state(State("rise", ClipNode(clip)))
    layer.add_transition(Transition("idle", "rise", [
        Condition("go", Comparison.TRIGGERED)], fade_duration=0.0))

    with server.lock:
        reg = server.app.renderer.registry
        e = reg.create()
        reg.add(e, AnimationComponent(state_machine=sm, playing=True))

    g = json.loads(_get(server, f"/api/animgraph?id={e}"))
    assert g["graph"] is not None
    names = {p["name"]: p for p in g["graph"]["parameters"]}
    assert names["speed"]["value"] == 0.25
    assert names["go"]["type"] == "trigger"
    base = g["graph"]["layers"][0]
    assert base["current"] == "idle"
    assert {s["name"] for s in base["states"]} == {"idle", "rise"}
    tr = base["transitions"][0]
    assert (tr["source"], tr["target"]) == ("idle", "rise")
    assert tr["conditions"][0]["comparison"] == "triggered"

    # edit a float param + fire the trigger through the panel API
    _post(server, "/api/anim_param", {"entity": e, "name": "speed",
                                      "value": 1.5})
    _post(server, "/api/anim_param", {"entity": e, "name": "go",
                                      "value": 1})
    assert sm.parameters["speed"] == 1.5
    sm.update(0.05)
    g2 = json.loads(_get(server, f"/api/animgraph?id={e}"))
    assert g2["graph"]["layers"][0]["current"] == "rise"


def test_frame_png_decodes_to_the_presented_frame(server):
    from trident_tpu_torch.io.image import decode_rgba

    png = _get(server, "/api/frame?vp=1")
    with server.lock:
        r = server.app.renderer
        frame = r.read_frame(viewport_id=server._last_vp)
    got = decode_rgba(png)
    assert got.shape == (128, 128, 4) and (got == frame).all()
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 16


def test_page_and_routes_match_the_jax_viewer():
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    from trident_tpu_torch.scripts import viewer as port_viewer

    jax_src = (root / "scripts" / "viewer.py").read_text()
    port_src = (root / "trident_tpu_torch" / "scripts" / "viewer.py") \
        .read_text()
    assert port_viewer._PAGE in jax_src                  # the same page
    ops = re.compile(r'(?:op|path) == "([^"]+)"')
    assert sorted(set(ops.findall(port_src))) == \
        sorted(set(ops.findall(jax_src)))
